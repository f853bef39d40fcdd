"""Drive the PyTorch/CUDA port's CCD render on one NVIDIA GPU, end to
end, and check it: the bench CCD through the optics chain and through
the analytic PSF, the flats, the silicon modes and object families, a
CCD built from its pointing, a CCD rendered from an instance catalog
through the runner's per-CCD path, a visit from a YAML config to files
on disk through the CLI, CCDs from skyCatalogs files, and the visit over
several ranks.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero and the final
ok line is never printed):

  1. device: the card's name and count, nvidia-smi's name and power limit;
  2. build: nvcc compiles imsim_tpu_torch/csrc/*.cu from this checkout
     (seconds and -Xptxas -v registers/shared memory per kernel);
  3. kernels vs plain twins on the card at the main path's shapes
     (bench workload: 1e5 objects, ~1e8 pooled photons, R22_S11,
     6 batches, pair 4, share 4), with CUDA-event times, each beside its
     bound (operations over 67 TFLOP/s FP32 or bytes over 3.35 TB/s,
     whichever is larger) and, where one PyTorch call computes the same
     function, that call's time (K3: one float32 conv2d, first held to
     1e-5 of max |out| of the twin); gate (ad): K1 repeats bit for bit,
     five calls on batch 0's deltas and one on a second stream, each
     equal to the first; K5, the binning scatter, through
     sensor/simple.accumulate onto a charged 4004 x 4096 frame at the
     flat's sub-batch (16,769,309 photons) and the sky chunk (1,876,480,
     9% off the frame), fluxes 0 and 1: bit-equal to its plain twin
     ops/binning.bin_scatter_plain, five calls alike, the same in-frame
     tally and counters (one PyTorch call: the twin's masked
     index_put_);
  4. the whole bench CCD, cold and warm: render_ccd_pooled with the FFT
     branch (the 17 bright stars in one Fourier synthesis, with
     diffraction spikes at the full well), the sky and its noise, and the
     readout chain to (16, 2048, 576) raw amps; per stage the wall time
     (synchronized), peak device memory and launch counts (K1 = K2 = 6,
     K3 = 24 on the render; the FFT, sky and readout stages run plain
     PyTorch and launch none of the hand-written kernels), and gates
     (a)-(f) on the charge, the FFT field, the spikes, the FFT noise,
     the sky and the readout's bias; then the galaxy-bucket FFT path on
     the eight brightest galaxies, its noiseless stamps held to the same
     call on the CPU;
  5. the probes: the three on-chip probe paths at their own sizes
     (imsim_tpu_torch.benchmarks.probe_rows at 24 x 16,777,216,
     probe_pallas and probe_pallas2 on 4096^2 frames with k = 9), each
     of K4 and P1-P7 held against its plain twin, with launch counts,
     bounds and one-call yardsticks (K4: torch.cumsum; P1-P3: their
     twins' single call; P4-P7: one float32 conv2d each);
  6. the analytic-PSF bench CCD, cold and warm: the same catalog with
     pixel positions through render_ccd_pooled without optics (the FFT
     stars with spikes, render.shoot, the silicon displaced chunk by
     chunk: K1 = 6, K2 = 0, K3 = 24), the sky, the cosmic rays and the
     readout; gates (g) the charge, (h) one 1e7-photon star's <r^2>
     against the PSF table and its centroid, (i) the cosmic-ray charge;
  7. the flats on the full 4096 x 4004 frame: build_flat at the
     runner's defaults (80,000 e-/px in 80 iterations, K3 = 80) and
     with a zero BF kernel, build_flat_photons cut to 50 e-/px (8.2e8
     photons, K3 = 49); gates (j) mean and var/mean, (k) the photon
     flat's mean and var/mean;
  8. families and modes: (l) knots, streaks and FITS clouds through
     sample_intrinsic on the card with host draws, against the CPU; (m)
     one analytic bench batch accumulated in bf_mode 'photon' and
     'image' (K3 = 4 each), charge and stacked star <r^2>;
  9. state from the pointing: convert.build_ccd_state builds R22_S11 at
     the bench pointing with no exported data, gate (n) holds it leaf by
     leaf to the exported fixture (bit-equal, field angles within 1
     float32 ulp), with the host seconds of the build; then R10_S11
     (ITL, 4072 x 4000, the runner's vendor BF kernel), K3 held to its
     twin on that frame, and its bench catalog rendered from that state
     through the optics path cold and warm (FFT stars with spikes at
     ITL's 97,000 e- full well, sky, readout to ITL raw amps), gates
     (a)-(f), launches under `launches_by_path["itl_ccd"]`;
 10. the instance-catalog CCD through the runner's per-CCD path
     (imsim_tpu_torch.config.runner): the generated workload
     (benchmarks/instcat_workload.py: 120,000 object lines over R22_S11
     and 300 SEDs, written under chiprun_out/ and removed after), the
     visit context from the catalog's header and prepare_ccd (cull, SEDs
     and scene, field angles, silicon, sky level, spikes) with each host
     step's seconds, gate (o): the prep against the JAX package's digest
     (data/instcat_r22_s11_digest.npz); K1, K2 and K3 held to their
     plain twins at this path's shapes (batch 0 of the catalog's pooled
     plan, the CCD's optics over the band, the runner's silicon, the
     frame); render_one_ccd cold and warm
     (K1, K2, K3 and the FFT pass, sky with gradient and vignetting,
     cosmic rays, readout) with gates (a)-(f) tagged [instcat], launches
     under `launches_by_path["instcat_ccd"]`, and (p) the sky-only frame;
     then the y-band copy, its kernels checked the same way, rendered
     once with its fringe map, gate (q);
 11. a visit from YAML through the CLI, in process
     (imsim_tpu_torch.__main__.main; files under chiprun_out/visit/,
     removed after): the workload with 120,000 more lines over R10_S11
     (ITL), a user config on the instance-catalog template rendering
     R22_S11 and R10_S11 with the prefetch thread and one IO worker, OPD
     and truth outputs, the template's readout and cosmic rays; host
     seconds per prep step, render step, readout and file write, the
     RICE encode, the visit's wall against the sum of its steps, launches
     under `launches_by_path["visit_yaml"]`; gates (r) R22_S11's prep
     against gate (o)'s digest, (s) the files read back (eimage and
     RICE amps bit-equal, truth rows, OPD images and Zernike cards),
     (a)-(f) on both CCDs; the FEA visit (the example catalog with
     FEA_TERMS, doOpt, OPD and sag, a checkpoint a batch) run twice:
     (t) the resumed eimage bit-equal with K1-K3 launched 0 times, (u)
     the telescope and the OPD Zernikes against the JAX package's digest
     (data/fea_opd_digest.npz); examples/flat.yaml on the full frame,
     (v) the file round trip and the flat's statistics;
 12. the skyCatalogs CCD (files under chiprun_out/skycat_workload/,
     removed after): the generated workload
     (benchmarks/skycat_workload.py: a 120,000-row mapped-schema parquet
     catalog over R22_S11, a native yaml with healpix parquet files,
     synthetic '{vendor}' sensor models, RowData tables), gate (w): the
     files' hashes, the mapped catalog's prep against the JAX package's
     digest (data/skycat_r22_s11_digest.npz; gate (o)'s bars) and the
     native ObjectTable bit for bit; the mapped catalog's full-frame CCD
     through the CLI with image.sensor.sensor_model and one opsim_meta
     value through RowData (host seconds by step, launches under
     `launches_by_path["skycat_ccd"]`), (x) its BF kernel bit-equal to
     the JAX package's and K3 on its taps, K1 and K2 at its shapes,
     (a)-(f) [skycat], a warm render; the native catalog's CCD (host
     seconds by step with its inline SEDs, `skycat_native`, (a)-(f),
     K1-K3); (y) the example visit twice with input.atm_psf.save_file:
     the second makes no screens, loads the first's bit-equal, and its
     eimage is bit-equal (else held to the [visit] bars);
 13. phase 11's visit over several ranks (output.mesh, files under
     chiprun_out/visit/, removed after): (z) both CCDs in this process
     with output.mesh=1, a mesh of one on NCCL, its eimage, amp and truth
     files bit-equal to phase 11's (`mesh_visit`); (aa) two ranks sharing
     the card on gloo with {ccd: 2, phot: 1}, started as torchrun starts
     them (`--mesh-child`), files bit-equal to (z)'s (`mesh_ranks_ccd`);
     (ab) two ranks with {ccd: 1, phot: 2} on R22_S11, per-object
     realized within 1e-6 relative and the render before the sky within
     1e-6 of its max of a one-rank visit (sensor none), the charge within
     2% of (z)'s with the silicon on (`mesh_ranks_phot`); each run's
     launches, summed over its ranks, equal to its plan; (ac) the native
     tokenizer's table against the Python loop's on the visit's catalog;
 14. the kernel report (JSON, all twelve kernels, with bound_ms,
     bound_by, library_ms and the launches on every path) and, last, the
     ok line.

The script needs CUDA and refuses to run without it.  `run()` takes a
device and a size so the CPU tests can rehearse the same phases at a
tiny size with the kernels' plain twins.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()     # a phase-13 rank's wall counts from here

def log(*a):
    print(*a, flush=True)


def log_kernel(row: dict, note: str = "") -> None:
    """One [kernels] line: time, share of the bound, twin, one call."""
    lib = row["library_ms"]
    log(f"[kernels] {row['name']}: {row['ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({row['bound_ms'] / row['ms']:.1%} of it), plain twin "
        f"{row['plain_ms']:.3f} ms, one PyTorch call "
        + ("none" if lib is None else f"{lib:.4f} ms") + note)


def _import_port():
    """The port from this checkout (never an installed copy)."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import imsim_tpu_torch

    pkg = os.path.dirname(os.path.abspath(imsim_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "imsim_tpu_torch"):
        raise RuntimeError(f"imsim_tpu_torch imported from {pkg}, not from "
                           f"this checkout")
    return imsim_tpu_torch


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA device only")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)
    return name, count, smi


def phase_build():
    from imsim_tpu_torch.ops import _build

    t0 = time.time()
    _build.library()
    log(f"[build] kernels ready in {time.time() - t0:.1f} s "
        f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for line in _build.BUILD_INFO.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_kernels(device, state, host, cfg, ctx, small=False):
    """Each kernel against its plain twin on the same inputs, at the
    main path's shapes.  Returns the report rows (launches filled in
    later)."""
    import torch

    from imsim_tpu_torch.benchmarks._util import Timer

    timer = Timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    k1, field, nb, N = _k1_row(timer, host, cfg, device, repeat=True)
    rows = [k1, _k2_row(timer, gen, state.tel, ctx, state.silicon, field, N,
                        device, (552.0, 691.0))]
    del field
    rows.append(_k3_row(timer, gen, state.silicon, cfg.ysize, cfg.xsize,
                        device))
    rows.append(_k5_row(timer, gen, device, small))
    for row in rows:
        log_kernel(row)
    return rows, nb


def _k1_row(timer, host, cfg, device, tag="K1", repeat=False):
    """K1 against its plain twin at batch 0's slot layout of the scene's
    pooled plan: the report row (bar sqrt(objects in the batch) float32
    ulps of each column's scale), the scanned field angles (K2's input),
    the batch count and the batch's photon slots.  With `repeat`, gate
    (ad) on the same deltas."""
    import numpy as np
    import torch

    from imsim_tpu_torch.benchmarks._util import PX_RAD, bound
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.ops import scanrows

    modes = PP.classify_objects(host, cfg, PP.make_psf_mtf(cfg))
    cum, total, nb, N = PP.pooled_plan(host, modes, cfg)
    pair, share = cfg.pupil_pairing, cfg.screen_share
    pe = pair * share
    mp = N // pe
    cum_dev = torch.as_tensor(cum, device=device)
    mat = torch.cat([host.scene.params, host.scene.wl_cheb], dim=1)
    C = mat.shape[1]
    d = PP.slot_deltas(mat, cum_dev, 0, nb, N, pair, share)
    got = scanrows.scan_slot_prefix(d, pair, share)
    want = scanrows.scan_slot_prefix_plain(d, pair, share)
    timer.sync()
    obj_map = PP.build_obj_map(cum_dev, total, nb, N, pair, share)
    obj_idx, w = PP.batch_from_obj_map(obj_map, total, 0, nb, N, pair,
                                       share)
    alive = w > 0
    gather = mat[obj_idx.to(torch.int64)].T
    # f32 prefix-sum rounding: each output is a running sum over at most
    # one delta per object in the batch, so the gap between two scan
    # orders is bounded by about sqrt(objects) ulps of the column scale
    n_obj_b = int((PP._first_ordinals(cum_dev, 0, nb) < N).sum())
    gap = (got - want).reshape(C, N)[:, alive].abs().amax(dim=1).cpu()
    scale = want.reshape(C, N)[:, alive].abs().amax(dim=1).cpu().numpy()
    tol = np.sqrt(n_obj_b) * np.spacing(scale.astype(np.float32))
    vs_gather = (got.reshape(C, N)[:, alive] - gather[:, alive]).abs().amax(
        dim=1).cpu()
    log(f"[{tag}] (C, pe, mp) = ({C}, {pe}, {mp}), {n_obj_b} objects in "
        f"batch 0 of {nb}")
    log(f"[{tag}] kernel-vs-plain gap per column: "
        + " ".join(f"{g:.3g}" for g in gap.tolist()))
    log(f"[{tag}] field-angle gap vs direct gather mat[obj_idx]: "
        f"x {float(vs_gather[0]) / PX_RAD:.4g} px, "
        f"y {float(vs_gather[1]) / PX_RAD:.4g} px (reference budget 0.05)")
    bad = np.nonzero(gap.numpy() > tol)[0]
    if len(bad):
        raise AssertionError(f"{tag}: columns {bad.tolist()} exceed "
                             f"sqrt(n) ulp: {gap.numpy()[bad]} > {tol[bad]}")
    del want
    if repeat:
        _k1_repeats(d, pair, share, got, tag)
    # bound: one add per element, d read and the rows written once; no
    # single PyTorch call computes the slot-order scan
    row = dict(
        name="scan_slot_prefix", route="cuda",
        source="imsim_tpu_torch/csrc/scanrows.cu",
        replaces="imsim_tpu/ops/scanrows.py:183",
        max_abs_err=float(gap.max()),
        ms=timer.ms(lambda: scanrows.scan_slot_prefix(d, pair, share)),
        plain_ms=timer.ms(lambda: scanrows.scan_slot_prefix_plain(
            d, pair, share)),
        library_ms=None, **bound(d.numel(), 8 * d.numel()))
    field = (got.reshape(C, N)[0].contiguous(),
             got.reshape(C, N)[1].contiguous())
    return row, field, nb, N


def _k1_repeats(d, pair, share, first, tag):
    """Gate (ad): K1 repeats bit for bit.  Five calls on d and, on the
    card, one on a second stream, each torch.equal to `first` (the
    look-back folds its predecessors serially, so which tiles published
    first cannot change a bit)."""
    import torch

    from imsim_tpu_torch.ops import scanrows

    same = [torch.equal(scanrows.scan_slot_prefix(d, pair, share), first)
            for _ in range(5)]
    where = "five calls on the stream"
    if d.is_cuda:
        main = torch.cuda.current_stream(d.device)
        side = torch.cuda.Stream(device=d.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            other = scanrows.scan_slot_prefix(d, pair, share)
        main.wait_stream(side)
        same.append(torch.equal(other, first))
        del other
        where += " and one on a second stream"
    else:
        where += " (the CPU has no second stream)"
    log(f"[{tag}] (ad) K1 repeats bit for bit: {sum(same)} of {len(same)} "
        f"calls ({where}) equal to the first")
    _check(all(same), f"{tag}: (ad) K1 does not repeat bit for bit")


def _k2_row(timer, gen, tel, octx, silicon, field, N, device, wl,
            tag="K2"):
    """K2 against its plain twin, fused and plain forms, on N photons at
    the given field angles (K1's output), with uniform pupil positions,
    wavelengths over wl = (lo, hi) nm and times over 30 s: the report row
    (bars: raychain.gaps_ok)."""
    import numpy as np
    import torch

    from imsim_tpu_torch.benchmarks._util import bound
    from imsim_tpu_torch.ops import raychain

    u = lambda lo=0.0, hi=1.0: torch.rand(  # noqa: E731
        N, generator=gen, device=device) * (hi - lo) + lo
    r = torch.sqrt(u(2.558**2, 4.18**2))
    a = u(0.0, 2 * np.pi)
    args = (field[0], field[1], r * torch.cos(a), r * torch.sin(a),
            u(*wl), u(0.0, 30.0), torch.ones(N, device=device),
            torch.randn(N, generator=gen, device=device))
    draws = (u(1e-7, 1.0), torch.randn(N, generator=gen, device=device),
             torch.randn(N, generator=gen, device=device))

    def k2(fn, fused):
        kw = dict(silicon=silicon, si_draws=draws) if fused else {}
        return fn(tel, octx, *args, **kw)

    k2_err = 0.0
    for fused in (False, True):
        ref = k2(raychain.field_to_sensor_plain, fused)
        out = k2(raychain.field_to_sensor, fused)
        gaps = raychain.chain_gaps(ref, out, octx, *args[2:6], args[7])
        form = "fused" if fused else "plain"
        log(f"[{tag}] {form} form: {json.dumps(gaps)}")
        if not raychain.gaps_ok(gaps, fused):
            raise AssertionError(f"{tag}: {form} form disagrees with its "
                                 f"plain twin")
        k2_err = max(k2_err, gaps["dxy"])
        del ref, out
    # bound: chain_flops per photon (counted from csrc/raychain.cu) and
    # 11 float32 inputs read, 3 written per photon (the fused form
    # timed); no single PyTorch call computes the chain
    flops = raychain.chain_flops(raychain.chain_params(
        tel, octx, True, True, True, silicon))
    log(f"[{tag}] {flops} operations per photon (ops/raychain.chain_flops)")
    return dict(
        name="field_to_sensor", route="cuda",
        source="imsim_tpu_torch/csrc/raychain.cu",
        replaces="imsim_tpu/ops/raychain.py:158", max_abs_err=k2_err,
        ms=timer.ms(lambda: k2(raychain.field_to_sensor, True)),
        plain_ms=timer.ms(lambda: k2(raychain.field_to_sensor_plain, True),
                          reps=1),
        library_ms=None, **bound(flops * N, 4 * 14 * N))


def _k3_row(timer, gen, silicon, H, W, device, tag="K3"):
    """K3 against its plain twin on an (H, W) frame of random charge
    with the silicon's taps, and the one-call yardstick: the report
    row (bar 1e-5 of max |out|)."""
    import torch

    from imsim_tpu_torch.benchmarks._util import check_kernel, conv2d_fp32
    from imsim_tpu_torch.ops import stencil
    from imsim_tpu_torch.sensor.silicon import bf_taps

    img = torch.rand((H, W), generator=gen, device=device) * 1e5
    # the render's taps: host tensors, passed by value to the kernel
    dkx, dky = bf_taps(silicon)
    k = dkx.shape[0]
    # the yardstick: one float32 conv2d with both tap sets as channels
    wt = torch.stack([dkx, dky])[:, None].to(device)
    r3 = check_kernel(
        timer, lambda: stencil.stencil_pair(img, dkx, dky),
        lambda: stencil.stencil_pair_plain(img, dkx, dky), 1e-5,
        (4 * k * k * H * W, 12 * H * W),
        lambda: conv2d_fp32(img[None, None], wt, padding=k // 2)[0]
        .unbind(0))
    log(f"[{tag}] {H}x{W}, k={k}: max gap {r3['max_abs_err']:.3g} = "
        f"{r3['max_abs_err'] / r3['scale']:.3g} of max |out| (<= 1e-5); "
        f"conv2d (TF32 off) {r3['library_err'] / r3['scale']:.3g} of max "
        f"|out| (<= 1e-5)")
    if r3["within"] > 1.0:
        raise AssertionError(f"{tag}: K3 disagrees with its plain twin")
    return dict(
        name="stencil_pair", route="cuda",
        source="imsim_tpu_torch/csrc/stencil.cu",
        replaces="imsim_tpu/ops/stencil.py:71",
        **{key: r3[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")})


def _k5_case(timer, gen, frame, n, share, star, device, tag):
    """K5 (through sensor/simple.accumulate) against its plain twin,
    ops/binning.bin_scatter_plain, on n photons with fluxes of 0 and 1
    over `frame`, the first `share` of them off it, binned onto a charged
    base: the image bit-equal, five calls alike, the in-frame tally and
    the counters sensor.binned, .off_frame and .nonunit equal to the
    twin's.  Returns (photons, kernel ms, plain ms, index_put_ ms,
    bound)."""
    import torch

    from imsim_tpu_torch.benchmarks import accumulate_probe as AP
    from imsim_tpu_torch.benchmarks._util import bound
    from imsim_tpu_torch.ops import binning
    from imsim_tpu_torch.photons.batch import PhotonBatch
    from imsim_tpu_torch.sensor import simple
    from imsim_tpu_torch.utils import trace

    H, W = frame
    x, y, flux = AP._chunk(gen, n, frame, share, device, star)
    flux = (flux < 1.8).float()
    ph = PhotonBatch.zeros(n, device=device).replace(x=x, y=y, flux=flux)
    base = torch.rand(frame, generator=gen, device=device) * 1e3

    tally = {}
    trace.reset()
    trace.enable()
    try:
        got = simple.accumulate(ph, base.clone(), tally)
        c_got = {c["name"]: c["value"] for c in trace.counters()}
    finally:
        trace.disable()
        trace.reset()
    t_got = float(tally["in_frame"])
    stats = torch.zeros(3, dtype=torch.float64, device=device)
    want = base + binning.bin_scatter_plain(
        x, y, flux, torch.zeros(frame, device=device), stats)
    s = stats.tolist()
    t_want = s[0]
    c_want = {"sensor.binned": float(n), "sensor.off_frame": s[1],
              "sensor.nonunit": s[2]}
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    repeats = sum(torch.equal(simple.accumulate(ph, base.clone()), got)
                  for _ in range(5))
    log(f"[{tag}] {n} photons on {H}x{W}, {share:.0%} off the frame: "
        f"image {'bit-equal' if same else 'DIFFERS'} to the twin's, "
        f"{repeats} of 5 calls alike, in-frame {t_got} / {t_want}, "
        f"counters {c_got} / {c_want}")
    _check(same and repeats == 5, f"{tag}: K5 off its twin or not "
           f"repeating")
    _check(t_got == t_want and c_got == c_want
           and c_got["sensor.nonunit"] == 0,
           f"{tag}: K5's tally or counters off the twin's")
    del got, want
    scratch = torch.zeros(frame, device=device)
    fx, fy = torch.round(x), torch.round(y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    idx = fy[inb].to(torch.int64) * W + fx[inb].to(torch.int64)
    f = flux[inb]
    # bound: x, y and flux read once (12 B a photon); the adds land in
    # a frame near L2's size and are not counted
    return (timer.ms(lambda: binning.bin_scatter(x, y, flux, scratch),
                     reps=5),
            timer.ms(lambda: binning.bin_scatter_plain(x, y, flux, scratch)),
            timer.ms(lambda: scratch.view(-1).index_put_(
                (idx,), f, accumulate=True), reps=5),
            bound(0, 12 * n))


def _k5_row(timer, gen, device, small, tag="K5"):
    """K5 against its plain twin at the flat's sub-batch and at the sky
    chunk on the flat's 4004 x 4096 frame (the rehearsal: the same
    photons a pixel on 512 x 512): the report row, at the flat's
    sub-batch; the sky chunk's times logged."""
    from imsim_tpu_torch.benchmarks import accumulate_probe as AP

    frame = (512, 512) if small else AP.FRAME
    scale = frame[0] * frame[1] / (AP.FRAME[0] * AP.FRAME[1])
    sky = _k5_case(timer, gen, frame, round(AP.N_CHUNK * scale), 0.09,
                   True, device, f"{tag} sky chunk")
    log(f"[{tag}] sky chunk: {sky[0]:.4f} ms (bound {sky[3]['bound_ms']:.4f}"
        f" ms), plain twin {sky[1]:.3f} ms, index_put_ {sky[2]:.4f} ms")
    ms, plain_ms, lib_ms, b = _k5_case(
        timer, gen, frame, round(AP.N_FLAT * scale), 0.0, False, device,
        f"{tag} flat sub-batch")
    return dict(name="bin_scatter", route="cuda",
                source="imsim_tpu_torch/csrc/binning.cu",
                replaces="imsim_tpu/sensor/simple.py:33",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **b)


def _stage(timer, name, fn, expect):
    """Run one stage with the counts set to 0 just before it: (result,
    wall s, peak device memory GiB, launches); the launches must equal
    `expect` on the card (none on the CPU)."""
    import torch

    from imsim_tpu_torch.ops import _build

    if timer.cuda:
        torch.cuda.reset_peak_memory_stats()
    timer.sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    timer.sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = expect if timer.cuda else {k: 0 for k in expect}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if timer.cuda \
        else float("nan")
    return out, wall, peak, launches


# gate (b)'s floor; the JAX package's own gap at the bench's Npad (8192),
# field sum over summed realized - 1, is 1.128e-4 (tests/test_torch_fft.py
# run as a script, on the CPU): the bar is max(1e-3, 2 x that)
FFT_GAP_JAX = 1.128e-4
FFT_BAR = max(1e-3, 2 * FFT_GAP_JAX)


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _frame(eimage, state):
    """The eimage on the CCD's full frame: the rehearsal's 512 x 512
    window is read out in the corner of the CCD's full frame (the amp
    geometry is the vendor's)."""
    import torch

    if eimage.shape == (state.ny, state.nx):
        return eimage
    full = torch.zeros((state.ny, state.nx), device=eimage.device)
    full[:eimage.shape[0], :eimage.shape[1]] = eimage
    return full


def phase_ccd(device, state, host, cfg, ctx, nb, small: bool,
              tag: str = "ccd", buckets: bool = True,
              labels=("cold", "warm")):
    """The whole CCD cold then warm (render with the FFT branch and
    spikes, sky and noise, readout to the vendor's raw amps), its gates,
    and (`buckets`) the galaxy-bucket FFT path.  Log lines carry
    `[tag]`.  Returns the render's launch counts of the cold run and the
    stages' seconds."""
    from imsim_tpu_torch.benchmarks._util import Timer
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.ccd_render import add_sky_and_noise
    from imsim_tpu_torch.ops import _build
    from imsim_tpu_torch.psf.atmosphere import make_screens
    from imsim_tpu_torch.utils.rng import ATM_SEED_OFFSET, stream

    timer = Timer(device)
    ro = state.readout
    screens = make_screens(state.screen_spec, device,
                           gen=stream(42 + ATM_SEED_OFFSET, "screens",
                                      device=device))
    spikes, frac = _spikes(device, ro)
    none = {k: 0 for k in _build.LAUNCHES}
    expect = dict(none, scan_slot_prefix=nb, field_to_sensor=nb,
                  stencil_pair=nb * cfg.nsub, bin_scatter=nb * cfg.nsub)
    grad = (0.0, 0.0, 1.0)
    result = {}
    gates_fft = None
    for label in labels:
        tally = {}
        (image, modes, realized), t_r, m_r, l_r = _stage(
            timer, "render", lambda: PP.render_ccd_pooled(
                0, host, cfg, state.silicon, state.tel, ctx, screens,
                state.sk_table, profiles=state.profiles, spikes=spikes,
                tally=tally), expect)
        eimage, t_s, m_s, _ = _stage(
            timer, "sky", lambda: add_sky_and_noise(
                stream(0, "sky", device=device), image, state.sky_level,
                grad, state.vig_coarse, cfg.pixel_scale,
                vig_step=state.vig_step), none)
        raw, t_o, m_o, _ = _stage(
            timer, "readout", lambda: ro.chain(
                stream(0, "readout", device=device), _frame(eimage, state),
                cfg.exptime), none)
        log(f"[{tag}] {label}: render {t_r:.3f} s ({m_r:.2f} GiB peak, "
            f"launches {l_r}), sky {t_s:.3f} s ({m_s:.2f} GiB), readout "
            f"{t_o:.3f} s ({m_o:.2f} GiB); whole CCD {t_r + t_s + t_o:.3f} s")
        n_fft = int((modes == PP.FFT).sum())
        _check((n_fft > 0) if small
               else n_fft == int((state.modes == PP.FFT).sum()),
               f"{n_fft} FFT-mode objects")
        if label == "cold":
            result = dict(launches=l_r, wall_cold=t_r + t_s + t_o)
        else:
            result.update(wall_warm=t_r + t_s + t_o, render=t_r, sky=t_s,
                          readout=t_o)
        gates_fft = _ccd_gates(
            device, tag, label, host, cfg, spikes, frac, image, eimage, raw,
            modes, tally, (state.sky_level, grad, state.vig_coarse,
                           state.vig_step, None), ro, gates_fft)
        del image, eimage, raw

    if buckets:
        _galaxy_buckets(device, host, cfg, spikes, 2 if small else 8)
    return result


def _ccd_gates(device, tag, label, host, cfg, spikes, frac, image, eimage,
               raw, modes, tally, sky, ro, gates_fft=None, masked=None,
               landed_min: float = 0.8, vign=None):
    """Gates (a)-(f) on one rendered CCD: (a) the pooled charge, (b)-(c)
    the FFT field and its spikes (computed once, when gates_fft is None),
    (d) the FFT noise, (e) the sky's mean and variance over the frame
    (less the `masked` flat pixel indices: the cosmic rays' hits), (f)
    the raw amps' prescan at the bias.  sky: (level, gradient, coarse
    vignetting, its step, fringe or None); landed_min: (a)'s floor on
    the landed fraction; vign: the FFT stamps' vignetting factors.  (b)-
    (d) need FFT objects.  Returns gates_fft."""
    import numpy as np
    import torch

    from imsim_tpu_torch.electronics.camera import VENDOR_SPECS
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.ccd_render import sky_expectation

    H, W = cfg.ysize, cfg.xsize
    spec = VENDOR_SPECS[ro.vendor]
    n_fft = int((modes == PP.FFT).sum())
    # (a) the pooled charge: the image less the FFT pass's charge is the
    # pooled flux binned in frame
    fft_sum = float(tally["fft"])
    pooled_img = float(image.sum(dtype=torch.float64)) - fft_sum
    in_frame = float(tally["in_frame"])
    pooled = float(tally["pooled"])
    rel = abs(pooled_img - in_frame) / max(in_frame, 1.0)
    landed = in_frame / pooled
    log(f"[{tag}] {label} (a): {n_fft} FFT objects; pooled photons "
        f"{pooled:.0f}, in-frame flux {in_frame:.1f}, image sum less "
        f"the FFT charge {pooled_img:.1f} (rel gap {rel:.3g} <= 1e-4), "
        f"landed fraction {landed:.6f} (> {landed_min:.3g})")
    _check(rel <= 1e-4 and landed > landed_min,
           "charge accounting or landed fraction out of bounds")
    if n_fft == 0:
        log(f"[{tag}] {label} (b)-(d): no FFT objects")
    else:
        if gates_fft is None:
            gates_fft = _fft_gates(device, host, modes, cfg, spikes, frac,
                                   tag, vign)
        # (d) the FFT noise: the added charge about the spiked field
        vis_sum = gates_fft["spiked_sum"]
        log(f"[{tag}] {label} (d): FFT charge added {fft_sum:.1f}, spiked "
            f"noiseless field {vis_sum:.1f}: gap {fft_sum - vis_sum:.1f} "
            f"(<= 5 sqrt = {5 * np.sqrt(vis_sum):.1f})")
        _check(abs(fft_sum - vis_sum) <= 5 * np.sqrt(vis_sum),
               "FFT noise out of bounds")

    # (e) the sky: the mean added charge and the residual's variance
    level, grad, vig, vig_step, fringe = sky
    sky_map = sky_expectation((H, W), level, grad, vig, cfg.pixel_scale,
                              vig_step, fringe, device=device)
    res = (eimage - image - sky_map).double().reshape(-1)
    if masked is not None and len(masked):
        keep = torch.ones(res.numel(), dtype=torch.bool, device=device)
        keep[torch.as_tensor(masked, device=device)] = False
        res = res[keep]
    n_pix = res.numel()
    sky_mean = float(sky_map.mean(dtype=torch.float64))
    res_mean = float(res.mean())
    res_var = float(res.var())
    want_var = sky_mean + 1.0 / 12
    log(f"[{tag}] {label} (e): sky map mean {sky_mean:.3f} e-/px; added "
        f"minus map {res_mean:.4f} (<= 5 sigma = "
        f"{5 * np.sqrt(want_var / n_pix):.4f}); residual variance "
        f"{res_var:.3f} vs map mean + 1/12 = {want_var:.3f} "
        f"(rel {res_var / want_var - 1:.4f}, bar 0.02)")
    _check(abs(res_mean) <= 5 * np.sqrt(want_var / n_pix)
           and abs(res_var / want_var - 1) <= 0.02,
           "sky noise out of bounds")
    del res, sky_map

    # (f) the readout: finite raw amps; prescan medians at the bias
    pre = raw[:, :spec["amp_ny"], :spec["prescan"]].reshape(
        raw.shape[0], -1).float()
    med = pre.median(dim=1).values.cpu().numpy()
    gap = np.abs(med - ro.bias_levels.cpu().numpy())
    log(f"[{tag}] {label} (f): {ro.vendor} raw amps {tuple(raw.shape)}, "
        f"prescan median - bias: max {gap.max():.3f} ADU (<= 0.5)")
    _check(tuple(raw.shape) == (16, 2048, 576)
           and bool(torch.isfinite(raw.float()).all()) and gap.max() <= 0.5,
           "raw amps not finite, of the wrong shape or off their bias")
    return gates_fft


def _spikes(device, ro):
    """The bench's spike overlay: the 513-px kernel (calibrated on the
    device) at the full well.  Returns (spikes, spike fraction)."""
    from imsim_tpu_torch.image.diffraction_fft import spike_kernel

    t0 = time.perf_counter()
    kern = spike_kernel(622.0, 0.2, alpha_deg=45.0, rot_smear_deg=0.1,
                        device=device)
    frac = 1.0 - float(kern[kern.shape[0] // 2, kern.shape[1] // 2])
    log(f"[spikes] kernel {kern.shape[0]}x{kern.shape[1]}, calibrated "
        f"spike fraction {frac:.5f} ({time.perf_counter() - t0:.2f} s), "
        f"saturation at the full well {ro.full_well:.0f} e-")
    return dict(kernel=kern, sat=ro.full_well), frac


def _fft_gates(device, host, modes, cfg, spikes, frac, tag="ccd",
               vign=None):
    """Gates (b) and (c) on the star field's noiseless synthesis with the
    render's inputs (vign: the FFT stamps' vignetting factors); returns
    the spiked field's sum for gate (d)."""
    import torch

    from imsim_tpu_torch.image import fft_render as F
    from imsim_tpu_torch.image import photon_pooling as PP

    H, W = cfg.ysize, cfg.xsize
    psf = PP.make_psf_mtf(cfg)
    stars, _ = PP.fft_plan(host, modes, cfg, psf, spikes, vign)
    a = stars.args(device)
    field, realized = F.star_frame(*a[:5], stars.Npad, H, W, stars.pad,
                                   cfg.pixel_scale)
    p, m = stars.pad, stars.margin
    vis0 = float(field[p:p + H, p:p + W].sum(dtype=torch.float64))
    real = float(realized.sum(dtype=torch.float64))
    rel = vis0 / real - 1.0
    log(f"[{tag}] (b): {len(stars.ids)} stars, Npad {stars.Npad}, pad {p}; "
        f"noiseless field without spikes {vis0:.1f} vs sum realized "
        f"{real:.1f}: rel gap {rel:.4g} (bar {FFT_BAR:g}: max(1e-3, 2 x the "
        f"JAX package's {FFT_GAP_JAX:g}))")
    _check(abs(rel) <= FFT_BAR, "FFT field vs realized out of bounds")
    ext = field[p - m:p + H + m, p - m:p + W + m]
    excess = float(torch.clamp(ext - stars.sat, min=0.0).sum(
        dtype=torch.float64))
    spiked = F.spike_crop(field, stars.kernel, stars.sat, H, W, p, m)
    sp_sum = float(spiked.sum(dtype=torch.float64))
    bar = frac * excess * (1 + 1e-5)
    log(f"[{tag}] (c): saturation excess {excess:.1f} e-; spikes change the "
        f"field's sum by {sp_sum - vis0:.1f} (<= spike fraction x excess "
        f"{frac * excess:.1f}, +1e-5 for the FFT pair's rounding)")
    _check(abs(sp_sum - vis0) <= bar, "spike overlay out of bounds")
    return dict(spiked_sum=sp_sum)


def _galaxy_buckets(device, host, cfg, spikes, n_gal: int):
    """_fft_pass with force_fft on the n_gal brightest Sersic or knot
    objects: the galaxy-bucket path (render_fft_stamps, a batched
    apply_spikes, add_stamps) on the card, its noiseless stamps held to
    the same call on the CPU to 1e-5 of max |stamp|."""
    import dataclasses

    import numpy as np
    import torch

    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.render import KNOTS, SERSIC
    from imsim_tpu_torch.image.scene import COL_TYPE

    n = host.n_objects
    t = host.scene.params[:n, COL_TYPE].cpu().numpy()
    gal = np.nonzero((t == SERSIC) | (t == KNOTS))[0]
    ids = gal[np.argsort(host.flux[gal])[::-1][:n_gal]]
    modes = np.full(n, PP.PHOT, np.int8)
    modes[ids] = PP.FFT
    cfg = dataclasses.replace(cfg, force_fft=True)
    psf = PP.make_psf_mtf(cfg)
    img, realized = PP._fft_pass(
        torch.zeros((cfg.ysize, cfg.xsize), device=device), host, modes,
        cfg, psf, 0, spikes=spikes)
    _, buckets = PP.fft_plan(host, modes, cfg, psf, spikes)
    worst = 0.0
    for b in buckets:
        got = PP.galaxy_stamps(b, psf, cfg, spikes, device).cpu()
        want = PP.galaxy_stamps(b, psf, cfg, spikes, "cpu")
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
    total = float(img.sum(dtype=torch.float64))
    log(f"[ccd] galaxy buckets: {len(ids)} galaxies (flux "
        f"{host.flux[ids].min():.0f}-{host.flux[ids].max():.0f}) in "
        f"{len(buckets)} buckets {[(b.N, b.n_s, len(b.ids)) for b in buckets]}"
        f"; stamps vs the CPU call: {worst:.3g} of max |stamp| (<= 1e-5); "
        f"image sum {total:.1f}, realized {realized.sum().item():.1f}")
    _check(worst <= 1e-5 and np.isfinite(total) and total > 0,
           "galaxy-bucket stamps disagree with the CPU call")


# the probes' kernels: report name, CUDA source, TPU kernel replaced
PROBE_KERNELS = (
    ("scan_lanes", "imsim_tpu_torch/csrc/scanrows.cu",
     "imsim_tpu/ops/scanrows.py:104"),
    ("probe_p1", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas.py:51"),
    ("probe_p2", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas.py:76"),
    ("probe_p3", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas.py:102"),
    ("probe_p4", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas.py:136"),
    ("probe_p5", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas.py:175"),
    ("probe_mk", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas2.py:45"),
    ("probe_mk2", "imsim_tpu_torch/csrc/probes.cu",
     "benchmarks/probe_pallas2.py:157"),
)


def phase_probes(device, small: bool):
    """The three probe paths, counts set to 0 just before and read just
    after.  Each probe holds its kernels against their plain twins (K4:
    sqrt(n_obj) ulps of each row's scale; P1-P3 and the one-tap bodies
    bitwise; the stencils 1e-5 of max |out|); the bars are checked here.
    Returns the report rows of K4 and P1-P7 and the phase's launches."""
    from imsim_tpu_torch.benchmarks import (probe_pallas, probe_pallas2,
                                            probe_rows)
    from imsim_tpu_torch.benchmarks._util import Timer
    from imsim_tpu_torch.ops import _build

    def plog(line):
        log(f"[probes] {line}")

    rows_kw = dict(n=65_536, n_obj=512) if small else {}
    frame_kw = dict(h=256, w=256) if small else {}
    timer = Timer(device)
    timer.sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    rep_rows = probe_rows.main(device, log=plog, **rows_kw)
    rep_p = probe_pallas.main(device, log=plog, **frame_kw)
    rep_p2 = probe_pallas2.main(device, log=plog, **frame_kw)
    timer.sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[probes] {wall:.1f} s wall, launches {launches}")
    names = [name for name, _, _ in PROBE_KERNELS]
    if timer.cuda:
        idle = [k for k in names if launches[k] == 0]
        if idle or launches["field_to_sensor"] or launches["stencil_pair"]:
            raise AssertionError(f"probe launch counts {launches}: "
                                 f"{idle} never launched")
    elif any(launches.values()):
        raise AssertionError(f"CPU run launched kernels: {launches}")
    found = {**rep_rows["kernels"], **rep_p["kernels"], **rep_p2["kernels"]}
    bad = {k: found[k]["within"] for k in names
           if not found[k]["within"] <= 1.0}
    if bad:
        raise AssertionError(f"kernels past their bar (gap / bar): {bad}")
    rows = rep_rows["rows"]
    xla = rep_p["p5_vs_shifted_slices"]
    # a wrong scatter or layout moves rows by O(1); f32 rounding of the
    # prefix sum stays near sqrt(n_obj) ulps of the parameters' scale
    if not rows["max_abs_err"] <= 1e-3 * rows["scale"]:
        raise AssertionError(f"K4 rows vs the direct gather: {rows}")
    if not xla["max_abs_err"] <= 1e-5 * xla["scale"]:
        raise AssertionError(f"P5 vs the shifted-slice sum: {xla}")
    report = []
    for name, source, replaces in PROBE_KERNELS:
        r = found[name]
        report.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}))
        log_kernel(report[-1], f", slowest body {r['slowest']}"
                   if "slowest" in r else "")
    # the row above reports only P6's slowest body; its one-tap bodies go
    # through the vector copy kernel, as P2 and P3 do, and c and d through
    # the row and column pattern kernels
    bodies = found["probe_mk"]["bodies"]
    for label, names in (("one-tap bodies", ("a", "b")),
                         ("row and column bodies", ("c", "d"))):
        log(f"[kernels] probe_mk {label}: " + ", ".join(
            f"{b} {bodies[b]['ms']:.4f} ms (bound {bodies[b]['bound_ms']:.4f}"
            f" ms by {bodies[b]['bound_by']}, plain twin "
            f"{bodies[b]['plain_ms']:.4f} ms)" for b in names))
    return report, launches


# ---- phase 6: the analytic-PSF bench CCD ----------------------------------

def _table_r2(tab) -> float:
    """E[r^2] of the piecewise-linear inverse CDF r(u) on [0, 1] (the
    table's own interpolation), in float64."""
    y = tab.y.double().cpu().numpy()
    a, b = y[:-1], y[1:]
    return float(((a * a + a * b + b * b) / 3.0).sum() / (len(y) - 1))


def phase_analytic(device, small: bool):
    """The bench catalog through the analytic PSF, cold then warm: the
    FFT pass with spikes, the pooled photons through render.shoot with
    the silicon displaced per chunk (K1 per batch, K3 per chunk), the
    sky, the cosmic rays and the readout.  Gates (g) charge, (h) the PSF
    of one 1e7-photon star, (i) the cosmic-ray charge.  Returns the
    render's launch counts."""
    import numpy as np
    import torch

    from imsim_tpu_torch.benchmarks._util import Timer, analytic_workload
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.ccd_render import add_sky_and_noise
    from imsim_tpu_torch.image.cosmic_rays import (CR_RATE_DEFAULT,
                                                   cosmic_ray_hits,
                                                   paint_cosmic_rays)
    from imsim_tpu_torch.ops import _build
    from imsim_tpu_torch.utils.rng import stream

    timer = Timer(device)
    state, host, cfg = analytic_workload(device, small)
    ro = state.readout
    spikes, _ = _spikes(device, ro)
    _, _, nb, _ = PP.pooled_plan(host, PP.classify_objects(
        host, cfg, PP.make_psf_mtf(cfg)), cfg)
    none = {k: 0 for k in _build.LAUNCHES}
    expect = dict(none, scan_slot_prefix=nb, stencil_pair=nb * cfg.nsub,
                  bin_scatter=nb * cfg.nsub)
    result = {}
    # the rehearsal runs it once: the CPU's readout takes seconds
    for label in ("cold",) if small else ("cold", "warm"):
        tally = {}
        (image, modes, _), t_r, m_r, l_r = _stage(
            timer, "analytic render", lambda: PP.render_ccd_pooled(
                0, host, cfg, state.silicon, profiles=state.profiles,
                spikes=spikes, tally=tally), expect)
        # (g) the pooled charge, as gate (a)
        fft_sum = float(tally["fft"])
        pooled_img = float(image.sum(dtype=torch.float64)) - fft_sum
        in_frame = float(tally["in_frame"])
        rel = abs(pooled_img - in_frame) / max(in_frame, 1.0)
        landed = in_frame / float(tally["pooled"])
        n_fft = int((modes == PP.FFT).sum())
        log(f"[analytic] {label} (g): {n_fft} FFT objects, FFT charge "
            f"{fft_sum:.1f}; pooled photons {float(tally['pooled']):.0f}, "
            f"in-frame flux {in_frame:.1f}, image sum less the FFT charge "
            f"{pooled_img:.1f} (rel gap {rel:.3g} <= 1e-4), landed fraction "
            f"{landed:.6f} (> 0.8)")
        _check(rel <= 1e-4 and landed > 0.8 and n_fft > 0,
               "analytic charge accounting out of bounds")
        eimage, t_s, _, _ = _stage(
            timer, "sky", lambda: add_sky_and_noise(
                stream(0, "sky", device=device), image, state.sky_level,
                (0.0, 0.0, 1.0), state.vig_coarse, cfg.pixel_scale,
                vig_step=state.vig_step), none)
        del image
        before = float(eimage.sum(dtype=torch.float64))
        eimage, t_c, _, _ = _stage(
            timer, "cosmic rays", lambda: paint_cosmic_rays(
                eimage, cfg.exptime, 189, ccd_rate=CR_RATE_DEFAULT), none)
        # (i) the painted charge against the hits' in-frame sum
        pix, charge = cosmic_ray_hits(eimage.shape, cfg.exptime, 189,
                                      ccd_rate=CR_RATE_DEFAULT)
        painted = float(eimage.sum(dtype=torch.float64)) - before
        want = float(charge.sum())
        log(f"[analytic] {label} (i): {len(pix)} CR pixel hits, painted "
            f"{painted:.3f} e- against the host's {want:.3f} (rel gap "
            f"{abs(painted - want) / want:.3g} <= 1e-6)")
        _check(len(pix) > 0 and abs(painted - want) <= 1e-6 * want,
               "cosmic-ray charge out of bounds")
        raw, t_o, m_o, _ = _stage(
            timer, "readout", lambda: ro.chain(
                stream(0, "readout", device=device), _frame(eimage, state),
                cfg.exptime), none)
        _check(tuple(raw.shape) == (16, 2048, 576)
               and bool(torch.isfinite(raw).all()),
               "analytic raw amps not finite or of the wrong shape")
        whole = t_r + t_s + t_c + t_o
        log(f"[analytic] {label}: render {t_r:.3f} s ({m_r:.2f} GiB peak, "
            f"launches {l_r}), sky {t_s:.4f} s, cosmic rays {t_c:.4f} s, "
            f"readout {t_o:.3f} s ({m_o:.2f} GiB); whole CCD {whole:.3f} s")
        result[label] = dict(launches=l_r, render=t_r, sky=t_s, cr=t_c,
                             readout=t_o, whole=whole)
        del eimage, raw
    _psf_gate(device, state, cfg, small)
    return result


def _psf_gate(device, state, cfg, small):
    """(h): one star of 1e7 photons (1e5 in the rehearsal) through
    render.shoot: its mean r^2 [arcsec^2] against the Kolmogorov table's
    E[r^2] plus 2 sigma_g^2, within 5 of its standard errors; its
    centroid within 0.02 px of the star."""
    import numpy as np
    import torch

    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.render import POINT, shoot
    from imsim_tpu_torch.image.scene import DeviceScene
    from imsim_tpu_torch.utils.rng import stream

    n = 100_000 if small else 10_000_000
    x0, y0 = 2048.3, 2002.7
    cols = [np.array([v, 0.0], np.float32) for v in
            (x0, y0, POINT, 0.5, 1.0, 1.0, 0.0, 0.0, 0.0, 1.0)]
    scene = DeviceScene.from_columns(
        *cols, wl_icdf=np.full((2, 96), 620.0, np.float32), device=device)
    tabs = PP.analytic_psf_tables(cfg.fwhm, cfg.gauss_fwhm, device)
    ph = shoot(stream(7, "psf", device=device), scene,
               torch.zeros(n, dtype=torch.int64, device=device),
               torch.ones(n, device=device), tabs, state.profiles,
               pixel_scale=cfg.pixel_scale, families=(POINT,))
    dx = ph.x.double() - float(np.float32(x0))
    dy = ph.y.double() - float(np.float32(y0))
    r2 = (dx * dx + dy * dy) * cfg.pixel_scale ** 2
    mean, se = float(r2.mean()), float(r2.std()) / np.sqrt(n)
    want = _table_r2(tabs["kolmogorov"]) + 2 * tabs["gauss_sigma"] ** 2
    cx, cy = float(dx.mean()), float(dy.mean())
    log(f"[analytic] (h): {n} photons, mean r^2 {mean:.5f} arcsec^2 against "
        f"the table's {want:.5f} (gap {(mean - want) / se:.2f} standard "
        f"errors of {se:.2g}, bar 5); centroid ({cx:+.4f}, {cy:+.4f}) px "
        f"(bar 0.02)")
    _check(abs(mean - want) <= 5 * se and abs(cx) <= 0.02
           and abs(cy) <= 0.02, "analytic PSF second moment or centroid off")


# ---- phase 7: flats at full frame -----------------------------------------

def phase_flats(device, state, small: bool):
    """build_flat at the runner's defaults (80 K3 launches on 4096 x
    4004) and with a zero BF kernel; build_flat_photons at the cut
    (one K3 launch per 16.7M-photon sub-batch).  Gates (j), (k).
    Returns the launches of the flat and the photon flat."""
    import dataclasses

    import numpy as np

    from imsim_tpu_torch.benchmarks._util import Timer, flat_workload
    from imsim_tpu_torch.image import flat as FL
    from imsim_tpu_torch.ops import _build
    from imsim_tpu_torch.sensor.silicon import absorption_length_table

    timer = Timer(device)
    none = {k: 0 for k in _build.LAUNCHES}
    cfg, pcfg, wl = flat_workload(small)
    n_iter = FL.n_iterations(cfg)
    flat, t_f, m_f, l_f = _stage(
        timer, "flat", lambda: FL.build_flat(1, cfg, state.silicon, device),
        dict(none, stencil_pair=n_iter))
    st = FL.flat_statistics(flat)
    del flat
    no_bf = dataclasses.replace(
        state.silicon, bf_kernel=np.zeros_like(state.silicon.bf_kernel))
    flat0, t_0, _, _ = _stage(
        timer, "flat without BF", lambda: FL.build_flat(1, cfg, no_bf,
                                                        device),
        dict(none, stencil_pair=n_iter))
    st0 = FL.flat_statistics(flat0)
    del flat0
    log(f"[flats] flat {cfg.ysize}x{cfg.xsize}, {cfg.counts_per_pixel:.0f} "
        f"e-/px in {n_iter} iterations: {t_f:.3f} s ({m_f:.2f} GiB peak, "
        f"launches {l_f}); without BF {t_0:.3f} s")
    log(f"[flats] (j): mean {st['mean']:.2f} (rel gap "
        f"{st['mean'] / cfg.counts_per_pixel - 1:+.5f}, bar 0.005), var/mean "
        f"{st['var_over_mean']:.4f} (< 0.97); without BF var/mean "
        f"{st0['var_over_mean']:.4f} (|. - 1| < 0.03)")
    _check(abs(st["mean"] / cfg.counts_per_pixel - 1) <= 0.005
           and st["var_over_mean"] < 0.97
           and abs(st0["var_over_mean"] - 1) < 0.03, "flat PTC out of bounds")

    n_it, n_sub, per = FL.photon_flat_plan(pcfg)
    pflat, t_p, m_p, l_p = _stage(
        timer, "photon flat", lambda: FL.build_flat_photons(
            2, pcfg, wl, state.silicon, device),
        dict(none, stencil_pair=n_it * n_sub, bin_scatter=n_it * n_sub))
    sp = FL.flat_statistics(pflat)
    del pflat
    # the expectation: every photon that converts inside the device
    abs_t = absorption_length_table()
    labs = np.interp(wl, abs_t.x0 + np.arange(len(abs_t.y)) * abs_t.dx,
                     abs_t.y)
    u = (np.arange(4096) + 0.5) / 4096
    keep = 1.0 - np.exp(-state.silicon.thickness_um
                        / np.interp(u, np.linspace(0, 1, len(labs)), labs))
    want = pcfg.counts_per_pixel * float(keep.mean())
    log(f"[flats] photon flat {pcfg.ysize}x{pcfg.xsize}: {n_it * n_sub * per}"
        f" photons in {n_it} x {n_sub} sub-batches of {per}: {t_p:.3f} s "
        f"({m_p:.2f} GiB peak, launches {l_p})")
    log(f"[flats] (k): mean {sp['mean']:.4f} against {want:.4f} (rel gap "
        f"{sp['mean'] / want - 1:+.5f}, bar 0.015), var/mean "
        f"{sp['var_over_mean']:.4f} (|. - 1| < 0.06)")
    _check(abs(sp["mean"] / want - 1) <= 0.015
           and abs(sp["var_over_mean"] - 1) < 0.06,
           "photon flat out of bounds")
    return dict(flat=l_f, photon_flat=l_p, flat_s=t_f, photon_flat_s=t_p)


# ---- phase 8: object families and silicon modes ---------------------------

def phase_modes(device, state, small: bool):
    """(l) streak, FITS-cloud and knot objects through sample_intrinsic
    on the device with host uniforms, against the CPU; (m) one analytic
    bench batch accumulated with bf_mode 'photon' and 'image' (K3 once
    per chunk in each).  Returns the launches of (m)."""
    import numpy as np
    import torch

    from imsim_tpu_torch.benchmarks._util import Timer, analytic_workload
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image import render as R
    from imsim_tpu_torch.image.scene import DeviceScene
    from imsim_tpu_torch.ops import _build
    from imsim_tpu_torch.sensor.silicon import (accumulate_silicon,
                                                tree_ring_field)
    from imsim_tpu_torch.utils.rng import stream

    # (l)
    rng = np.random.default_rng(8)
    n_obj, n = 48, (65_536 if small else 1 << 20)
    t = np.resize(np.array([R.KNOTS, R.STREAK, R.FITSIMAGE], np.float32),
                  n_obj)
    p2 = rng.uniform(0.3, 1.0, n_obj)
    p2[t == R.FITSIMAGE] = rng.integers(1, 4, int((t == R.FITSIMAGE).sum()))
    p0 = np.where(t == R.STREAK, rng.uniform(5, 40, n_obj),
                  rng.uniform(0.2, 1.5, n_obj))
    cols = [rng.uniform(50, 450, n_obj), rng.uniform(50, 450, n_obj), t, p0,
            np.where(t == R.KNOTS, 25.0, rng.uniform(0.5, 4, n_obj)), p2,
            rng.uniform(0, np.pi, n_obj), rng.normal(0, 0.03, n_obj),
            rng.normal(0, 0.03, n_obj), 1 + rng.normal(0, 0.03, n_obj)]
    cloud = np.concatenate([np.zeros((1, 1024, 2)),
                            rng.normal(0, 0.8, (3, 1024, 2))])
    wl = np.full((n_obj, 96), 620.0, np.float32)
    obj = rng.integers(0, n_obj, n)
    fam = (R.KNOTS, R.STREAK, R.FITSIMAGE)
    draws = R.intrinsic_draws(torch.Generator().manual_seed(9), n, fam)
    out = {}
    for dev in (device, torch.device("cpu")):
        sc = DeviceScene.from_columns(*cols, wl_icdf=wl, aux_cloud=cloud,
                                      device=dev)
        o = torch.as_tensor(obj, device=dev)
        out[dev.type] = [a.cpu() for a in R.sample_intrinsic(
            None, sc.params[o].T, o, state.profiles, fam, 0.2, sc.aux_cloud,
            {k: v.to(dev) for k, v in draws.items()})]
    scale = max(float(a.abs().max()) for a in out["cpu"])
    gap = max(float((a - b).abs().max())
              for a, b in zip(out[device.type], out["cpu"]))
    log(f"[modes] (l): {n} photons of knots, streaks and FITS clouds; "
        f"device vs CPU {gap / scale:.3g} of max |offset| {scale:.3g} px "
        f"(<= 1e-5)")
    _check(gap <= 1e-5 * scale, "sample_intrinsic disagrees with the CPU")

    # (m)
    _, host, cfg = analytic_workload(device, small)
    modes = PP.classify_objects(host, cfg, PP.make_psf_mtf(cfg))
    cum, total, nb, N = PP.pooled_plan(host, modes, cfg)
    pair, share = cfg.pupil_pairing, cfg.screen_share
    cum_dev = torch.as_tensor(cum, device=device)
    obj_map = PP.build_obj_map(cum_dev, total, nb, N, pair, share)
    obj_idx, weight = PP.batch_from_obj_map(obj_map, total, 0, nb, N, pair,
                                            share)
    del obj_map
    families = tuple(sorted(set(host.scene.params[:host.n_objects, 2].to(
        torch.int64).tolist())))
    mat = torch.cat([host.scene.params, host.scene.wl_cheb], dim=1)
    photons = R.shoot(stream(0, "photons", 0, device=device), host.scene,
                      obj_idx, weight,
                      PP.analytic_psf_tables(cfg.fwhm, cfg.gauss_fwhm, device),
                      state.profiles, exptime=cfg.exptime,
                      pixel_scale=cfg.pixel_scale,
                      row=PP.materialize_rows_T(mat, cum_dev, 0, nb, N, pair,
                                                share), families=families)
    del mat
    tr = tree_ring_field(state.silicon, (cfg.ysize, cfg.xsize), device)
    none = {k: 0 for k in _build.LAUNCHES}
    timer = Timer(device)
    imgs, launches = {}, {}
    for mode in ("photon", "image"):
        zero = torch.zeros((cfg.ysize, cfg.xsize), device=device)
        imgs[mode], t_m, _, launches[mode] = _stage(
            timer, f"bf_mode {mode}", lambda: accumulate_silicon(
                photons, zero, state.silicon, nsub=cfg.nsub, tr_field=tr,
                bf_mode=mode, gen=stream(0, "si", 0, device=device)),
            dict(none, stencil_pair=cfg.nsub, bin_scatter=cfg.nsub))
        log(f"[modes] (m) bf_mode {mode}: {t_m:.3f} s, launches "
            f"{launches[mode]}")
    charge = {k: float(v.sum(dtype=torch.float64)) for k, v in imgs.items()}
    rel = abs(charge["photon"] / charge["image"] - 1)
    m2, n_star = _stacked_moments(imgs, host, modes, cfg, weight, obj_idx,
                                  200 if small else 2000)
    m_rel = m2["photon"] / m2["image"] - 1
    # the bar: the modes bin the same photons with the same draws and
    # differ in how the displacement d moves charge: per photon (the
    # rings' exact sinusoids, BF at the nearest pixel) or by the first-
    # order continuity update of the binned charge (the rings folded as
    # the bilinear stride-6 field).  A star's <r^2> moves by ~2 |grad d|;
    # the rings' gradient bounds what the two can disagree on through
    # the rings; the BF field comes from the same charge in both, so
    # the formulations part at second order in |d|: 1e-3 for it (4e-5
    # on the rehearsal's scene with the rings off)
    grad = max(float((tr[0][:, 2:] - tr[0][:, :-2]).abs().max()),
               float((tr[1][2:] - tr[1][:-2]).abs().max())) / 2
    bar = 2 * grad + 1e-3
    log(f"[modes] (m): charge photon {charge['photon']:.1f} / image "
        f"{charge['image']:.1f} (rel gap {rel:.3g} <= 1e-4); stacked <r^2> "
        f"of {n_star} stars photon {m2['photon']:.5f} / image "
        f"{m2['image']:.5f} px^2 (rel gap {m_rel:+.3g}, bar {bar:.3g} = "
        f"2 x the rings' largest gradient {grad:.3g} + 1e-3)")
    _check(rel <= 1e-4 and abs(m_rel) <= bar,
           "bf_mode photon and image disagree")
    return launches


def _stacked_moments(imgs, host, modes, cfg, weight, obj_idx, min_count,
                     r=6, max_stars=500):
    """<r^2> [px^2] about each pooled star's own centroid in a (2r+1)^2
    box, stacked over (at most max_stars of) the stars with at least
    min_count photons in the batch that sit inside the frame with no
    neighbour within 2r holding more than 2% of the star's photons (the
    two modes bin the same photons, so the faint neighbours' light is
    the same in both).  Returns ({mode: stacked <r^2>}, star count)."""
    import numpy as np
    import torch

    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.render import POINT

    n = host.n_objects
    p = host.scene.params[:n].cpu().numpy()
    counts = torch.bincount(obj_idx.long(), weights=weight,
                            minlength=host.scene.n)[:n].cpu().numpy()
    x, y = p[:, 0], p[:, 1]
    pick = ((p[:, 2] == POINT) & (np.asarray(modes) == PP.PHOT)
            & (counts >= min_count) & (x > 3 * r) & (x < cfg.xsize - 3 * r)
            & (y > 3 * r) & (y < cfg.ysize - 3 * r))
    ids = []
    for i in np.nonzero(pick)[0]:
        near = np.hypot(x - x[i], y - y[i]) < 2 * r
        near[i] = False
        if not (counts[near] > 0.02 * counts[i]).any():
            ids.append(i)
    ids = ids[:max_stars]
    if not ids:
        raise AssertionError("no pooled star for (m)")
    out = {}
    for mode, img in imgs.items():
        num = den = 0.0
        for i in ids:
            ix, iy = int(round(float(x[i]))), int(round(float(y[i])))
            box = img[iy - r:iy + r + 1, ix - r:ix + r + 1].double()
            yy, xx = torch.meshgrid(
                torch.arange(-r, r + 1, dtype=torch.float64,
                             device=img.device),
                torch.arange(-r, r + 1, dtype=torch.float64,
                             device=img.device), indexing="ij")
            w = box.sum()
            cx, cy = (box * xx).sum() / w, (box * yy).sum() / w
            num += float((box * ((xx - cx) ** 2 + (yy - cy) ** 2)).sum())
            den += float(w)
        out[mode] = num / den
    return out, len(ids)


# ---- phase 9: state from the pointing ------------------------------------

# the CCD that the exported fixture does not hold: ITL, 4072 x 4000
ITL_DET = "R10_S11"


def _build_state(det_name, device, **kw):
    """build_ccd_state at the bench pointing; returns (state, host s,
    per-step host s)."""
    from imsim_tpu_torch.convert import BENCH_POINTING, build_ccd_state

    steps = {}
    t0 = time.perf_counter()
    state = build_ccd_state(det_name, **BENCH_POINTING, device=device,
                            timings=steps, **kw)
    return state, time.perf_counter() - t0, steps


def phase_pointing(device, small: bool):
    """Gate (n): R22_S11's state built from the bench pointing equals the
    exported fixture leaf by leaf (bit-equal; the field angles within 1
    float32 ulp).  Then R10_S11 (ITL, 4072 x 4000), which the fixture
    does not hold, built with the runner's silicon and rendered from
    that state through the optics path, cold and warm, with gates (a)-(f)
    on its frame, and K3 held to its twin once at that frame's size.
    Returns the ITL render's launches and the seconds."""
    import torch

    from imsim_tpu_torch.benchmarks._util import Timer, workload
    from imsim_tpu_torch.convert import load_ccd_state, state_mismatches
    from imsim_tpu_torch.image import photon_pooling as PP

    def fmt(steps):
        return ", ".join(f"{k} {v:.3f}" for k, v in steps.items())

    built, t_b, steps = _build_state("R22_S11", device)
    log(f"[pointing] R22_S11 built from the pointing in {t_b:.3f} s of host "
        f"time ({fmt(steps)})")
    bad, ulp = state_mismatches(built, load_ccd_state(device=device))
    log(f"[pointing] (n): {len(bad)} leaves differ from the exported state "
        f"(bar: none; the field angles' largest gap {ulp} float32 ulp, "
        f"bar 1)" + "".join(f"\n[pointing]   {k}: {v}"
                            for k, v in bad.items()))
    _check(not bad, "the built bench state differs from the exported one")
    del built

    state, t_i, steps = _build_state(ITL_DET, device, silicon="runner")
    log(f"[pointing] {ITL_DET} ({state.readout.vendor}, {state.nx} x "
        f"{state.ny}) built in {t_i:.3f} s of host time ({fmt(steps)}); "
        f"{int((state.modes == PP.FFT).sum())} FFT objects, full well "
        f"{state.readout.full_well:.0f} e-")
    _check(state.readout.vendor == "ITL" and (state.nx, state.ny)
           == (4072, 4000), f"{ITL_DET} is not the ITL frame")
    timer = Timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(20261017)
    H, W = (512, 512) if small else (state.ny, state.nx)
    k3 = _k3_row(timer, gen, state.silicon, H, W, device, tag="pointing K3")
    log_kernel(k3, f" ({ITL_DET}'s frame and vendor kernel)")
    state, host, cfg, ctx = workload(device, small, state=state)
    _, _, nb, _ = PP.pooled_plan(host, PP.classify_objects(
        host, cfg, PP.make_psf_mtf(cfg)), cfg)
    # the rehearsal renders it once: the CPU's readout takes seconds
    res = phase_ccd(device, state, host, cfg, ctx, nb, small, tag="itl",
                    buckets=False,
                    labels=("cold",) if small else ("cold", "warm"))
    return dict(res, build_s=t_b, build_itl_s=t_i, k3=k3)


# ---- phase 10: the instance-catalog CCD -----------------------------------

INSTCAT_DET = "R22_S11"
# the rehearsal's workload: 2,000 objects over R22_S11's central 512 x 512
# window (+10 px), two bright stars; rendered in 2 batches with 102.4 m
# screens
INSTCAT_SMALL = dict(n_lines=2000, window=(512, 512), margin=10.0,
                     n_bright=2, total_photons=3e5)
INSTCAT_SMALL_CFG = {"image.nbatch": 2, "input.atm_psf.screen_size": 102.4}


def _sky_only(device, cfg, pieces, seed):
    """(p)/(q): the sky stage alone on an empty frame, its mean against
    level x gradient x vignetting (x fringe) evaluated on the host in
    float64 (the plane analytically, the coarse vignetting upsampled by
    separable linear interpolation), within 5 sigma of the frame mean."""
    import numpy as np
    import torch

    from imsim_tpu_torch.image.ccd_render import add_sky_and_noise
    from imsim_tpu_torch.utils.rng import stream

    level, grad, vig, step, fringe = pieces
    H, W = cfg.ysize, cfg.xsize
    sky = add_sky_and_noise(stream(seed, "sky only", device=device),
                            torch.zeros((H, W), device=device),
                            float(np.float32(level)), grad, vig,
                            cfg.pixel_scale, vig_step=step, fringe=fringe)
    got = float(sky.mean(dtype=torch.float64))
    del sky
    ys, xs = np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64)
    v = np.asarray(vig, np.float64)
    gy, gx = np.arange(v.shape[0]) * step, np.arange(v.shape[1]) * step
    cols = np.stack([np.interp(xs, gx, row) for row in v])
    vmap = np.stack([np.interp(ys, gy, cols[:, j]) for j in range(W)], 1)
    plane = grad[0] * xs[None, :] + grad[1] * ys[:, None] + grad[2]
    fac = plane * vmap
    if fringe is not None:
        f = fringe.cpu().numpy() if hasattr(fringe, "cpu") else fringe
        fac = fac * np.asarray(f, np.float64)
    want = float(np.float32(level)) * cfg.pixel_scale ** 2 * fac.mean()
    sigma = np.sqrt(want / (H * W))
    return got, want, sigma


def phase_instcat(device, small: bool):
    """The instance-catalog CCD through the runner's per-CCD path: the
    generated workload (120,000 lines and its SED library, or the
    rehearsal's 2,000 over a 512 x 512 window), the visit context and
    prepare_ccd for R22_S11 with each host step's seconds, gate (o)
    against the JAX package's digest (full size), render_one_ccd cold
    and warm with gates (a)-(f) tagged [instcat] and (p) the sky-only
    frame; then the y-band copy, rendered once with its fringe map, gate
    (q).  Returns the r render's launches (cold)."""
    import shutil
    import tempfile

    import numpy as np

    from imsim_tpu_torch.benchmarks import instcat_workload as WL

    t0 = time.perf_counter()
    if small:
        out_dir = tempfile.mkdtemp(prefix="instcat_")
        kw, window = INSTCAT_SMALL, INSTCAT_SMALL["window"]
    else:
        out_dir = os.path.join(HERE, "chiprun_out", "instcat_workload")
        kw, window = {}, None
    try:
        wl = WL.write_workload(out_dir, **kw)
        log(f"[instcat] workload written in {time.perf_counter() - t0:.1f} s:"
            f" {kw.get('n_lines', 120_000)} object lines, sha256 r "
            f"{wl['sha256']['r'][:16]}..., y {wl['sha256']['y'][:16]}...")
        want = None
        if not small:
            with np.load(WL.DIGEST) as z:
                want = {k: z[k] for k in z.files}
        launches = _instcat_band(device, small, wl, "r", window, want)
        _instcat_band(device, small, wl, "y", window, want)
        log(f"[instcat] phase 10 took {time.perf_counter() - t0:.1f} s")
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _instcat_band(device, small, wl, band, window, want):
    """One band of phase 10: the prep with its host seconds, gate (o),
    K1-K3 held to their twins at this path's shapes, the renders (r cold and warm, y once; the rehearsal renders each
    once) and their gates, and (p) or (q).  Returns the first render's
    launches."""
    import numpy as np
    import torch

    from imsim_tpu_torch.benchmarks import instcat_workload as WL
    from imsim_tpu_torch.benchmarks._util import Timer
    from imsim_tpu_torch.config import runner as TR
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.cosmic_rays import cosmic_ray_hits
    from imsim_tpu_torch.ops import _build

    timer = Timer(device)
    tag = "instcat" if band == "r" else "instcat y"
    ctx = WL.visit_context(wl["catalog"][band], wl["sed_dir"],
                           INSTCAT_SMALL_CFG if small else None)
    prep = TR.prepare_ccd(ctx, INSTCAT_DET, window=window, device=device)
    t = time.perf_counter()
    pieces = TR.sky_noise_pieces(ctx, prep, device=device)
    timer.sync()
    steps = dict(ctx.seconds, **prep.seconds,
                 **{"sky pieces": time.perf_counter() - t})
    host, cfg = prep.host, prep.pcfg
    modes = PP.classify_objects(host, cfg, PP.make_psf_mtf(cfg))
    _, total, nb, _ = PP.pooled_plan(host, modes, cfg)
    counts = np.bincount(modes, minlength=3)
    log(f"[{tag}] {INSTCAT_DET} {cfg.ysize} x {cfg.xsize}: host seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f" (sum {sum(steps.values()):.3f}); {host.n_objects} objects kept,"
        f" modes FFT/PHOT/FAINT {counts.tolist()}, {total} pooled photons in "
        f"{nb} batches; sky {prep.sky_level:.1f} photons/arcsec^2, FWHMeff "
        f"{cfg.fwhm:.4f}, wl_ref {cfg.wl_ref:.3f} nm")
    if want is not None:
        got = WL.prep_digest(ctx, prep, pieces, modes, band)
        bad, gaps = WL.digest_mismatches(got, want, band)
        sha_ok = wl["sha256"][band] == str(want[f"{band}.catalog_sha256"])
        log(f"[{tag}] (o): prep against the JAX package's digest: catalog "
            f"sha256 {'equal' if sha_ok else 'DIFFERS'}; {len(bad)} leaves "
            f"past their bars (kept, ids, realized sum, modes exact; "
            f"sampled nominal flux and wavelength rows bit-equal; field "
            f"angles <= 1 float32 ulp; sky level and gradient <= 1e-12 "
            f"relative; fringe mean and std <= 1e-6 relative); gaps "
            + json.dumps({k: float(v) for k, v in gaps.items()})
            + "".join(f"\n[{tag}]   {k}: {v}" for k, v in bad.items()))
        _check(sha_ok and not bad, f"{band}-band prep differs from the "
                                   f"JAX package's digest")
    else:
        log(f"[{tag}] (o): the rehearsal's catalog has no JAX digest; the "
            f"full-size run holds the prep to it")

    # this path's kernels against their plain twins at its own shapes: K1
    # on batch 0 of the catalog's pooled plan, K2 on that batch's field
    # angles with the CCD's telescope, optics context and the runner's
    # silicon over the band's wavelengths, K3 with that silicon's taps on
    # the frame
    _check(prep.use_optics, "the catalog CCD is not on the optics path")
    gen = torch.Generator(device=device)
    gen.manual_seed(20261018)
    bp = prep.bandpass
    band_wl = tuple(float(v) for v in bp.wave[bp.throughput > 0][[0, -1]])
    k1, field, _, n_slots = _k1_row(timer, host, cfg, device, f"{tag} K1")
    krows = [k1, _k2_row(timer, gen, prep.tel32, prep.octx, prep.silicon,
                         field, n_slots, device, band_wl, f"{tag} K2")]
    del field
    krows.append(_k3_row(timer, gen, prep.silicon, cfg.ysize, cfg.xsize,
                         device, tag=f"{tag} K3"))
    for row in krows:
        log_kernel(row, f" ({tag}: the catalog's batch, {band_wl[0]:.1f}-"
                        f"{band_wl[1]:.1f} nm, the runner's silicon)")

    none = {k: 0 for k in _build.LAUNCHES}
    expect = dict(none, scan_slot_prefix=nb, field_to_sensor=nb,
                  stencil_pair=nb * cfg.nsub, bin_scatter=nb * cfg.nsub)
    if not timer.cuda:
        expect = none
    spikes = prep.spikes
    kern = spikes["kernel"]
    frac = 1.0 - float(kern[kern.shape[0] // 2, kern.shape[1] // 2])
    rate = float(ctx.cfg["output"]["cosmic_ray_rate"])
    hits, _ = cosmic_ray_hits((cfg.ysize, cfg.xsize), prep.exptime,
                              ctx.seed * 189 + prep.det_num, ccd_rate=rate)
    # (a)'s floor: 0.8 of the pooled photons' mean chance to convert in
    # the silicon (in y a third of them pass through it)
    n = host.n_objects
    labs = host.scene.labs_icdf[:n].double().cpu().numpy()
    conv = (1.0 - np.exp(-prep.silicon.thickness_um / labs)).mean(axis=1)
    w = np.where(modes != PP.FFT, host.flux[:n], 0.0)
    landed_min = 0.8 * float((conv * w).sum() / w.sum())
    first = gates_fft = None
    labels = ("once",) if band == "y" else ("cold",) if small \
        else ("cold", "warm")
    for label in labels:
        tally = {}
        if timer.cuda:
            torch.cuda.reset_peak_memory_stats()
        timer.sync()
        _build.reset_launches()
        t = time.perf_counter()
        res = TR.render_one_ccd(ctx, INSTCAT_DET, device, prep=prep,
                                tally=tally)
        timer.sync()
        wall = time.perf_counter() - t
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30 if timer.cuda \
            else float("nan")
        log(f"[{tag}] {label}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in res["seconds"].items())
            + f"; whole CCD {wall:.3f} s ({peak:.2f} GiB peak, launches "
            f"{launches})")
        _check(launches == expect, f"{tag} launch counts {launches} != "
                                   f"{expect}")
        _check(int((res["modes"] == PP.FFT).sum()) == int(counts[PP.FFT]),
               "FFT-mode objects differ from the classifier's")
        gates_fft = _ccd_gates(
            device, tag, label, host, cfg, spikes, frac, res["image"],
            res["eimage"], res["amps"], res["modes"], tally, res["pieces"],
            prep.readout, gates_fft, masked=hits, landed_min=landed_min)
        first = first or launches
        del res

    # (p) / (q): the sky stage alone against level x gradient x vignetting
    # (x the fringe map in y)
    got, want_mean, sigma = _sky_only(device, cfg, pieces, 10)
    gate = "(p)" if band == "r" else "(q)"
    msg = (f"[{tag}] {gate}: sky-only frame mean {got:.4f} e-/px against "
           f"level x gradient x vignetting{' x fringe' if band == 'y' else ''}"
           f" {want_mean:.4f} (gap {(got - want_mean) / sigma:+.2f} sigma, "
           f"bar 5)")
    ok = abs(got - want_mean) <= 5 * sigma
    if band == "y":
        fringe = pieces[4]
        _check(fringe is not None, "no fringe map in y on E2V")
        f = fringe.double()
        fm, fs = float(f.mean()), float(f.std(correction=0))
        msg += f"; fringe map mean {fm:.7f}, std {fs:.3e}"
        if want is not None:
            wm, ws = (float(v) for v in want["y.fringe"])
            rel = max(abs(fm / wm - 1), abs(fs / ws - 1))
            msg += (f" against the JAX package's {wm:.7f}, {ws:.3e} (rel "
                    f"gap {rel:.3g}, bar 1e-6)")
            ok = ok and rel <= 1e-6
        else:
            ok = ok and 0 < fs < 0.01 and abs(fm - 1) < 1e-3
    log(msg)
    _check(ok, f"{gate} sky-only frame out of bounds")
    return first


# ---- phase 11: a visit from YAML through the CLI --------------------------

# the FEA visit: the example catalog's header puts the boresight at
# altitude 60 deg, so the gravity terms sit at zenith 30 deg; aos_dof moves
# four degrees of freedom, rigid body (M2 dz, M2 rx) and bending (M1M3
# mode 2, M2 mode 3)
FEA_TERMS = {
    "m1m3_gravity": {"zenith": "30 deg"},
    "m1m3_temperature": {"m1m3_TBulk": 1.0},
    "aos_dof": {"dof": [0.5, 0.0, 0.0, 2.0] + [0.0] * 8 + [0.3]
                + [0.0] * 20 + [0.2] + [0.0] * 16}}
OPD_FIELDS = [[0.0, 0.0], [1.0, 1.0]]
OPD_JMAX = 28
EXAMPLE_CATALOG = os.path.join("examples", "example_instance_catalog.txt")
EXAMPLE_SEDS = os.path.join("examples", "seds")


VISIT_DETS = ("R22_S11", "R10_S11")
# the rehearsal: 2,000 lines over R22_S11's central window and 2,000 over
# R10_S11, none above the FFT threshold (the star field spans the whole
# frame: its plain synthesis takes tens of seconds on the CPU), one batch
# a CCD without the silicon (its plain BF stencil takes seconds a pass
# over a full frame), small screens and OPD maps, the FEA visit without
# its readout, the flat on 256 x 256
VISIT_SMALL = dict(n_lines=2000, window=(512, 512), margin=10.0,
                   n_bright=0, total_photons=3e5)
VISIT_SMALL_OVER = {"image.nbatch": 1, "image.sensor.type": "none",
                    "input.atm_psf.screen_size": 102.4}


def _user_yaml(path, over: dict, template="imsim-config-instcat"):
    """A user config: `template` and one dotted key a line, each value in
    flow form (JSON), read back through the port's YAML reader to check
    that it means what it says (1e-06 would be a string there)."""
    from imsim_tpu_torch.config.yaml_subset import safe_load

    text = "".join([f"template: {template}\n"] + [
        f"{k}: {json.dumps(v)}\n" for k, v in over.items()])
    want = dict(template=template, **over)
    _check(safe_load(text) == want, f"{path} does not read back as written")
    with open(path, "w") as f:
        f.write(text)
    return path


def _cli(device, argv):
    """imsim_tpu_torch.__main__.main on `argv` with the device; returns
    (results: shallow copies of each CCD's result, as the visit yields
    them, wall seconds, launches)."""
    import torch

    from imsim_tpu_torch import __main__ as CLI
    from imsim_tpu_torch.ops import _build

    results = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    rc = CLI.main([*argv, "--device", str(device), "-q"],
                  on_result=lambda r: results.append(dict(r)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    _check(rc == 0, f"the CLI returned {rc}")
    return results, wall, launches


def phase_visit(device, small: bool, root: str):
    """A visit from YAML through the CLI, in process: two CCDs (R22_S11,
    E2V, and R10_S11, ITL) of a catalog over both, with io_workers and
    prefetch, OPD and truth outputs, gates (r), (s) and (a)-(f) tagged
    [visit]; the FEA visit (example catalog, fea terms, doOpt, OPD and
    sag, checkpointed) run twice, gates (t) and (u); the example flat
    config, gate (v).  Files go under `root` (visit_root), which phase 13
    reuses.  Returns the two-CCD visit's launches and the workload."""
    from imsim_tpu_torch.benchmarks import instcat_workload as WL

    t0 = time.perf_counter()
    wl = WL.write_workload(os.path.join(root, "workload"),
                           more_dets=VISIT_DETS[1:],
                           **(VISIT_SMALL if small else {}))
    log(f"[visit] workload written in {time.perf_counter() - t0:.1f} s:"
        f" {VISIT_SMALL['n_lines'] if small else 120_000} object lines "
        f"over each of {', '.join(VISIT_DETS)}")
    launches = _visit_ccds(device, small, root, wl)
    _visit_fea(device, small, root)
    _visit_flat(device, small, root)
    log(f"[visit] phase 11 took {time.perf_counter() - t0:.1f} s")
    return launches, wl


def visit_root(small: bool) -> str:
    """The directory of phases 11 and 13: chiprun_out/visit/ (a
    temporary directory in the rehearsal), emptied first; run() removes
    it after phase 13."""
    import shutil
    import tempfile

    if small:
        return tempfile.mkdtemp(prefix="visit_")
    root = os.path.join(HERE, "chiprun_out", "visit")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def _visit_ccds(device, small, root, wl):
    """The two-CCD visit: timings, launches, (r), (s), (a)-(f)."""
    from imsim_tpu_torch.catalog.opsim import read_instcat_header
    from imsim_tpu_torch.config import runner as TR
    from imsim_tpu_torch.config.interpreter import load_config
    from imsim_tpu_torch.electronics.camera import get_camera
    from imsim_tpu_torch.io.fits import HDU
    from imsim_tpu_torch.io.rice import serialize_rice_hdu

    cam = get_camera()
    out = os.path.join(root, "ccds")
    over = {"input.instance_catalog.file_name": wl["catalog"]["r"],
            "input.instance_catalog.sed_dir": wl["sed_dir"],
            "output.dir": out,
            "output.det_num": [cam.det_num(d) for d in VISIT_DETS],
            "output.io_workers": 1,
            "output.file_name": "eimage_{det_name}.fits",
            "output.readout.file_name": "amp_{det_name}.fits",
            "output.truth": {"file_name": "centroid_{det_name}.txt"},
            "output.opd": {"fields": OPD_FIELDS, "jmax": OPD_JMAX,
                           "file_name": "opd_{det_name}.fits"}}
    if small:
        over.update(VISIT_SMALL_OVER, **{"output.opd": dict(
            over["output.opd"], nx=65)})
    user = _user_yaml(os.path.join(root, "visit.yaml"), over)
    cfg = load_config(user)
    TR.reset_host_timers()
    results, wall, launches = _cli(device, [user])
    timers = dict(TR.HOST_TIMERS)
    _check([r["det_name"] for r in results] == list(VISIT_DETS),
           f"the visit rendered {[r['det_name'] for r in results]}")

    # the launches the plan predicts: K1 and K2 once a batch, K3 and K5
    # once a sub-batch with the silicon
    want = _plan_launches(device, results)
    steps = 0.0
    for r in results:
        prep, sec = r["prep"], r["seconds"]
        steps += sum(v for k, v in sec.items() if k != "readout")
        log(f"[visit] {r['det_name']} ({prep.ccd.vendor}, "
            f"{prep.pcfg.ysize} x {prep.pcfg.xsize}): host prep "
            + ", ".join(f"{k} {v:.3f}" for k, v in prep.seconds.items())
            + " s; render " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         sec.items()) + " s; "
            f"{prep.host.n_objects} objects")
    steps += timers["prep_s"] + timers["readout_s"] + timers["io_s"]
    log(f"[visit] 2 CCDs through the CLI: wall {wall:.2f} s; host timers "
        f"prep {timers['prep_s']:.2f} s, readout {timers['readout_s']:.3f} "
        f"s, file writes {timers['io_s']:.2f} s; steps sum {steps:.2f} s, "
        f"hidden by the prefetch and IO threads {1 - wall / steps:.1%}; "
        f"launches {launches} (expected {want})")
    _check(launches == want, f"visit launches {launches} != {want}")
    amps = results[0]["amps"]
    t = time.perf_counter()
    for k in range(amps.shape[0]):
        serialize_rice_hdu(HDU(amps[k]))
    log(f"[visit] RICE encode of {results[0]['det_name']}'s "
        f"{amps.shape[0]} amps {tuple(amps.shape[1:])}: "
        f"{time.perf_counter() - t:.3f} s (host)")

    rate = float(cfg["output"]["cosmic_ray_rate"])
    seed = int(read_instcat_header(wl["catalog"]["r"]).get("seed", 42))
    for r in results:
        if r["det_name"] == "R22_S11":
            _visit_gate_r(small, wl, r)
        _visit_gate_s(out, r)
        _render_gates(device, "visit", r["det_name"], r, seed, rate)
    return launches


def _visit_gate_r(small, wl, r):
    """(r): the visit's R22_S11 prep against gate (o)'s digest."""
    import numpy as np

    from imsim_tpu_torch.benchmarks import instcat_workload as WL

    if small:
        log("[visit] (r): the rehearsal's catalog has no JAX digest; the "
            "full-size run holds the visit's R22_S11 prep to gate (o)'s")
        return
    with np.load(WL.DIGEST) as z:
        want = {k: z[k] for k in z.files}
    # the sky model for the digest's gradient plane, from the same config
    ctx = WL.visit_context(wl["catalog"]["r"], wl["sed_dir"])
    got = WL.prep_digest(ctx, r["prep"], r["pieces"], r["modes"], "r")
    bad, gaps = WL.digest_mismatches(got, want, "r")
    log(f"[visit] (r): the YAML visit's R22_S11 prep against gate (o)'s "
        f"digest (its catalog with R10_S11's lines appended): {len(bad)} "
        f"leaves past their bars (kept, ids, realized sum, modes exact; "
        f"nominal flux and wavelength rows bit-equal; field angles <= 1 "
        f"float32 ulp; sky level and gradient <= 1e-12 relative); gaps "
        + json.dumps({k: float(v) for k, v in gaps.items()})
        + "".join(f"\n[visit]   {k}: {v}" for k, v in bad.items()))
    _check(not bad, "the YAML visit's prep differs from the digest")


def _visit_gate_s(out, r):
    """(s): the CCD's files read back: the eimage and the RICE amps bit
    for bit, the truth rows and nominal fluxes, the OPD images and
    cards."""
    import numpy as np

    from imsim_tpu_torch.io.fits import read_fits

    det, host = r["det_name"], r["host"]
    (_, eim), = read_fits(os.path.join(out, f"eimage_{det}.fits"))
    e_ok = eim.astype("<f4").tobytes() == np.asarray(
        r["eimage"], "<f4").tobytes()
    amp = read_fits(os.path.join(out, f"amp_{det}.fits"))
    a_ok = len(amp) == 17 and all(
        d.dtype == np.int32 and np.array_equal(d, r["amps"][k])
        for k, (_, d) in enumerate(amp[1:]))
    with open(os.path.join(out, f"centroid_{det}.txt")) as f:
        rows = [ln.split() for ln in f if not ln.startswith("#")]
    n = host.n_objects
    t_ok = len(rows) == n and [row[5] for row in rows] == [
        f"{v:.2f}" for v in host.nominal_flux[:n]]
    opd = read_fits(os.path.join(out, f"opd_{det}.fits"))
    nx = opd[1][1].shape[0]
    o_ok = len(opd) == 1 + len(OPD_FIELDS) and all(
        d.shape == (nx, nx) and all(f"AZ_{j:03d}" in h
                                    for j in range(1, OPD_JMAX + 1))
        for h, d in opd[1:])
    log(f"[visit] (s) {det}: eimage read back "
        f"{'bit-equal' if e_ok else 'DIFFERS'}; amp file {len(amp)} HDUs, "
        f"RICE segments "
        f"{'bit-equal to the readout' if a_ok else 'DIFFER'}; truth "
        f"{len(rows)} rows for {n} objects, nominal fluxes "
        f"{'equal' if t_ok else 'DIFFER'}; OPD {len(opd) - 1} fields of "
        f"{nx} x {nx} with AZ_001..AZ_{OPD_JMAX:03d}: "
        f"{'yes' if o_ok else 'NO'}")
    _check(e_ok and a_ok and t_ok and o_ok, f"{det}'s files differ")


def _visit_fea(device, small, root):
    """The FEA visit twice, the second resumed from the first's
    checkpoints: (t) and (u)."""
    import numpy as np

    from imsim_tpu_torch.catalog.opsim import read_instcat_header
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.io.fits import read_fits
    from imsim_tpu_torch.optics.aos import OpticalZernikes
    from imsim_tpu_torch.optics.loader import load_telescope

    opd = {"fields": OPD_FIELDS, "jmax": OPD_JMAX}
    over = {"input.instance_catalog.file_name": os.path.join(
                HERE, EXAMPLE_CATALOG),
            "input.instance_catalog.sed_dir": os.path.join(HERE,
                                                           EXAMPLE_SEDS),
            "input.telescope.fea": FEA_TERMS, "input.atm_psf.doOpt": True,
            "output.det_num": [94], "output.opd": opd, "output.sag": {},
            "image.nbatch_per_checkpoint": 1,
            "input.checkpoint.dir": os.path.join(root, "checkpoints")}
    if small:
        over.update(VISIT_SMALL_OVER, **{"output.opd": dict(opd, nx=65),
                                         "output.sag": {"nx": 65},
                                         "output.readout.enabled": False})
    user = _user_yaml(os.path.join(root, "fea.yaml"), over)
    runs = [_cli(device, [user, f"output.dir={os.path.join(root, d)}"])
            for d in ("fea", "fea_resumed")]
    (r1, w1, l1), (r2, w2, l2) = [(res[0], w, n) for res, w, n in runs]
    nb = PP.pooled_plan(r1["host"], r1["modes"], r1["prep"].pcfg)[2]
    ks = ("scan_slot_prefix", "field_to_sensor", "stencil_pair")
    same = np.asarray(r1["eimage"]).tobytes() == \
        np.asarray(r2["eimage"]).tobytes()
    log(f"[visit] (t): FEA visit {w1:.2f} s ({r1['host'].n_objects} "
        f"objects, {nb} batches; K1-K3 launches "
        f"{[l1[k] for k in ks]}), resumed from its checkpoints "
        f"{w2:.2f} s: K1-K3 launches {[l2[k] for k in ks]} (bar 0), "
        f"eimage {'bit-equal' if same else 'DIFFERS'}")
    _check(same and not any(l2[k] for k in ks)
           and (device.type != "cuda" or l1["scan_slot_prefix"] == nb),
           "the resumed FEA visit differs or rendered again")

    with np.load(os.path.join(HERE, "imsim_tpu_torch", "data",
                              "fea_opd_digest.npz")) as z:
        want = {k: z[k] for k in z.files}
    cfg_ok = str(want["config"]) == json.dumps(dict(
        fea=FEA_TERMS, fields=OPD_FIELDS, jmax=OPD_JMAX,
        catalog=EXAMPLE_CATALOG), sort_keys=True)
    ods = read_instcat_header(os.path.join(HERE, EXAMPLE_CATALOG))
    tel = load_telescope(band=ods.get("band", "r"), fea=FEA_TERMS,
                         rotTelPos=float(ods.get("rotTelPos", 0.0))
                         * np.pi / 180)
    OpticalZernikes(seed=int(ods.get("seed", 42))).apply_to(tel)
    rel = max(float(np.abs(getattr(tel.fiducial, k) - want[k]).max()
                    / max(float(np.abs(want[k]).max()), 1e-300))
              for k in ("z0", "c", "kappa", "coefs", "aper", "shift", "rot",
                        "zk"))
    hdus = read_fits(os.path.join(root, "fea", "opd.fits"))
    zk = np.array([[h[f"AZ_{j:03d}"] for j in range(1, OPD_JMAX + 1)]
                   for h, _ in hdus[1:]])
    gap = float(np.abs(zk - want["opd_zk"]).max())
    wl_ok = all(h["WAVELEN"] == float(want["wavelength"]) for h, _ in hdus[1:])
    sag = read_fits(os.path.join(root, "fea", "sag.fits"))
    log(f"[visit] (u): FEA / AOS telescope against the JAX package's digest "
        f"(config {'equal' if cfg_ok else 'DIFFERS'}): design max rel gap "
        f"{rel:.3g} (bar 1e-12); the OPD file's Zernikes at "
        f"{len(zk)} fields, |Z4| {abs(zk[0, 3]):.1f} nm, max gap "
        f"{gap:.3g} nm (bar 1e-6), wavelength "
        f"{'equal' if wl_ok else 'DIFFERS'}; sag file {len(sag) - 1} "
        f"surfaces")
    _check(cfg_ok and rel <= 1e-12 and gap <= 1e-6 and wl_ok
           and len(sag) == 4, "FEA / AOS optics differ from the JAX digest")


def _visit_flat(device, small, root):
    """examples/flat.yaml through the CLI on the full R22_S11 frame: (v)."""
    import numpy as np

    from imsim_tpu_torch.image.flat import flat_statistics
    from imsim_tpu_torch.io.fits import read_fits

    out = os.path.join(root, "flat")
    argv = [os.path.join(HERE, "examples", "flat.yaml"), f"output.dir={out}",
            "output.readout.enabled=false"]
    if small:
        argv += ["image.xsize=256", "image.ysize=256"]
    res, wall, launches = _cli(device, argv)
    r = res[0]
    (_, data), = read_fits(os.path.join(out, "flat_R22_S11.fits"))
    exact = data.astype("<f4").tobytes() == np.asarray(
        r["eimage"], "<f4").tobytes()
    st = flat_statistics(np.asarray(r["eimage"]))
    cpp = 80_000.0
    log(f"[visit] (v): examples/flat.yaml, {data.shape[0]} x {data.shape[1]}"
        f": {wall:.2f} s through the CLI (launches "
        f"{ {k: v for k, v in launches.items() if v} }); file round trip "
        f"{'exact' if exact else 'DIFFERS'}; mean {st['mean']:.2f} (rel gap "
        f"{st['mean'] / cpp - 1:+.5f}, bar 0.005), var/mean "
        f"{st['var_over_mean']:.4f} (< 0.97)")
    _check(exact and abs(st["mean"] / cpp - 1) <= 0.005
           and st["var_over_mean"] < 0.97, "the YAML flat is out of bounds")

# ---- phase 12: the skyCatalogs CCD -----------------------------------------

SKYCAT_DET = "R22_S11"
# the rehearsal: 2,000 mapped rows over R22_S11's central 512 x 512 window
# (+10 px), none above the FFT threshold (the star field spans the whole
# frame: its plain synthesis takes tens of seconds on the CPU), a
# 100-galaxy / 20-star native catalog there; one batch, small screens, no
# silicon (the BF stencil's plain twin takes seconds a pass over the full
# frame: the sensor model's silicon is built apart for its kernels), the
# saved-screen visits without the readout
SKYCAT_SMALL = dict(n_rows=2000, window=(512, 512), margin=10.0, n_bright=0,
                    total_photons=3e5, n_gal_native=100, n_star_native=20,
                    native_photons=1e5)
SKYCAT_SMALL_OVER = {"image.nbatch": 1, "image.batch_size": 10_000_000,
                     "image.sensor.type": "none",
                     "input.atm_psf.screen_size": 102.4}


def phase_skycat(device, small: bool):
    """The skyCatalogs CCD: the generated workload
    (benchmarks/skycat_workload.py, under chiprun_out/ and removed after),
    gate (w) against the JAX package's digest, the mapped catalog's
    full-frame CCD through the CLI with the '{vendor}' sensor model and
    one opsim_meta value through RowData, (a)-(f) [skycat], K1-K3 held to
    their twins at its shapes with the model kernel's taps (x); the
    native catalog's CCD (a)-(f) [skycat native]; (y) the saved screens.
    Returns the launches of the two CCDs."""
    import shutil
    import tempfile

    from imsim_tpu_torch.benchmarks import skycat_workload as SW

    t0 = time.perf_counter()
    if small:
        root = tempfile.mkdtemp(prefix="skycat_")
    else:
        root = os.path.join(HERE, "chiprun_out", "skycat_workload")
        shutil.rmtree(root, ignore_errors=True)
    try:
        wl = SW.write_workload(os.path.join(root, "workload"),
                               **(SKYCAT_SMALL if small else {}))
        log(f"[skycat] workload written in {time.perf_counter() - t0:.1f} s:"
            f" {SKYCAT_SMALL['n_rows'] if small else 120_000} mapped rows, "
            f"{len(wl['sha256']) - 1} native files, sensor models "
            f"{sorted(os.listdir(wl['sensor_model_dir']))}")
        want = None
        if not small:
            import numpy as np

            with np.load(SW.DIGEST) as z:
                want = {k: z[k] for k in z.files}
        mapped = _skycat_mapped(device, small, root, wl, want)
        native = _skycat_native(device, small, wl, want)
        _skycat_saved_screens(device, small, root)
        log(f"[skycat] phase 12 took {time.perf_counter() - t0:.1f} s")
        return mapped, native
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _skycat_kernels(device, tag, prep, small):
    """K1, K2 and K3 against their twins at this path's shapes: batch 0
    of the CCD's pooled plan, its optics over the band, its silicon's
    taps (the frame; 512 x 512 in the rehearsal)."""
    import torch

    from imsim_tpu_torch.benchmarks._util import Timer

    timer = Timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(20261019)
    host, cfg = prep.host, prep.pcfg
    bp = prep.bandpass
    band_wl = tuple(float(v) for v in bp.wave[bp.throughput > 0][[0, -1]])
    k1, field, _, n_slots = _k1_row(timer, host, cfg, device, f"{tag} K1")
    rows = [k1, _k2_row(timer, gen, prep.tel32, prep.octx, prep.silicon,
                        field, n_slots, device, band_wl, f"{tag} K2")]
    del field
    H, W = (512, 512) if small else (cfg.ysize, cfg.xsize)
    rows.append(_k3_row(timer, gen, prep.silicon, H, W, device,
                        tag=f"{tag} K3"))
    for row in rows:
        log_kernel(row, f" ({tag}: the catalog's batch, the CCD's silicon)")
    return rows


def _ccd_plan(r) -> dict:
    """A rendered CCD's batch plan: its batches, sub-batches, optics and
    silicon (the JSON a phase-13 rank reports)."""
    from imsim_tpu_torch.image import photon_pooling as PP

    prep = r["prep"]
    return dict(nb=PP.pooled_plan(r["host"], r["modes"], prep.pcfg)[2],
                nsub=prep.pcfg.nsub, optics=bool(prep.use_optics),
                silicon=prep.silicon is not None)


def _plan_of(ccds) -> dict:
    """The launches CCD plans predict: K1 and K2 once a batch on the
    optics path, K3 and K5 once a sub-batch with the silicon, K5 once a
    batch without."""
    from imsim_tpu_torch.ops import _build

    want = {k: 0 for k in _build.LAUNCHES}
    for c in ccds:
        if c["optics"]:
            want["scan_slot_prefix"] += c["nb"]
            want["field_to_sensor"] += c["nb"]
        if c["silicon"]:
            want["stencil_pair"] += c["nb"] * c["nsub"]
        want["bin_scatter"] += c["nb"] * (c["nsub"] if c["silicon"] else 1)
    return want


def _plan_launches(device, results):
    """The launches the results' plans predict on the card (none on the
    CPU, where the plain twins run)."""
    return _plan_of([_ccd_plan(r) for r in results
                     if device.type == "cuda"])


def _render_gates(device, tag, label, r, seed, rate):
    """(a)-(f) on one CCD's render result (phase 10's bars)."""
    import numpy as np
    import torch

    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.image.cosmic_rays import cosmic_ray_hits

    prep = r["prep"]
    host, pcfg = prep.host, prep.pcfg
    kern = prep.spikes["kernel"]
    frac = 1.0 - float(kern[kern.shape[0] // 2, kern.shape[1] // 2])
    hits, _ = cosmic_ray_hits((pcfg.ysize, pcfg.xsize), prep.exptime,
                              seed * 189 + prep.det_num, ccd_rate=rate)
    n = host.n_objects
    if prep.silicon is not None:
        labs = host.scene.labs_icdf[:n].double().cpu().numpy()
        conv = (1.0 - np.exp(-prep.silicon.thickness_um / labs)).mean(axis=1)
    else:
        conv = np.ones(n)
    w = np.where(r["modes"] != PP.FFT, host.flux[:n], 0.0)
    landed_min = 0.8 * float((conv * w).sum() / w.sum())
    _ccd_gates(device, tag, label, host, pcfg, prep.spikes, frac,
               r["image"], torch.as_tensor(r["eimage"], device=device),
               torch.as_tensor(r["amps"], device=device), r["modes"],
               r["tally"], r["pieces"], prep.readout, masked=hits,
               landed_min=landed_min, vign=prep.fft_vign)


def _skycat_mapped(device, small, root, wl, want):
    """The mapped catalog's CCD through the CLI: host seconds by step, the
    launches, (w), (x), (a)-(f) [skycat], K1-K3 at its shapes, a warm
    render."""
    import dataclasses

    import numpy as np

    from imsim_tpu_torch.benchmarks import instcat_workload as IW
    from imsim_tpu_torch.benchmarks import skycat_workload as SW
    from imsim_tpu_torch.config import runner as TR
    from imsim_tpu_torch.config.interpreter import load_config

    out = os.path.join(root, "ccd")
    meta = dict(SW.OPSIM_META, rawSeeing={
        "type": "RowData", "file_name": wl["tables"]["csv"],
        "key_column": "observationId", "key_value": 181000,
        "field": "seeing"})
    over = {"input.sky_catalog.file_name": wl["catalog"],
            "input.sky_catalog.sed_dir": wl["sed_dir"],
            "opsim_meta": meta,
            "image.sensor.sensor_model": SW.SENSOR_MODEL_NAME,
            "image.sensor.sensor_model_dir": wl["sensor_model_dir"],
            "output.dir": out, "output.det_num": [94],
            "output.file_name": "eimage_{det_name}.fits",
            "output.readout.file_name": "amp_{det_name}.fits"}
    if small:
        over.update(SKYCAT_SMALL_OVER)
    user = _user_yaml(os.path.join(root, "skycat.yaml"), over,
                      template="imsim-config-skycat")
    cfg = load_config(user)
    TR.reset_host_timers()
    results, wall, launches = _cli(device, [user])
    (r,) = results
    prep = r["prep"]
    _check(prep.ccd.vendor == "E2V" and float(
        prep.pcfg.fwhm) > 0, "the skycat CCD is not R22_S11's")
    log(f"[skycat] {SKYCAT_DET} {prep.pcfg.ysize} x {prep.pcfg.xsize} "
        f"through the CLI: wall {wall:.2f} s; host prep "
        + ", ".join(f"{k} {v:.3f}" for k, v in prep.seconds.items())
        + f" s (sum {sum(prep.seconds.values()):.3f}); render "
        + ", ".join(f"{k} {v:.3f}" for k, v in r["seconds"].items()
                    if k not in prep.seconds)
        + f" s; {prep.host.n_objects} objects (the galaxies' components), "
        f"modes FFT/PHOT/FAINT {np.bincount(r['modes'], minlength=3)}")
    expect = _plan_launches(device, results)
    log(f"[skycat] launches {launches} (expected {expect})")
    _check(launches == expect, f"skycat launches {launches} != {expect}")

    # (w): the prep against the JAX package's digest; the files' hashes
    # (x): the sensor model's kernel against the JAX package's
    vendor = prep.ccd.vendor.lower()
    kprep = prep
    if small:
        kprep = dataclasses.replace(prep, silicon=TR._silicon(
            TR.build_visit_context(load_config(
                user, ["image.sensor.type=Silicon"])), prep.ccd, SKYCAT_DET))
    kern = kprep.silicon.bf_kernel
    if want is not None:
        import json as _json

        sha_ok = wl["sha256"] == _json.loads(str(want["sha256"]))
        ctx = SW.visit_context(wl["catalog"], wl["sed_dir"])
        got = IW.prep_digest(ctx, prep, r["pieces"], r["modes"], "r")
        bad, gaps = IW.digest_mismatches(got, want, "r")
        log(f"[skycat] (w): the mapped catalog's prep against the JAX "
            f"package's digest: files' sha256 "
            f"{'equal' if sha_ok else 'DIFFER'}; {len(bad)} leaves past "
            f"their bars (kept, ids, realized sum, modes exact; nominal "
            f"flux and wavelength rows bit-equal; field angles <= 1 "
            f"float32 ulp; sky level and gradient <= 1e-12 relative); gaps "
            + json.dumps({k: float(v) for k, v in gaps.items()})
            + "".join(f"\n[skycat]   {k}: {v}" for k, v in bad.items()))
        _check(sha_ok and not bad, "the skycat prep differs from the digest")
        k_ok = all(np.array_equal(
            want[f"bf_kernel.{v}"], TR._kernel_cached(os.path.join(
                wl["sensor_model_dir"], SW.SENSOR_MODEL_NAME.format(
                    vendor=v) + ".dat"), 4, 1.0)) for v in SW.SENSOR_MODELS)
        k_ok = k_ok and np.array_equal(kern, want[f"bf_kernel.{vendor}"])
    else:
        log("[skycat] (w): the rehearsal's workload has no JAX digest; the "
            "full-size run holds the prep to it")
        k_ok = True
    k3 = _skycat_kernels(device, "skycat", kprep, small)[2]
    verdict = ("no digest (rehearsal)" if want is None else
               "bit-equal to the JAX package" if k_ok else
               "DIFFERS from the JAX package")
    log(f"[skycat] (x): the silicon's BF kernel from "
        f"{SW.SENSOR_MODEL_NAME.format(vendor=vendor)}.dat (K[4,4] "
        f"{float(kern[4, 4]):.4g}): {verdict}; K3 on its taps within "
        f"{k3['max_abs_err']:.3g} of its twin")
    _check(k_ok, "the sensor model's kernel differs from the JAX package's")
    rate = float(cfg["output"]["cosmic_ray_rate"])
    seed = int(cfg["opsim_meta"]["observationId"])
    _render_gates(device, "skycat", "cold", r, seed, rate)
    if not small:
        # the warm render of the same prep, its screens made beforehand
        import torch

        ctx = TR.build_visit_context(cfg)
        ctx.screens(device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = TR.render_one_ccd(ctx, SKYCAT_DET, device, prep=prep)
        torch.cuda.synchronize()
        log("[skycat] warm: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in res["seconds"].items())
            + f"; whole CCD {time.perf_counter() - t:.3f} s")
        del res
    return launches


def _skycat_native(device, small, wl, want):
    """The native catalog's CCD through the runner (the vendor's kernel):
    the whole table against the digest (w), host seconds by step, the
    launches, (a)-(f) [skycat native], K1-K3 at its shapes."""
    import numpy as np

    from imsim_tpu_torch.benchmarks import skycat_workload as SW
    from imsim_tpu_torch.catalog.skycat import SkyCatalogInterface
    from imsim_tpu_torch.config import runner as TR
    from imsim_tpu_torch.ops import _build

    if want is not None:
        tab = SkyCatalogInterface(wl["native"]).to_object_table()
        got = SW.table_digest(tab)
        bad = SW.table_mismatches(got, {k[7:]: v for k, v in want.items()
                                        if k.startswith("native.")})
        log(f"[skycat native] (w): the native catalog's ObjectTable "
            f"({len(tab)} rows) against the JAX package's digest: "
            f"{len(bad)} columns differ {bad}")
        _check(not bad, "the native table differs from the digest")
        del tab
    ctx = SW.visit_context(wl["native"], wl["sed_dir"],
                           SKYCAT_SMALL_OVER if small else None)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    prep = TR.prepare_ccd(ctx, SKYCAT_DET, device=device)
    res = TR.render_one_ccd(ctx, SKYCAT_DET, device, prep=prep)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    log(f"[skycat native] {SKYCAT_DET}: {wall:.2f} s; host prep "
        + ", ".join(f"{k} {v:.3f}" for k, v in prep.seconds.items())
        + f" s (sum {sum(prep.seconds.values()):.3f}); render "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
        + f" s; {prep.host.n_objects} objects, "
        f"{sum(s is not None for s in prep.table.sed_obj)} of them with "
        f"inline SEDs; modes {np.bincount(res['modes'], minlength=3)}")
    expect = _plan_launches(device, [dict(res, prep=prep)])
    log(f"[skycat native] launches {launches} (expected {expect})")
    _check(launches == expect, f"native launches {launches} != {expect}")
    _check(prep.seconds.get("tophat seds", 0.0) > 0,
           "no inline SEDs timed")
    res = dict(res, prep=prep)
    rate = float(ctx.cfg["output"]["cosmic_ray_rate"])
    _render_gates(device, "skycat native", "cold", res, ctx.seed, rate)
    del res
    if not small:
        # the rehearsal's native CCD has no silicon for K2's fused form
        _skycat_kernels(device, "skycat native", prep, small)
    return launches


def _skycat_saved_screens(device, small, root):
    """(y): the example visit twice with input.atm_psf.save_file: the
    second builds no screens, loads the first's bit-equal, and renders
    the same eimage (else it is held to the [visit] bars)."""
    import numpy as np
    import torch

    from imsim_tpu_torch.config import runner as TR

    made, loaded = [], []
    real_make, real_load = TR.make_screens, TR.load_screens
    TR.make_screens = lambda *a, **k: made.append(real_make(*a, **k)) \
        or made[-1]
    TR.load_screens = lambda *a, **k: loaded.append(real_load(*a, **k)) \
        or loaded[-1]
    try:
        atm = os.path.join(root, "atm.npz")
        over = {"input.instance_catalog.file_name": os.path.join(
                    HERE, EXAMPLE_CATALOG),
                "input.instance_catalog.sed_dir": os.path.join(
                    HERE, EXAMPLE_SEDS),
                "input.atm_psf.save_file": atm, "output.det_num": [94]}
        if small:
            over.update(VISIT_SMALL_OVER, **{"output.readout.enabled": False})
        user = _user_yaml(os.path.join(root, "atm.yaml"), over)
        runs = []
        for k in range(2):
            n0 = len(made)
            res, wall, _ = _cli(device, [
                user, f"output.dir={os.path.join(root, f'atm{k}')}"])
            runs.append((res[0], wall, len(made) - n0))
    finally:
        TR.make_screens, TR.load_screens = real_make, real_load
    (r1, w1, m1), (r2, w2, m2) = runs
    same_scr = len(made) == 1 and len(loaded) == 1 and torch.equal(
        made[0].grad.cpu(), loaded[0].grad.cpu()) and np.array_equal(
        made[0].winds, loaded[0].winds) and made[0].weights == \
        loaded[0].weights
    same_img = np.asarray(r1["eimage"]).tobytes() == \
        np.asarray(r2["eimage"]).tobytes()
    log(f"[skycat] (y): the example visit with input.atm_psf.save_file: "
        f"{w1:.2f} s making {m1} screen set(s) and saving "
        f"{os.path.getsize(atm) / 2**20:.1f} MiB, then {w2:.2f} s making "
        f"{m2} (bar 0) and loading {len(loaded)}: loaded screens "
        f"{'bit-equal to the saved' if same_scr else 'DIFFER'}; eimage "
        + ("bit-equal" if same_img else "not bit-equal (the render is not "
           "deterministic here): held to the [visit] bars"))
    _check(m1 == 1 and m2 == 0 and same_scr,
           "the second visit made screens or loaded other ones")
    if not same_img:
        _render_gates(device, "visit", "saved screens", r2, 181000 % 2**31,
                      0.2)


# ---- phase 13: CCDs and photons over several ranks ------------------------

MESH_DET = "R22_S11"
MESH_TIMEOUT = 420


def mesh_child(prefix: str, device: str, argv: list) -> int:
    """One rank of a phase-13 launch (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment, as
    torchrun sets them): the CLI in process (it initializes the group
    from that environment), then `{prefix}.{rank}.json` with the kernel
    launches and, per CCD this rank wrote, its batch plan, and
    `{prefix}.{rank}.{det}.npz` with its render before the sky and its
    realized fluxes."""
    _import_port()
    import numpy as np

    from imsim_tpu_torch import __main__ as CLI
    from imsim_tpu_torch.ops import _build

    rank = int(os.environ["RANK"])
    if device == "cpu":
        import torch

        # ranks on the CPU share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // int(os.environ["WORLD_SIZE"])))
    ccds = []

    def keep(r):
        npz = f"{prefix}.{rank}.{r['det_name']}.npz"
        np.savez(npz, image=r["image"].cpu().numpy(),
                 realized=np.asarray(r["realized"], np.float64))
        ccds.append(dict(_ccd_plan(r), det=r["det_name"], npz=npz))

    _build.reset_launches()
    rc = CLI.main([*argv, "--device", device, "-q"], on_result=keep)
    with open(f"{prefix}.{rank}.json", "w") as f:
        json.dump(dict(rc=rc, launches=dict(_build.LAUNCHES), ccds=ccds,
                       wall=time.perf_counter() - T0), f)
    return rc


def _mesh_launch(device, root: str, tag: str, argv: list, world: int = 2):
    """Start `world` ranks of mesh_child sharing this card (gloo): the
    processes, their log files and the output prefix."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    prefix = os.path.join(root, f"mesh_{tag}")
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out = open(f"{prefix}.{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--mesh-child", prefix, device.type, *argv], env=env,
            stdout=out, stderr=subprocess.STDOUT, start_new_session=True),
            out))
    return procs, prefix, time.perf_counter()


def _mesh_wait(launch) -> tuple:
    """Wait for a launch's ranks (killed at MESH_TIMEOUT); returns (each
    rank's JSON, the ranks' longest wall from their start to their files
    written, the launches summed over the ranks)."""
    import signal

    procs, prefix, t0 = launch
    try:
        for p, _ in procs:
            p.wait(timeout=max(MESH_TIMEOUT - (time.perf_counter() - t0),
                               1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, out in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            out.close()
    codes = [p.returncode for p, _ in procs]
    if codes != [0] * len(procs):
        for r in range(len(procs)):
            with open(f"{prefix}.{r}.log") as f:
                log(f"[mesh] rank {r} of {os.path.basename(prefix)} "
                    f"(exit {codes[r]}), log tail:\n" + f.read()[-3000:])
        _check(False, f"{os.path.basename(prefix)}: ranks exited {codes}")
    outs = []
    for r in range(len(procs)):
        with open(f"{prefix}.{r}.json") as f:
            outs.append(json.load(f))
    total = {k: sum(o["launches"][k] for o in outs)
             for k in outs[0]["launches"]}
    return outs, max(o["wall"] for o in outs), total


def _same_files(a: str, b: str, dets) -> dict:
    """{file: bit-equal} of the eimage, RICE amp and truth files of
    `dets` in directories a and b; an eimage that differs is logged with
    its count of differing pixels and their largest gap."""
    import numpy as np

    from imsim_tpu_torch.io.fits import read_fits

    out = {}
    for det in dets:
        for name in (f"eimage_{det}.fits", f"amp_{det}.fits",
                     f"centroid_{det}.txt"):
            pa, pb = os.path.join(a, name), os.path.join(b, name)
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                out[name] = fa.read() == fb.read()
            if name.startswith("eimage") and not out[name]:
                (_, x), = read_fits(pa)
                (_, y), = read_fits(pb)
                gap = np.abs(x.astype(np.float64) - y)
                log(f"[mesh] {name}: {int((gap > 0).sum())} pixels differ, "
                    f"largest gap {gap.max():.4g}")
    return out


def phase_mesh(device, small: bool, root: str, wl) -> dict:
    """Phase 11's visit over several ranks (output.mesh), under phase
    11's directory: (z) the two CCDs in this process with output.mesh=1
    (a group of one: NCCL on the card, gloo in the rehearsal), their
    eimage, amp and truth files bit-equal to phase 11's serial files;
    (aa) two ranks sharing the card on gloo with {ccd: 2, phot: 1}, files
    bit-equal to (z)'s; (ab) two ranks with {ccd: 1, phot: 2} on
    R22_S11: per-object realized within 1e-6 relative and the render
    before the sky within 1e-6 of its max of a one-rank visit with
    image.sensor.type none, and with the silicon on the charge within 2%
    of (z)'s (brighter-fatter sees the image of the previous outer step
    on each rank); the rank launches start together with this process's
    visit of the same stage.  (ac) the native tokenizer against the
    Python loop on the workload catalog.  Kernel launches: each run's
    sum over its ranks equals its plan.  Returns the paths' launches."""
    import numpy as np

    from imsim_tpu_torch.electronics.camera import get_camera

    t0 = time.perf_counter()
    cam = get_camera()
    base = [os.path.join(root, "visit.yaml"), "output.opd.enabled=false"]
    one = base + [f"output.det_num=[{cam.det_num(MESH_DET)}]"]
    # the rehearsal's one batch would leave the second photon rank idle
    none = ["image.sensor.type=none"] + (["image.nbatch=3"] if small
                                         else [])
    d = {k: os.path.join(root, f"mesh_{k}_out")
         for k in ("z", "aa", "zn", "abn", "abs")}

    aa = _mesh_launch(device, root, "aa", base + [
        f"output.dir={d['aa']}", "output.mesh={ccd: 2, phot: 1}"])
    res_z, wall_z, l_z = _cli(device, base + [f"output.dir={d['z']}",
                                              "output.mesh=1"])
    outs_aa, wall_aa, l_aa = _mesh_wait(aa)
    want_z = _plan_launches(device, res_z)
    same_z = _same_files(os.path.join(root, "ccds"), d["z"], VISIT_DETS)
    log(f"[mesh] (z): output.mesh=1, one rank ("
        f"{'nccl' if device.type == 'cuda' else 'gloo'}), 2 CCDs through the"
        f" CLI in {wall_z:.2f} s: launches {l_z} (plan {want_z}); files "
        f"against phase 11's serial visit: "
        + ", ".join(f"{k} {'bit-equal' if v else 'DIFFER'}"
                    for k, v in same_z.items()))
    _check(all(same_z.values()) and
           [r["det_name"] for r in res_z] == list(VISIT_DETS),
           "the mesh-of-one visit's files differ from the serial visit's")
    _check(device.type != "cuda" or l_z == want_z,
           f"mesh_visit launches {l_z} != {want_z}")
    same_aa = _same_files(d["z"], d["aa"], VISIT_DETS)
    wrote = [[c["det"] for c in o["ccds"]] for o in outs_aa]
    want_aa = _plan_of([c for o in outs_aa for c in o["ccds"]])
    log(f"[mesh] (aa): {{ccd: 2, phot: 1}}, 2 ranks on gloo sharing the "
        f"card, {wall_aa:.2f} s a rank (process start to files): rank 0 "
        f"wrote "
        f"{wrote[0]}, rank 1 {wrote[1]}; launches summed over the ranks "
        f"{l_aa} (plan {want_aa}); files against (z): "
        + ", ".join(f"{k} {'bit-equal' if v else 'DIFFER'}"
                    for k, v in same_aa.items()))
    _check(all(same_aa.values()) and wrote == [[VISIT_DETS[0]],
                                                [VISIT_DETS[1]]],
           "the two CCD ranks' files differ from (z)'s")
    _check(device.type != "cuda" or l_aa == want_aa,
           f"mesh_ranks_ccd launches {l_aa} != {want_aa}")

    phot = "output.mesh={ccd: 1, phot: 2}"
    abn = _mesh_launch(device, root, "abn", one + none + [
        f"output.dir={d['abn']}", phot])
    # the rehearsal leaves the silicon to the card: the BF stencil's
    # plain twin takes tens of seconds over the full frame on the CPU
    abs_ = None if small else _mesh_launch(device, root, "abs", one + [
        f"output.dir={d['abs']}", phot])
    res_zn, wall_zn, _ = _cli(device, one + none + [f"output.dir={d['zn']}",
                                                    "output.mesh=1"])
    outs_n, wall_n, l_n = _mesh_wait(abn)
    ref = res_zn[0]
    ref_img = ref["image"].cpu().numpy()
    (c_n,) = outs_n[0]["ccds"]
    with np.load(c_n["npz"]) as z:
        img_n, real_n = z["image"], z["realized"]
    r_gap = float(np.max(np.abs(real_n - ref["realized"])
                         / np.maximum(np.abs(ref["realized"]), 1e-300)))
    i_gap = float(np.abs(img_n - ref_img).max() / ref_img.max())
    want_n = _plan_of([c_n])
    log(f"[mesh] (ab) sensor none: {{ccd: 1, phot: 2}} on {MESH_DET}, "
        f"{wall_n:.2f} s a rank (process start to files; one rank in this "
        f"process {wall_zn:.2f} s); only rank 0 wrote: "
        f"{'yes' if not outs_n[1]['ccds'] else 'NO'}; launches {l_n} "
        f"(plan {want_n}); realized max rel gap {r_gap:.3g} (bar 1e-6) "
        f"over {len(real_n)} objects; render before the sky max gap "
        f"{i_gap:.3g} of its max {ref_img.max():.1f} (bar 1e-6)")
    _check(not outs_n[1]["ccds"] and r_gap <= 1e-6 and i_gap <= 1e-6,
           "the photon ranks' render is off the one-rank render")
    _check(device.type != "cuda" or l_n == want_n,
           f"mesh_ranks_phot launches {l_n} != {want_n}")
    l_phot = dict(l_n)
    if abs_ is not None:
        outs_s, wall_s, l_s = _mesh_wait(abs_)
        (c_s,) = outs_s[0]["ccds"]
        with np.load(c_s["npz"]) as z:
            q_s = float(z["image"].sum(dtype=np.float64))
        r_z = next(r for r in res_z if r["det_name"] == MESH_DET)
        q_z = float(r_z["image"].double().sum())
        want_s = _plan_of([c_s])
        log(f"[mesh] (ab) silicon: {wall_s:.2f} s a rank; "
            f"launches {l_s} (plan {want_s}); charge {q_s:.6g} against "
            f"(z)'s {q_z:.6g}: rel gap {q_s / q_z - 1:+.3g} (bar 2%)")
        _check(abs(q_s / q_z - 1) < 0.02 and
               (device.type != "cuda" or l_s == want_s),
               "the photon ranks' silicon render is off (z)'s")
        l_phot = {k: l_n[k] + l_s[k] for k in l_n}
    _mesh_tokenizer(wl)
    log(f"[mesh] phase 13 took {time.perf_counter() - t0:.1f} s")
    return dict(mesh_visit=l_z, mesh_ranks_ccd=l_aa, mesh_ranks_phot=l_phot)


def _mesh_tokenizer(wl):
    """(ac): the native tokenizer's table against the Python loop's on the
    visit's catalog: every column bit-equal but the two where the JAX
    package's two paths differ too (a Sersic index at a rounding tie of
    20 n, 0.05 apart; mu in its last bits, at most 2 ulp)."""
    import numpy as np

    from imsim_tpu_torch.catalog import instcat as IC

    path = wl["catalog"]["r"]
    t = time.perf_counter()
    nat, n1 = IC._parse_instcat(path)
    t_nat = time.perf_counter() - t
    t = time.perf_counter()
    py, n2 = IC._parse_instcat(path, force_python=True)
    t_py = time.perf_counter() - t
    cols = ("ra", "dec", "magnorm", "redshift", "g1", "g2", "mu", "p0",
            "p1", "p2", "p3", "int_av", "int_rv", "mw_av", "mw_rv")
    diff = {c: int(np.sum(getattr(nat, c) != getattr(py, c))) for c in cols}
    strings = all(list(getattr(nat, c)) == list(getattr(py, c))
                  for c in ("id", "sed_name", "image_file")) and \
        np.array_equal(nat.obj_type, py.obj_type)
    d1 = np.nonzero(nat.p1 != py.p1)[0]
    mid = 10.0 * (nat.p1[d1] + py.p1[d1])
    ties = bool(np.all(nat.obj_type[d1] == IC.SERSIC) and np.allclose(
        np.abs(nat.p1[d1] - py.p1[d1]), 0.05, rtol=1e-9) and np.allclose(
        mid - np.floor(mid), 0.5, atol=1e-9))
    dm = np.nonzero(nat.mu != py.mu)[0]
    ulp = np.maximum(np.spacing(nat.mu[dm]), np.spacing(py.mu[dm]))
    mu_ok = bool(np.all(np.abs(nat.mu[dm] - py.mu[dm]) <= 2 * ulp))
    others = {c: v for c, v in diff.items() if v and c not in ("p1", "mu")}
    log(f"[mesh] (ac): the native tokenizer on the visit's catalog "
        f"({n1} object lines, {len(nat)} rows): {t_nat:.3f} s against the "
        f"Python loop's {t_py:.3f} s; ids, SEDs, types "
        f"{'equal' if strings else 'DIFFER'}; rows off the loop's: p1 "
        f"{diff['p1']} (Sersic rounding ties: {'yes' if ties else 'NO'}), "
        f"mu {diff['mu']} (<= 2 ulp: {'yes' if mu_ok else 'NO'}), every "
        f"other column {'bit-equal' if not others else others}")
    _check(n1 == n2 and strings and ties and mu_ok and not others,
           "the native tokenizer's table is off the Python loop's")


def run(device, small: bool = False) -> dict:
    """Phases 2-13 on `device`; returns the kernel report.  Each row's
    `launches` is the bench CCD's (phase 4; the probes' for K4 and P1-P7)
    and `launches_by_path` the count on every path that drives it
    (`itl_ccd`: phase 9's CCD built from the pointing; `instcat_ccd`:
    phase 10's CCD from the instance catalog, its cold r render;
    `visit_yaml`: phase 11's two-CCD visit through the CLI;
    `skycat_ccd`, `skycat_native`: phase 12's CCDs from the mapped and
    the native sky catalog; `mesh_visit`: phase 13's output.mesh=1 visit,
    `mesh_ranks_ccd` and `mesh_ranks_phot`: its two-rank visits, summed
    over the ranks)."""
    import torch

    _import_port()
    from imsim_tpu_torch.benchmarks._util import workload

    device = torch.device(device)
    if device.type == "cuda":
        phase_build()
    state, host, cfg, ctx = workload(device, small)
    rows, nb = phase_kernels(device, state, host, cfg, ctx, small)
    res = phase_ccd(device, state, host, cfg, ctx, nb, small)
    del host
    paths = dict(bench_ccd=res["launches"])
    for row in rows:
        row["launches"] = res["launches"][row["name"]]
    probe_rows, paths["probes"] = phase_probes(device, small)
    rows += probe_rows
    paths["analytic_ccd"] = phase_analytic(device, small)["cold"]["launches"]
    flats = phase_flats(device, state, small)
    paths["flat"], paths["photon_flat"] = flats["flat"], flats["photon_flat"]
    modes = phase_modes(device, state, small)
    paths["bf_mode_photon"], paths["bf_mode_image"] = (modes["photon"],
                                                       modes["image"])
    del state
    paths["itl_ccd"] = phase_pointing(device, small)["launches"]
    with _traced():
        paths["instcat_ccd"] = phase_instcat(device, small)
    root = visit_root(small)
    try:
        with _traced():
            paths["visit_yaml"], wl = phase_visit(device, small, root)
            paths["skycat_ccd"], paths["skycat_native"] = phase_skycat(
                device, small)
        paths.update(phase_mesh(device, small, root, wl))
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items()
                                   if c[row["name"]]}
    log("[launches] per path: " + json.dumps(
        {p: {k: v for k, v in c.items() if v} for p, c in paths.items()}))
    return {"kernels": rows}


@contextlib.contextmanager
def _traced():
    """Tracing on (imsim_tpu_torch.utils.trace) for phases that print
    the runner's step seconds: its steps synchronise the card only while
    tracing is on, so that the seconds hold their device work."""
    from imsim_tpu_torch.utils import trace

    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def main() -> int:
    _import_port()
    name, count, _ = phase_device()
    import torch

    report = run(torch.device("cuda"))
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
