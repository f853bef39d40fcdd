"""Drive the PyTorch/CUDA port's pooled full-physics CCD render on one
NVIDIA GPU, end to end, and check it.

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
     1e-5 of max |out| of the twin);
  4. the slice: render_ccd_pooled on that workload, cold and warm, with
     launch counts, peak memory, charge accounting and landed fraction;
  5. the probes: the three on-chip probe paths at their own sizes
     (imsim_tpu_torch.benchmarks.probe_rows at 24 x 16,777,216,
     probe_pallas and probe_pallas2 on 4096^2 frames with k = 9), each
     of K4 and P1-P7 held against its plain twin, with launch counts,
     bounds and one-call yardsticks (K4: torch.cumsum; P1-P3: their
     twins' single call; P4-P7: one float32 conv2d each);
  6. the kernel report (JSON, all eleven kernels, with bound_ms,
     bound_by and library_ms) and, last, the ok line.

The script needs CUDA and refuses to run without it.  `run()` takes a
device and a size so the CPU tests can rehearse the same phases at a
tiny size with the kernels' plain twins.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

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


def phase_kernels(device, state, host, cfg, ctx):
    """Each kernel against its plain twin on the same inputs, at the
    main path's shapes.  Returns the report rows (launches filled in
    later)."""
    import numpy as np
    import torch

    from imsim_tpu_torch.benchmarks._util import (PX_RAD, Timer, bound,
                                                  check_kernel, conv2d_fp32)
    from imsim_tpu_torch.image import photon_pooling as PP
    from imsim_tpu_torch.ops import raychain, scanrows, stencil
    from imsim_tpu_torch.sensor.silicon import bf_taps

    timer = Timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    rows = []

    # ---- K1 at batch 0's slot layout -----------------------------------
    modes = PP.classify_objects(host, cfg)
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
    log(f"[K1] (C, pe, mp) = ({C}, {pe}, {mp}), {n_obj_b} objects in "
        f"batch 0")
    log("[K1] kernel-vs-plain gap per column: "
        + " ".join(f"{g:.3g}" for g in gap.tolist()))
    log(f"[K1] field-angle gap vs direct gather mat[obj_idx]: "
        f"x {float(vs_gather[0]) / PX_RAD:.4g} px, "
        f"y {float(vs_gather[1]) / PX_RAD:.4g} px (reference budget 0.05)")
    bad = np.nonzero(gap.numpy() > tol)[0]
    if len(bad):
        raise AssertionError(f"K1 columns {bad.tolist()} exceed "
                             f"sqrt(n) ulp: {gap.numpy()[bad]} > {tol[bad]}")
    # bound: one add per element, d read and the rows written once; no
    # single PyTorch call computes the slot-order scan
    rows.append(dict(
        name="scan_slot_prefix", route="cuda",
        source="imsim_tpu_torch/csrc/scanrows.cu",
        replaces="imsim_tpu/ops/scanrows.py:183",
        max_abs_err=float(gap.max()),
        ms=timer.ms(lambda: scanrows.scan_slot_prefix(d, pair, share)),
        plain_ms=timer.ms(lambda: scanrows.scan_slot_prefix_plain(
            d, pair, share)),
        library_ms=None, **bound(d.numel(), 8 * d.numel())))
    field = (got.reshape(C, N)[0].contiguous(),
             got.reshape(C, N)[1].contiguous())
    del d, got, want, gather, obj_map

    # ---- K2 on the batch's photons (fused and plain forms) -------------
    u = lambda lo=0.0, hi=1.0: torch.rand(  # noqa: E731
        N, generator=gen, device=device) * (hi - lo) + lo
    r = torch.sqrt(u(2.558**2, 4.18**2))
    a = u(0.0, 2 * np.pi)
    args = (field[0], field[1], r * torch.cos(a), r * torch.sin(a),
            u(552.0, 691.0), u(0.0, 30.0), torch.ones(N, device=device),
            torch.randn(N, generator=gen, device=device))
    draws = (u(1e-7, 1.0), torch.randn(N, generator=gen, device=device),
             torch.randn(N, generator=gen, device=device))

    def k2(fn, fused):
        kw = dict(silicon=state.silicon, si_draws=draws) if fused else {}
        return fn(state.tel, ctx, *args, **kw)

    k2_err = 0.0
    for fused in (False, True):
        ref = k2(raychain.field_to_sensor_plain, fused)
        out = k2(raychain.field_to_sensor, fused)
        gaps = raychain.chain_gaps(ref, out, ctx, *args[2:6], args[7])
        form = "fused" if fused else "plain"
        log(f"[K2] {form} form: {json.dumps(gaps)}")
        if not raychain.gaps_ok(gaps, fused):
            raise AssertionError(f"K2 {form} form disagrees with its plain "
                                 f"twin")
        k2_err = max(k2_err, gaps["dxy"])
    # bound: chain_flops per photon (counted from csrc/raychain.cu) and
    # 11 float32 inputs read, 3 written per photon (the fused form
    # timed); no single PyTorch call computes the chain
    flops = raychain.chain_flops(raychain.chain_params(
        state.tel, ctx, True, True, True, state.silicon))
    log(f"[K2] {flops} operations per photon (ops/raychain.chain_flops)")
    rows.append(dict(
        name="field_to_sensor", route="cuda",
        source="imsim_tpu_torch/csrc/raychain.cu",
        replaces="imsim_tpu/ops/raychain.py:158", max_abs_err=k2_err,
        ms=timer.ms(lambda: k2(raychain.field_to_sensor, True)),
        plain_ms=timer.ms(lambda: k2(raychain.field_to_sensor_plain, True),
                          reps=1),
        library_ms=None, **bound(flops * N, 4 * 14 * N)))
    del args, draws, field, ref, out

    # ---- K3 on a full frame ---------------------------------------------
    H, W = cfg.ysize, cfg.xsize
    img = torch.rand((H, W), generator=gen, device=device) * 1e5
    # the render's taps: host tensors, passed by value to the kernel
    dkx, dky = bf_taps(state.silicon)
    k = dkx.shape[0]
    # the yardstick: one float32 conv2d with both tap sets as channels
    wt = torch.stack([dkx, dky])[:, None].to(device)
    r3 = check_kernel(
        timer, lambda: stencil.stencil_pair(img, dkx, dky),
        lambda: stencil.stencil_pair_plain(img, dkx, dky), 1e-5,
        (4 * k * k * H * W, 12 * H * W),
        lambda: conv2d_fp32(img[None, None], wt, padding=k // 2)[0]
        .unbind(0))
    log(f"[K3] {H}x{W}, k={k}: max gap {r3['max_abs_err']:.3g} = "
        f"{r3['max_abs_err'] / r3['scale']:.3g} of max |out| (<= 1e-5); "
        f"conv2d (TF32 off) {r3['library_err'] / r3['scale']:.3g} of max "
        f"|out| (<= 1e-5)")
    if r3["within"] > 1.0:
        raise AssertionError("K3 disagrees with its plain twin")
    rows.append(dict(
        name="stencil_pair", route="cuda",
        source="imsim_tpu_torch/csrc/stencil.cu",
        replaces="imsim_tpu/ops/stencil.py:71",
        **{key: r3[key] for key in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")}))
    for row in rows:
        log_kernel(row)
    return rows, nb


def phase_slice(device, state, host, cfg, ctx, nb):
    """render_ccd_pooled cold then warm; launch counts from each run."""
    import torch

    from imsim_tpu_torch.benchmarks._util import Timer
    from imsim_tpu_torch.image.photon_pooling import render_ccd_pooled
    from imsim_tpu_torch.ops import _build
    from imsim_tpu_torch.psf.atmosphere import make_screens
    from imsim_tpu_torch.utils.rng import ATM_SEED_OFFSET, stream

    timer = Timer(device)
    screens = make_screens(state.screen_spec, device,
                           gen=stream(42 + ATM_SEED_OFFSET, "screens",
                                      device=device))
    # the render launches K1-K3 and none of the probes' kernels
    expect = dict({k: 0 for k in _build.LAUNCHES}, scan_slot_prefix=nb,
                  field_to_sensor=nb, stencil_pair=nb * cfg.nsub)
    result = {}
    for label in ("cold", "warm"):
        tally = {}
        if timer.cuda:
            torch.cuda.reset_peak_memory_stats()
        timer.sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        image, _ = render_ccd_pooled(
            0, host, cfg, state.silicon, state.tel, ctx, screens,
            state.sk_table, profiles=state.profiles, tally=tally)
        timer.sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        want = expect if timer.cuda else {k: 0 for k in expect}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30 \
            if timer.cuda else float("nan")
        if tuple(image.shape) != (cfg.ysize, cfg.xsize) \
                or not bool(torch.isfinite(image).all()):
            raise AssertionError("image is not finite / has the wrong shape")
        img_sum = float(image.sum(dtype=torch.float64))
        in_frame = float(tally["in_frame"])
        pooled = float(tally["pooled"])
        rel = abs(img_sum - in_frame) / max(in_frame, 1.0)
        landed = in_frame / pooled
        log(f"[slice] {label}: {wall:.3f} s wall, peak device memory "
            f"{peak:.2f} GiB, launches {launches}")
        log(f"[slice] {label}: pooled photons {pooled:.0f}, in-frame flux "
            f"{in_frame:.1f}, image sum {img_sum:.1f} (rel gap {rel:.3g} "
            f"<= 1e-4), landed fraction {landed:.6f} (> 0.8)")
        if rel > 1e-4 or landed <= 0.8:
            raise AssertionError("charge accounting or landed fraction "
                                 "out of bounds")
        if label == "cold":
            result = dict(launches=launches, wall_cold=wall)
        else:
            result["wall_warm"] = wall
    return result


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
    Returns the report rows of K4 and P1-P7."""
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
    return report


def run(device, small: bool = False) -> dict:
    """Phases 2-5 on `device`; returns the kernel report."""
    import torch

    _import_port()
    from imsim_tpu_torch.benchmarks._util import workload

    device = torch.device(device)
    if device.type == "cuda":
        phase_build()
    state, host, cfg, ctx = workload(device, small)
    rows, nb = phase_kernels(device, state, host, cfg, ctx)
    res = phase_slice(device, state, host, cfg, ctx, nb)
    for row in rows:
        row["launches"] = res["launches"][row["name"]]
    rows += phase_probes(device, small)
    return {"kernels": rows}


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
    sys.exit(main())
