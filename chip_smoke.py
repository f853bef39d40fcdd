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
     6 batches, pair 4, share 4), with CUDA-event times;
  4. the slice: render_ccd_pooled on that workload, cold and warm, with
     launch counts, peak memory, charge accounting and landed fraction;
  5. the kernel report (JSON) and, last, the ok line.

The script needs CUDA and refuses to run without it.  `run()` takes a
device and a size so the CPU tests can rehearse the same phases at a
tiny size with the kernels' plain twins.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the bench workload (bench.py main()): NB = 6 batches of the pooled
# photons; batch_size is set high enough that pooled_plan keeps NB = 6
BENCH_CFG = dict(nbatch=6, batch_size=30_000_000, pupil_pairing=4,
                 screen_share=4, nsub=4)
PX_RAD = 0.2 / 3600 * 3.141592653589793 / 180   # 1 pixel in radians


def log(*a):
    print(*a, flush=True)


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


class Timer:
    """Warm per-call milliseconds: CUDA events on the card, the host
    clock on the CPU (rehearsal only; not a device time)."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, fn, reps=3):
        fn()
        self.sync()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        e0 = self.torch.cuda.Event(enable_timing=True)
        e1 = self.torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        self.torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps


def workload(device, small: bool):
    """(state, host, cfg, ctx): the bench scene on `device`, or for the
    rehearsal a 500-object scene around the CCD centre seen through a
    512 x 512 detector window."""
    from imsim_tpu_torch.convert import load_ccd_state, synthetic_scene
    from imsim_tpu_torch.image.photon_pooling import PoolingConfig

    import numpy as np

    state = load_ccd_state(device=device)
    if not small:
        host = synthetic_scene(state, device)
        cfg = PoolingConfig(xsize=state.nx, ysize=state.ny, **BENCH_CFG)
        return state, host, cfg, state.ctx
    n = 500
    cx, cy = np.median(state.thx), np.median(state.thy)
    near = np.nonzero(np.hypot(state.thx - cx, state.thy - cy)
                      < 180 * PX_RAD)[0][:n]
    host = synthetic_scene(
        state, device, n_obj=n, total_photons=3e5, n_bright=0,
        field_angles=lambda x, y: (state.thx[near], state.thy[near]),
        modes=None)
    cfg = PoolingConfig(xsize=512, ysize=512, **dict(BENCH_CFG, nbatch=2))
    ctx = dataclasses.replace(state.ctx, det_nx=512, det_ny=512)
    return state, host, cfg, ctx


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
    rows.append(dict(
        name="scan_slot_prefix", route="cuda",
        source="imsim_tpu_torch/csrc/scanrows.cu",
        replaces="imsim_tpu/ops/scanrows.py:183",
        max_abs_err=float(gap.max()),
        ms=timer.ms(lambda: scanrows.scan_slot_prefix(d, pair, share)),
        plain_ms=timer.ms(lambda: scanrows.scan_slot_prefix_plain(
            d, pair, share))))
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
    rows.append(dict(
        name="field_to_sensor", route="cuda",
        source="imsim_tpu_torch/csrc/raychain.cu",
        replaces="imsim_tpu/ops/raychain.py:158", max_abs_err=k2_err,
        ms=timer.ms(lambda: k2(raychain.field_to_sensor, True)),
        plain_ms=timer.ms(lambda: k2(raychain.field_to_sensor_plain, True),
                          reps=1)))
    del args, draws, field, ref, out

    # ---- K3 on a full frame ---------------------------------------------
    img = torch.rand((cfg.ysize, cfg.xsize), generator=gen,
                     device=device) * 1e5
    dkx, dky = bf_taps(state.silicon)
    ox, oy = stencil.stencil_pair(img, dkx, dky)
    px_, py_ = stencil.stencil_pair_plain(img, dkx, dky)
    scale = max(float(px_.abs().max()), float(py_.abs().max()))
    err = max(float((ox - px_).abs().max()), float((oy - py_).abs().max()))
    log(f"[K3] {cfg.ysize}x{cfg.xsize}, k={dkx.shape[0]}: max gap "
        f"{err:.3g} = {err / scale:.3g} of max |out| (<= 1e-5)")
    if err > 1e-5 * scale:
        raise AssertionError("K3 disagrees with its plain twin")
    rows.append(dict(
        name="stencil_pair", route="cuda",
        source="imsim_tpu_torch/csrc/stencil.cu",
        replaces="imsim_tpu/ops/stencil.py:70", max_abs_err=err,
        ms=timer.ms(lambda: stencil.stencil_pair(img, dkx, dky)),
        plain_ms=timer.ms(lambda: stencil.stencil_pair_plain(img, dkx,
                                                             dky))))
    for row in rows:
        log(f"[kernels] {row['name']}: {row['ms']:.3f} ms "
            f"(plain twin {row['plain_ms']:.3f} ms)")
    return rows, nb


def phase_slice(device, state, host, cfg, ctx, nb):
    """render_ccd_pooled cold then warm; launch counts from each run."""
    import torch

    from imsim_tpu_torch.image.photon_pooling import render_ccd_pooled
    from imsim_tpu_torch.ops import _build
    from imsim_tpu_torch.psf.atmosphere import make_screens
    from imsim_tpu_torch.utils.rng import ATM_SEED_OFFSET, stream

    timer = Timer(device)
    screens = make_screens(state.screen_spec, device,
                           gen=stream(42 + ATM_SEED_OFFSET, "screens",
                                      device=device))
    expect = dict(scan_slot_prefix=nb, field_to_sensor=nb,
                  stencil_pair=nb * cfg.nsub)
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


def run(device, small: bool = False) -> dict:
    """Phases 2-4 on `device`; returns the kernel report."""
    import torch

    _import_port()
    device = torch.device(device)
    if device.type == "cuda":
        phase_build()
    state, host, cfg, ctx = workload(device, small)
    rows, nb = phase_kernels(device, state, host, cfg, ctx)
    res = phase_slice(device, state, host, cfg, ctx, nb)
    for row in rows:
        row["launches"] = res["launches"][row["name"]]
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
