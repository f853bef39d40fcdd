"""Ranks for the port's multi-rank tests, on the CPU: `spawn` processes
that meet in a `file://` store under the test's tmp_path, initialize a
gloo group (imsim_tpu_torch.parallel.mesh.init_group), run one task of
TASKS and pickle its result for the parent.  The parent joins with a
timeout and kills what is left.  This module imports the port only
(no JAX), so a rank starts in a few seconds."""
import os
import pickle


def spawn(task: str, world: int, tmp_path, timeout: float = 150.0,
          **kwargs) -> list:
    """Run TASKS[task](**kwargs) on `world` gloo ranks; returns each
    rank's result, in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    d = os.path.join(str(tmp_path), f"ranks_{task}_{os.getpid()}_"
                     f"{len(os.listdir(str(tmp_path)))}")
    os.makedirs(d)
    procs = [ctx.Process(target=_child, args=(task, r, world, d, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    codes = [p.exitcode for p in procs]
    errors = [open(os.path.join(d, f"err.{r}")).read()
              for r in range(world) if os.path.exists(
                  os.path.join(d, f"err.{r}"))]
    assert codes == [0] * world, (codes, errors)
    out = []
    for r in range(world):
        with open(os.path.join(d, f"out.{r}"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(task, rank, world, d, kwargs):
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    from imsim_tpu_torch.parallel.mesh import init_group

    torch.set_num_threads(1)
    try:
        init_group("cpu", f"file://{os.path.join(d, 'store')}", rank, world)
        try:
            res = TASKS[task](**kwargs)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(d, f"out.{rank}"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(d, f"err.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _visit(cfg, overrides, keep=("eimage", "realized", "image")):
    """config.runner.run_visit_iter on this rank: [(det_name, {key:
    numpy})] of the CCDs this rank wrote."""
    import torch

    from imsim_tpu_torch.config import runner as TR

    out = []
    for r in TR.run_visit_iter(cfg, overrides, device="cpu"):
        out.append((r["det_name"], {
            k: (r[k].cpu().numpy() if isinstance(r[k], torch.Tensor)
                else r[k]) for k in keep}))
    return out


def _cli(argv):
    """The CLI in this rank (its group already initialized)."""
    from imsim_tpu_torch import __main__ as CLI

    names = []
    assert CLI.main([*argv, "--device", "cpu", "-q"],
                    on_result=lambda r: names.append(r["det_name"])) == 0
    return names


def _topology(local_world_size):
    """parallel.multihost.detect_topology on this rank's group, with
    torchrun's LOCAL_WORLD_SIZE set to `local_world_size`."""
    from imsim_tpu_torch.parallel.multihost import detect_topology

    os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    return detect_topology()


def _window_pass(cfg, overrides, det, window, mesh_cfg):
    """parallel.visit.render_mesh_pass of one windowed CCD (prepare_ccd
    window=) on this rank's mesh: (image, realized) numpy."""
    from imsim_tpu_torch.config import runner as TR
    from imsim_tpu_torch.config.interpreter import load_config
    from imsim_tpu_torch.parallel import visit as V
    from imsim_tpu_torch.parallel.mesh import make_mesh

    import torch.distributed as dist

    ctx = TR.build_visit_context(load_config(cfg, overrides))
    prep = TR.prepare_ccd(ctx, det, window=window, device="cpu")
    mesh = make_mesh(*V._parse_mesh_cfg(mesh_cfg, dist.get_world_size()),
                     "cpu")
    image, _, realized = V.render_mesh_pass(ctx, prep, mesh, 0, {})
    return image.numpy(), realized


def _sharded(n_phot_axis):
    """__graft_entry__'s dryrun on this rank's mesh through the port's
    run_visit_sharded: (images, wide images, expected flux)."""
    import dataclasses

    import numpy as np
    import torch

    from imsim_tpu_torch import convert
    from imsim_tpu_torch.electronics.camera import get_camera
    from imsim_tpu_torch.image.scene import WL_CDF_K, DeviceScene, \
        SceneHost
    from imsim_tpu_torch.optics.wcs_factory import make_wcs_factory
    from imsim_tpu_torch.parallel import visit as V
    from imsim_tpu_torch.parallel.mesh import make_mesh
    from imsim_tpu_torch.psf.atmosphere import AtmConfig, \
        second_kick_table
    from imsim_tpu_torch.sensor.silicon import SiliconParams

    import torch.distributed as dist

    deg = np.pi / 180
    n_ccd = dist.get_world_size() // n_phot_axis
    mesh = make_mesh(n_ccd, n_phot_axis, "cpu")
    img, n_phot = 64, 2048
    fac = make_wcs_factory(30 * deg, -20 * deg, mjd=60674.2, band="r")
    ccd = get_camera("LsstCamSim")["R22_S11"]
    wcs, tel, octx = convert.ccd_optics(fac, ccd)

    def host(seed):
        rng = np.random.default_rng(seed)
        nx, ny = ccd.bounds.width, ccd.bounds.height
        x = (nx - 1) / 2 + rng.uniform(-img / 3, img / 3, 8)
        y = (ny - 1) / 2 + rng.uniform(-img / 3, img / 3, 8)
        thx, thy = fac.icrf_to_field(*wcs.xy_to_radec(x, y))
        wl = np.linspace(550.0, 690.0, WL_CDF_K, dtype=np.float32)
        scene = DeviceScene.from_columns(
            x=thx, y=thy, obj_type=rng.integers(0, 2, 8),
            p0=rng.uniform(0.3, 1.5, 8), p1=np.full(8, 1.0),
            p2=rng.uniform(0.3, 1.0, 8), p3=np.zeros(8), g1=np.zeros(8),
            g2=np.zeros(8), mu=np.ones(8),
            wl_icdf=np.broadcast_to(wl, (8, WL_CDF_K)), device="cpu")
        flux = np.full(8, n_phot // 8, np.float64)
        return SceneHost(scene=scene, flux=flux, nominal_flux=flux,
                         n_objects=8)

    hosts = [host(i) for i in range(n_ccd)]
    sk_y = torch.as_tensor(np.asarray(second_kick_table(
        AtmConfig(fwhm=0.8), 622.0).y, np.float32))
    sil = SiliconParams.make()
    out = []
    for size in (img, 4 * img):
        ctxs = [(tel, dataclasses.replace(octx, det_nx=size, det_ny=size))
                for _ in range(n_ccd)]
        cfg = dataclasses.make_dataclass("Cfg", [])()
        cfg.xsize = cfg.ysize = size
        cfg.exptime, cfg.batch_size, cfg.nsub = 30.0, n_phot, 2
        out.append(V.run_visit_sharded(ctxs, hosts, mesh, cfg, sk_y=sk_y,
                                       silicon=sil, seed=0).numpy())
    return out[0], out[1], float(n_phot)


DETS = ("R22_S10", "R22_S11")


def two_ccd_catalog(d):
    """(catalog, sed_dir) under the pathlib directory `d`: six objects on
    each of R22_S10 and R22_S11 (tests/test_config_pipeline.py's header,
    flat SED and line forms), one of each in the CCD's central window."""
    import numpy as np

    from imsim_tpu_torch.electronics.camera import get_camera
    from imsim_tpu_torch.optics.wcs_factory import make_wcs_factory

    deg = np.pi / 180
    (d / "flatSED").mkdir()
    w = np.linspace(300, 1150, 200)
    np.savetxt(d / "flatSED" / "sed_flat.txt",
               np.column_stack([w, np.ones_like(w)]))
    lines = ["rightascension 30.0", "declination -20.0", "mjd 60674.2",
             "filter 2", "seeing 0.7", "vistime 30.0", "rottelpos 0.0",
             "obshistid 4242", "altitude 60.0"]
    fac = make_wcs_factory(30 * deg, -20 * deg, 60674.2, band="r")
    cam = get_camera()
    rng = np.random.default_rng(12)
    i = 0
    for det in DETS:
        wcs = fac.get_wcs(cam[det])
        # one object in the central window of the silicon test
        xs, ys = rng.uniform(600, 3400, 6), rng.uniform(600, 3400, 6)
        xs[0], ys[0] = 2060.0, 1990.0
        ra, dec = wcs.xy_to_radec(xs, ys)
        for r, dd in zip(np.degrees(ra), np.degrees(dec)):
            mag = rng.uniform(20.0, 22.5)
            if i % 2 == 0:
                lines.append(f"object {i} {r:.6f} {dd:.6f} {mag:.2f} "
                             "flatSED/sed_flat.txt 0 0 0 0 0 0 point none "
                             "none")
            else:
                lines.append(f"object {i} {r:.6f} {dd:.6f} {mag:.2f} "
                             "flatSED/sed_flat.txt 0.1 0.01 -0.01 0.02 0 0 "
                             "sersic2d 1.2 0.8 30.0 1.5 none CCM 0.02 3.1")
            i += 1
    (d / "cat.txt").write_text("\n".join(lines) + "\n")
    return str(d / "cat.txt"), str(d)


TASKS = {"visit": _visit, "cli": _cli, "window_pass": _window_pass,
         "topology": _topology,
         "sharded": _sharded}
