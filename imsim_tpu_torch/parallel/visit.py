"""Full-physics visit rendering over a device mesh
(imsim_tpu/parallel/visit.py counterpart).

The JAX package runs one controller whose shard_map programs hold a
block of CCDs stacked along the mesh's 'ccd' axis.  The port is SPMD,
one process per rank (parallel.mesh): rank (c, p) of a (C, M) mesh
renders CCD c of each block of C detectors, and its 'phot' group of M
ranks splits that CCD's pooled photon batches.

Two layers live here:

* `sharded_full_step` / `run_visit_sharded` — the minimal sharded
  pooled-photon step (the dryrun surface of the JAX package's
  __graft_entry__), returning every CCD's image on every rank.
* `run_visit_mesh` — the production path (config key `output.mesh`):
  each CCD goes through the runner's pipeline (prepare_ccd, the FFT
  bright-star pass, the block-paired pooled loop, sky and noise, cosmic
  rays, readout, files).  Phot rank p of outer step k runs GLOBAL batch
  b = k*M + p with the serial path's streams ("photons", b) and ("si",
  b), and the image and the realized fluxes gain the all-reduced deltas
  of the step (the JAX delta scheme, so a nonzero start such as the FFT
  pass is counted once).  Each CCD renders with its own pooled plan, so
  a CCD's files do not depend on the mesh: with one phot rank they are
  the serial visit's bit for bit.  The JAX package's block-stacked sky
  and readout stages (`_sky_sharded`, `_readout_sharded`) are the
  writing rank's own stages for its CCD (config.runner.finish_ccd).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..image import render
from ..image.photon_pooling import (FFT, _fft_pass, classify_objects,
                                    make_psf_mtf, pooled_pass)
from ..io.checkpoint import Checkpointer
from ..sensor.silicon import accumulate_silicon
from ..sensor.simple import accumulate
from ..utils import trace
from ..utils.lookup import UniformTable
from ..utils.rng import stream, stream_seed
from .mesh import (Mesh, all_gather, all_reduce, broadcast, make_mesh,
                   stack_scenes)


def _is_leaf_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def stack_pytrees(items):
    """Stack a list of identical-structure trees (dataclasses, tuples,
    lists, dicts of tensors, arrays and scalars) along a new axis 0.
    Values that are equal in every item (a telescope's surface kinds, a
    context's frame size) are kept as they are."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items))
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_pytrees([getattr(x, f.name) for x in items])
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, dict):
        return {k: stack_pytrees([x[k] for x in items]) for k in first}
    if all(_same(x, first) for x in items):
        return first
    if isinstance(first, (tuple, list)):
        return type(first)(stack_pytrees(list(xs)) for xs in zip(*items))
    return np.asarray(items)


def _same(a, b) -> bool:
    if _is_leaf_array(a) or _is_leaf_array(b):
        return False
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def take_pytree(tree, i: int):
    """Item i of a stack_pytrees tree (numpy scalars back as Python
    numbers)."""
    if tree is None or isinstance(tree, (str, bool, int, float)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, np.ndarray):
        v = tree[i]
        return v.item() if np.ndim(v) == 0 else v
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: take_pytree(getattr(tree, f.name), i)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: take_pytree(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(take_pytree(v, i) for v in tree)
    return tree


def pad_scene(scene, n_pad: int, m_pad: int = None):
    """Pad a DeviceScene to n_pad objects (and m_pad aux clouds) so
    per-CCD scenes stack along a 'ccd' axis.  Padding rows repeat the
    last object (dead photons carry weight 0, so the values only need to
    be finite)."""
    n = scene.params.shape[0]
    if m_pad is None:
        m_pad = scene.aux_cloud.shape[0]
    if n >= n_pad and scene.aux_cloud.shape[0] >= m_pad:
        return scene

    def pad_rows(a, target):
        if a is None or a.shape[0] >= target:
            return a
        reps = a[-1:].expand((target - a.shape[0],) + tuple(a.shape[1:]))
        return torch.cat([a, reps], dim=0)

    return dataclasses.replace(
        scene, params=pad_rows(scene.params, n_pad),
        wl_icdf=pad_rows(scene.wl_icdf, n_pad),
        labs_icdf=pad_rows(scene.labs_icdf, n_pad),
        wl_cheb=pad_rows(scene.wl_cheb, n_pad),
        aux_cloud=pad_rows(scene.aux_cloud, m_pad))


def sharded_full_step(mesh: Mesh, xsize: int, ysize: int,
                      exptime: float = 30.0, use_silicon: bool = False,
                      nsub: int = 2):
    """The sharded step of the FULL chain:

      (seeds (n_ccd,), scenes [n_ccd, ...], obj_idx (n_ccd, N),
       weight (n_ccd, N), tels [n_ccd-stacked], ctxs [n_ccd-stacked],
       screens | None, sk_y (K,) | None, silicon | None,
       images (n_ccd, H, W)) -> this rank's CCD image (H, W)

    Rank (c, p) takes CCD c and its p-th slice of the N photons, traces
    them through the optics with stream(seed, "phot", p), and the
    partial images are summed over 'phot' (the sum of the DELTA, so a
    nonzero carried-in image is counted once).  With `silicon` the
    photons are displaced chunk by chunk with stream(seed, "phot", p,
    "si")."""
    from ..convert import profile_tables

    profiles = profile_tables()

    def step(seeds, scenes, obj_idx, weight, tels, ctxs, screens, sk_y,
             sil, images):
        c, p = mesh.coordinate
        M = mesh.size("phot")
        n = obj_idx.shape[1] // M
        sl = slice(p * n, (p + 1) * n)
        scene = take_pytree(scenes, c)
        image = images[c]
        dev = image.device
        gen = stream(int(seeds[c]), "phot", p, device=dev)
        idx = obj_idx[c, sl]
        row = torch.cat([scene.params, scene.wl_cheb], dim=1)[
            idx.to(torch.int64)].T.contiguous()
        sk_table = None if sk_y is None else UniformTable(
            0.0, 1.0 / (sk_y.shape[0] - 1), sk_y)
        # pupil_pairing=1: these batches are object-major, not
        # block-paired, so pairing mates would hold different objects
        photons = render.shoot_full(
            gen, row, idx, weight[c, sl], take_pytree(tels, c),
            take_pytree(ctxs, c), profiles, render.ALL_FAMILIES,
            screens=screens, sk_table=sk_table, exptime=exptime,
            pupil_pairing=1, aux_cloud=scene.aux_cloud)
        if use_silicon:
            img = accumulate_silicon(
                photons, image.clone(), sil, nsub=nsub,
                gen=stream(int(seeds[c]), "phot", p, "si", device=dev))
        else:
            img = accumulate(photons, image.clone())
        if M > 1:
            img = image + all_reduce(img - image, mesh)
        return img

    return step


def run_visit_sharded(ctx_list, host_list, mesh: Mesh, cfg, screens=None,
                      sk_y=None, silicon=None, seed=0):
    """Render len(ctx_list) CCDs (the mesh's 'ccd' size) over the mesh.

    ctx_list: [(tel, optics_ctx)] per CCD; host_list: SceneHost per CCD,
    the same lists on every rank.  Batch b of CCD i draws from
    stream(seed + i, "batch", b) folded with the phot index.  Returns the
    (n_ccd, H, W) images on every rank (an all-gather over 'ccd')."""
    from ..image.scene import make_photon_batches

    n_ccd = len(host_list)
    if n_ccd != mesh.size("ccd"):
        raise ValueError(f"{n_ccd} CCDs on a mesh of {mesh.size('ccd')}")
    tels = stack_pytrees([t for t, _ in ctx_list])
    ctxs = stack_pytrees([c for _, c in ctx_list])
    scenes = stack_scenes([h.scene for h in host_list])
    H, W = cfg.ysize, cfg.xsize
    c, _ = mesh.coordinate
    step = sharded_full_step(mesh, W, H, exptime=cfg.exptime,
                             use_silicon=silicon is not None,
                             nsub=getattr(cfg, "nsub", 2))
    dev = mesh.device
    N = cfg.batch_size
    nbatch = max(-(-int(h.flux.astype(np.int64).sum()) // N)
                 for h in host_list)
    own = list(make_photon_batches(host_list[c], N))
    images = torch.zeros((n_ccd, H, W), dtype=torch.float32, device=dev)
    for b in range(nbatch):
        if b < len(own):
            idx, w = own[b]
        else:
            idx = torch.full((N,), host_list[c].scene.n - 1,
                             dtype=torch.int64, device=dev)
            w = torch.zeros((N,), dtype=torch.float32, device=dev)
        # only row c is read on this rank
        obj_idx = idx.expand(n_ccd, N)
        weight = w.expand(n_ccd, N)
        seeds = [stream_seed(seed + i, "batch", b) for i in range(n_ccd)]
        images[c] = step(seeds, scenes, obj_idx, weight, tels, ctxs,
                         screens, sk_y, silicon, images)
    return torch.stack(all_gather(images[c].contiguous(), mesh, "ccd"))


# ---------------------------------------------------------------------------
# Production mesh visit: the runner's per-CCD pipeline over a mesh
# ---------------------------------------------------------------------------

def mesh_batch(k: int, p: int, n_phot: int) -> int:
    """The global batch that phot rank p runs in outer step k."""
    return k * n_phot + p


def mesh_pooled_step(mesh: Mesh, ps):
    """This rank's step of a CCD's pooled pass `ps` (photon_pooling.
    PooledPass): step(k, image, tally, realized) runs global batch
    b = k*M + p with the serial path's streams and returns the image
    with the phot group's all-reduced delta added (realized, a float64
    (scene.n,) tensor or None, gains its delta in place).  A rank past
    the last batch adds a zero delta (the JAX package runs the last
    batch with weight 0: the same image).  With one phot rank the step
    is the serial batch itself."""
    M = mesh.size("phot")
    p = mesh.coordinate[1]

    def step(k: int, image, tally=None, realized=None):
        b = mesh_batch(k, p, M)
        if M == 1:
            return ps.batch(b, image, tally, realized)
        r_delta = None if realized is None else torch.zeros_like(realized)
        if b < ps.nb:
            delta = ps.batch(b, image.clone(), tally, r_delta) - image
        else:
            delta = torch.zeros_like(image)
        image = image + all_reduce(delta, mesh)
        if realized is not None:
            realized += all_reduce(r_delta, mesh)
        return image

    return step


def _parse_mesh_cfg(mesh_cfg, ndev: int):
    """`output.mesh` -> (n_ccd_axis, n_phot_axis).  Accepts `auto`/true
    (all ranks on the ccd axis), an int (ccd axis size), or
    {ccd: C, phot: M}."""
    if mesh_cfg in (True, "auto"):
        return ndev, 1
    if isinstance(mesh_cfg, (int, float, str)):
        return int(mesh_cfg), 1
    c = int(mesh_cfg.get("ccd", ndev))
    m = int(mesh_cfg.get("phot", 1))
    return c, m


def render_mesh_pass(ctx, prep, mesh: Mesh, index: int, tally: dict,
                     logger=None):
    """This rank's share of CCD `prep`'s render (its device scene on the
    rank's device): the classification, the FFT pass on the phot group's
    first rank (broadcast to the group), and the pooled loop of
    mesh_pooled_step, checkpointed after every outer step with
    input.checkpoint (file checkpoint_mesh_{visit}_{index}.npz, `index`
    the CCD's place in the visit, written by the group's first rank).
    Returns (image, modes, realized numpy or None)."""
    host, pcfg = prep.host, prep.pcfg
    dev = mesh.device
    if host is None or host.n_objects == 0:
        return (torch.zeros((pcfg.ysize, pcfg.xsize), dtype=torch.float32,
                            device=dev), None, None)
    writer = mesh.coordinate[1] == 0
    track = bool((ctx.cfg.get("output", {}).get("truth", {})
                  or {}).get("enabled", True))
    psf_mtf = make_psf_mtf(pcfg)
    modes = classify_objects(host, pcfg, psf_mtf)
    image = torch.zeros((pcfg.ysize, pcfg.xsize), dtype=torch.float32,
                        device=dev)
    realized = torch.zeros(host.scene.n, dtype=torch.float64, device=dev)

    # ---- the checkpoint: the writer reads it, its group follows -------
    ck_cfg = ctx.cfg.get("input", {}).get("checkpoint", {}) or {}
    ckpt, start = None, -1
    if ck_cfg.get("dir"):
        if writer:
            visit = int(ctx.opsim.get("observationId", 0))
            ckpt = Checkpointer(f"checkpoint_mesh_{visit}_{index}.npz",
                                dir=ck_cfg["dir"])
            saved = ckpt.load("mesh")
            if saved is not None:
                image = torch.as_tensor(saved["images"][0], device=dev)
                realized = torch.as_tensor(saved["realized"][0],
                                           device=dev)
                start = int(saved["next_outer"])
        flag = broadcast(torch.tensor([start], dtype=torch.int64,
                                      device=dev), mesh)
        start = int(flag.item())
        if start >= 0:
            broadcast(image, mesh)
            if logger:
                logger.info("mesh CCD %s resumed at outer step %d",
                            prep.det_name, start)

    if start < 0 and np.any(modes == FFT):
        if writer:
            image, realized[:host.n_objects] = _fft_pass(
                image, host, modes, pcfg, psf_mtf, ctx.seed + prep.det_num,
                spikes=prep.spikes, vign=prep.fft_vign)
        broadcast(image, mesh)
    if start < 0 and writer:
        # the pass runs on an empty frame: its sum is what it added
        tally["fft"] = image.sum(dtype=torch.float64)
    optics = prep.use_optics
    ps = pooled_pass(ctx.seed + prep.det_num, host, modes, pcfg,
                     prep.silicon, prep.tel32 if optics else None,
                     prep.octx if optics else None,
                     ctx.screens(dev) if optics else None,
                     prep.sk_table if optics else None, prep.profiles)
    if ps.total == 0:
        return image, modes, realized.cpu().numpy()
    step = mesh_pooled_step(mesh, ps)
    M = mesh.size("phot")
    for k in range(max(start, 0), -(-ps.nb // M)):
        image = step(k, image, tally, realized if track else None)
        if ckpt is not None:
            ckpt.save("mesh", dict(images=image.cpu().numpy()[None],
                                   realized=realized.cpu().numpy()[None],
                                   next_outer=k + 1))
    return image, modes, realized.cpu().numpy()


def render_mesh_ccd(ctx, det, mesh: Mesh, *, prep=None, index: int = 0,
                    logger=None):
    """One CCD on this rank of its phot group: render_mesh_pass, then on
    the group's first rank the sky, cosmic rays and readout
    (runner.finish_ccd); returns that rank's result dict and None on the
    group's other ranks."""
    from ..config import runner as R

    device = mesh.device
    seconds = {}
    det_name = R._det(ctx, det)[0]
    with trace.span("ccd", ccd=det_name, device=device):
        if prep is None:
            prep = R.prepare_ccd(ctx, det, device=device)
            seconds.update(prep.seconds)
        elif prep.device is None or torch.device(prep.device) != device:
            with trace.span("ccd.upload", device=device):
                prep = R.upload_prep(ctx, prep, device)
        clock = R._Clock(seconds, device, span="ccd", ccd=det_name)
        writer = mesh.coordinate[1] == 0
        pieces = R.sky_noise_pieces(ctx, prep, device=device) if writer \
            else None
        clock("sky pieces")
        tally = {}
        image, modes, realized = render_mesh_pass(ctx, prep, mesh, index,
                                                  tally, logger)
        clock("render")
        if not writer:
            return None
        return R.finish_ccd(ctx, prep, image, modes, realized, pieces,
                            tally, seconds, clock, logger=logger)


def run_visit_mesh(ctx, dets, mesh_cfg, logger=None, device="cuda"):
    """The multi-device visit (config key `output.mesh`): the CCDs in
    blocks of the mesh's 'ccd' size, CCD i of the visit on ccd row
    i % C, its photon batches over the row's phot ranks.  Yields the
    results whose files this rank wrote (the JAX package's single
    controller returns them all).  A rank outside the mesh renders
    nothing; a group of one made here is destroyed at the end."""
    from ..config import runner as R

    world = dist.get_world_size() if dist.is_initialized() else 1
    C, M = _parse_mesh_cfg(mesh_cfg, world)
    mesh = make_mesh(C, M, device)
    try:
        if mesh.coordinate is None:
            return
        c = mesh.coordinate[0]
        mine = [(i, d) for i, d in enumerate(dets) if i % C == c]
        if logger:
            logger.info("mesh rank %s: CCDs %s", mesh.coordinate,
                        [d for _, d in mine])
        index = dict((d, i) for i, d in mine)
        yield from R.visit_loop(
            ctx, [d for _, d in mine],
            lambda det, prep: render_mesh_ccd(ctx, det, mesh, prep=prep,
                                              index=index[det],
                                              logger=logger),
            mesh.device, logger)
    finally:
        mesh.close()
