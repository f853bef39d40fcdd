"""CCDs and photons over several devices (imsim_tpu/parallel/mesh.py
counterpart).

The JAX package runs one controller and `shard_map` over a ('ccd',
'phot') device mesh.  The port is SPMD: one process per rank, each with
its own device, and rank r is the mesh point (ccd = r // M, phot = r % M)
of a `torch.distributed` DeviceMesh with mesh_dim_names ("ccd", "phot")
over the default process group.  The 'ccd' axis is data parallel over
detectors; the 'phot' axis splits a CCD's photon batches, whose partial
images are summed over the 'phot' sub-group.

Backends follow the launch, with no fallback from one to the other:
NCCL when each rank has a card of its own, gloo on the CPU and when
ranks share a card (NCCL refuses two ranks on one device).  Every group
has a 120 s timeout, so a collective that hangs fails.  A mesh of one
with no group initialized makes a group of one in this process, so
`output.mesh=1` runs without a launcher.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import torch
import torch.distributed as dist

from ..image import render
from ..image.scene import DeviceScene
from ..photons import profiles as Pr
from ..sensor.simple import accumulate
from ..utils.lookup import UniformTable
from ..utils.rng import stream

AXES = ("ccd", "phot")
TIMEOUT = datetime.timedelta(seconds=120)

log = logging.getLogger(__name__)


def pick_backend(device) -> str:
    """NCCL when each local rank has a card of its own; gloo on the CPU
    and for ranks that share a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: `cuda` becomes cuda:LOCAL_RANK (modulo the
    card count, for ranks that share a card); an indexed device or the
    CPU is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_group(device, init_method: str = "env://", rank=None,
               world_size=None) -> str:
    """Initialize the default process group for ranks on `device` (the
    backend from pick_backend, logged) and return the backend.
    init_method: torchrun's environment by default, or a `file://` /
    `tcp://` address with `rank` and `world_size`."""
    backend = pick_backend(device)
    kw = {} if rank is None else dict(rank=int(rank),
                                      world_size=int(world_size))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=TIMEOUT, **kw)
    log.info("process group: rank %d of %d on %s, backend %s",
             dist.get_rank(), dist.get_world_size(), dev, backend)
    return backend


@dataclasses.dataclass
class Mesh:
    """The port's mesh: the DeviceMesh over the default group, this
    rank's device and the group's backend.  `owned`: make_mesh made the
    group (a group of one) and close() destroys it."""

    device_mesh: object
    device: torch.device
    backend: str
    owned: bool = False

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.device_mesh.shape))

    @property
    def coordinate(self):
        """(ccd, phot) of this rank, or None for a rank outside the
        mesh (a world larger than the mesh leaves those ranks idle)."""
        c = self.device_mesh.get_coordinate()
        return None if c is None else tuple(c)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def src(self, axis: str, index: int = 0) -> int:
        """The global rank at `index` along `axis` from this rank."""
        c, p = self.coordinate
        c, p = (index, p) if axis == "ccd" else (c, index)
        return c * self.size("phot") + p

    def close(self):
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_ccd: int, n_phot: int, device="cuda") -> Mesh:
    """The (n_ccd, n_phot) mesh over the default process group; a group
    of one in this process when n_ccd * n_phot == 1 and none is
    initialized.  Raises when the world is smaller than the mesh."""
    n = n_ccd * n_phot
    owned = False
    dev = rank_device(device)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {n_ccd} x {n_phot} mesh needs {n} ranks: launch with "
                f"torchrun --nproc-per-node {n} (no process group is "
                f"initialized)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(pick_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=TIMEOUT)
        owned = True
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks for a {n_ccd} x {n_phot} mesh, "
                         f"the world has {world}")
    backend = dist.get_backend()
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                    torch.arange(n).reshape(n_ccd, n_phot),
                    mesh_dim_names=AXES)
    mesh = Mesh(dm, dev, backend, owned)
    log.info("mesh ccd=%d phot=%d: rank %d at %s on %s (%s)", n_ccd,
             n_phot, dist.get_rank(), mesh.coordinate, dev, backend)
    return mesh


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    # gloo's collectives on CUDA tensors depend on how PyTorch was built:
    # on that backend every collective goes through host memory
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "phot"):
    """Sum `t` in place over this rank's `axis` group (the identity on a
    group of one) and return it."""
    if mesh.size(axis) == 1:
        return t
    if _staged(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, group=mesh.group(axis))
        t.copy_(h)
    else:
        dist.all_reduce(t, group=mesh.group(axis))
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str = "phot"):
    """`t` of the rank at index 0 along `axis`, in place on every rank of
    the group."""
    if mesh.size(axis) == 1:
        return t
    if _staged(mesh, t):
        h = t.cpu()
        dist.broadcast(h, src=mesh.src(axis), group=mesh.group(axis))
        t.copy_(h)
    else:
        dist.broadcast(t, src=mesh.src(axis), group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str = "ccd") -> list:
    """Every rank's `t` along `axis` (the list form: gloo lacks some of
    the tensor-form collectives); the tensors keep t's device."""
    if mesh.size(axis) == 1:
        return [t]
    src = t.cpu() if _staged(mesh, t) else t
    out = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(out, src.contiguous(), group=mesh.group(axis))
    return [o.to(t.device) for o in out]


def sharded_render_step(mesh: Mesh, xsize: int, ysize: int,
                        exptime: float = 30.0, pixel_scale: float = 0.2):
    """The analytic-PSF step over the mesh: (seeds, scenes, obj_idx,
    weight, kolm_y, images) -> this rank's CCD image, its photon shards
    summed over 'phot'.

    Global arguments, the same on every rank:
      seeds    (n_ccd,) int    per-CCD stream seeds
      scenes   DeviceScene with a leading (n_ccd, ...) axis
      obj_idx  (n_ccd, N) int  photon -> object map, split over 'phot'
      weight   (n_ccd, N) float32
      kolm_y   (K,) float32    the Kolmogorov inverse-CDF values
      images   (n_ccd, ysize, xsize)
    The phot shards draw from stream(seed, "phot", p), decorrelated by
    their 'phot' index."""
    from ..convert import profile_tables

    kolm0 = Pr.kolmogorov_cdf()
    profiles = profile_tables()

    def step(seeds, scenes, obj_idx, weight, kolm_y, images):
        c, p = mesh.coordinate
        M = mesh.size("phot")
        n = obj_idx.shape[1] // M
        sl = slice(p * n, (p + 1) * n)
        scene = DeviceScene(**{
            f.name: None if getattr(scenes, f.name) is None
            else getattr(scenes, f.name)[c]
            for f in dataclasses.fields(DeviceScene)})
        image = images[c]
        gen = stream(int(seeds[c]), "phot", p, device=image.device)
        tab = UniformTable(kolm0.x0, kolm0.dx, kolm_y)
        photons = render.shoot(
            gen, scene, obj_idx[c, sl], weight[c, sl],
            {"kolmogorov": tab, "gauss_sigma": 0.3 / 2.3548}, profiles,
            exptime=exptime, pixel_scale=pixel_scale)
        img = accumulate(photons, image.clone())
        if M > 1:
            delta = all_reduce(img - image, mesh)
            img = image + delta
        return img

    return step


def stack_scenes(scenes) -> DeviceScene:
    """Stack per-CCD DeviceScenes along a new leading axis (a field that
    is None in every scene stays None)."""
    out = {}
    for f in dataclasses.fields(DeviceScene):
        vals = [getattr(s, f.name) for s in scenes]
        out[f.name] = None if vals[0] is None else torch.stack(vals)
    return DeviceScene(**out)
