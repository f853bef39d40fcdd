"""The work a CCD's inputs need from the three hand-written kernels, and
the card's published peaks: the rooflines' numerators, frozen when the
benchmark was defined (chip_smoke.py's arithmetic), so that a change to
the program cannot move them.

Per pooled photon (every photon of the objects outside the FFT pass):

  K1 (`slot_scan_kernel`, the rows' slot-order scan): the (C, N) deltas
     read once and the rows written once, 8 bytes per element, C = 24
     columns (the scene's parameters and wavelength coefficients);
  K2 (`ray_chain_kernel`, the fused ray chain): 2,871 operations (its
     stage counts for the LSST design in r with DCR, diffraction, field
     rotation and the silicon's displacement: ops/raychain.chain_flops)
     and 11 float32 inputs read, 3 written (56 bytes);

and per BF recalculation (nsubbatch of them per batch of batch_size
photons):

  K3 (`stencil_pair_kernel`): 4 k^2 operations per pixel for the two
     k x k tap sets (k = 9) and 12 bytes per pixel (the charge read,
     two displacement planes written).

The bound is the larger of operations over 67 TFLOP/s (FP32 outside
the tensor cores) and bytes over 3.35 TB/s: NVIDIA's H100 SXM data
sheet at its 700 W limit.
"""
from __future__ import annotations

import math

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K1_COLUMNS = 24
K2_OPS_PER_PHOTON = 2871
K2_BYTES_PER_PHOTON = 4 * 14
K3_TAPS = 9
KERNELS = {"k1": "slot_scan_kernel", "k2": "ray_chain_kernel",
           "k3": "stencil_pair_kernel"}


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def ccd_work(visit, rows, det: str, cfg: dict, n_ccds: int) -> dict:
    """Each kernel's bound [s] over n_ccds renders of `det`: the pooled
    photons are the reference's expected photons of the rows the cull
    keeps, less the bright stars (the FFT pass)."""
    from .reference import expect

    idx, _, _ = expect.cull(visit, rows, det, float(cfg["check"]["edge_pix"]))
    pooled = idx[~rows["bright"][idx]]
    photons = visit.total_flux(rows.take(pooled))
    ccd = visit.camera[det]
    h, w = ccd.bounds.height, ccd.bounds.width
    img = cfg["render"]
    recalcs = math.ceil(photons / img["batch_size"]) * img["nsubbatch"]
    per_ccd = {
        "k1": bound_s(photons * K1_COLUMNS, 8 * K1_COLUMNS * photons),
        "k2": bound_s(K2_OPS_PER_PHOTON * photons,
                      K2_BYTES_PER_PHOTON * photons),
        "k3": recalcs * bound_s(4 * K3_TAPS ** 2 * h * w, 12 * h * w)}
    return {"photons": photons, "bound_s": {k: v * n_ccds
                                            for k, v in per_ccd.items()}}


def kernel_seconds(kernels: dict, name: str) -> float:
    """Device seconds of the kernels whose name contains `name`."""
    return sum(v for k, v in kernels.items() if name in k)


def roofline(rec: dict, key: str):
    """The share [%] of its bound that kernel `key` reached over the
    window, or None where the trace holds none of it."""
    t = kernel_seconds(rec.get("kernels", {}), KERNELS[key])
    if not t or "work" not in rec:
        return None
    return 100.0 * rec["work"]["bound_s"][key] / t
