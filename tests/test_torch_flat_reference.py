"""The port's SED photon flat (image/flat.build_flat_photons, the
LSST_Flat image type with an SED) against the benchmark's plain
reference of it (portbench/reference/flat.py: plain torch, conv2d for
the BF field, the tree rings at every pixel): pixel for pixel when both
take the same draws, the brighter-fatter droop of var / mean on both
sides, the wavelengths' inverse CDF and the plan, and the flat's spans
and counter."""
import os

import numpy as np
import pytest
import torch

from imsim_tpu_torch.catalog.sed import _cached_raw_sed
from imsim_tpu_torch.config.interpreter import load_config
from imsim_tpu_torch.config.runner import build_visit_context
from imsim_tpu_torch.image import flat as F
from imsim_tpu_torch.image.scene import _wavelength_icdf
from imsim_tpu_torch.sensor.silicon import SiliconParams
from imsim_tpu_torch.sensor.treerings import TreeRingModel
from imsim_tpu_torch.utils import trace
from imsim_tpu_torch.utils.rng import stream
from portbench.reference import flat as R
from portbench.reference.frozen import silicon as FS
from portbench.reference.frozen import treerings as FT

torch.set_num_threads(1)

SED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "seds", "flatSED", "sed_flat.txt")
DET = "R22_S11"


@pytest.fixture(scope="module")
def icdf():
    return R.wavelength_icdf(SED, "r", 1.0)


def _program_draws(seed):
    """The reference's draws(n) from the program's streams in the
    program's order: sub-batch i's generator, x, y, the wavelength
    uniform, then the silicon's depth uniform and two normals."""
    count = iter(range(10**9))

    def draws(n):
        g = stream(seed, "flatphot", next(count), device="cpu")
        return tuple(torch.rand(n, generator=g) for _ in range(4)) + tuple(
            torch.randn(n, generator=g) for _ in range(2))
    return draws


def _div(fx, fy):
    return (0.5 * (torch.roll(fx, -1, 1) - torch.roll(fx, 1, 1))
            + 0.5 * (torch.roll(fy, -1, 0) - torch.roll(fy, 1, 0)))


@pytest.mark.parametrize("rings", [True, False], ids=["rings", "no_rings"])
def test_flat_matches_the_reference_pixel_for_pixel(icdf, rings):
    """A 96 x 80 corner of R22_S11 at 300 e-/px in iterations of 100, the
    default BF kernel, both sides fed the same draws: every photon lands
    in the same pixel, so the flats differ only where their arithmetic
    does.  Tolerance: 1e-3 e- for the float32 sums (the level's last
    place is 3e-5; K3's plain twin and conv2d add the taps in other
    orders, a field of ~1e-4 px) plus, with tree rings, 1.5 x the level
    x the largest gap between the two ring fields' area terms: the
    program evaluates the field on a grid of stride tree_ring_step
    (6 px here) and upsamples it bilinearly, the reference at every
    pixel."""
    H, W, seed = 80, 96, 11
    cfg = F.FlatConfig(counts_per_pixel=300.0, counts_per_iter=100.0,
                       xsize=W, ysize=H)
    sp = SiliconParams.make(treering_model=TreeRingModel(DET) if rings
                            else None)
    prog = F.build_flat_photons(seed, cfg, icdf, sp, device="cpu")
    si = R.Silicon(100.0, 10.0, 4.0, FS.default_bf_kernel(),
                   FT.model(DET) if rings else None)
    ref = R.build(H, W, 300.0, 100.0, icdf, si, _program_draws(seed), "cpu")
    tol = 1e-3
    if rings:
        gap = (_div(*F.tree_ring_field(sp, (H, W), "cpu"))
               - _div(*R.tree_ring_field(si.rings, H, W, "cpu")))
        tol += 1.5 * 300.0 * float(gap.abs().max())
    assert float(prog.sum()) > 0.95 * 300 * H * W
    assert float((prog - ref).abs().max()) <= tol


def test_wavelengths_and_plan_are_the_programs(icdf):
    """The reference's inverse CDF of SED x bandpass equals the one the
    runner builds for the flat's config (airmass 1.0), and its plan is
    build_flat_photons' (4 x 489 sub-batches of 16,769,309 photons on
    the full frame)."""
    ctx = build_visit_context(load_config({
        "template": "imsim-config-flat", "opsim_meta.airmass": 1.0,
        "image.sed": "flatSED/sed_flat.txt"}))
    got = _wavelength_icdf(_cached_raw_sed(SED), ctx.bandpass)
    assert np.array_equal(got.astype(np.float32), icdf)
    cfg = F.FlatConfig(counts_per_pixel=2000.0, counts_per_iter=500.0)
    assert F.photon_flat_plan(cfg) == R.plan(2000.0, 500.0, 4004, 4096) \
        == (4, 489, 16_769_309)
    assert R.kept_fraction(SED, "r", 1.0, 100.0) > 0.99999


def _vom(a):
    return R.moments(a.numpy(), 8)[1]


def test_brighter_fatter_droop_on_both_sides(icdf):
    """256 x 256 at 400 e-/px with the kernel at strength 40 (100 x the
    default, so that this frame shows what the full one shows at 0.4):
    var / mean well below 1 with the kernel, at 1 within its noise
    without it, each side with draws of its own, and the two sides'
    droops within their noise of each other.  Noise of var / mean over
    240 x 240 pixels: sqrt(2 / N) = 0.0059."""
    N, cpp, cpi, strength = 256, 400.0, 100.0, 40.0
    sigma = np.sqrt(2.0 / (N - 16) ** 2)
    cfg = F.FlatConfig(counts_per_pixel=cpp, counts_per_iter=cpi,
                       xsize=N, ysize=N)
    got = {}
    for bf in (strength, 0.0):
        got["prog", bf] = _vom(F.build_flat_photons(
            5, cfg, icdf, SiliconParams.make(bf_strength=bf), device="cpu"))
        si = R.Silicon(100.0, 10.0, 4.0,
                       FS.default_bf_kernel(strength=bf), None)
        gen = torch.Generator().manual_seed(17)
        got["ref", bf] = _vom(R.build(N, N, cpp, cpi, icdf, si,
                                      R.torch_draws(gen), "cpu"))
    for side in ("prog", "ref"):
        assert got[side, strength] < 1.0 - 8 * sigma, got
        assert abs(got[side, 0.0] - 1.0) < 4 * sigma, got
    assert abs(got["prog", strength] - got["ref", strength]) \
        < 4 * np.sqrt(2) * sigma, got


@pytest.fixture
def clean_store():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


SENSOR = ["sensor.field", "sensor.displace", "sensor.bin",
          "sensor.redistribute"]


def test_flat_spans_nest_and_count_the_photons(icdf, clean_store):
    cfg = F.FlatConfig(counts_per_pixel=200.0, counts_per_iter=100.0,
                       xsize=64, ysize=48)
    sp = SiliconParams.make(treering_model=TreeRingModel(DET))
    F.build_flat_photons(3, cfg, icdf, sp, device="cpu")
    assert trace.spans() == [] and trace.counters() == []
    trace.enable()
    F.build_flat_photons(3, cfg, icdf, sp, device="cpu")
    trace.disable()
    sp_ = trace.spans()
    kids = {s["id"]: [c["name"] for c in sp_ if c["parent"] == s["id"]]
            for s in sp_}
    n_iter, n_sub, per = F.photon_flat_plan(cfg)
    iters = [s for s in sp_ if s["name"] == "flat.iter"]
    assert len(iters) == n_iter
    assert all(s["parent"] is None for s in iters)
    for s in iters:
        assert kids[s["id"]] == ["flat.draw", "flat.sensor"] * n_sub
    for s in sp_:
        if s["name"] == "flat.sensor":
            assert kids[s["id"]] == SENSOR
        if s["name"].startswith("sensor."):
            assert kids[s["id"]] == []
    photons = [c for c in trace.counters() if c["name"] == "flat.photons"]
    assert len(photons) == n_iter * n_sub
    assert sum(c["value"] for c in photons) == n_iter * n_sub * per


def test_flat_photons_bin_whole_fluxes(icdf, clean_store):
    """`sensor.nonunit` reads 0 on what the photon flat hands the binner
    (ones, zeroed where the photon converts past the silicon): the
    contract that makes the card's atomic binning exact."""
    cfg = F.FlatConfig(counts_per_pixel=200.0, counts_per_iter=100.0,
                       xsize=64, ysize=48)
    sp = SiliconParams.make(treering_model=TreeRingModel(DET))
    trace.enable()
    F.build_flat_photons(3, cfg, icdf, sp, device="cpu")
    trace.disable()
    tot = {}
    for c in trace.counters():
        tot[c["name"]] = tot.get(c["name"], 0.0) + c["value"]
    assert tot["sensor.binned"] == sum(
        c["value"] for c in trace.counters() if c["name"] == "flat.photons")
    assert tot["sensor.nonunit"] == 0
