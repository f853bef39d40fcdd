"""The binning scatter's plain twin (imsim_tpu_torch.sensor.simple.
accumulate_plain, which `accumulate` runs on the CPU; on the card K5
bins, held to the twin by tests/test_torch_cuda.py) against its former
formulation, kept here as the plain reference: every out-of-frame
photon sent to pixel 0 with flux 0.  The twin sends each to a tail slot
of its own past the frame; the frame must come out bit-equal, for any
flux, wherever the scatter is deterministic: the sorted scatter
(`torch.use_deterministic_algorithms`, the kind `index_put_` always
runs on CUDA) and the CPU's serial loop on one thread.  (The CPU's
threaded scatter adds in no fixed order, for either formulation.)"""
import contextlib

import pytest
import torch

from imsim_tpu_torch.photons.batch import PhotonBatch
from imsim_tpu_torch.sensor import silicon as TS
from imsim_tpu_torch.sensor import simple
from imsim_tpu_torch.utils import trace

# 2,688 pixels: N photons take a tail of 1,408 slots, some two to a slot
H, W = 48, 56
N = 30_000
SHARES = [0.0, 0.002, 0.09, 1.0]
# (share off the frame, some of them at NaN, infinite or huge coordinates)
CASES = [(s, False) for s in SHARES] + [(s, True) for s in SHARES if s]
BAD = [float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 2.0 ** 63,
       3.0e9]


def _pixel0(photons, image, tally=None):
    """The binner as it was: an out-of-frame photon goes to pixel 0 with
    flux 0."""
    H, W = image.shape
    fx = torch.round(photons.x)
    fy = torch.round(photons.y)
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    if trace.on():
        trace.count("sensor.binned", inb.numel())
        trace.count("sensor.off_frame", inb.numel() - inb.sum())
        trace.count("sensor.nonunit",
                    ((photons.flux != 0) & (photons.flux != 1)).sum())
    flux = torch.where(inb, photons.flux, 0.0).to(image.dtype)
    ix = torch.where(inb, fx, 0.0).to(torch.int64)
    iy = torch.where(inb, fy, 0.0).to(torch.int64)
    image.view(-1).index_put_((iy * W + ix,), flux, accumulate=True)
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) \
            + flux.sum(dtype=torch.float64)
    return image


@contextlib.contextmanager
def _deterministic(mode):
    """'sorted': the sort-then-sum-runs scatter; 'serial': one thread."""
    threads = torch.get_num_threads()
    det = torch.are_deterministic_algorithms_enabled()
    if mode == "sorted":
        torch.use_deterministic_algorithms(True)
    else:
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det)
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_store():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _photons(share, seed, n=N, whole=False, bad=False, star=True):
    """n photons, `share` of them off the frame (beyond every edge, in
    the 0.5 px band around it, and, with bad=True, at NaN, infinite and
    huge coordinates), a tenth of the rest in a star 1.5 px wide (runs
    of several hundred, so that the scatter's summing order shows), a
    dozen at pixel (0, 0) among the off-frame ones; fluxes non-whole in
    [0, 2), or 0 and 1 with whole=True."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, generator=g) * W - 0.5
    y = torch.rand(n, generator=g) * H - 0.5
    if star:
        k = n // 10
        x[-k:] = 20.0 + 1.5 * torch.randn(k, generator=g)
        y[-k:] = 17.0 + 1.5 * torch.randn(k, generator=g)
    n_out = int(round(share * n))
    if n_out:
        pick = torch.randperm(n, generator=g)[:n_out]
        u = torch.rand(n_out, generator=g)
        side = torch.randint(0, 4, (n_out,), generator=g)
        far = torch.where(u < 0.3, 0.5 + 0.49 * u / 0.3, 1.0 + 300.0 * u)
        ox = torch.rand(n_out, generator=g) * W - 0.5
        oy = torch.rand(n_out, generator=g) * H - 0.5
        ox = torch.where(side == 0, -far, torch.where(side == 1, W - 1 + far,
                                                      ox))
        oy = torch.where(side == 2, -far, torch.where(side == 3, H - 1 + far,
                                                      oy))
        x[pick], y[pick] = ox, oy
        if bad:
            m = min(n_out, 4 * len(BAD))
            vals = torch.tensor(BAD * 4)[:m]
            x[pick[:m]] = vals
            y[pick[:m:2]] = vals[::2].flip(0)
        if share < 1.0:
            # photons of pixel (0, 0) among the off-frame ones: its run
            # loses the zeros it shared with them
            c = pick[: min(12, n_out)] + 1
            c = c[c < n]
            x[c], y[c] = 0.2 * torch.rand(c.numel(), generator=g) - 0.1, 0.1
    flux = (torch.rand(n, generator=g) < 0.9).float() if whole \
        else 2.0 * torch.rand(n, generator=g)
    return PhotonBatch.zeros(n, device="cpu").replace(x=x, y=y, flux=flux)


def _counted(fn, *args):
    trace.enable()
    out = fn(*args)
    got = {}
    for c in trace.counters():
        got[c["name"]] = got.get(c["name"], 0) + int(c["value"])
    trace.disable()
    trace.reset()
    return out, got


@pytest.mark.parametrize("mode", ["sorted", "serial"])
@pytest.mark.parametrize("charged", [False, True])
@pytest.mark.parametrize("share,bad", CASES)
def test_accumulate_is_bit_equal_to_pixel0(share, bad, charged, mode):
    """The frame, updated in place and returned, bit-equal to the pixel-0
    reference's (pixel (0, 0) too); the tally and both counters equal."""
    ph = _photons(share, seed=int(1000 * share) + 7 * bad + charged)
    g = torch.Generator().manual_seed(5)
    start = 1e3 * torch.rand((H, W), generator=g) if charged \
        else torch.zeros((H, W))
    with _deterministic(mode):
        t_ref, t_new = {}, {}
        want, c_ref = _counted(_pixel0, ph, start.clone(), t_ref)
        image = start.clone()
        got, c_new = _counted(simple.accumulate, ph, image, t_new)
    assert got is image
    assert torch.equal(got, want)
    assert torch.equal(t_new["in_frame"], t_ref["in_frame"])
    assert c_new == c_ref
    n_off = int(c_ref["sensor.off_frame"])
    assert c_ref["sensor.binned"] == N
    assert abs(n_off - round(share * N)) <= (12 if share < 1.0 else 0)


@pytest.mark.parametrize("share,bad", CASES)
def test_indices_stay_inside_the_buffer(share, bad):
    """Every index falls in the padded buffer: an in-frame photon at the
    reference's pixel, an off-frame one (NaN, infinite and huge
    coordinates too) in the tail with flux 0."""
    ph = _photons(share, seed=11 + bad, bad=bad)
    tail = simple.tail_slots(ph.n, H * W)
    idx, flux, inb = simple.bin_indices(ph, H, W, tail)
    assert idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < H * W + tail
    assert bool((idx[inb] < H * W).all())
    assert bool((idx[~inb] >= H * W).all())
    assert bool((flux[~inb] == 0).all())
    fx, fy = torch.round(ph.x[inb]), torch.round(ph.y[inb])
    assert torch.equal(idx[inb], (fy * W + fx).to(torch.int64))
    # each slot of the tail takes at most one warp's pass of photons
    if (~inb).any():
        assert int(torch.bincount(idx[~inb] - H * W).max()) <= 32


@pytest.mark.parametrize("n,frame", [
    (1_876_480, 4004 * 4096),     # the catalog CCD's chunk (E2V)
    (1_876_480, 4072 * 4000),     # ITL
    (4_670_000, 4004 * 4096),     # the bench CCD's chunk
    (1_876_480, 4096 * 4096),     # a power of two: no room below it
    (1_000, 2 ** 20 - 3), (30_000, 48 * 56), (7, 1), (0, 16), (1, 16)])
def test_tail_slots(n, frame):
    """The tail is at least one slot, at most n (or 1), holds every
    photon in at most 32 to a slot, and, where the room below the next
    power of two allows that, adds no bit to the largest index."""
    tail = simple.tail_slots(n, frame)
    assert 1 <= tail <= max(n, 1)
    assert -(-n // tail) <= 32
    room = (1 << (frame - 1).bit_length()) - frame
    if room >= max(1, -(-n // 32)):
        assert (frame + tail - 1).bit_length() == (frame - 1).bit_length()
    if n and room >= n:
        assert tail == n


@pytest.mark.parametrize("whole", [True, False])
def test_pixel_00_beside_the_off_frame_photons(whole):
    """Pixel (0, 0) is the one pixel whose run changes: its photons no
    longer share it with the off-frame zeros.  Adding +0.0 changes no
    sum, so it stays bit-equal where the run is summed in photon order
    (the CPU's scatters, both tried here, for any flux).  On the card a
    run is summed by a warp's 32 lanes, and dropping zeros from it moves
    its photons between lanes: the sum is exact there only for whole
    fluxes, as the pooled render's are (each photon 0 or 1, K2's
    survival draw): `tests/test_torch_cuda.py` holds that on the card."""
    n = 4_000
    g = torch.Generator().manual_seed(3)
    ph = _photons(0.5, seed=31, n=n, whole=whole, star=False)
    at00 = torch.rand(n, generator=g) < 0.1
    x = torch.where(at00, 0.3 * torch.rand(n, generator=g) - 0.15, ph.x)
    y = torch.where(at00, torch.zeros(n), ph.y)
    ph = ph.replace(x=x, y=y)
    for mode in ("sorted", "serial"):
        with _deterministic(mode):
            want = _pixel0(ph, torch.zeros((H, W)))
            got = simple.accumulate(ph, torch.zeros((H, W)))
        assert float(want[0, 0]) > 100
        assert torch.equal(got, want), mode


def _silicon_photons(n, seed):
    g = torch.Generator().manual_seed(seed)
    ph = _photons(0.09, seed=seed, n=n)
    wl = 400.0 + 600.0 * torch.rand(n, generator=g)
    return ph.replace(wavelength=wl,
                      dxdz=0.1 * torch.randn(n, generator=g),
                      dydz=0.1 * torch.randn(n, generator=g))


@pytest.mark.parametrize("mode", ["sorted", "serial"])
@pytest.mark.parametrize("bf_mode,pre_displaced", [
    ("image", True), ("image", False), ("photon", False)])
def test_accumulate_silicon_is_bit_equal_with_pixel0(
        monkeypatch, bf_mode, pre_displaced, mode):
    """accumulate_silicon in both BF modes gives the image it gives with
    the pixel-0 binner patched in, and the same tally."""
    ph = _silicon_photons(8_000, seed=41)
    sil = TS.SiliconParams.make()
    start = torch.zeros((H, W))

    def run():
        tally = {}
        out = TS.accumulate_silicon(
            ph, start, sil, nsub=4, tally=tally, bf_mode=bf_mode,
            pre_displaced=pre_displaced,
            gen=torch.Generator().manual_seed(1))
        return out, tally

    with _deterministic(mode):
        got, t_new = run()
        monkeypatch.setattr(TS, "accumulate", _pixel0)
        want, t_ref = run()
    assert float(start.abs().sum()) == 0.0
    assert float(want.sum()) > 1000
    assert torch.equal(got, want)
    assert torch.equal(t_new["in_frame"], t_ref["in_frame"])
