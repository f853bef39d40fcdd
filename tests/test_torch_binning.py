"""The binning scatter's plain twin (imsim_tpu_torch.ops.binning.
bin_scatter_plain, which `bin_scatter` takes for a CPU frame; on the card
K5 bins, held to the twin by tests/test_torch_cuda.py) and its callers in
sensor/simple, against a reference independent of both: float64 sums of
the in-frame photons' fluxes per pixel.  A frame must equal the
reference bit for bit for fluxes of 0 and 1, and within float32 rounding
for others, wherever the scatter runs: the sorted scatter
(`torch.use_deterministic_algorithms`, the kind `index_put_` always
runs on CUDA) and the CPU's serial loop on one thread."""
import contextlib

import pytest
import torch

from imsim_tpu_torch.ops import binning
from imsim_tpu_torch.photons.batch import PhotonBatch
from imsim_tpu_torch.sensor import silicon as TS
from imsim_tpu_torch.sensor import simple
from imsim_tpu_torch.utils import trace

H, W = 48, 56
N = 30_000
SHARES = [0.0, 0.002, 0.09, 1.0]
# (share off the frame, some of them at NaN, infinite or huge coordinates)
CASES = [(s, False) for s in SHARES] + [(s, True) for s in SHARES if s]
BAD = [float("nan"), float("inf"), -float("inf"), 1e30, -1e30, 2.0 ** 63,
       3.0e9]


def _pixel_sums(ph, shape):
    """(sum of flux, sum of |flux|, photons) per pixel of the in-frame
    photons, in float64 on the CPU."""
    H, W = shape
    x, y = torch.round(ph.x.cpu().double()), torch.round(ph.y.cpu().double())
    inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    idx = (y[inb] * W + x[inb]).to(torch.int64)
    f = ph.flux.cpu().double()[inb]
    s = torch.bincount(idx, weights=f, minlength=H * W)
    a = torch.bincount(idx, weights=f.abs(), minlength=H * W)
    c = torch.bincount(idx, minlength=H * W).double()
    return s.view(H, W), a.view(H, W), c.view(H, W)


def _check_binned(got, base, ph):
    """`got` is base + the photons' binned frame: bit-equal to the
    reference's for fluxes of 0 and 1 (whole sums below 2^24, exact in
    any order, one rounding of base + S on both sides); otherwise within
    float32 rounding: the summing order moves a pixel by at most
    (photons - 1) x 2^-24 x the sum of |flux| there, so by photons x
    2^-23 x it, and the add onto the base by 2^-24 x |value| (the bound
    allows twice that)."""
    s, a, c = _pixel_sums(ph, got.shape)
    want = base.cpu().double() + s
    got = got.cpu()
    flux = ph.flux.cpu()
    if bool(((flux == 0) | (flux == 1)).all()):
        assert torch.equal(got, want.float())
    else:
        gap = (got.double() - want).abs()
        assert bool((gap <= 2.0 ** -23 * (c * a + want.abs())).all())


def _reference(ph, shape):
    """The reference's tally and counters for binning `ph` into `shape`."""
    s, _, c = _pixel_sums(ph, shape)
    flux = ph.flux.cpu()
    return float(s.sum()), {
        "sensor.binned": ph.n, "sensor.off_frame": ph.n - int(c.sum()),
        "sensor.nonunit": int(((flux != 0) & (flux != 1)).sum())}


def _check_tally(got, want, ph):
    """Float64 sums of the same float32 fluxes in two orders differ by at
    most n x 2^-52 x sum |flux| (by nothing for whole fluxes)."""
    scale = float(ph.flux.double().abs().sum())
    assert abs(float(got) - want) <= ph.n * 2.0 ** -52 * scale


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
            # photons of pixel (0, 0) among the off-frame ones
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
    """`accumulate` onto an empty and a charged image, updated in place
    and returned, against the reference: bit-equal for fluxes of 0 and 1,
    within float32 rounding for others; the tally and the three counters
    the reference's."""
    g = torch.Generator().manual_seed(5)
    start = 1e3 * torch.rand((H, W), generator=g) if charged \
        else torch.zeros((H, W))
    for whole in (True, False):
        ph = _photons(share, seed=int(1000 * share) + 7 * bad + charged,
                      whole=whole, bad=bad)
        t_want, c_want = _reference(ph, (H, W))
        tally = {}
        image = start.clone()
        with _deterministic(mode):
            got, counts = _counted(simple.accumulate, ph, image, tally)
        assert got is image
        _check_binned(got, start, ph)
        _check_tally(tally["in_frame"], t_want, ph)
        assert counts == c_want
        n_off = c_want["sensor.off_frame"]
        assert abs(n_off - round(share * N)) <= (12 if share < 1.0 else 0)


@pytest.mark.parametrize("charged", [False, True])
@pytest.mark.parametrize("share,bad", CASES)
def test_accumulate_is_base_plus_binned(share, bad, charged):
    """`accumulate(ph, base)` is `base + binned(ph)` bit for bit, with the
    same tally and counters."""
    ph = _photons(share, seed=23 + int(1000 * share) + bad, bad=bad)
    g = torch.Generator().manual_seed(6)
    base = 1e3 * torch.rand((H, W), generator=g) if charged \
        else torch.zeros((H, W))
    t_acc, t_bin = {}, {}
    got, c_acc = _counted(simple.accumulate, ph, base.clone(), t_acc)
    frame, c_bin = _counted(simple.binned, ph, (H, W), "cpu", t_bin)
    assert frame.dtype == torch.float32 and frame.shape == (H, W)
    assert torch.equal(got, base + frame)
    assert torch.equal(t_acc["in_frame"], t_bin["in_frame"])
    assert c_acc == c_bin


@pytest.mark.parametrize("share,bad", CASES)
def test_indices_stay_inside_the_buffer(share, bad):
    """Off-frame photons (NaN, infinite and huge coordinates too) touch
    nothing: the twin bins into a frame that is a view inside a larger
    buffer, and the buffer around it keeps its sentinel values; the
    frame is the reference's, and the off-frame count in `stats` and in
    `sensor.off_frame` the reference's."""
    ph = _photons(share, seed=11 + bad, bad=bad)
    pad = 2 * W + 3
    buf = torch.full((H * W + 2 * pad,), -7.0)
    frame = buf[pad:pad + H * W].view(H, W)
    frame.zero_()
    stats = torch.zeros(3, dtype=torch.float64)
    assert binning.bin_scatter(ph.x, ph.y, ph.flux, frame, stats) is frame
    assert bool((buf[:pad] == -7.0).all())
    assert bool((buf[pad + H * W:] == -7.0).all())
    _check_binned(frame, torch.zeros((H, W)), ph)
    t_want, c_want = _reference(ph, (H, W))
    assert stats[1] == c_want["sensor.off_frame"]
    assert stats[2] == c_want["sensor.nonunit"]
    _check_tally(stats[0], t_want, ph)
    _, counts = _counted(simple.binned, ph, (H, W), "cpu")
    assert counts == c_want


@pytest.mark.parametrize("whole", [True, False])
def test_pixel_00_beside_the_off_frame_photons(whole):
    """Pixel (0, 0) beside half the photons off the frame holds the sum of
    its own photons and nothing of the others: the reference's, in both
    of the CPU's scatters."""
    n = 4_000
    g = torch.Generator().manual_seed(3)
    ph = _photons(0.5, seed=31, n=n, whole=whole, star=False)
    at00 = torch.rand(n, generator=g) < 0.1
    x = torch.where(at00, 0.3 * torch.rand(n, generator=g) - 0.15, ph.x)
    y = torch.where(at00, torch.zeros(n), ph.y)
    ph = ph.replace(x=x, y=y)
    for mode in ("sorted", "serial"):
        with _deterministic(mode):
            got = simple.accumulate(ph, torch.zeros((H, W)))
        assert float(got[0, 0]) > 100
        _check_binned(got, torch.zeros((H, W)), ph)


def _silicon_photons(n, seed):
    g = torch.Generator().manual_seed(seed)
    ph = _photons(0.09, seed=seed, n=n, whole=True)
    wl = 400.0 + 600.0 * torch.rand(n, generator=g)
    return ph.replace(wavelength=wl,
                      dxdz=0.1 * torch.randn(n, generator=g),
                      dydz=0.1 * torch.randn(n, generator=g))


def _reference_binned(photons, shape, device, tally=None):
    s, _, _ = _pixel_sums(photons, shape)
    if tally is not None:
        tally["in_frame"] = tally.get("in_frame", 0.0) + s.sum()
    return s.float().to(device)


def _reference_accumulate(photons, image, tally=None):
    image += _reference_binned(photons, image.shape, image.device, tally)
    return image


@pytest.mark.parametrize("mode", ["sorted", "serial"])
@pytest.mark.parametrize("bf_mode,pre_displaced", [
    ("image", True), ("image", False), ("photon", False)])
def test_accumulate_silicon_is_bit_equal_with_pixel0(
        monkeypatch, bf_mode, pre_displaced, mode):
    """accumulate_silicon in both BF modes, fluxes of 0 and 1, gives the
    image and the tally it gives with the reference's binner patched in;
    in 'image' mode a chunk's `binned` frame also equals the former
    `accumulate(ph, zeros_like(image))`."""
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
        if bf_mode == "image":
            with monkeypatch.context() as m:
                m.setattr(TS, "binned", lambda p, shape, dev, tally=None:
                          simple.accumulate(p, torch.zeros(shape, device=dev),
                                            tally))
                old, t_old = run()
            assert torch.equal(got, old)
            assert torch.equal(t_new["in_frame"], t_old["in_frame"])
        monkeypatch.setattr(TS, "binned", _reference_binned)
        monkeypatch.setattr(TS, "accumulate", _reference_accumulate)
        want, t_ref = run()
    assert float(start.abs().sum()) == 0.0
    assert float(want.sum()) > 1000
    assert torch.equal(got, want)
    assert float(t_new["in_frame"]) == float(t_ref["in_frame"])
