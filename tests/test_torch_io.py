"""The port's file layer against the JAX package, on the CPU: the RICE
codec (io/rice.py, the C++ codec built with g++), the FITS writer and
reader (io/fits.py), the eimage / raw-primary / amp headers
(electronics/headers.py), the npz checkpoint container (io/checkpoint.py)
and the cosmic-ray catalog files."""
import os
import pickle

import numpy as np
import pytest

from imsim_tpu.catalog.opsim import from_dict as jfrom_dict
from imsim_tpu.electronics import camera as JC
from imsim_tpu.electronics import headers as JH
from imsim_tpu.image.cosmic_rays import CosmicRayCatalog as JCR
from imsim_tpu.io import fits as JFITS
from imsim_tpu.io import rice as JR
from imsim_tpu.optics.wcs import TanSipWCS as JWCS
from imsim_tpu_torch import _version
from imsim_tpu_torch.catalog.opsim import from_dict as tfrom_dict
from imsim_tpu_torch.electronics import camera as TC
from imsim_tpu_torch.electronics import headers as TH
from imsim_tpu_torch.image.cosmic_rays import CosmicRayCatalog as TCR
from imsim_tpu_torch.io import fits as TFITS
from imsim_tpu_torch.io import rice as TR
from imsim_tpu_torch.io.checkpoint import Checkpointer

from test_rice_interop import _cases


@pytest.mark.parametrize("name,arr", list(_cases()))
def test_rice_bytes_are_the_jax_codec_s(name, arr):
    stream = TR.rice_encode(arr)
    assert stream == JR.rice_encode(arr), name
    np.testing.assert_array_equal(TR.rice_decode(stream, arr.size), arr)
    np.testing.assert_array_equal(JR.rice_decode(stream, arr.size), arr)


def test_rice_edge_cases():
    """The raw-block marker is fs code 26 (fsmax + 1), and the blocks
    start at pixel 0 (one zero-code block for 32 equal pixels)."""
    arr = np.array([0, 2**31 - 1, -2**31, 2**31 - 1] * 8, np.int32)
    assert TR.rice_encode(arr)[4] >> 3 == 26
    stream = TR.rice_encode(np.full(32, 42, np.int32))
    assert len(stream) == 5 and stream[4] == 0
    np.testing.assert_array_equal(TR.rice_decode(stream, 32),
                                  np.full(32, 42, np.int32))
    assert os.path.basename(TR.library_path()).startswith("_rice_")


def _hdus(mod, rng):
    img = rng.normal(0, 1, (7, 9)).astype(np.float32)
    amp = (1000 + rng.poisson(50, (5, 33))).astype(np.int32)
    hdr = {"EXPTIME": 30.0, "FILTER": "r", "FLAG": True, "N": 3,
           "TINY": 1.25e-9, "BIG": 123456789012.0, "NEG": -0.5,
           "QUOTE": "it's", "WHOLE": 2.0}
    table = mod.BinTableHDU(
        {"fp_id": np.arange(4, dtype=np.int32),
         "x0": np.array([1, 2, 3, 4], np.int16),
         "v": np.arange(8, dtype=np.float64).reshape(4, 2),
         "name": np.array(["a", "bb", "ccc", "d"]),
         "pix": [np.arange(k + 1, dtype=np.int32) for k in range(4)]},
        name="TAB", header={"EXPTIME": 2.5})
    return [[mod.HDU(img, header=hdr)],
            [mod.HDU(None, header={"ORIGIN": "x"}, is_primary=True),
             mod.HDU(amp, header={"EXTNAME": "Segment10"},
                     compress="rice"),
             mod.HDU(amp.astype(np.uint16), name="U16")],
            [mod.HDU(None, is_primary=True), table]]


def test_write_fits_gives_the_jax_bytes_and_reads_back(tmp_path):
    """Image, RICE and binary-table HDUs: the port's files are the JAX
    package's byte for byte, and each reader reads the other's."""
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    for k, (jh, th) in enumerate(zip(_hdus(JFITS, rng_j),
                                     _hdus(TFITS, rng_t))):
        pj, pt = str(tmp_path / f"j{k}.fits"), str(tmp_path / f"t{k}.fits")
        JFITS.write_fits(pj, jh)
        TFITS.write_fits(pt, th)
        assert open(pt, "rb").read() == open(pj, "rb").read(), k
        for (hj, dj), (ht, dt) in zip(JFITS.read_fits(pt),
                                      TFITS.read_fits(pj)):
            assert hj == ht
            if isinstance(dj, bytes):
                assert dj == dt
                got = TFITS.read_bintable(ht, dt)
                want = JFITS.read_bintable(hj, dj)
                assert list(got) == list(want)
            elif dj is not None:
                np.testing.assert_array_equal(dj, dt)
    # the RICE segment decodes to the written amp, exactly
    amp = _hdus(TFITS, np.random.default_rng(4))[1][1].data
    seg = TFITS.read_fits(str(tmp_path / "t1.fits"))[1][1]
    assert seg.dtype == np.int32
    np.testing.assert_array_equal(seg, amp)


OPSIM = dict(fieldRA=30.0, fieldDec=-20.0, observationStartMJD=60674.2,
             band="i", rawSeeing=0.7, exptime=30.0, observationId=4242,
             rotTelPos=12.5, altitude=60.0, azimuth=40.0, seqnum=7)


def _wcs(mod):
    a = np.array([1e-6, -2e-7, 3e-8])
    return mod(np.array([2047.5, 2001.5]),
               np.array([[-5.5e-5, 1e-7], [2e-7, 5.5e-5]]),
               np.array([0.5, -0.35]), a_coeffs=a, b_coeffs=-a,
               ab_powers=[(2, 0), (1, 1), (0, 2)])


@pytest.mark.parametrize("det,camera", [("R22_S11", "LsstCamSim"),
                                        ("R10_S11", "LsstCamSim"),
                                        ("R22_S11", "LsstComCamSim")])
def test_headers_are_the_jax_package_s(det, camera):
    """eimage, raw-primary and amp headers card for card (IMSIMVER is the
    port's version); E2V and ITL amp layouts."""
    from imsim_tpu_torch.optics.wcs import TanSipWCS as TWCS

    jw, tw = _wcs(JWCS), _wcs(TWCS)
    for w in (jw, tw):
        w.order = 2
    jcam, tcam = JC.get_camera(camera), TC.get_camera(camera)
    jccd, tccd = jcam[det], tcam[det]
    je = JH.eimage_header(jfrom_dict(dict(OPSIM)), det, jccd.getSerial(),
                          jccd.vendor, camera, jw, 17.25)
    te = TH.eimage_header(tfrom_dict(dict(OPSIM)), det, tccd.getSerial(),
                          tccd.vendor, camera, tw, 17.25)
    assert list(te.items()) == list(je.items())
    jp = JH.raw_primary_header(je, jccd.getSerial(), camera)
    tp = TH.raw_primary_header(te, tccd.getSerial(), camera)
    assert tp.pop("IMSIMVER") == _version.__version__
    jp.pop("IMSIMVER")
    assert list(tp.items()) == list(jp.items())
    for aname in tccd.amp_names:
        assert list(TH.amp_header(tccd, tccd[aname], tw).items()) == \
            list(JH.amp_header(jccd, jccd[aname], jw).items())
    # and the card text of the written headers
    cards_t = [TFITS._card(k, v) for k, v in tp.items()]
    cards_j = [JFITS._card(k, v) for k, v in jp.items()]
    assert cards_t == cards_j
    assert TH.mjd_to_isot(60674.2) == JH.mjd_to_isot(60674.2)
    assert TH.dayobs(60674.2) == JH.dayobs(60674.2)


def test_checkpointer_roundtrip_and_recovery(tmp_path):
    """save / load / names, and the crash cases of the _new / _bak
    protocol: a truncated _new beside an intact file, a crash between the
    renames (only _new and _bak left), only _bak left."""
    f = str(tmp_path / "ckpt.npz")
    ck = Checkpointer(f)
    assert ck.load("a") is None and ck.names() == []
    ck.save("a", {"x": np.arange(5), "n": 3})
    ck.save("b", "hello")
    assert Checkpointer(f).load("a")["n"] == 3
    np.testing.assert_array_equal(Checkpointer(f).load("a")["x"],
                                  np.arange(5))
    assert Checkpointer(f).load("b") == "hello"
    assert Checkpointer(f).load("missing") is None
    assert set(Checkpointer(f).names()) == {"a", "b"}
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz"]
    # a crash while writing _new: the intact current file wins
    ck.save("b", "old")
    with open(f + "_new", "wb") as fn:
        fn.write(b"truncat")
    assert Checkpointer(f).load("b") == "old"
    assert not os.path.exists(f + "_new")
    # a crash between the renames: current moved to _bak, _new complete
    ck.save("b", "new")
    os.replace(f, f + "_bak")
    with open(f + "_new", "wb") as fn:
        np.savez(fn, b=np.frombuffer(pickle.dumps("newest"), np.uint8))
    assert Checkpointer(f).load("b") == "newest"
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz"]
    # only _bak survived
    os.replace(f, f + "_bak")
    assert Checkpointer(f).load("b") == "newest"
    # dir= joins the directory, made on open
    ck = Checkpointer("c.npz", dir=str(tmp_path / "sub"))
    ck.save("k", 1)
    assert os.path.isfile(tmp_path / "sub" / "c.npz")


def test_cosmic_ray_catalog_files(tmp_path):
    """A saved footprint bank and the reference's span catalog (written by
    the JAX package) load in the port as in the JAX package."""
    cat = JCR.synthesize(40, seed=3)
    p = str(tmp_path / "crs.npz")
    cat.save(p)
    for a, b in zip(TCR.load(p).footprints, JCR.load(p).footprints):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    f = str(tmp_path / "crs.fits")
    cat.write_catalog_fits(f, exptime=20.0)
    tc, trate = TCR.read_catalog_fits(f)
    jc, jrate = JCR.read_catalog_fits(f)
    assert trate == jrate and len(tc) == len(jc) == 40
    for a, b in zip(tc.footprints, jc.footprints):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_flats_resume_from_their_checkpoints(tmp_path):
    """build_flat and build_flat_photons save their image every 10
    iterations; a flat resumed from a 10-iteration flat's checkpoint is
    the uninterrupted flat bit for bit (each iteration draws from its own
    stream)."""
    import torch

    from imsim_tpu_torch.image import flat as FL
    from imsim_tpu_torch.image.scene import WL_CDF_K

    torch.set_num_threads(1)
    wl = np.linspace(550.0, 700.0, WL_CDF_K)
    runs = [(lambda cfg, ck: FL.build_flat(3, cfg, device="cpu",
                                           checkpointer=ck), 100.0),
            (lambda cfg, ck: FL.build_flat_photons(
                3, cfg, wl, device="cpu", checkpointer=ck), 2.0)]
    for k, (build, per_iter) in enumerate(runs):
        short = FL.FlatConfig(counts_per_pixel=10 * per_iter,
                              counts_per_iter=per_iter, xsize=48, ysize=40)
        full = FL.FlatConfig(counts_per_pixel=20 * per_iter,
                             counts_per_iter=per_iter, xsize=48, ysize=40)
        ref = build(full, None)
        ck = Checkpointer(str(tmp_path / f"flat{k}.npz"))
        build(short, ck)
        assert ck.names() == ["flat" if k == 0 else "flat_phot"]
        resumed = build(full, ck)
        assert torch.equal(resumed, ref)
        # the finished flat's checkpoint leaves nothing to do
        assert torch.equal(build(full, ck), ref)
