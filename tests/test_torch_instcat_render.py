"""Both runners render one instance-catalog CCD window on the CPU: the
JAX package's config/runner.render_one_ccd and the port's
(imsim_tpu_torch.config.runner), on the ~300-object generated catalog of
test_torch_instcat_ccd.py, R22_S11's central 512 x 512 window (the JAX
prep seen through the same window).  Renders are random draws, so they
are compared statistically: the total charge, the bright stars'
centroids, and the sky stage's mean."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from imsim_tpu.config import runner as JR
from imsim_tpu.image.ccd_render import _add_sky_and_noise
from imsim_tpu.utils.rng import stream as jstream
from imsim_tpu_torch.benchmarks import instcat_workload as W
from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.image import photon_pooling as TPP
from imsim_tpu_torch.image.ccd_render import (add_sky_and_noise,
                                              sky_expectation)
from imsim_tpu_torch.utils.rng import stream

from test_torch_instcat_ccd import DET, SMALL, WINDOW, jax_context

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return W.write_workload(str(tmp_path_factory.mktemp("instcat")), **SMALL)


def _jax_window(jctx, jprep, h, w):
    """The JAX prep seen through the CCD's central h x w window, as the
    port's prepare_ccd(window=) builds it."""
    ccd = jprep.ccd
    x0 = (ccd.bounds.width - w) // 2
    y0 = (ccd.bounds.height - h) // 2
    host = dataclasses.replace(jprep.host, pix_x=jprep.host.pix_x - x0,
                               pix_y=jprep.host.pix_y - y0)
    return dataclasses.replace(
        jprep, wcs=TR.WindowWCS(jprep.wcs, x0, y0), host=host,
        octx=dataclasses.replace(jprep.octx, det_nx=w, det_ny=h),
        pcfg=dataclasses.replace(jprep.pcfg, xsize=w, ysize=h))


def _centroids(img, xs, ys, r=5):
    out = []
    for x, y in zip(xs, ys):
        ix, iy = int(round(x)), int(round(y))
        box = np.asarray(img[iy - r:iy + r + 1, ix - r:ix + r + 1],
                         np.float64)
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        s = box.sum()
        out.append(((box * xx).sum() / s + ix - x,
                    (box * yy).sum() / s + iy - y, s))
    return np.array(out)


def test_render_matches_the_jax_render(small):
    """Both runners render the window with the sky off: the charge within
    5 sqrt of it (cosmic rays are the same hits in both), the centroids of
    the bright, isolated stars within 5 sigma; then each package's sky
    stage on that window, with its own pieces at the sky model's level:
    the mean within 5 sigma of level x gradient x vignetting."""
    cat, seds = small["catalog"]["r"], small["sed_dir"]
    jctx = jax_context(cat, seds, **{"image.sky_level": 0})
    jprep = _jax_window(jctx, JR.prepare_ccd(jctx, 94), *WINDOW)
    jimg = np.asarray(JR.render_one_ccd(jctx, 94, write=False,
                                        prep=jprep)["eimage"])
    tctx = W.visit_context(cat, seds, {
        "image.sky_level": 0, "input.atm_psf.screen_size": 102.4})
    res = TR.render_one_ccd(tctx, DET, "cpu", window=WINDOW)
    timg = res["eimage"].numpy()
    assert timg.shape == jimg.shape == WINDOW
    assert res["pieces"] is None and res["amps"].shape == (16, 2048, 576)
    assert set(res["seconds"]) >= {"cull", "scene", "state", "render",
                                   "sky", "readout"}
    sj, st = jimg.sum(dtype=np.float64), timg.sum(dtype=np.float64)
    assert abs(sj - st) <= 5 * np.sqrt(sj), (sj, st)
    assert int((res["modes"] == TPP.FFT).sum()) == 2
    # stars of >= 2e3 photons, 8 px from the edges and 12 px from every
    # other object of 1% of their flux: centroids within 5 sigma of each
    # other (sigma: 2.5 px / sqrt(photons) each)
    prep = res["prep"]
    host, tab = prep.host, prep.table
    n = host.n_objects
    x, y, f = host.pix_x, host.pix_y, host.nominal_flux[:n]
    pick = []
    for i in np.nonzero((tab.obj_type == 0) & (f > 2e3))[0]:
        near = (np.hypot(x - x[i], y - y[i]) < 12) & (f > 0.01 * f[i])
        if near.sum() == 1 and 8 < x[i] < WINDOW[1] - 9 and \
                8 < y[i] < WINDOW[0] - 9:
            pick.append(i)
    assert len(pick) >= 3
    cj = _centroids(jimg, x[pick], y[pick])
    ct = _centroids(timg, x[pick], y[pick])
    bar = 5 * np.sqrt(2) * 2.5 / np.sqrt(np.minimum(cj[:, 2], ct[:, 2]))
    assert (np.abs(cj[:, :2] - ct[:, :2]).max(axis=1) < bar).all(), \
        (cj, ct, bar)

    # the sky stage on the window, each package with its own pieces at
    # the sky model's level at the CCD centre (test_torch_instcat_ccd
    # holds the levels equal)
    jprep = dataclasses.replace(jprep, sky_level=jctx.sky_model.get_sky_level(
        jprep.ra_c, jprep.dec_c))
    jl, jg, jv, jstep, _ = JR._sky_noise_pieces(jctx, jprep)
    tprep = dataclasses.replace(prep, sky_level=tctx.sky_model.get_sky_level(
        prep.ra_c, prep.dec_c))
    tl, tg, tv, tstep, _ = TR.sky_noise_pieces(tctx, tprep)
    js = np.asarray(_add_sky_and_noise(
        jstream(1, "sky", 94), jnp.zeros(WINDOW, jnp.float32),
        jnp.float32(jl), jg, jnp.asarray(jv), 0.2, vig_step=jstep))
    ts = add_sky_and_noise(stream(1, "sky", 94, device="cpu"),
                           torch.zeros(WINDOW), float(np.float32(tl)), tg,
                           tv, 0.2, vig_step=tstep)
    want = float(sky_expectation(WINDOW, float(np.float32(tl)), tg, tv, 0.2,
                                 tstep, device="cpu").double().mean())
    sigma = np.sqrt(want / (WINDOW[0] * WINDOW[1]))
    for got in (float(js.mean(dtype=np.float64)),
                float(ts.double().mean())):
        assert abs(got - want) <= 5 * sigma, (got, want, sigma)
