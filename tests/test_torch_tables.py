"""The port's host tables of a CCD's state against the JAX package's:
the profile inverse CDFs (von Karman, obscured Airy, second kick, the
Sersic grid and its 2-D Chebyshev fit, the exponential disk), the
PolyCDF fit and inverse_cdf_table, the seeing solve, and the screen
spec's numpy draws of layer weights and winds.  All are numpy / scipy
copies run on the same inputs, so each is bit-equal."""
import dataclasses

import numpy as np
import pytest
import torch

from imsim_tpu.photons import profiles as JP
from imsim_tpu.psf import atmosphere as JA
from imsim_tpu.utils import lookup as JL
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.photons import profiles as TP
from imsim_tpu_torch.psf import atmosphere as TA
from imsim_tpu_torch.utils import lookup as TL

torch.set_num_threads(1)


def _same_table(t, j):
    assert (t.x0, t.dx) == (j.x0, j.dx)
    a, b = np.asarray(t.y), np.asarray(j.y)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def _same_poly(t, j):
    want = CV.polycdf_from_numpy(j)
    for k in ("c_core", "c_tail"):
        np.testing.assert_array_equal(getattr(t, k), getattr(want, k))
    assert (t.u_split, t.s_lo, t.s_hi) == (want.u_split, want.s_lo,
                                           want.s_hi)


@pytest.mark.parametrize("lam, fwhm", [(622.0, 0.7), (480.0, 0.9)])
def test_second_kick_table_and_fit(lam, fwhm):
    t_cfg, j_cfg = TA.AtmConfig(fwhm=fwhm), JA.AtmConfig(fwhm=fwhm)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert TA.solve_r0_500(fwhm, 25.0) == JA.solve_r0_500(fwhm, 25.0)
    assert TA.vk_fwhm_factor(0.15, 25.0) == JA.vk_fwhm_factor(0.15, 25.0)
    t_tab = TA.second_kick_table(t_cfg, lam)
    j_tab = JA.second_kick_table(j_cfg, lam)
    _same_table(t_tab, j_tab)
    (tp, terr), (jp, jerr) = TL.PolyCDF.fit(t_tab), JL.PolyCDF.fit(j_tab)
    assert terr == jerr
    _same_poly(tp, jp)
    u = torch.linspace(0, 1, 1001)
    assert torch.equal(tp(u), CV.polycdf_from_numpy(jp)(u))


def test_radial_cdfs():
    _same_table(TP.vonkarman_cdf(622.0, 0.17), JP.vonkarman_cdf(622.0, 0.17))
    _same_table(TP.airy_cdf(622.0), JP.airy_cdf(622.0))
    _same_table(TP.airy_cdf(870.0, 8.36, 0.5), JP.airy_cdf(870.0, 8.36, 0.5))


def test_sersic_tables():
    np.testing.assert_array_equal(TP.sersic_cdf_grid(), JP.sersic_cdf_grid())
    assert TP.sersic_cdf_grid().dtype == np.float32
    got = TP.sersic_poly2d()
    want = CV.sersic_from_numpy(JP.sersic_poly2d())
    for k in ("D_core", "D_tail"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert (got.n_lo, got.n_hi, got.u_split, got.s_lo, got.s_hi) == (
        want.n_lo, want.n_hi, want.u_split, want.s_lo, want.s_hi)
    _same_poly(TP.exp_disk_poly(), JP.exp_disk_poly())


def test_inverse_cdf_table():
    x = np.linspace(0.0, 5.0, 300)
    pdf = x * np.exp(-x) + 0.01 * (x > 4)
    _same_table(TL.inverse_cdf_table(x, pdf, n=1024),
                JL.inverse_cdf_table(x, pdf, n=1024))


@pytest.mark.parametrize("seed, fwhm, alt", [(42 + 271828, 0.7, 90.0),
                                             (7, 1.1, 55.0)])
def test_screen_spec_matches_make_screens(seed, fwhm, alt):
    """The weights and winds of the JAX package's make_screens (a small
    screen keeps its FFT cheap; the draws do not depend on the size),
    and the synthesis constants the exported state carries."""
    kw = dict(fwhm=fwhm, altitude_deg=alt, screen_size=51.2, t0=1.5)
    spec = TA.screen_spec(seed, TA.AtmConfig(**kw))
    j = JA.make_screens(seed, JA.AtmConfig(**kw))
    assert spec.weights == j.weights
    np.testing.assert_array_equal(spec.winds, np.asarray(j.winds))
    assert spec.winds.dtype == np.float32
    airmass = 1.0 / max(np.sin(np.radians(alt)), 0.1)
    r0 = JA.solve_r0_500(fwhm, 25.0) * airmass ** (-3.0 / 5.0)
    want = CV.screen_spec_from_numpy(j, r0, 25.0, 0.2)
    np.testing.assert_array_equal(spec.r0_layer, want.r0_layer)
    assert (spec.L0, spec.kcrit_rad, spec.size, spec.scale, spec.t0) == (
        want.L0, want.kcrit_rad, want.size, want.scale, want.t0)
    assert spec.n == 64
