"""The optics' perturbation models in the port (imsim_tpu_torch:
utils/zernike, optics/fea, optics/aos, optics/loader's fea branch,
optics/opd and the trace's optical path and Zernike textures) against
the JAX package, on the CPU: host float64, bit-equal.

The digest of chip_smoke's gate (u) is written here, beside the JAX
package it needs.  Where JAX is installed,

    python tests/test_torch_fea.py

writes imsim_tpu_torch/data/fea_opd_digest.npz: the JAX package's
telescope for phase 11's FEA visit (chip_smoke.FEA_TERMS with doOpt, at
the example catalog's header) and its OPD Zernikes at both fields."""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from imsim_tpu.catalog.bandpass import rubin_bandpass  # noqa: E402
from imsim_tpu.catalog.opsim import read_instcat_header  # noqa: E402
from imsim_tpu.optics import aos as JA  # noqa: E402
from imsim_tpu.optics import fea as JF  # noqa: E402
from imsim_tpu.optics import loader as JL  # noqa: E402
from imsim_tpu.optics import opd as JO  # noqa: E402
from imsim_tpu.optics import trace as JT  # noqa: E402
from imsim_tpu.utils import zernike as JZ  # noqa: E402
from imsim_tpu_torch.optics import aos as TA  # noqa: E402
from imsim_tpu_torch.optics import fea as TF  # noqa: E402
from imsim_tpu_torch.optics import loader as TL  # noqa: E402
from imsim_tpu_torch.optics import opd as TO  # noqa: E402
from imsim_tpu_torch.optics import trace as TT  # noqa: E402
from imsim_tpu_torch.utils import zernike as TZ  # noqa: E402

torch.set_num_threads(1)

DIGEST = os.path.join(REPO, "imsim_tpu_torch", "data", "fea_opd_digest.npz")
DESIGN_KEYS = ("z0", "c", "kappa", "coefs", "aper", "shift", "rot", "zk")
# one of each term, and the whole of phase 11's
TERMS = {
    "m1m3_gravity": {"zenith": "30 deg"},
    "m1m3_lut": {"zenith": 0.6, "error": 0.05, "seed": 3},
    "m1m3_temperature": {"m1m3_TBulk": 1.0, "m1m3_TxGrad": 0.2,
                         "m1m3_TrGrad": -0.1},
    "m2_gravity": {"zenith": "45 deg"},
    "m2_temperature": {"m2_TzGrad": 0.3, "m2_TrGrad": 0.1},
    "camera_gravity": {"zenith": "20 deg", "rotation": "10 deg"},
    "camera_temperature": {"camera_TBulk": -2.0},
    "aos_dof": {"dof": list(np.linspace(-1.0, 1.0, 50))},
}


def _same_design(t, j):
    for k in DESIGN_KEYS:
        a, b = np.asarray(getattr(t, k)), np.asarray(getattr(j, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (t.kinds, t.names) == (j.kinds, j.names)


def test_zernike_polynomials_are_the_jax_package_s():
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-1, 1, (2, 500))
    coef = rng.normal(size=28)
    for j in range(1, 37):
        assert TZ.noll_to_nm(j) == JZ.noll_to_nm(j)
        assert np.array_equal(TZ.zernike_xy_coeffs(j),
                              JZ.zernike_xy_coeffs(j))
    assert np.array_equal(TZ.zernike_eval(coef, x, y),
                          JZ.zernike_eval(coef, x, y))
    for a, b in zip(TZ.zernike_grad(coef, x, y), JZ.zernike_grad(coef, x, y)):
        assert np.array_equal(a, b)
    z = JZ.zernike_eval(coef, x, y)
    assert np.array_equal(TZ.fit_zernikes(x, y, z, 28),
                          JZ.fit_zernikes(x, y, z, 28))


@pytest.mark.parametrize("term", sorted(TERMS))
def test_fea_instructions_per_term(term):
    """Each term's instructions, with the shipped measured tables and with
    the modeled basis (no tables)."""
    for measured in (None, {}):
        jt = JF.fea_instructions({term: TERMS[term]}, measured=measured)
        tt = TF.fea_instructions({term: TERMS[term]}, measured=measured)
        assert len(jt) == len(tt) > 0
        for a, b in zip(tt, jt):
            assert a[:2] == b[:2] and len(a) == len(b)
            for u, v in zip(a[2:], b[2:]):
                assert np.array_equal(np.asarray(u), np.asarray(v))
    assert TF.parse_angle("12 arcsec") == JF.parse_angle("12 arcsec")


def test_shipped_fea_tables_are_byte_copies():
    for name in ("m1m3_modes.npz", "m2_modes.npz"):
        port = os.path.join(REPO, "imsim_tpu_torch", "data", "fea", name)
        jax = os.path.join(REPO, "imsim_tpu", "data", "fea", name)
        assert open(port, "rb").read() == open(jax, "rb").read()
    meas = TF.load_measured_fea()
    assert meas["m1m3"] is not None and meas["m2"] is not None
    with pytest.raises(ValueError, match="unknown fea term"):
        TF.fea_instructions({"m3_gravity": {}})


def test_optical_zernikes_match_the_jax_model():
    for seed in (42, 7):
        j, t = JA.OpticalZernikes(seed=seed), TA.OpticalZernikes(seed=seed)
        assert np.array_equal(t.sensitivity, j.sensitivity)
        assert np.array_equal(t.deviations, j.deviations)
        for fx, fy in ((0.0, 0.0), (1.1, -0.4)):
            assert np.array_equal(t.coefficients(fx, fy),
                                  j.coefficients(fx, fy))
        jt = j.apply_to(JL.load_telescope(band="i"))
        tt = t.apply_to(TL.load_telescope(band="i"))
        _same_design(tt.fiducial, jt.fiducial)
        assert tt._cache == {}
    assert np.array_equal(TA.hexapolar_field_points(),
                          JA.hexapolar_field_points())


@pytest.mark.parametrize("fea", [
    {"M1": [1e-8, -2e-8, 5e-9], "M2": [3e-9]},
    TERMS, chip_smoke.FEA_TERMS], ids=["legacy", "terms", "phase11"])
def test_load_telescope_with_fea_is_the_jax_design(fea):
    j = JL.load_telescope(band="r", fea=fea, rotTelPos=0.2, focusZ=1e-5)
    t = TL.load_telescope(band="r", fea=fea, rotTelPos=0.2, focusZ=1e-5)
    _same_design(t.fiducial, j.fiducial)
    assert np.any(t.fiducial.zk)
    # the rigid-body terms move what the photon chain traces
    if "aos_dof" in fea:
        assert not np.array_equal(t.fiducial.host.surf,
                                  TL.load_telescope(band="r").fiducial
                                  .host.surf)


def _rays(n=3000, seed=2):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(2.6 ** 2, 4.1 ** 2, n))
    a = rng.uniform(0, 2 * np.pi, n)
    return (np.full(n, 0.01), np.full(n, -0.012), r * np.cos(a),
            r * np.sin(a), np.full(n, 622.0))


def test_trace_path_and_textures_match_the_jax_trace():
    """The float64 host trace, with and without the optical path and the
    Zernike textures, bit-equal to the JAX package's numpy trace; the
    path changes nothing else."""
    j = JL.load_telescope(band="r", fea=chip_smoke.FEA_TERMS).fiducial
    t = TL.load_telescope(band="r", fea=chip_smoke.FEA_TERMS).fiducial
    jtex, ttex = JT.build_zk_textures(j, grid=64), \
        TT.build_zk_textures(t, grid=64)
    assert sorted(jtex) == sorted(ttex) and len(ttex) == 3
    for i in ttex:
        assert np.array_equal(ttex[i], jtex[i])
    thx, thy, pu, pv, wl = _rays()
    rj = JT.rays_from_field(np, thx, thy, pu, pv)

    def T(a):
        return torch.as_tensor(a, dtype=torch.float64)

    rt = TT.rays_from_field(T(thx), T(thy), T(pu), T(pv))
    for tex_j, tex_t in ((None, None), (jtex, ttex)):
        for with_path in (False, True):
            oj = JT.trace(j, *rj, wl, np, zk_textures=tex_j,
                          with_path=with_path)
            ot = TT.trace(t.host, *rt, T(wl), zk_textures=tex_t,
                          with_path=with_path)
            for k in ("x", "y", "vx", "vy", "vz", "vignette"):
                assert np.array_equal(ot[k].numpy(), oj[k]), k
            assert (ot["path"] is None) == (not with_path)
            if with_path:
                assert np.array_equal(ot["path"].numpy(), oj["path"])


@pytest.mark.parametrize("fea", [None, chip_smoke.FEA_TERMS],
                         ids=["design", "phase11"])
def test_opd_maps_zernikes_and_sag_match_the_jax_package(fea):
    j = JL.load_telescope(band="r", fea=fea).fiducial
    t = TL.load_telescope(band="r", fea=fea).fiducial
    thx, thy = np.radians(0.7), np.radians(-0.4)
    a = JO.opd_map(j, thx, thy, 622.0, nx=65)
    b = TO.opd_map(t, thx, thy, 622.0, nx=65)
    assert np.array_equal(a[0], b[0], equal_nan=True)
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    for eps in (None, 0.7):
        zj = JO.annular_zernikes(j, thx, thy, 622.0, jmax=28, nx=65,
                                 eps=eps)
        zt = TO.annular_zernikes(t, thx, thy, 622.0, jmax=28, nx=65,
                                 eps=eps)
        assert np.abs(zt - zj).max() <= 1e-6, np.abs(zt - zj).max()
    assert TO.opd_fits_header(thx, thy, 622.0) == \
        JO.opd_fits_header(thx, thy, 622.0)
    for s in ("M1", "M2", "M3", "L1_entrance"):
        for u, v in zip(TO.surface_sag_map(t, s, nx=65),
                        JO.surface_sag_map(j, s, nx=65)):
            assert np.array_equal(u, v, equal_nan=True), s


def export_digest(path: str = DIGEST) -> dict:
    """The JAX package's telescope for phase 11's FEA visit (the example
    catalog's header: band, airmass, seed, rotator; chip_smoke.FEA_TERMS;
    doOpt) and its OPD Zernikes at chip_smoke.OPD_FIELDS."""
    ods = read_instcat_header(os.path.join(REPO, chip_smoke.EXAMPLE_CATALOG))
    band = ods.get("band", "r")
    tel = JL.load_telescope(band=band, fea=chip_smoke.FEA_TERMS,
                            rotTelPos=float(ods.get("rotTelPos", 0.0))
                            * np.pi / 180)
    JA.OpticalZernikes(seed=int(ods.get("seed", 42))).apply_to(tel)
    design = tel.fiducial
    wl = float(rubin_bandpass(band, airmass=float(
        ods.get("airmass", 1.0))).effective_wavelength)
    zk = np.stack([JO.annular_zernikes(
        design, fx * np.pi / 180, fy * np.pi / 180, wl,
        jmax=chip_smoke.OPD_JMAX, eps=JO.OBSCURATION, nx=65)
        for fx, fy in chip_smoke.OPD_FIELDS])
    out = {k: np.asarray(getattr(design, k)) for k in DESIGN_KEYS}
    out.update(opd_zk=zk, wavelength=np.float64(wl), config=_config_json())
    np.savez_compressed(path, **out)
    return out


def _config_json() -> str:
    return json.dumps(dict(fea=chip_smoke.FEA_TERMS,
                           fields=chip_smoke.OPD_FIELDS,
                           jmax=chip_smoke.OPD_JMAX,
                           catalog=chip_smoke.EXAMPLE_CATALOG),
                      sort_keys=True)


def test_digest_belongs_to_phase_11_s_config():
    """The committed digest was written for chip_smoke's FEA visit, and
    the port's telescope for it equals the digest's design."""
    with np.load(DIGEST) as z:
        want = {k: z[k] for k in z.files}
    assert str(want["config"]) == _config_json()
    assert want["opd_zk"].shape == (len(chip_smoke.OPD_FIELDS),
                                chip_smoke.OPD_JMAX)
    from imsim_tpu_torch.catalog.opsim import read_instcat_header as tread

    ods = tread(os.path.join(REPO, chip_smoke.EXAMPLE_CATALOG))
    tel = TL.load_telescope(band=ods.get("band", "r"),
                            fea=chip_smoke.FEA_TERMS)
    TA.OpticalZernikes(seed=int(ods.get("seed", 42))).apply_to(tel)
    for k in DESIGN_KEYS:
        assert np.array_equal(getattr(tel.fiducial, k), want[k]), k


if __name__ == "__main__":
    out = export_digest()
    print(DIGEST, os.path.getsize(DIGEST), "bytes; zk", out["opd_zk"][:, :6])
