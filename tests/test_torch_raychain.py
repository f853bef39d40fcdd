"""K2's plain twin (imsim_tpu_torch.ops.raychain.field_to_sensor on CPU
tensors) against the JAX package's XLA chain
(_field_to_sensor_xla + depth_diffusion_displace) on the same photons,
the same diffraction normal and the same silicon draws, to the bar of
tests/test_optics.py::test_raychain_pallas_matches_xla."""
import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imsim_tpu.electronics.camera import get_camera
from imsim_tpu.optics.wcs_factory import make_wcs_factory
from imsim_tpu.photons.optics_ops import (_field_to_sensor_xla,
                                          make_optics_context)
from imsim_tpu.sensor.silicon import SiliconParams as JSilicon
from imsim_tpu.sensor.silicon import depth_diffusion_displace as j_ddd
from imsim_tpu.sensor.silicon import absorption_length_poly as j_labs
from imsim_tpu.sensor.treerings import TreeRings
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.ops import raychain

torch.set_num_threads(1)

DEG = np.pi / 180
N = 1 << 14


@pytest.fixture(scope="module")
def chain_inputs():
    cam = get_camera()
    fac = make_wcs_factory(30 * DEG, -20 * DEG, mjd=60674.2, band="r")
    octx = make_optics_context(fac, cam["R22_S11"])
    tel = fac.telescope.for_detector("R22_S11")
    rng = np.random.default_rng(11)
    r = np.sqrt(rng.uniform(2.558**2, 4.18**2, N))
    a = rng.uniform(0, 2 * np.pi, N)
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    # field angles over R22_S11 (the focal-plane centre) and its rim
    args = [f32(rng.uniform(-0.0025, 0.0025, N)),
            f32(rng.uniform(-0.0025, 0.0025, N)),
            f32(r * np.cos(a)), f32(r * np.sin(a)),
            f32(rng.uniform(552, 691, N)), f32(rng.uniform(0, 30, N)),
            np.ones(N, np.float32)]
    key = jax.random.PRNGKey(5)
    # the normal the XLA chain draws inside apply_diffraction
    normal = np.array(jax.random.normal(key, (N,)))
    draws = [f32(rng.uniform(1e-7, 1, N)), f32(rng.normal(0, 1, N)),
             f32(rng.normal(0, 1, N))]
    sil = JSilicon.make(treering_model=TreeRings().get("R22_S11"))
    return dict(tel=tel, octx=octx, args=args, key=key, normal=normal,
                draws=draws, sil=sil)


def _port(s, silicon=False):
    T = [torch.as_tensor(a) for a in s["args"]]
    kw = {}
    if silicon:
        kw = dict(silicon=CV.silicon_from_numpy(s["sil"]),
                  si_draws=[torch.as_tensor(d) for d in s["draws"]])
    out = raychain.field_to_sensor(
        CV.telescope_from_numpy(s["tel"]),
        CV.optics_context_from_numpy(s["octx"]), *T,
        torch.as_tensor(s["normal"]), **kw)
    return [o.numpy() for o in out]


def _gaps(s, ref, out):
    """raychain.chain_gaps on numpy outputs (the bar and its reasons
    are documented there)."""
    T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    a = s["args"]
    return raychain.chain_gaps(
        [T(v) for v in ref], [T(v) for v in out],
        CV.optics_context_from_numpy(s["octx"]), T(a[2]), T(a[3]),
        T(a[4]), T(a[5]), T(s["normal"]))


def test_field_to_sensor_plain_matches_xla(chain_inputs):
    s = chain_inputs
    ref = [np.asarray(v) for v in _field_to_sensor_xla(
        s["key"], s["tel"], s["octx"], *map(jnp.asarray, s["args"]))]
    out = _port(s)
    gaps = _gaps(s, ref, out)
    assert gaps["landed"] > 0.85
    assert raychain.gaps_ok(gaps, fused=False), gaps


def test_field_to_sensor_fused_silicon_matches_xla(chain_inputs):
    s = chain_inputs
    rx, ry, rdx, rdy, rf = _field_to_sensor_xla(
        s["key"], s["tel"], s["octx"], *map(jnp.asarray, s["args"]))
    sil = s["sil"]
    rx, ry, rf = j_ddd(*map(jnp.asarray, s["draws"]), rx, ry, rdx, rdy, rf,
                       j_labs(jnp.asarray(s["args"][4])),
                       float(sil.thickness_um), float(sil.pixel_um),
                       float(sil.diffusion_um))
    out = _port(s, silicon=True)
    assert len(out) == 3
    gaps = _gaps(s, (rx, ry, rf), out)
    assert gaps["landed"] > 0.85
    assert raychain.gaps_ok(gaps, fused=True), gaps


def test_chain_gaps_separates_spider_edge_photons():
    """chain_gaps holds photons near a spider edge to a kick-relative
    bar and every other photon to 0.35 px."""
    from imsim_tpu_torch.convert import load_ccd_state

    ctx = load_ccd_state(device="cpu").ctx
    n = 4
    # photon 0 sits 0.1 mm outside the edge of the vane at +0.4 m
    on_vane = (0.4 + 0.025 + 1e-4) / 2 ** 0.5
    pu = torch.tensor([on_vane, 3.0, 3.0, 3.0])
    pv = torch.tensor([on_vane, 0.5, 0.5, 0.5])
    base = [torch.full((n,), 2000.0), torch.full((n,), 2000.0),
            torch.ones(n)]
    moved = [base[0] + torch.tensor([30.0, 0.2, 0.0, 0.0]), base[1],
             base[2]]
    g = raychain.chain_gaps(base, moved, ctx, pu, pv, torch.full((n,), 620.0),
                            torch.zeros(n), torch.ones(n),
                            field_rotation=False)
    assert g["n_near_edge"] == 1 and abs(g["dxy"] - 0.2) < 1e-3
    assert g["near_edge_excess"] < 0.35
    assert raychain.gaps_ok(g, fused=True) is False   # n_on <= 1000


def test_chain_gaps_holds_spider_edge_ties_to_the_kick_bar():
    """A photon at an exact tie between the two parallel vanes at
    +-0.4 m (0.375 m from both edges, far beyond NEAR_EDGE_M) may take
    either vane's kick: the old rule held it to 0.35 px and refused a
    0.6 px gap, chain_gaps now holds it to three of its kicks and
    accepts it.  The same gap off the tie is still refused."""
    from imsim_tpu_torch.convert import load_ccd_state
    from imsim_tpu_torch.photons import diffraction as D

    ctx = load_ccd_state(device="cpu").ctx
    n = 2001
    g = torch.Generator().manual_seed(4)
    # filler photons on the annulus, between the vanes' ends, no gap
    r = torch.sqrt(2.7**2 + torch.rand(n, generator=g) * (4.0**2 - 2.7**2))
    a = torch.rand(n, generator=g) * 2 * np.pi
    pu, pv = r * torch.cos(a), r * torch.sin(a)
    pu[0], pv[0] = 2.4, -2.4              # u + v = 0: the tie
    base = [torch.full((n,), 2000.0), torch.full((n,), 2000.0),
            torch.ones(n)]
    moved = [base[0].clone(), base[1], base[2]]
    moved[0][0] += 0.6
    args = (torch.full((n,), 622.0), torch.zeros(n), torch.ones(n))

    def gaps(u, v):
        return raychain.chain_gaps(base, moved, ctx, u, v, *args,
                                   field_rotation=False)

    two = D.two_nearest_edges(pu[:1], pv[:1])
    assert float(two[1, 0] - two[0, 0]) < D.TIE_M
    assert float(two[0, 0]) > 100 * raychain.NEAR_EDGE_M
    # the old rule: every photon beyond NEAR_EDGE_M in the strict set
    dist = D.spider_distance(pu, pv)
    assert float(dist[0]) > raychain.NEAR_EDGE_M
    assert float((moved[0] - base[0])[dist >= raychain.NEAR_EDGE_M].max()) \
        > 0.35
    new = gaps(pu, pv)
    assert new["n_tie"] == 1 and new["dxy"] == 0.0
    assert 0.0 < new["near_edge_excess"] <= 0.35
    assert raychain.gaps_ok(new, fused=True), new
    # off the tie (u + v = 0.2 m), the same 0.6 px is refused
    off_u = pu.clone()
    off_u[0] = 2.6
    off = gaps(off_u, pv)
    assert off["n_tie"] == 0 and abs(off["dxy"] - 0.6) < 1e-3
    assert not raychain.gaps_ok(off, fused=True)


def test_chain_params_layout_matches_cuda_source():
    """The ctypes mirror of `struct ChainParams` lists the C fields in
    the same order with the same element counts (the card checks the
    total size against the library; this catches a reorder here)."""
    import os

    src = open(os.path.join(os.path.dirname(raychain.__file__), "..",
                            "csrc", "raychain.cu")).read()
    body = re.search(r"struct ChainParams \{(.*?)\};", src, re.S).group(1)
    consts = dict(kMaxSurf=raychain.MAX_SURF, kSurfW=raychain.SURF_W,
                  kNAbs=raychain.N_ABS)
    c_fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for nm in names.split(","):
            m = re.match(r"(\w+)(?:\[(.+)\])?", nm.strip())
            count = 1
            if m.group(2):
                count = eval(m.group(2), {}, consts)
            c_fields.append((m.group(1), ctype, count))
    py_fields = []
    for nm, t in raychain.ChainParams._fields_:
        count = getattr(t, "_length_", 1)
        base = t._type_ if hasattr(t, "_length_") else t
        py_fields.append((nm, "float" if base is ctypes.c_float else "int",
                          count))
    assert c_fields == py_fields
    assert ctypes.sizeof(raychain.ChainParams) == 4 * sum(
        c for _, _, c in c_fields)


def test_chain_params_pack_the_visit(chain_inputs):
    """chain_params packs every surface's folded constants, kinds and
    Newton steps and the folded weather factors."""
    s = chain_inputs
    tel = CV.telescope_from_numpy(s["tel"])
    ctx = CV.optics_context_from_numpy(s["octx"])
    sil = CV.silicon_from_numpy(s["sil"])
    p = raychain.chain_params(tel, ctx, True, True, True, sil)
    S = len(tel.kinds)
    surf = np.frombuffer(p.surf, np.float32).reshape(raychain.MAX_SURF, -1)
    assert (surf[:S] == raychain.surface_block(tel)).all()
    assert not surf[S:].any()
    # the block, column by column, from the float64 surface matrix
    m = tel.surf.astype(np.float64)
    c, k1, coefs = m[:, 0], 1.0 + m[:, 1], m[:, 2:6]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    want = np.concatenate(
        [f32(c)[:, None], f32(k1)[:, None], f32(k1 * c * c)[:, None],
         f32(c * c * k1 / 2)[:, None], f32(coefs),
         f32(coefs * [2, 3, 4, 5]),
         f32(np.where(m[:, 6] > 0, m[:, 6] ** 2, -1.0))[:, None],
         f32(m[:, 7] ** 2)[:, None], f32(m[:, 8:20])], axis=1)
    np.testing.assert_array_equal(surf[:S], want)
    assert list(p.kinds[:S]) == list(tel.kinds)
    assert list(p.newton[:S]) == [tel.newton_steps(i) for i in range(S)]
    # M1-M3 carry aspheric terms: 1 polish step + 2
    assert list(p.newton[:3]) == [3, 3, 3] and p.newton[3] == 1
    assert p.fused == 1 and p.n_surf == S
    t_c = ctx.temperature_k - 273.15
    assert np.isclose(p.air_f3, 1.0 + 0.003661 * t_c)


def test_chain_flops_counts_the_bench_chain(chain_inputs):
    """The per-photon operation count behind K2's bound, summed from the
    `ops[stage] = n` notes of csrc/raychain.cu: one note per stage, and
    the bench telescope (3 aspheric mirrors with 3 Newton steps, 8 lens
    surfaces, the detector) is 2,871 operations fused, 110 fewer without
    the silicon stage, 40 fewer without field rotation."""
    import os

    src = open(os.path.join(os.path.dirname(raychain.__file__), "..",
                            "csrc", "raychain.cu")).read()
    notes = [k for k, _ in re.findall(r"ops\[(\w+)\] = (\d+)", src)]
    assert sorted(notes) == sorted(
        ["dcr", "diffraction", "field_rotation", "entrance", "silica",
         "to_local", "root", "newton", "asphere", "hit", "normal",
         "normal_asphere", "mirror", "refract", "to_global", "pixels",
         "slopes", "silicon"])
    s = chain_inputs
    tel = CV.telescope_from_numpy(s["tel"])
    ctx = CV.optics_context_from_numpy(s["octx"])
    sil = CV.silicon_from_numpy(s["sil"])
    assert tel.kinds == (0, 0, 0, 1, 2, 1, 2, 1, 2, 1, 2, 3)
    count = lambda *a: raychain.chain_flops(  # noqa: E731
        raychain.chain_params(tel, ctx, *a))
    assert count(True, True, True, sil) == 2871
    assert count(True, True, True) == 2871 - 110
    assert count(True, True, False, sil) == 2871 - 40
    assert count(False, False, False) == 2871 - 110 - 40 - 56 - 38


def test_chain_random_on_the_cpu_meets_the_bar():
    """benchmarks/chain_random's CPU run: the wrapper takes the plain
    twin, so both forms agree exactly and nothing lies beyond the bar."""
    from imsim_tpu_torch.benchmarks import chain_random as CR

    out = CR.main("cpu", n=4096, seed=2, log=lambda *_: None)
    for form, r in out.items():
        assert r["beyond_bar"] == [] and r["gaps"]["dxy"] == 0.0, form
        assert r["gaps"]["n_on"] > 1000 and r["ok"], form


def test_chain_random_lists_photons_beyond_the_bar():
    """A photon moved 2 px off the twin's output, far from every spider
    edge, is listed with its two nearest edges, not as a tie, and sets
    the gap; the rest stay within the bar."""
    from imsim_tpu_torch.benchmarks import chain_random as CR
    from imsim_tpu_torch.convert import load_ccd_state
    from imsim_tpu_torch.photons import diffraction as D

    st = load_ccd_state(device="cpu")
    args, _ = CR.photons(4096, 3, "cpu")
    want = raychain.field_to_sensor(st.tel, st.ctx, *args)
    x, y = want[0], want[1]
    dist = D.spider_distance(args[2], args[3], args[5], st.ctx.latitude,
                             st.ctx.bore_alt, st.ctx.bore_az)
    ok = (want[-1] > 0) & (x > 0) & (x < st.ctx.det_nx) & (y > 0) \
        & (y < st.ctx.det_ny) & (dist > 0.05)
    i = int(torch.nonzero(ok)[0, 0])
    got = [w.clone() for w in want]
    got[0][i] += 2.0
    rows = CR.beyond_bar(want, got, st.ctx, args)
    assert [r["photon"] for r in rows] == [i] and not rows[0]["tie"]
    gaps = raychain.chain_gaps(want, got, st.ctx, *args[2:6], args[7])
    assert abs(rows[0]["dxy"] - 2.0) < 1e-3 and gaps["dxy"] == rows[0]["dxy"]
    assert 0.05 < rows[0]["edge1_m"] < rows[0]["edge2_m"]
