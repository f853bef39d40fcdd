"""The port's own ray-surface math (imsim_tpu_torch.optics.geometry)
against the JAX package's array-generic imsim_tpu.optics.geometry run
with xp = jax.numpy (as the package runs it), on the same float32 rays
made from a seed with numpy.

Both evaluate the same float32 operations in the same order (python
floats folded in float64 first); torch divides by a python float as a
multiply by its reciprocal and XLA may not, so they agree to a few
float32 ulps, not bitwise.  Bars: hit points and path lengths 1e-6 m
(2 ulps at the 4.2 m aperture), the Newton residual 5e-7 m, unit vectors
1e-6 (8 ulps of 1), indices 1e-6 relative; rays are compared where the
reference converged (|F| < 1e-5, the trace's own vignetting test)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imsim_tpu.optics import geometry as JG
from imsim_tpu_torch.optics import geometry as TG

torch.set_num_threads(1)

N = 20_000


def _close(got, want, atol, rtol=0.0, mask=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _rays(seed, rmax):
    """Rays aimed down at a local surface frame: p within radius rmax,
    0.1-2 m above the vertex, slopes up to 0.3."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    r = np.sqrt(rng.uniform(0, rmax**2, N))
    a = rng.uniform(0, 2 * np.pi, N)
    tx, ty = rng.uniform(-0.3, 0.3, (2, N))
    vz = -1.0 / np.sqrt(1.0 + tx * tx + ty * ty)
    return (f32(r * np.cos(a)), f32(r * np.sin(a)),
            f32(rng.uniform(0.1, 2.0, N)), f32(-tx * vz), f32(-ty * vz),
            f32(vz))


# (c, kappa, coefs): a plane, a sphere, M1-like and M2-like conics with
# the asphere terms of an even polynomial, an oblate ellipsoid without
# terms; rays reach r = min(4.18 m, 0.3 / |c|)
SURFACES = [
    (0.0, 0.0, ()),
    (1.0 / 5.0, 0.0, ()),
    (1.0 / 19.835, -1.215, (1.4e-5, -2.1e-7, 1.2e-9, 0.0)),
    (-1.0 / 6.788, -0.222, (-1.3e-3, 1.1e-5, -2.0e-7, 3.0e-9)),
    (1.0 / 8.344, 0.155, ()),
]


@pytest.mark.parametrize("surface", range(len(SURFACES)))
def test_intersect_and_normal_match_jax_package(surface):
    c, kappa, coefs = SURFACES[surface]
    rays = _rays(surface, min(4.18, 0.3 / abs(c)) if c else 4.18)
    want = [np.asarray(w) for w in JG.intersect(
        jnp, *map(jnp.asarray, rays), c, kappa, coefs)]
    got = TG.intersect(*map(torch.as_tensor, rays), c, kappa, coefs)
    ok = np.abs(want[4]) < 1e-5
    assert ok.mean() > 0.99
    for g, w in zip(got[:4], want[:4]):
        _close(g, w, 1e-6, mask=ok)
    _close(got[4], want[4], 5e-7, mask=ok)
    x, y = want[0], want[1]
    for g, w in zip(TG.surface_normal(torch.as_tensor(x),
                                      torch.as_tensor(y), c, kappa, coefs),
                    JG.surface_normal(jnp, jnp.asarray(x),
                                      jnp.asarray(y), c, kappa, coefs)):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("eta", [1.0 / 1.46, 1.46])
def test_reflect_and_refract_match_jax_package(eta):
    rng = np.random.default_rng(7)
    v = rng.normal(size=(3, N))
    v[2] = -np.abs(v[2]) - 2.0
    v /= np.linalg.norm(v, axis=0)
    n = rng.normal(0, 0.2, size=(3, N))
    n[2] = 1.0
    n /= np.linalg.norm(n, axis=0)
    v, n = v.astype(np.float32), n.astype(np.float32)
    T = [torch.as_tensor(a) for a in (*v, *n)]
    J = [jnp.asarray(a) for a in (*v, *n)]
    for g, w in zip(TG.reflect(*T), JG.reflect(jnp, *J)):
        _close(g, w, 1e-6)
    for g, w in zip(TG.refract(*T, eta), JG.refract(jnp, *J, eta)):
        _close(g, w, 1e-6)


def test_indices_match_jax_package():
    wl = np.linspace(320.0, 1100.0, 4001).astype(np.float32)
    _close(TG.silica_index(torch.as_tensor(wl)),
           JG.silica_index(jnp, jnp.asarray(wl)), 0.0, rtol=1e-6)
    for kw in ({}, dict(pressure_kpa=75.0, temperature_k=280.0,
                        h2o_pressure_kpa=0.4)):
        _close(TG.air_index_excess(torch.as_tensor(wl), **kw),
               JG.air_index_excess(jnp, jnp.asarray(wl), **kw), 0.0,
               rtol=1e-6)
    assert TG.NEWTON_POLISH == JG.NEWTON_POLISH
