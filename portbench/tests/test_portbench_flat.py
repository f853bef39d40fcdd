"""The flat cell (lsst_flat_sed.flat) rehearsed on the CPU, the look for a
card skipped: a 256 x 512 corner of R22_S11 at 800 e-/px in iterations
of 25 reads `correct`; the program broken underneath (no BF kernel,
tree rings off, half of each sub-batch's photons dropped, the flat x
0.9) and the control (the reference in bfloat16 in its place) read not
correct.  A flat this small holds too few photons to show the BF droop
of the kernel at strength 0.4 (5e-3 of var / mean at 2,000 e-/px, the
noise here 6e-3), so both sides take the kernel 100 times stronger, and
the limits are this size's own: each about four times the noise of its
number here, the sound runs' readings below it, the faults' above."""
import copy
import json
import subprocess
import sys

import pytest

from portbench import control, harness, run

SEED = 3_000_000_019          # past 32 signed bits, as the driver's are
NAME = "lsst_flat_sed.flat"
BOOST = 100.0
W, H, LEVEL, PER_ITER = 256, 512, 800, 25
# var / mean and the covariances over (H - 16) x (W - 16) pixels: noise
# sqrt(2 / N) = 0.0058 and sqrt(1 / N) = 0.0041 on each side; the ring
# amplitude's about 0.12 over 30 annuli of 4,000 pixels
LIMITS = {"level_rel": 0.001, "vom_gap": 0.03, "cov_gap": 0.02,
          "treering_gap": 0.6}


@pytest.fixture(autouse=True)
def strong_bf(monkeypatch):
    from imsim_tpu_torch.sensor import silicon

    real = silicon.default_bf_kernel
    monkeypatch.setattr(silicon, "default_bf_kernel",
                        lambda radius=4, strength=0.4: real(
                            radius, strength * BOOST))


def _cell():
    c = harness.Cell(NAME, limits=LIMITS)
    cfg = copy.deepcopy(c.config)
    cfg.update(counts_per_pixel=LEVEL, counts_per_iter=PER_ITER)
    cfg["program"].update({"image.xsize": W, "image.ysize": H,
                           "image.counts_per_pixel": LEVEL,
                           "image.counts_per_iter": PER_ITER})
    cfg["silicon"]["bf_strength"] *= BOOST
    cfg["check"]["ring_min_pixels"] = 1500
    c.config = cfg
    return c


def _last_line(capsys, trace=0):
    rc = run.main(["--workload", NAME, "--seed", str(SEED), "--seconds",
                   "0.1", "--trace", str(trace)], device_check=False,
                  cell=_cell())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_flat_reads_correct(capsys, trace):
    out = _last_line(capsys, trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(LIMITS)
    assert out["attempted"] == 1 and out["failed"] == 0
    if trace:
        # no device seconds on the CPU: the span readers give nothing,
        # the profiler's share of idle does
        assert "device_idle.flat" in out["metrics"]
        assert set(out["metrics"]) <= {m["name"] for m in _cell().per_layer}
    else:
        assert set(out["metrics"]) == {"ccd_s", "setup_s"}


def _no_bf(monkeypatch):
    from imsim_tpu_torch.sensor import silicon

    real = silicon.default_bf_kernel
    monkeypatch.setattr(silicon, "default_bf_kernel",
                        lambda radius=4, strength=0.4: 0.0 * real(radius))


def _no_rings(monkeypatch):
    import torch

    from imsim_tpu_torch.image import flat

    monkeypatch.setattr(flat, "tree_ring_field", lambda params, shape, dev: (
        torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)))


def _half_photons(monkeypatch):
    from imsim_tpu_torch.image import flat

    real = flat.accumulate_silicon

    def half(ph, *a, **k):
        flux = ph.flux.clone()
        flux[ph.n // 2:] = 0
        return real(ph.replace(flux=flux), *a, **k)

    monkeypatch.setattr(flat, "accumulate_silicon", half)


def _scaled(monkeypatch):
    from imsim_tpu_torch.image import flat

    real = flat.build_flat_photons
    monkeypatch.setattr(flat, "build_flat_photons",
                        lambda *a, **k: real(*a, **k) * 0.9)


@pytest.mark.parametrize("fault,fails", [
    (_no_bf, {"vom_gap"}), (_no_rings, {"treering_gap"}),
    (_half_photons, {"level_rel"}), (_scaled, {"level_rel"})],
    ids=["no_bf", "no_rings", "half_photons", "flat_scaled"])
def test_broken_flat_is_not_correct(capsys, monkeypatch, fault, fails):
    fault(monkeypatch)
    out = _last_line(capsys)
    assert not out["correct"], out["checks"]
    bad = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    assert fails <= bad, out["checks"]


def test_control_comes_out_not_correct():
    r = control.readings(_cell(), SEED, 0.1, "cpu")
    assert not [k for k, v in r["program"].items() if v > r["limits"][k]]
    assert r["control_fails"], r
    for name, want in [("no_bf", "vom_gap"), ("no_rings", "treering_gap"),
                       ("half_photons", "level_rel"),
                       ("scale_0.9", "level_rel")]:
        assert r["faults"][name][want] > r["limits"][want], (name, r)


def test_reference_loads_nothing_forbidden():
    code = ("import sys; import portbench.reference.flat; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'imsim_tpu', "
            "'imsim_tpu_torch')))")
    got = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert got.stdout.strip() == "[]"
