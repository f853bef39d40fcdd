"""The port's sensor model (imsim_tpu_torch/sensor/sensor_model.py)
against the JAX package's, on the CPU, on Poisson-solver vertex files
forward-generated by tests/test_sensor_model.py's synth_vertex_file (and
by the workload generator's copy of it): every function bit-equal; the
runner's silicon with image.sensor.sensor_model equal to the JAX
runner's, and its K3 taps from that kernel."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from imsim_tpu.config import runner as JR
from imsim_tpu.sensor import sensor_model as JSM
from imsim_tpu_torch import convert as CV
from imsim_tpu_torch.benchmarks import skycat_workload as W
from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.sensor import sensor_model as TSM
from imsim_tpu_torch.sensor.silicon import bf_taps

from test_sensor_model import synth_vertex_file
from test_config_pipeline import instcat, sed_dir  # noqa: F401
from test_torch_visit import _over

torch.set_num_threads(1)


@pytest.fixture(params=[(2.0e-7, 0.3, False), (1.0e-6, 0.7, True),
                        (2.0e-6, 0.5, True)],
                ids=["weak-nocfg", "mid-cfg", "strong-cfg"])
def vertex_file(tmp_path, request):
    amp, core, cfg = request.param
    p = str(tmp_path / "lsst_e2v_synth.dat")
    synth_vertex_file(p, amp=amp, core=core)
    if cfg:
        (tmp_path / "lsst_e2v_synth.cfg").write_text(
            "# run\nPixelSizeX = 10\nCollectedCharge_0_0 = 90000 # e-\n"
            "FilledPixelCoords_0_0 = 55.0 55.0\nName = synth run\n")
    return p


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_every_function_is_bit_equal(vertex_file):
    cfg = vertex_file[:-4] + ".cfg"
    if os.path.exists(cfg):
        assert TSM.read_cfg(cfg) == JSM.read_cfg(cfg)
    for a, b in zip(TSM.read_vertex_file(vertex_file),
                    JSM.read_vertex_file(vertex_file)):
        assert _same(a, b)
    assert TSM._cfg_for(vertex_file) == JSM._cfg_for(vertex_file)
    for a, b in zip(TSM.pixel_areas(vertex_file),
                    JSM.pixel_areas(vertex_file)):
        assert _same(a, b)
    for nbin in (48, 17):
        for a, b in zip(TSM.radial_displacement_profile(vertex_file, nbin),
                        JSM.radial_displacement_profile(vertex_file, nbin)):
            assert _same(a, b)
    for kw in ({}, {"radius": 3, "strength": 0.7}, {"ngrid": 32}):
        assert _same(TSM.bf_kernel_from_model(vertex_file, **kw),
                     JSM.bf_kernel_from_model(vertex_file, **kw))
    assert _same(TSM._kernel_cached(vertex_file, 4, 1.3),
                 JSM._kernel_cached(vertex_file, 4, 1.3))


def test_resolve_sensor_model(tmp_path):
    p = str(tmp_path / "lsst_itl_50_8.dat")
    synth_vertex_file(p)
    dirs = [str(tmp_path / "none"), str(tmp_path)]
    for name in ("lsst_itl_50_8", "lsst_itl_50_8.dat", p,
                 "lsst_{vendor}_50_8".format(vendor="itl")):
        assert TSM.resolve_sensor_model(name, dirs) == \
            JSM.resolve_sensor_model(name, dirs) == p
    with pytest.raises(FileNotFoundError):
        TSM.resolve_sensor_model("nope", dirs)


def test_the_workload_generator_writes_the_test_generator_s_file(tmp_path):
    """skycat_workload.synth_vertex_file is the tests' generator: the same
    bytes."""
    a, b = str(tmp_path / "a.dat"), str(tmp_path / "b.dat")
    synth_vertex_file(a, amp=1.5e-6, core=0.6)
    W.synth_vertex_file(b, amp=1.5e-6, core=0.6)
    assert open(a).read() == open(b).read()
    assert os.path.exists(b[:-4] + ".cfg")


@pytest.mark.parametrize("det, strength, where", [
    (94, 1.0, "dir"), (94, 0.6, "data_dir"), (31, 1.0, "data_dir_models")])
def test_runner_silicon_matches_the_jax_runner(tmp_path, monkeypatch,
                                               instcat, sed_dir,  # noqa: F811
                                               det, strength, where):
    """image.sensor.sensor_model with the '{vendor}' placeholder, found in
    sensor_model_dir, $IMSIM_DATA_DIR/sensor_models or $IMSIM_DATA_DIR:
    the silicon (tree rings, BF kernel at `strength`) equal to the JAX
    runner's, field by field; K3's taps are the kernel's."""
    root = tmp_path / "models"
    sub = root / "sensor_models" if where == "data_dir_models" else root
    sub.mkdir(parents=True)
    for vendor, (amp, core) in W.SENSOR_MODELS.items():
        W.synth_vertex_file(str(sub / f"lsst_{vendor}_synth.dat"), amp=amp,
                            core=core)
    over = [*_over(instcat, sed_dir, tmp_path / "out"),
            "image.sensor.sensor_model=lsst_{vendor}_synth",
            f"image.sensor.strength={strength}"]
    if where == "dir":
        over.append(f"image.sensor.sensor_model_dir={root}")
    else:
        monkeypatch.setenv("IMSIM_DATA_DIR", str(root))
        monkeypatch.delenv("IMSIM_TPU_DATA_DIR", raising=False)
    from imsim_tpu.config.interpreter import load_config as jload
    from imsim_tpu_torch.config.interpreter import load_config as tload

    base = {"template": "imsim-config-instcat"}
    jctx = JR.build_visit_context(jload(base, over))
    tctx = TR.build_visit_context(tload(base, over))
    jprep = JR.prepare_ccd(jctx, det)
    tprep = TR.prepare_ccd(tctx, det, device="cpu")
    js = CV.silicon_from_numpy(jprep.silicon)
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(tprep.silicon, f.name)
        assert (_same(a, b) if isinstance(a, np.ndarray) else a == b), \
            f.name
    vendor = tprep.ccd.vendor.lower()
    want = JSM.bf_kernel_from_model(str(sub / f"lsst_{vendor}_synth.dat"),
                                    strength=strength)
    assert _same(tprep.silicon.bf_kernel, want)
    tx, ty = bf_taps(tprep.silicon)
    Kp = np.pad(want, 1)
    assert _same(tx.numpy(), np.float32(0.5) * (Kp[1:-1, 2:] - Kp[1:-1, :-2]))
    assert _same(ty.numpy(), np.float32(0.5) * (Kp[2:, 1:-1] - Kp[:-2, 1:-1]))
