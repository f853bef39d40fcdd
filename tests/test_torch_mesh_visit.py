"""The port's mesh visit (output.mesh, imsim_tpu_torch.parallel.visit.
run_visit_mesh) against its serial visit on the CPU, with gloo ranks
started by tests/torch_ranks.py, on tests/test_torch_parallel.py's
two-CCD catalog (R22_S10 and R22_S11, the DoubleGaussianPSF, no sensor,
full frames):

  * output.mesh=1 writes the serial visit's files byte for byte (eimage,
    RICE amps, truth) and returns its images and realized fluxes;
  * {ccd: 2} on 2 ranks through the CLI writes the {1, 1} files byte
    for byte, each rank its own CCD's;
  * {ccd: 1, phot: 2} on 2 ranks: only the first rank writes; per-object
    realized within 1e-6 relative and the render before the sky within
    1e-6 of its max of the {1, 1} visit's;
  * a mesh visit resumes from its checkpoint without rendering a batch.
"""
import os

import numpy as np
import pytest
import torch

from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.image import photon_pooling as TPP

import torch_ranks
from test_torch_parallel import DETS, TEMPLATE, overrides, two_ccds  # noqa: F401

torch.set_num_threads(1)


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def _run(cat, out, *extra, dets=(93, 94)):
    """run_visit_iter in this process: {det_name: (eimage, realized,
    image)} numpy."""
    res = {}
    for r in TR.run_visit_iter(TEMPLATE, overrides(cat, out, *extra,
                                                   dets=dets),
                               device="cpu"):
        res[r["det_name"]] = tuple(
            np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                       else v) for v in (r["eimage"], r["realized"],
                                         r["image"]))
    return res


@pytest.fixture(scope="module")
def serial_and_one(two_ccds, tmp_path_factory):
    """The serial visit and the output.mesh=1 visit of both CCDs."""
    d = tmp_path_factory.mktemp("visits")
    return dict(serial=(_run(two_ccds, d / "serial"), d / "serial"),
                one=(_run(two_ccds, d / "one", "output.mesh=1"), d / "one"),
                root=d)


def test_mesh_of_one_writes_the_serial_files(serial_and_one):
    (sres, sdir), (ores, odir) = serial_and_one["serial"], \
        serial_and_one["one"]
    assert list(ores) == list(sres) == list(DETS)
    files = _files(sdir)
    assert len(files) == 6 and _files(odir) == files
    for det in DETS:
        for a, b in zip(ores[det], sres[det]):
            np.testing.assert_array_equal(a, b)


def test_two_ccd_ranks_write_the_mesh_of_one_files(serial_and_one,
                                                   two_ccds, tmp_path):
    """{ccd: 2} on 2 ranks through the CLI: each rank writes its CCD's
    files, the same bytes as output.mesh=1's."""
    out = tmp_path / "ccd2"
    user = tmp_path / "user.yaml"
    user.write_text("template: imsim-config-instcat\n")
    names = torch_ranks.spawn(
        "cli", 2, tmp_path,
        argv=[str(user), *overrides(two_ccds, out,
                                    "output.mesh={ccd: 2, phot: 1}")])
    assert names == [["R22_S10"], ["R22_S11"]]
    assert _files(out) == _files(serial_and_one["one"][1])


def test_two_photon_ranks_within_the_bars(serial_and_one, two_ccds,
                                          tmp_path):
    """{ccd: 1, phot: 2} on 2 ranks: only rank 0 writes; per-object
    realized within 1e-6 relative, the render before the sky within 1e-6
    of its max (sensor none: the binner's deltas add in another order)."""
    res = torch_ranks.spawn(
        "visit", 2, tmp_path, cfg=TEMPLATE,
        overrides=overrides(two_ccds, tmp_path / "phot2",
                            "output.mesh={ccd: 1, phot: 2}",
                            "output.readout.enabled=false"))
    assert [[n for n, _ in r] for r in res] == [list(DETS), []]
    ones = serial_and_one["one"][0]
    for det, got in res[0]:
        _, r1, img1 = ones[det]
        assert img1.sum() > 1e4
        np.testing.assert_allclose(got["realized"], r1, rtol=1e-6, atol=0)
        assert np.abs(got["image"] - img1).max() <= 1e-6 * img1.max()


def test_a_mesh_visit_resumes_from_its_checkpoint(two_ccds, tmp_path,
                                                  monkeypatch):
    over = [f"input.checkpoint.dir={tmp_path}/ck", "output.mesh=1",
            "output.readout.enabled=false"]
    first = _run(two_ccds, tmp_path / "a", *over, dets=(94,))
    (ck,) = (tmp_path / "ck").glob("checkpoint_mesh_4242_0.npz")
    from imsim_tpu_torch.io.checkpoint import Checkpointer

    saved = Checkpointer(str(ck)).load("mesh")
    assert saved["next_outer"] >= 3 and saved["images"].shape[0] == 1

    def no_batch(*a, **k):
        raise AssertionError("a restored batch was rendered again")

    monkeypatch.setattr(TPP.PooledPass, "batch", no_batch)
    again = _run(two_ccds, tmp_path / "b", *over, dets=(94,))
    for a, b in zip(again["R22_S11"][:2], first["R22_S11"][:2]):
        np.testing.assert_array_equal(a, b)
