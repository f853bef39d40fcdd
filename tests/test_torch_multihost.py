"""The port's visit fan-out across hosts (imsim_tpu_torch.parallel.
multihost) against the JAX package's on the CPU: detect_topology from
explicit arguments, the scheduler's environment (IMSIM_TPU_* before
SLURM_*) and the lone-value error, and from an initialized gloo group of
2 ranks (hosts = world // LOCAL_WORLD_SIZE); host_share's strided split;
a two-host visit of two CCDs whose union of files is the serial visit's
byte for byte; a visit list split over hosts first."""
import os

import pytest
import torch

from imsim_tpu.parallel import multihost as JM
from imsim_tpu_torch.config import runner as TR
from imsim_tpu_torch.parallel import multihost as TM

import torch_ranks
from test_torch_parallel import TEMPLATE, overrides, two_ccds  # noqa: F401

torch.set_num_threads(1)

ENV_VARS = ("IMSIM_TPU_NUM_HOSTS", "IMSIM_TPU_HOST_ID", "SLURM_NTASKS",
            "SLURM_PROCID")


@pytest.mark.parametrize("env, kw", [
    ({}, {}),
    ({"IMSIM_TPU_NUM_HOSTS": "4", "IMSIM_TPU_HOST_ID": "2"}, {}),
    ({"SLURM_NTASKS": "3", "SLURM_PROCID": "1"}, {}),
    ({"IMSIM_TPU_NUM_HOSTS": "2", "IMSIM_TPU_HOST_ID": "1",
      "SLURM_NTASKS": "8", "SLURM_PROCID": "5"}, {}),
    ({"IMSIM_TPU_NUM_HOSTS": "1", "IMSIM_TPU_HOST_ID": "0",
      "SLURM_NTASKS": "3", "SLURM_PROCID": "2"}, {}),
    ({"IMSIM_TPU_NUM_HOSTS": "4", "IMSIM_TPU_HOST_ID": "2"},
     {"num_hosts": 2, "host_id": 1}),
    ({}, {"num_hosts": 5, "host_id": 0})])
def test_detect_topology_is_the_jax_function(monkeypatch, env, kw):
    for k in ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert TM.detect_topology(**kw) == JM.detect_topology(**kw)


@pytest.mark.parametrize("kw", [{"num_hosts": 2}, {"host_id": 0}])
def test_a_lone_value_raises(kw):
    for fn in (TM.detect_topology, JM.detect_topology):
        with pytest.raises(ValueError, match="BOTH num_hosts and host_id"):
            fn(**kw)


@pytest.mark.parametrize("local, want", [(1, [(2, 0), (2, 1)]),
                                         (2, [(1, 0), (1, 0)])])
def test_topology_of_an_initialized_group(tmp_path, local, want):
    assert torch_ranks.spawn("topology", 2, tmp_path,
                             local_world_size=local) == want


@pytest.mark.parametrize("n_items, n, j", [(10, 4, 2), (10, 4, 3),
                                           (3, 5, 4), (189, 8, 0)])
def test_host_share_is_the_jax_function(n_items, n, j):
    items = [f"det{i}" for i in range(n_items)]
    assert TM.host_share(items, n, j) == JM.host_share(items, n, j)
    assert sorted(sum((TM.host_share(items, n, k) for k in range(n)), []),
                  key=items.index) == items


def test_two_hosts_write_the_serial_files(two_ccds, tmp_path):
    serial = tmp_path / "serial"
    TR.run_visit(TEMPLATE, overrides(two_ccds, serial), device="cpu")
    shares = [[r["det_name"] for r in TM.run_visit_multihost(
        TEMPLATE, overrides(two_ccds, tmp_path / "hosts"), num_hosts=2,
        host_id=j, device="cpu")] for j in range(2)]
    assert shares == [["R22_S10"], ["R22_S11"]]
    files = sorted(os.listdir(serial))
    assert len(files) == 6 and sorted(os.listdir(tmp_path / "hosts")) == \
        files
    for f in files:
        assert (tmp_path / "hosts" / f).read_bytes() == \
            (serial / f).read_bytes(), f


def test_visits_split_over_hosts_first(two_ccds, tmp_path):
    from test_torch_visit import _opsim_db

    db = str(tmp_path / "opsim.db")
    _opsim_db(db)
    over = overrides(two_ccds, tmp_path / "out", "image.nobjects=2",
                     "output.readout.enabled=false",
                     f"input.opsim_data.file_name={db}",
                     "output.file_name=eimage_{visit}_{det_name}.fits",
                     dets=(94,))
    out = TM.run_visits_multihost(TEMPLATE, [101, 102, 103], over,
                                  num_hosts=2, host_id=1, device="cpu")
    assert list(out) == [102]
    assert [r["det_name"] for r in out[102]] == ["R22_S11"]
    assert os.path.exists(tmp_path / "out" / "eimage_102_R22_S11.fits")
