"""The card has no JAX: every imsim_tpu_torch module must import, and a
tiny render from the committed state must run, with `jax` blocked by a
meta-path hook.  chip_smoke.py's CPU rehearsal runs there too, and the
script itself refuses to run without CUDA or outside the checkout."""
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = r'''
import importlib.abc
import sys


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked: the port must not use JAX")
        return None


sys.meta_path.insert(0, _NoJax())
'''

REHEARSE = BLOCK_JAX + r'''
import importlib
import json
import pkgutil

import torch

torch.set_num_threads(1)
import imsim_tpu_torch

names = [m.name for m in pkgutil.walk_packages(imsim_tpu_torch.__path__,
                                               "imsim_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]

import chip_smoke

report = chip_smoke.run("cpu", small=True)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print("MODULES", len(names))
print("REPORT", json.dumps(report))
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    return env


def test_port_imports_and_renders_without_jax():
    res = subprocess.run([sys.executable, "-c", REHEARSE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    n_mod = int(next(ln for ln in lines if ln.startswith("MODULES")).split()[1])
    assert n_mod >= 20
    report = next(ln for ln in lines if ln.startswith("REPORT"))
    assert '"scan_slot_prefix"' in report and '"stencil_pair"' in report
    # the rehearsal reached the slice's charge and landing checks
    assert "[slice] warm" in res.stdout and "landed fraction" in res.stdout


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA device here: the script exits non-zero and prints no ok
    line; alone in a directory it fails too."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
