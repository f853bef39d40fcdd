"""The card has no JAX, and the port stands alone: every imsim_tpu_torch
module must import, and a tiny render from the committed state must run,
with `jax` and the JAX package `imsim_tpu` blocked by a meta-path hook;
no source of the port imports `imsim_tpu`.  chip_smoke.py's CPU
rehearsal runs there too, and the script itself refuses to run without
CUDA or outside the checkout."""
import ast
import glob
import json
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
        if name.split(".")[0] in ("jax", "jaxlib", "imsim_tpu"):
            raise ImportError(f"{name} is blocked: the port must not use "
                              f"JAX or the JAX package")
        return None


def blocked():
    return [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "imsim_tpu")]


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
assert not blocked(), blocked()

import chip_smoke

report = chip_smoke.run("cpu", small=True)
assert not blocked(), blocked()
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
    report = json.loads(next(ln for ln in lines
                             if ln.startswith("REPORT")).split(" ", 1)[1])
    names = [row["name"] for row in report["kernels"]]
    assert names == ["scan_slot_prefix", "field_to_sensor", "stencil_pair",
                     "scan_lanes", "probe_p1", "probe_p2", "probe_p3",
                     "probe_p4", "probe_p5", "probe_mk", "probe_mk2"]
    # the CPU rehearsal runs the plain twins: no launches, no gaps
    assert all(row["launches"] == 0 and row["max_abs_err"] == 0
               for row in report["kernels"][3:])
    # the probe phase ran every probe_rows case
    assert sum(ln.startswith("[probes] ") and ln.endswith(" ms")
               for ln in lines) == 13
    # the rehearsal reached the whole CCD's gates, warm, and the
    # galaxy-bucket path
    for gate in "adef":
        assert f"[ccd] warm ({gate})" in res.stdout, gate
    assert "[ccd] (b)" in res.stdout and "[ccd] (c)" in res.stdout
    assert "[ccd] galaxy buckets" in res.stdout


def _imported_modules(path):
    """Top-level module names that `path` imports (absolute imports)."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


def test_port_sources_never_import_the_jax_package():
    """Static check of every port source and chip_smoke.py: no `import
    imsim_tpu...` or `from imsim_tpu... import` anywhere (docstrings that
    name a counterpart are fine)."""
    paths = glob.glob(os.path.join(REPO, "imsim_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(paths) >= 30
    bad = {os.path.relpath(p, REPO): mods for p in paths
           if (mods := sorted({m for m in _imported_modules(p)
                               if m in ("imsim_tpu", "jax", "jaxlib")}))}
    assert not bad, bad


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
