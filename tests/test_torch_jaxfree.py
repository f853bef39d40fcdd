"""The card has no JAX, PyYAML, h5py, pandas or pyarrow, and the port
stands alone: every imsim_tpu_torch module must import, and a tiny render
from the committed state must run, with those and the JAX package
`imsim_tpu` blocked by a meta-path hook; no source of the port imports
them.
chip_smoke.py's CPU rehearsal runs there too (every phase at small size,
the state built from the pointing, the instance-catalog CCD, the visit
from YAML through the CLI, the skyCatalogs CCDs and the visit over gloo
ranks included), and the
script itself refuses to run without CUDA or outside the checkout."""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what the card's machine lacks, and the JAX package
FORBIDDEN = ("jax", "jaxlib", "imsim_tpu", "yaml", "h5py", "pandas",
             "pyarrow", "fastparquet")

BLOCK_JAX = r'''
import importlib.abc
import sys

FORBIDDEN = %r


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} is blocked: the port must not use "
                              f"JAX, the JAX package, PyYAML, h5py, "
                              f"pandas or pyarrow")
        return None


def blocked():
    return [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]


sys.meta_path.insert(0, _NoJax())
''' % (FORBIDDEN,)

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
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    n_mod = int(next(ln for ln in lines if ln.startswith("MODULES")).split()[1])
    assert n_mod >= 20
    report = json.loads(next(ln for ln in lines
                             if ln.startswith("REPORT")).split(" ", 1)[1])
    names = [row["name"] for row in report["kernels"]]
    assert names == ["scan_slot_prefix", "field_to_sensor", "stencil_pair",
                     "bin_scatter", "scan_lanes", "probe_p1", "probe_p2",
                     "probe_p3", "probe_p4", "probe_p5", "probe_mk",
                     "probe_mk2"]
    # the CPU rehearsal runs the plain twins: no launches, no gaps
    assert all(row["launches"] == 0 and row["max_abs_err"] == 0
               for row in report["kernels"][3:])
    # gate (ad): K1 repeats bit for bit (the plain twin here)
    assert "[K1] (ad) K1 repeats bit for bit: 5 of 5 calls" in res.stdout
    # K5's row: the binner against its sorted twin at both shapes
    for case in ("sky chunk", "flat sub-batch"):
        assert any(ln.startswith(f"[K5 {case}] ") and "image bit-equal"
                   in ln and "5 of 5 calls alike" in ln
                   for ln in lines), case
    # the probe phase ran every probe_rows case
    assert sum(ln.startswith("[probes] ") and ln.endswith(" ms")
               for ln in lines) == 13
    # the rehearsal reached the whole CCD's gates, warm, and the
    # galaxy-bucket path
    for gate in "adef":
        assert f"[ccd] warm ({gate})" in res.stdout, gate
    assert "[ccd] (b)" in res.stdout and "[ccd] (c)" in res.stdout
    assert "[ccd] galaxy buckets" in res.stdout
    # and every gate of the analytic CCD, the flats and the modes
    for line in ("[analytic] cold (g)", "[analytic] cold (i)",
                 "[analytic] (h)", "[flats] (j)", "[flats] (k)",
                 "[modes] (l)", "[modes] (m)"):
        assert line in res.stdout, line
    # phase 9: the bench state rebuilt from the pointing equals the
    # exported one, and the ITL CCD built from its pointing renders with
    # its gates
    assert "[pointing] (n): 0 leaves differ" in res.stdout
    assert "[pointing] R10_S11 (ITL, 4072 x 4000)" in res.stdout
    assert "[pointing K3] 512x512" in res.stdout
    for gate in "abcdef":
        assert f"[itl] {'' if gate in 'bc' else 'cold '}({gate})" \
            in res.stdout, gate
    assert "ITL raw amps (16, 2048, 576)" in res.stdout
    # phase 10: the instance-catalog CCD through the runner's per-CCD
    # path, r with gates (a)-(f) and (p), y with its fringe map and (q)
    assert "[instcat] R22_S11 512 x 512: host seconds" in res.stdout
    for band, label in (("instcat", "cold"), ("instcat y", "once")):
        for gate in "adef":
            assert f"[{band}] {label} ({gate})" in res.stdout, (band, gate)
        assert f"[{band}] (b)" in res.stdout and f"[{band}] (c)" \
            in res.stdout
    assert "[instcat] (p): sky-only frame" in res.stdout
    assert "[instcat y] (q): sky-only frame" in res.stdout
    assert "fringe map mean" in res.stdout
    assert all("launches_by_path" in row for row in report["kernels"])
    # phase 11: the visit from YAML through the CLI, both CCDs' files and
    # gates, the FEA visit resumed, the FEA digest and the YAML flat
    assert "[visit] (r)" in res.stdout
    for det in ("R22_S11", "R10_S11"):
        assert f"[visit] (s) {det}: eimage read back bit-equal" \
            in res.stdout, det
        for gate in "aef":
            assert f"[visit] {det} ({gate})" in res.stdout, (det, gate)
    for line in ("[visit] 2 CCDs through the CLI", "[visit] (t)",
                 "[visit] (u)", "[visit] (v)", "[visit] RICE encode"):
        assert line in res.stdout, line
    # phase 12: the skyCatalogs CCDs, the mapped catalog through the CLI
    # with a sensor model and RowData, the native one, the saved screens
    for line in ("[skycat] R22_S11 4004 x 4096 through the CLI",
                 "[skycat] (w)", "[skycat] (x)", "[skycat K3] 512x512",
                 "[skycat native] R22_S11", "tophat seds",
                 "[skycat] (y)", "making 0 (bar 0)",
                 "loaded screens bit-equal to the saved"):
        assert line in res.stdout, line
    for tag in ("skycat", "skycat native"):
        for gate in "aef":
            assert f"[{tag}] cold ({gate})" in res.stdout, (tag, gate)
    # phase 13: the visit over several ranks (gloo ranks in the
    # rehearsal), its files bit-equal, the native tokenizer
    for line in ("[mesh] (z): output.mesh=1, one rank (gloo)",
                 "[mesh] (aa): {ccd: 2, phot: 1}, 2 ranks",
                 "[mesh] (ab) sensor none", "[mesh] (ac)"):
        assert line in res.stdout, line
    assert "DIFFER" not in "".join(ln for ln in lines
                                   if ln.startswith("[mesh]"))


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
    """Static check of every port source and chip_smoke.py: no import of
    the JAX package, JAX, PyYAML, h5py or pandas anywhere (docstrings
    that name a counterpart are fine)."""
    paths = glob.glob(os.path.join(REPO, "imsim_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(paths) >= 30
    bad = {os.path.relpath(p, REPO): mods for p in paths
           if (mods := sorted({m for m in _imported_modules(p)
                               if m in FORBIDDEN}))}
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
