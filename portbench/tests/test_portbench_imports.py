"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared
whole, so imsim_tpu_torch is not imsim_tpu."""
import ast
import os

import pytest

from portbench import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.HERE)
               for f in fs if f.endswith(".py"))


def _tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax(path):
    bad = set(_tops(path)) & {"jax", "jaxlib", "flax", "imsim_tpu"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "imsim_tpu_torch" not in set(_tops(path))


def test_the_check_compares_whole_names():
    import sys

    sys.modules.setdefault("imsim_tpu_torch_probe_name", sys)
    try:
        assert "imsim_tpu_torch_probe_name" not in \
            harness.forbidden_modules()
    finally:
        sys.modules.pop("imsim_tpu_torch_probe_name", None)
