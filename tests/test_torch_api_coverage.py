"""Every public top-level name of the JAX package (imsim_tpu/) has a
counterpart in the port (imsim_tpu_torch/) at the same module path: a
function, class, constant or imported name there, and for a class each
of its public methods and properties.  Both packages are read with
`ast`, nothing is imported.  What has no counterpart is listed below
with the reason, and a listed name that the port gains, or that leaves
the JAX package, fails the test, so the list stays true."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX class -> the port's class of the same role, by module
RENAMED = {
    # the JAX Telescope pytree is the port's TelescopeDesign (float64
    # arrays with the perturbation API); the port's Telescope is the
    # surface matrix the K2 chain and the host trace read
    ("optics.telescope", "Telescope"): "TelescopeDesign",
}

# JAX plumbing with no counterpart, each with the port's way or reason
NO_COUNTERPART = {
    # pytree registration (jax.tree_util): the port's dataclasses hold
    # tensors and need no flattening
    **{(m, f"{c}.{f}"): "pytree registration" for m, c in (
        ("image.scene", "DeviceScene"), ("optics.telescope", "Telescope"),
        ("photons.batch", "PhotonBatch"),
        ("photons.optics_ops", "OpticsContext"),
        ("psf.atmosphere", "AtmScreens"), ("sensor.silicon",
                                           "SiliconParams"),
        ("utils.lookup", "PolyCDF"), ("utils.lookup", "UniformTable"))
       for f in ("tree_flatten", "tree_unflatten")},
    # Pallas size gates (the TPU kernels' VMEM and tiling limits): the
    # CUDA kernels take every size the path gives them
    ("ops.raychain", "size_ok"): "Pallas size gate",
    ("ops.scanrows", "size_ok"): "Pallas size gate",
    ("ops.scanrows", "slot_size_ok"): "Pallas size gate",
    ("ops.stencil", "size_ok"): "Pallas size gate",
    ("ops.stencil", "supports"): "Pallas size gate",
    # the Pallas K2 entry: the port's K2 is ops.raychain.field_to_sensor
    # (field_to_sensor_cuda with its plain twin field_to_sensor_plain)
    ("ops.raychain", "field_to_sensor_pallas"): "ops.raychain."
                                                "field_to_sensor",
    # JAX PRNG keys: the port's streams are torch Generators seeded by
    # utils.rng.stream(seed, *tags) (stream_seed), never split
    ("utils.rng", "base_key"): "utils.rng.stream",
    ("utils.rng", "split"): "utils.rng.stream",
}


def _public(name: str) -> bool:
    return not any(p.startswith("_") for p in name.split("."))


def _names(pkg: str, with_imports: bool) -> dict:
    """{module path: {name, Class.method}} of a package."""
    out = {}
    root = os.path.join(REPO, pkg)
    for dp, dn, fn in os.walk(root):
        dn[:] = [d for d in dn if not d.startswith(("_", "."))]
        for f in fn:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dp, f)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            names = set()
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    names.add(node.name)
                    if isinstance(node, ast.ClassDef):
                        names |= {f"{node.name}.{b.name}" for b in node.body
                                  if isinstance(b, ast.FunctionDef)}
                elif isinstance(node, ast.Assign):
                    names |= {t.id for t in node.targets
                              if isinstance(t, ast.Name)}
                elif isinstance(node, ast.AnnAssign) and isinstance(
                        node.target, ast.Name):
                    names.add(node.target.id)
                elif with_imports and isinstance(node, ast.ImportFrom):
                    names |= {a.asname or a.name for a in node.names}
            out[mod] = names
    return out


JAX = _names("imsim_tpu", with_imports=False)
PORT = _names("imsim_tpu_torch", with_imports=True)


def _counterpart(mod: str, name: str) -> str:
    cls, _, rest = name.partition(".")
    cls = RENAMED.get((mod, cls), cls)
    return f"{cls}.{rest}" if rest else cls


@pytest.mark.parametrize("mod", sorted(JAX))
def test_module_names_have_counterparts(mod):
    assert mod in PORT, f"imsim_tpu_torch has no module {mod}"
    missing = sorted(
        n for n in JAX[mod] if _public(n)
        and (mod, n) not in NO_COUNTERPART
        and _counterpart(mod, n) not in PORT[mod])
    assert not missing, f"{mod}: no counterpart in the port for {missing}"


def test_the_exceptions_are_still_exceptions():
    """Each listed name is in the JAX package and still lacks a
    counterpart in the port."""
    for (mod, name), why in NO_COUNTERPART.items():
        assert name in JAX[mod], (mod, name)
        assert _counterpart(mod, name) not in PORT[mod], (mod, name, why)
