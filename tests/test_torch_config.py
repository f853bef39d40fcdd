"""The port's config layer (imsim_tpu_torch.config: yaml_subset,
interpreter, registry) against PyYAML and the JAX package's interpreter:

  * the YAML reader equals yaml.safe_load on every template, every
    examples/*.yaml, a corpus of YAML 1.1 scalars and every override
    string of tests/test_config_pipeline.py, and refuses what lies
    outside its subset;
  * the port's templates are byte copies of the JAX package's;
  * load_config + deep_resolve give the JAX package's tree for each
    example; the registries hold the same names.
"""
import ast
import glob
import math
import os

import pytest
import yaml

from imsim_tpu.catalog.opsim import from_dict as jfrom_dict
from imsim_tpu.config import interpreter as JI
from imsim_tpu.config import registry as JREG
from imsim_tpu_torch.catalog.opsim import from_dict as tfrom_dict
from imsim_tpu_torch.config import interpreter as TI
from imsim_tpu_torch.config import registry as TREG
from imsim_tpu_torch.config.yaml_subset import safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TEMPLATES = sorted(glob.glob(os.path.join(
    REPO, "imsim_tpu", "config", "templates", "*.yaml")))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml")))


def same(a, b):
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", JAX_TEMPLATES + EXAMPLES,
                         ids=os.path.basename)
def test_reader_equals_safe_load_on_the_configs(path):
    text = open(path).read()
    assert same(safe_load(text), yaml.safe_load(text))


# YAML 1.1 scalars as PyYAML resolves them, and the block and flow forms
# of the subset
SCALARS = [
    "1.0e-6", "1e-6", "1.0e6", "1.5", "-2.", "+.5", ".5", "6.", "1_000.5",
    ".inf", "-.Inf", "+.INF", ".NaN", "190:20:30.15",
    "0", "-0", "+12", "1_000", "0b101", "-0b1_0", "017", "0o17", "0x1F",
    "-0x1f", "190:20:30", "08", "09.5",
    "yes", "No", "ON", "off", "true", "False", "TRUE", "y", "n", "Yes!",
    "null", "~", "Null", "NULL", "", "nulls", "none",
    "2020-1-2", "2020-01-02x",
    "'single ''q'''", "\"dq \\t \\u00e9 \\\" x\"", "'1.0'", "\"yes\"", "''",
    "eimage_{visit}-{band}.fits", "abc def", "a#b", "x # comment",
    "$x * 2", "\"$band == 'y'\"", "-", "--x", "=", "<<", "a:b",
]
DOCS = [
    "[94]", "[93, 94]", "[]", "{}", "{a: 1, b: [1, 2], c: {d: e}}",
    "{a, b: 2}", "[1, [2, [3]], {x: y}]", "{'q': \"r\", s: 't u'}",
    "hello: world", "- a\n- b\n-\n- c: 1\n  d: 2",
    "a:\n- 1\n- 2\nb: x", "a:\n  b:\n    c: 1\n  d: [1,\n    2]\n",
    "- - a\n  - b\n- c", "k: 'a # b' # c", "key with spaces: v",
    "'quoted key': 1", "1: one", "yes: true", "~: null", "a: -1.5e+3",
    "a: 12:30", "# only a comment\n", "a:   \n  # c\n  b: 1\n",
    "x: {a: 1,\n  b: 2}\n", "a: 1\na: 2\n",
]


@pytest.mark.parametrize("text", SCALARS + DOCS)
def test_reader_equals_safe_load_on_the_corpus(text):
    """The same value, or both refuse (PyYAML has no constructor for the
    `=` and `<<` scalars)."""
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError):
            safe_load(text)
        return
    got = safe_load(text)
    assert same(got, want), (got, want)


def test_reader_resolves_the_yaml_1_1_traps():
    assert safe_load("1.0e-6") == 1.0e-6 and safe_load("1e-6") == "1e-6"
    assert safe_load("on") is True and safe_load("off") is False
    assert safe_load("0o17") == "0o17" and safe_load("017") == 15
    assert safe_load("1_000") == 1000 and safe_load("~") is None
    assert safe_load("eimage_{visit}-{band}.fits") == \
        "eimage_{visit}-{band}.fits"


def _override_strings():
    """Every literal `key.path=value` string of test_config_pipeline.py."""
    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_config_pipeline.py")).read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            # an f-string: its literal tail after '='
            parts = [v.value for v in node.values
                     if isinstance(v, ast.Constant)]
            if parts and "=" in parts[0]:
                out.append(parts[0] + "X")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "=" in node.value and "." in node.value.split("=")[0] \
                and " " not in node.value.split("=")[0]:
            out.append(node.value)
    return out


OVERRIDES = _override_strings()


def test_every_override_string_is_read_as_safe_load_reads_it():
    assert len(OVERRIDES) >= 15
    for ov in OVERRIDES:
        _, _, val = ov.partition("=")
        assert same(safe_load(val), yaml.safe_load(val)), ov


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
    "---\na: 1", "a: 1\n---\nb: 2", "a: 1\n...\n", "%YAML 1.1\n---\na: 1",
    "? a\n: b", "<<: {a: 1}", "a: b: c", "a: x\n  y", "\ta: 1",
    "a: 'open", "a: [1, 2", "a: @b", "- a\nb: 1", "2020-01-02",
    "t: 2001-12-14 21:59:43.10", "d: 2002-12-14T01:02:03Z"])
def test_reader_refuses_what_lies_outside_the_subset(text):
    with pytest.raises(ValueError):
        safe_load(text)


@pytest.mark.parametrize("path", JAX_TEMPLATES, ids=os.path.basename)
def test_templates_are_byte_copies(path):
    port = os.path.join(REPO, "imsim_tpu_torch", "config", "templates",
                        os.path.basename(path))
    assert open(port, "rb").read() == open(path, "rb").read()


OPSIM = dict(band="r", exptime=30.0, seed=7, airmass=1.2, rawSeeing=0.7,
             rotTelPos=0.0)


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_load_config_and_deep_resolve_give_the_jax_tree(path, monkeypatch):
    monkeypatch.chdir(REPO)
    over = ["image.nbatch=3", "output.det_num=[93, 94]",
            "output.file_name=eimage_{det_name}.fits", "stamp.maxN=1e6"]
    jcfg = JI.load_config(path, over)
    tcfg = TI.load_config(path, over)
    assert same(tcfg, jcfg)
    jv, tv = JI.ConfigView(jcfg), TI.ConfigView(tcfg)
    jv.state["opsim_data"] = jfrom_dict(dict(OPSIM))
    tv.state["opsim_data"] = tfrom_dict(dict(OPSIM))
    assert same(TI.deep_resolve(tv, tcfg), JI.deep_resolve(jv, jcfg))
    assert same(tv.variables(), jv.variables())


def test_interpreter_templates_and_eval():
    """tests/test_config_pipeline.py's case, on the port."""
    user = {
        "template": "imsim-config-instcat",
        "input.instance_catalog.file_name": "x.txt",
        "image.nbatch": 3,
        "eval_variables": {"ffoo": 2.5, "sname": "abc"},
        "custom": {"v": "$foo * 2", "w": "@image.nbatch"},
    }
    cfg = TI.load_config(user)
    assert cfg["image"]["nbatch"] == 3
    assert cfg["input"]["instance_catalog"]["file_name"] == "x.txt"
    assert cfg["image"]["type"] == "LSST_PhotonPoolingImage"  # inherited
    view = TI.ConfigView(cfg)
    view.state["opsim_data"] = tfrom_dict(dict(band="r"))
    assert view.get("custom.v") == 5.0
    assert view.get("custom.w") == 3
    assert TI.parse_angle("30 deg") == JI.parse_angle("30 deg")
    assert TI.find_template("imsim-config").startswith(
        os.path.join(REPO, "imsim_tpu_torch"))


@pytest.mark.parametrize("name", ["INPUT_TYPES", "VALUE_TYPES",
                                  "IMAGE_TYPES", "STAMP_TYPES",
                                  "OUTPUT_TYPES", "PSF_TYPES", "WCS_TYPES",
                                  "PHOTON_OP_TYPES", "BANDPASS_TYPES"])
def test_registries_hold_the_jax_names(name):
    assert sorted(getattr(TREG, name)) == sorted(getattr(JREG, name))


def test_registry_values_match_the_jax_registry():
    """The generic value types, resolved in both packages."""
    nodes = [{"type": "Sequence", "first": 3, "nitems": 4, "step": 2},
             {"type": "Sequence", "first": 5, "last": 1, "step": -2},
             {"type": "List", "items": [1, "$2 * 3"], "index": 1},
             {"type": "FormattedStr", "format": "c_%03d_%s",
              "items": [7, "x"]},
             {"type": "OpsimData", "field": "band"},
             {"type": "Eval", "str": "a + 1", "ia": 4}]
    jv, tv = JI.ConfigView({}), TI.ConfigView({})
    jv.state["opsim_data"] = jfrom_dict(dict(OPSIM))
    tv.state["opsim_data"] = tfrom_dict(dict(OPSIM))
    for node in nodes:
        assert same(tv.resolve(node), jv.resolve(node)), node
    with pytest.raises(KeyError, match="unknown config type"):
        tv.resolve({"type": "NoSuchType"})
    # RowData reads a table's row (tests/test_torch_skycat.py holds its
    # values to the JAX package's); a node without a file is a KeyError
    # in both
    for view in (jv, tv):
        with pytest.raises(KeyError, match="file_name"):
            view.resolve({"type": "RowData"})
