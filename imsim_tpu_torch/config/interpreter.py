"""GalSim-style YAML config interpreter (imsim_tpu/config/interpreter.py
counterpart, the same semantics): `template:` inheritance with dotted-key
overrides, typed `eval_variables` with first-letter type codes, `$`
expressions, `@key.path` references, and the registries' typed values.

  cfg = load_config("user.yaml", overrides=["output.nproc=4"])
  view = ConfigView(cfg)

YAML is read by `yaml_subset.safe_load` (no PyYAML), the templates are
byte copies of the JAX package's in `config/templates/`; registries live
in config.registry and the visit driver in config.runner.
"""
from __future__ import annotations

import copy
import math
import os
import re

import numpy as np

from .yaml_subset import safe_load

_TEMPLATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "templates")

DEG = math.pi / 180.0
ARCSEC = DEG / 3600.0


# ---------------------------------------------------------------------------
# Loading: templates + dotted-key merging
# ---------------------------------------------------------------------------


def find_template(name: str) -> str:
    """Resolve a template name to a file: bundled names (imsim-config*)
    or explicit paths (the reference's templates.py registry)."""
    if os.path.isfile(name):
        return name
    cand = os.path.join(_TEMPLATE_DIR, name + ".yaml")
    if os.path.isfile(cand):
        return cand
    raise FileNotFoundError(f"config template '{name}' not found")


def set_dotted(d: dict, path: str, value):
    keys = path.split(".")
    for k in keys[:-1]:
        nxt = d.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            d[k] = nxt
        d = nxt
    d[keys[-1]] = value


def get_dotted(d, path: str):
    cur = d
    for k in path.split("."):
        if isinstance(cur, list):
            cur = cur[int(k)]
        else:
            cur = cur[k]
    return cur


def _merge(base: dict, over: dict):
    """Template semantics: keys containing '.' are dotted overrides into
    the merged tree; plain dict keys replace wholesale (GalSim rule)."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if k == "template":
            continue
        if k == "eval_variables" and isinstance(v, dict):
            # merge rather than replace: templates rely on their own
            # eval variables; user additions extend them
            out.setdefault("eval_variables", {}).update(copy.deepcopy(v))
        elif "." in k:
            set_dotted(out, k, copy.deepcopy(v))
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path_or_dict, overrides=()) -> dict:
    """Load a user config, expanding `template:` chains; apply
    `key.path=value` CLI override strings (doc/usage.rst:9-16)."""
    if isinstance(path_or_dict, dict):
        cfg = copy.deepcopy(path_or_dict)
    else:
        with open(path_or_dict) as f:
            cfg = safe_load(f)
    if "template" in cfg:
        base = load_config(find_template(cfg["template"]))
        cfg = _merge(base, cfg)
    for ov in overrides:
        key, _, val = ov.partition("=")
        set_dotted(cfg, key.strip(), safe_load(val))
    return cfg


# ---------------------------------------------------------------------------
# Typed eval_variables + $/@/Eval value resolution
# ---------------------------------------------------------------------------

_TYPE_CODES = {
    "f": float, "i": int, "s": str, "b": bool, "a": "angle", "d": dict,
    "l": list, "x": None,
}


class ConfigView:
    """Evaluation context: the full config tree + eval_variables +
    runtime state (current det_num, wcs, bandpass objects...)."""

    def __init__(self, cfg: dict, state: dict | None = None):
        self.cfg = cfg
        self.state = state or {}
        self._vars_cache = None

    # -- eval_variables (config/imsim-config.yaml:15-62 semantics) ---------
    def variables(self) -> dict:
        if self._vars_cache is None:
            out = {}
            for key, raw in (self.cfg.get("eval_variables") or {}).items():
                code, name = key[0], key[1:]
                val = self.resolve(raw)
                typ = _TYPE_CODES.get(code)
                if typ == "angle" and isinstance(val, str):
                    val = parse_angle(val)
                elif typ in (float, int, bool) and not isinstance(val, dict):
                    val = typ(val)
                out[name] = val
            self._vars_cache = out
        return dict(self._vars_cache)

    # -- value resolution ----------------------------------------------------
    def resolve(self, node, key_hint=None):
        """Resolve a config leaf: scalars pass through; '$expr' and
        '@path' strings evaluate; {type: Eval/...} dicts dispatch."""
        if isinstance(node, str):
            if node.startswith("$"):
                return self.eval_expr(node[1:])
            if node.startswith("@"):
                return self.resolve(get_dotted(self.cfg, node[1:]))
            return node
        if isinstance(node, dict) and "type" in node:
            t = node["type"]
            if t == "Eval":
                scope = {k[1:]: self.resolve(v) for k, v in node.items()
                         if k not in ("type", "str")}
                return self.eval_expr(node["str"], extra=scope)
            from .registry import build_value
            return build_value(t, node, self)
        return node

    def eval_expr(self, expr: str, extra: dict | None = None):
        scope = dict(np=np, math=math, numpy=np,
                     degrees=DEG, arcsec=ARCSEC, arcmin=60 * ARCSEC,
                     radians=1.0, hours=15 * DEG)
        scope.update(self.variables())
        scope.update(self.state)
        if extra:
            scope.update(extra)
        # @refs inside expressions: (@image.bandpass) -> resolved object
        def _ref(m):
            name = "_ref_%d" % len(scope)
            scope[name] = self.resolve("@" + m.group(1))
            return name
        expr = re.sub(r"\(@([A-Za-z0-9_.]+)\)", _ref, expr)
        expr = re.sub(r"@([A-Za-z0-9_.]+)", _ref, expr)
        return eval(expr, {"__builtins__": {}}, scope)  # noqa: S307

    def get(self, path: str, default=None):
        try:
            return self.resolve(get_dotted(self.cfg, path))
        except (KeyError, IndexError, TypeError):
            return default


def deep_resolve(view: ConfigView, node, _depth=0):
    """Resolve every '$expr' / '@path' string and {type: Eval} dict in a
    config tree (leaving other typed dicts for their builders), so the
    runner's plain dict reads see final values — the lazy-eval pass of
    the reference's GetAllParams, done eagerly once per visit."""
    if _depth > 32:
        return node
    if isinstance(node, str) and node[:1] in ("$", "@"):
        return view.resolve(node)
    if isinstance(node, dict):
        if node.get("type") == "Eval":
            return view.resolve(node)
        return {k: (v if k == "eval_variables"
                    else deep_resolve(view, v, _depth + 1))
                for k, v in node.items()}
    if isinstance(node, list):
        return [deep_resolve(view, v, _depth + 1) for v in node]
    return node


_ANGLE_UNITS = {"deg": DEG, "degree": DEG, "degrees": DEG,
                "arcsec": ARCSEC, "arcmin": 60 * ARCSEC,
                "rad": 1.0, "radians": 1.0, "hour": 15 * DEG,
                "hours": 15 * DEG}


def parse_angle(s) -> float:
    """'30 deg' / '1.2 arcsec' / numeric (radians) -> radians."""
    if isinstance(s, (int, float)):
        return float(s)
    parts = str(s).split()
    if len(parts) == 2 and parts[1] in _ANGLE_UNITS:
        return float(parts[0]) * _ANGLE_UNITS[parts[1]]
    return float(s)
