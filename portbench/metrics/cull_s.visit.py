"""The catalog's seconds per CCD (read, expand and cull), from each
window CCD's preparation clock."""


def read(rec):
    s = [p["cull"] for p in rec.get("prep_seconds", []) if "cull" in p]
    return sum(s) / len(s) if s else None
