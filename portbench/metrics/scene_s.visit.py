"""The scene's seconds per CCD (build_scene: the SEDs through the
bandpass), from each window CCD's preparation clock."""


def read(rec):
    s = [p["scene"] for p in rec.get("prep_seconds", []) if "scene" in p]
    return sum(s) / len(s) if s else None
