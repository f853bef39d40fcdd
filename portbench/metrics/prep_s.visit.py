"""Host preparation seconds per CCD (prepare_ccd on the prefetch
thread), from each window CCD's own preparation clock: its WCS, cull,
scene and state steps."""


def read(rec):
    if "prep_s" not in rec or not rec.get("ccds"):
        return None
    return rec["prep_s"] / rec["ccds"]
