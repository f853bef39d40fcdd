"""The device's idle share [%] over the flat's window: 1 - busy / wall,
busy the union of device operations on every stream (torch.profiler)."""


def read(rec):
    if not rec.get("window_s") or "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
