"""What the per-layer metrics read of the program's own spans and
counters (imsim_tpu_torch.utils.trace), after the window.  Tracing is on
only while the window's profiler records, so the store holds the
window's spans (those that opened inside it) and counters.  A program
without that store reads as None: its metrics are left out."""
from __future__ import annotations


def store():
    """The program's trace module, or None where it has none."""
    try:
        from imsim_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def per_ccd(rec, names, field="device_s"):
    """The sum of `field` over the spans named in `names`, per window
    CCD (rec['ccds']); None without a store, CCDs or such a span (no
    device seconds in a run on the CPU)."""
    tr = store()
    if tr is None or not rec.get("ccds"):
        return None
    got = [s[field] for s in tr.spans()
           if s["name"] in names and s[field] is not None]
    return sum(got) / rec["ccds"] if got else None


def counter_total(name):
    """The sum of the counter `name`, or None without one."""
    tr = store()
    if tr is None:
        return None
    got = [c["value"] for c in tr.counters() if c["name"] == name]
    return sum(got) if got else None
