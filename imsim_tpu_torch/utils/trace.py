"""Spans and counters of the port, kept in memory.

A span is one named interval of a thread's work:

    with trace.span("render.batch", device=image.device):
        ...

It records the host interval (`time.perf_counter_ns`), the thread's CPU
time over it (`time.thread_time_ns`: wall minus CPU is the time the
thread waited for the interpreter lock, IO or a core), the thread, the
enclosing span of the same thread and the CCD it works on (the detector
name, inherited from the enclosing span when not given).  With a CUDA
`device` it also records a pair of timing events on the device's
current stream, so its device seconds cost no synchronisation: they are
resolved when the store is read, after one synchronise.  The port's
device work runs on the current stream, which the events therefore
cover.  `count(name, value)` adds a counter record; the value may be a
device scalar, resolved when the store is read.

Tracing is on while torch.profiler records (in any thread of the
process), or between `enable()` and `disable()`.  Off, `span` returns a
shared no-op context and `count` returns at once: no record, no event,
no clock read.  A span that opened while tracing was off is never
recorded, nor are `Steps` of a clock made while it was off; a span
whose enclosing span opened before tracing turned on is recorded as a
root.  On the thread that runs torch.profiler, a span also enters
`torch.profiler.record_function(name)`, so the exported profiler trace
nests its operations under it (the profiler records no other thread's
annotations).

`spans()` and `counters()` report times on the profiler's clock
(kineto's `start_ns`, CLOCK_REALTIME in ns): the host clock plus one
offset taken when the store is first written after `reset()`.
`write_chrome_trace(path)` writes both as Chrome-trace JSON, which
opens beside a torch.profiler trace in Perfetto.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_LOCK = threading.Lock()
_SPANS: list = []           # closed _Record
_COUNTS: list = []          # (name, value, ccd, thread, tid, t_ns)
_LOCAL = threading.local()  # .stack: the thread's open records
_IDS = itertools.count(1)
_NOOP = contextlib.nullcontext()
_explicit = False
_offset_ns = None


def on() -> bool:
    """Whether spans and counters are recorded now."""
    return _explicit or _autograd_profiler._is_profiler_enabled


def enable() -> None:
    """Record spans and counters until disable(), profiler or not."""
    global _explicit
    _explicit = True


def disable() -> None:
    global _explicit
    _explicit = False


def reset() -> None:
    """Empty the store (open spans still record when they close)."""
    global _offset_ns
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
        _offset_ns = None


class _Record:
    __slots__ = ("id", "name", "parent", "ccd", "thread", "tid", "t0", "t1",
                 "c0", "c1", "dev", "ev0", "ev1", "dropped")

    def __init__(self, name, parent, ccd):
        self.id = next(_IDS)
        self.name, self.parent, self.ccd = name, parent, ccd
        th = threading.current_thread()
        self.thread, self.tid = th.name, threading.get_native_id()
        self.ev0 = self.ev1 = None
        self.dropped = False


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _cuda(device):
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _open(name, ccd, device) -> _Record:
    global _offset_ns
    if _offset_ns is None:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    st = _stack()
    parent = st[-1] if st else None
    if ccd is None and parent is not None:
        ccd = parent.ccd
    r = _Record(name, parent, ccd)
    r.dev = _cuda(device)
    if r.dev is not None:
        r.ev0 = torch.cuda.Event(enable_timing=True)
        r.ev0.record(torch.cuda.current_stream(r.dev))
    r.c0 = time.thread_time_ns()
    r.t0 = time.perf_counter_ns()
    st.append(r)
    return r


def _close(r: _Record, name=None) -> None:
    r.t1 = time.perf_counter_ns()
    r.c1 = time.thread_time_ns()
    if r.ev0 is not None:
        r.ev1 = torch.cuda.Event(enable_timing=True)
        r.ev1.record(torch.cuda.current_stream(r.dev))
    if name is not None:
        r.name = name
    st = _stack()
    if any(x is r for x in st):
        # what a step clock left open above the span ends with it
        while True:
            top = st.pop()
            if top is r:
                break
            top.dropped = True
    with _LOCK:
        _SPANS.append(r)


class _Span:
    __slots__ = ("name", "ccd", "device", "rec", "rf")

    def __init__(self, name, ccd, device):
        self.name, self.ccd, self.device = name, ccd, device
        self.rf = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():     # the profiler's thread
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _open(self.name, self.ccd, self.device)
        return self

    def __exit__(self, *exc):
        _close(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, *, ccd=None, device=None):
    """A context that records a span `name` while tracing is on (see the
    module's docstring); a shared no-op context while it is off."""
    if not on():
        return _NOOP
    return _Span(name, ccd, device)


class Steps:
    """Adjacent spans on one thread, each closed and named at the next
    mark: a step clock's steps.  mark(name) ends the step that began at
    the last mark (or at construction) as the span `<prefix>.<name>`
    (spaces as underscores) and begins the next one.  Spans opened
    inside a step are its children; the step still open when its
    enclosing span ends is not recorded, and its children count under
    that span."""

    def __init__(self, prefix: str, *, ccd=None, device=None):
        self.prefix, self.ccd, self.device = prefix, ccd, device
        self.rec = _open(None, ccd, device) if on() else None

    def mark(self, name: str) -> None:
        if self.rec is not None:
            _close(self.rec, f"{self.prefix}.{name.replace(' ', '_')}")
        self.rec = _open(None, self.ccd, self.device) if on() else None


def count(name: str, value, *, ccd=None) -> None:
    """A counter record `name` += value (a number or a device scalar)
    while tracing is on; the CCD is the enclosing span's by default."""
    if not on():
        return
    if ccd is None:
        st = _stack()
        ccd = st[-1].ccd if st else None
    rec = (name, value, ccd, threading.current_thread().name,
           threading.get_native_id(), time.perf_counter_ns())
    with _LOCK:
        _COUNTS.append(rec)


def _parent_id(r: _Record):
    p = r.parent
    while p is not None and p.dropped:
        p = p.parent
    return None if p is None else p.id


def spans() -> list:
    """The closed spans, oldest first, as dicts: id, name, parent (the
    id of the enclosing span, which may still be open and then is not
    listed; None for a root), ccd, thread, tid, start_ns and end_ns (the
    profiler's clock), host_s, cpu_s (the thread's CPU seconds) and
    device_s (None without a device).  Synchronises once when a span
    holds device events."""
    with _LOCK:
        recs = list(_SPANS)
        off = _offset_ns or 0
    if any(r.ev0 is not None for r in recs):
        torch.cuda.synchronize()
    return [dict(id=r.id, name=r.name, parent=_parent_id(r), ccd=r.ccd,
                 thread=r.thread, tid=r.tid, start_ns=r.t0 + off,
                 end_ns=r.t1 + off, host_s=(r.t1 - r.t0) * 1e-9,
                 cpu_s=(r.c1 - r.c0) * 1e-9,
                 device_s=None if r.ev0 is None
                 else r.ev0.elapsed_time(r.ev1) * 1e-3)
            for r in recs]


def counters() -> list:
    """The counter records, oldest first, as dicts: name, value (a float,
    device scalars resolved in one copy per device), ccd, thread, tid,
    t_ns (the profiler's clock)."""
    with _LOCK:
        recs = list(_COUNTS)
        off = _offset_ns or 0
    values = [v for _, v, *_ in recs]
    by_dev = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_dev.setdefault(v.device, []).append(i)
    for idx in by_dev.values():
        got = torch.stack([values[i].reshape(()).to(torch.float64)
                           for i in idx]).cpu().tolist()
        for i, g in zip(idx, got):
            values[i] = g
    return [dict(name=n, value=float(v), ccd=c, thread=th, tid=tid,
                 t_ns=t + off)
            for (n, _, c, th, tid, t), v in zip(recs, values)]


def write_chrome_trace(path: str) -> None:
    """The store as Chrome-trace JSON: each span an "X" event (ts and dur
    in microseconds on the profiler's clock; args: ccd, cpu_s,
    device_s, id, parent), each counter a "C" event holding the
    running total of its name, and each thread's name."""
    pid = os.getpid()
    events, names = [], {}
    for s in spans():
        names[s["tid"]] = s["thread"]
        events.append(dict(
            name=s["name"], ph="X", cat="imsim_tpu_torch", pid=pid,
            tid=s["tid"], ts=s["start_ns"] * 1e-3,
            dur=(s["end_ns"] - s["start_ns"]) * 1e-3,
            args=dict(ccd=s["ccd"], cpu_s=s["cpu_s"], device_s=s["device_s"],
                      id=s["id"], parent=s["parent"])))
    totals = {}
    for c in counters():
        names[c["tid"]] = c["thread"]
        totals[c["name"]] = totals.get(c["name"], 0.0) + c["value"]
        events.append(dict(name=c["name"], ph="C", pid=pid, tid=c["tid"],
                           ts=c["t_ns"] * 1e-3,
                           args={c["name"]: totals[c["name"]]}))
    events += [dict(name="thread_name", ph="M", pid=pid, tid=tid,
                    args=dict(name=name)) for tid, name in names.items()]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms"), f)
