"""Pieces the window drivers share: the run's work directory, the
(traced) window, the card's synchronisation and the check's random
streams."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np

from .. import harness


def workdir() -> str:
    """A fresh directory for this run's inputs and files under the
    TMPDIR the run was given (removed at exit by the caller)."""
    return tempfile.mkdtemp(prefix="portbench_", dir=os.environ.get("TMPDIR"))


class Window:
    """The measured window: host wall clock, and with `trace` the
    profiler over it (device operations on every stream, host
    operations), reduced by harness.reduce_trace."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.prof = None
        self.reduced = {}

    @contextlib.contextmanager
    def run(self):
        import torch

        stack = contextlib.ExitStack()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = stack.enter_context(profile(activities=acts))
            stack.enter_context(torch.profiler.record_function(
                "portbench.window"))
        self.t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.t1 = time.perf_counter()
            stack.close()
        if self.trace:
            ev = harness.kineto_events(self.prof)
            t0, t1 = next((s, t) for n, s, t, kind, _ in ev
                          if n == "portbench.window" and kind == "CPU")
            self.reduced = harness.reduce_trace(ev, t0, t1)
            self.reduced["window_s"] = self.t1 - self.t0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, 7, stream])
