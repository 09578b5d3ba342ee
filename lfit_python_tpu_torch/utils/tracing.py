"""Profiling hooks: a device trace of a block, named spans, a step meter.

Port of ``lfit_python_tpu/utils/tracing.py`` on ``torch.profiler``:
:func:`trace_to` records the host and the card (CPU and CUDA activities)
for the enclosed block, or its first steps, and writes one Chrome trace
under ``logdir`` (open it in Perfetto or ``chrome://tracing``);
:func:`annotate` is a named span in that trace; :class:`StepMeter` is a windowed step-rate meter
(ln-prob evaluations per second is the north-star metric).

Only a process's first profiler window is sure to keep every kernel
record: a later window, after many untraced launches, may lose its first
ones.  Trace a fresh process for a complete count.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

__all__ = ["Trace", "trace_to", "annotate", "StepMeter"]


class Trace:
    """An open :func:`trace_to` window: ``path`` is where its Chrome trace
    is written; :meth:`step` ends one step of the traced loop, and the
    window closes after ``steps`` of them (never, where ``steps`` is
    None)."""

    def __init__(self, prof, path, steps):
        self._prof, self.path, self.steps, self.done = prof, path, steps, 0

    @property
    def closed(self):
        return self._prof is None

    def step(self):
        self.done += 1
        if self.steps is not None and self.done >= self.steps:
            self.close()

    def close(self):
        """Stop recording (after the card's queued work) and write the
        trace; a no-op once closed."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(str(self.path))
        print(f"trace written to {self.path}", flush=True)


@contextlib.contextmanager
def trace_to(logdir, steps=None):
    """Record the enclosed block with ``torch.profiler`` (CPU, and CUDA
    where a card is present) and write it as a Chrome trace
    ``<logdir>/trace_<pid>_<ms>.json``, whose path is printed.  Yields the
    open :class:`Trace`.  With ``steps``, recording ends after that many
    calls of its :meth:`Trace.step` (a trace holds every event, so its
    size grows with each step it records); else at the block's end."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    trace = Trace(prof, path, steps)
    try:
        yield trace
    finally:
        trace.close()


def annotate(name):
    """Named span in the trace; a context manager or a decorator."""
    return torch.profiler.record_function(name)


class StepMeter:
    """Windowed sampler-step rate and ln-prob-eval rate meter."""

    def __init__(self, n_walkers, window=50):
        self.n_walkers = n_walkers
        self.window = window
        self._t = []
        self._s = []

    def tick(self, step):
        self._t.append(time.perf_counter())
        self._s.append(step)
        if len(self._t) > self.window:
            self._t.pop(0)
            self._s.pop(0)

    @property
    def steps_per_sec(self):
        if len(self._t) < 2:
            return float("nan")
        dt = self._t[-1] - self._t[0]
        return (self._s[-1] - self._s[0]) / dt if dt > 0 else float("nan")

    @property
    def evals_per_sec(self):
        # one full step = one ln-prob evaluation per walker
        return self.steps_per_sec * self.n_walkers
