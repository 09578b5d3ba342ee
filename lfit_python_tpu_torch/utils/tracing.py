"""Profiling hooks: a device trace of a block, and named spans in it.

Port of ``lfit_python_tpu/utils/tracing.py`` on ``torch.profiler``:
:func:`trace_to` records the host and the card (CPU and CUDA activities)
for the enclosed block, or its first steps, and writes one Chrome trace
under ``logdir`` (open it in Perfetto or ``chrome://tracing``);
:func:`annotate` is a named span in that trace, a ``record_function``
range on the profiler's clock beside the card's kernels, and next to
nothing when no profiler runs.

The program's stages are such spans: ``lfit.params`` (the tree and the
priors), ``lfit.geometry`` (the core geometry), ``lfit.flux`` (the flux
model) with ``lfit.flux.contacts`` (the contact solve) inside it,
``lfit.like.gp`` (the GP likelihood) and ``lfit.chain.copy`` (a kept
row's copy to the host between sampler steps).  A ``fit --profile`` trace
shows them.  A posterior call replayed from a CUDA graph
(``models/graphs.py``) enters none of the posterior's stages: it is one
``lfit.replay`` span, around the graph's replay and its input's and
outputs' copies.

Only a process's first profiler window is sure to keep every kernel
record: a later window, after many untraced launches, may lose its first
ones.  Trace a fresh process for a complete count.

An HMC trajectory's eager updates of position and momentum between its
gradient evaluations, its last half-step and its accept test are the span
``lfit.hmc.leapfrog`` (``sampling/hmc.py``): host work that no graph
holds, outside the posterior's stages.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

__all__ = ["Trace", "trace_to", "annotate", "PARAMS", "GEOMETRY", "FLUX",
           "CONTACTS", "GP", "CHAIN_COPY", "SPANS", "REPLAY", "LEAPFROG"]

# the program's stage spans (module docstring)
PARAMS = "lfit.params"
GEOMETRY = "lfit.geometry"
FLUX = "lfit.flux"
CONTACTS = "lfit.flux.contacts"
GP = "lfit.like.gp"
CHAIN_COPY = "lfit.chain.copy"
SPANS = (PARAMS, GEOMETRY, FLUX, CONTACTS, GP, CHAIN_COPY)
# a posterior call replayed from a CUDA graph
REPLAY = "lfit.replay"
# an HMC trajectory's updates between its gradient evaluations
LEAPFROG = "lfit.hmc.leapfrog"

_OFF = contextlib.nullcontext()


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
    """Named span in the trace, a context manager to enter where the span
    starts: a ``record_function`` range while a profiler runs, else one
    shared ``nullcontext`` (a flag check, not the dispatcher's range)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
