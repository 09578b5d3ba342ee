"""The program's stage spans read from a traced window: the host ms each
stage takes a posterior call (or a step), and the device work each one
launched.

The port marks its stages with ``record_function`` ranges while a
profiler runs (``lfit_python_tpu_torch.utils.tracing``); their names are
fixed here, as part of the yardstick.  A stage's host time is its self
time: its ranges' durations less those of the stage ranges directly
inside them (``lfit.flux`` less ``lfit.flux.contacts``).

Device work is put down to a stage through its launch.  The port runs one
stream, so the window's device events in start order match its launch
calls (host ranges named in :data:`LAUNCHES`) in start order, one for
one; the i-th event goes to the innermost stage range open at the i-th
launch's start.  Where the two counts differ nothing is attributed.

Every reader returns None where its stage has no range in the trace (a
program without the spans, or a stage replayed from a graph, which
enters no Python range), and the device readers also where the trace has
no device events or the counts differ.
"""

from __future__ import annotations

from .trace import _NOT_KERNELS, STEP

__all__ = ["PARAMS", "GEOMETRY", "FLUX", "CONTACTS", "GP", "CHAIN_COPY",
           "SPANS", "LAUNCHES", "Summary", "host_ms",
           "device_ms", "h2d_per_call"]

PARAMS = "lfit.params"
GEOMETRY = "lfit.geometry"
FLUX = "lfit.flux"
CONTACTS = "lfit.flux.contacts"
GP = "lfit.like.gp"
CHAIN_COPY = "lfit.chain.copy"
SPANS = (PARAMS, GEOMETRY, FLUX, CONTACTS, GP, CHAIN_COPY)
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync",
    "cudaMemset"})
H2D = "Memcpy HtoD"


class Summary:
    """The stages of a traced window.

    ``self_ns``: {stage: self time, ns}; ``steps``: the window's
    ``bench.step`` ranges; ``launches`` and ``events``: the launch calls
    and the device events counted; ``owners``: each device event (name,
    start ns, duration ns) with the stage it is put down to (None outside
    every stage), or None where the counts differ."""

    def __init__(self, trace):
        ranges = sorted((r for r in trace.host if r[0] in SPANS),
                        key=lambda r: (r[1], -r[2]))
        self.self_ns = {}
        parents = _innermost(ranges, [r[1] for r in ranges], skip_self=True)
        for r, parent in zip(ranges, parents):
            d = r[2] - r[1]
            self.self_ns[r[0]] = self.self_ns.get(r[0], 0) + d
            if parent is not None:
                p = ranges[parent][0]
                self.self_ns[p] = self.self_ns.get(p, 0) - d
        self.steps = sum(1 for r in trace.host if r[0] == STEP)
        starts = sorted(r[1] for r in trace.host if r[0] in LAUNCHES)
        events = sorted(trace.device, key=lambda e: e[1])
        self.launches, self.events = len(starts), len(events)
        self.owners = None
        if self.launches == self.events:
            self.owners = [(e, None if i is None else ranges[i][0])
                           for e, i in zip(events,
                                           _innermost(ranges, starts))]


def _innermost(ranges, points, skip_self=False):
    """For each of the sorted ``points``, the index in ``ranges`` (sorted
    by start, the outer first where two start together; nested as one
    thread's ranges are) of the innermost range open there (start <= t <
    end), or None.
    With ``skip_self`` the points are the ranges' own starts, and each
    gets the range it lies in (its parent)."""
    out, stack, j = [], [], 0
    for k, t in enumerate(points):
        while j < len(ranges) and ranges[j][1] <= t and (
                not skip_self or j < k):
            while stack and ranges[stack[-1]][2] <= ranges[j][1]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and ranges[stack[-1]][2] <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _calls(ctx):
    return len(ctx.trace_rows) if ctx.trace is not None else 0


def host_ms(ctx, stage, per_step=False):
    """Host ms of ``stage``'s self time a posterior call of the traced
    window, or a step with ``per_step``."""
    if ctx.trace is None:
        return None
    s = Summary(ctx.trace)
    n = s.steps if per_step else _calls(ctx)
    if stage not in s.self_ns or not n:
        return None
    return 1e-6 * s.self_ns[stage] / n


def device_ms(ctx, stage):
    """Device ms a posterior call of the kernels ``stage`` launched
    outside the stages inside it (copies and sets left out, as in
    ``device_ms_per_eval``)."""
    n = _calls(ctx)
    if not n:
        return None
    s = Summary(ctx.trace)
    if stage not in s.self_ns or not s.owners:
        return None
    return 1e-6 * sum(e[2] for e, owner in s.owners if owner == stage
                      and not e[0].startswith(_NOT_KERNELS)) / n


def h2d_per_call(ctx):
    """Host-to-device copies a posterior call launched inside any stage."""
    n = _calls(ctx)
    if not n:
        return None
    s = Summary(ctx.trace)
    if not s.self_ns or not s.owners:
        return None
    return sum(1 for e, owner in s.owners
               if owner is not None and e[0].startswith(H2D)) / n
