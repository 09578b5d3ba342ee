"""What the gradient cells' readers (``lfit_bench/metrics/*.grad.py``)
share beyond :mod:`lfit_bench.layers`: the replays inside the gradient
calls, a program span's host ms a step, and the backward kernels' work
for their rooflines.

A gradient cell's posterior calls are its gradient evaluations: the
sampler module marks each with the harness's clock, rows and
``bench.posterior`` range, so the per-call readers of ``layers`` count
gradient calls.
"""

from __future__ import annotations

import bisect

from . import layers, work
from .trace import POSTERIOR, STEP

__all__ = ["REPLAY", "LEAPFROG", "replays_per_call", "span_ms_per_step",
           "backward_roofline_pct"]

# the program's spans these readers read (lfit_python_tpu_torch's
# utils/tracing.py): a call replayed from a CUDA graph, and an HMC
# trajectory's updates between its gradient evaluations
REPLAY = "lfit.replay"
LEAPFROG = "lfit.hmc.leapfrog"


def replays_per_call(ctx):
    """``lfit.replay`` ranges that start inside the traced window's
    ``bench.posterior`` ranges, over those calls; None where the trace
    holds no replay range."""
    if ctx.trace is None:
        return None
    calls = sorted((s, e) for name, s, e in ctx.trace.host
                   if name == POSTERIOR)
    replays = [s for name, s, _ in ctx.trace.host if name == REPLAY]
    if not calls or not replays:
        return None
    starts = [s for s, _ in calls]
    inside = 0
    for t in replays:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t <= calls[i][1]
    return inside / len(calls)


def span_ms_per_step(ctx, name):
    """Host ms a step of the traced window in the ranges named ``name``
    (ranges of one name do not nest, and no other program span lies in
    them); None where the trace has none or no step."""
    if ctx.trace is None:
        return None
    steps = sum(1 for r in ctx.trace.host if r[0] == STEP)
    ns = [e - s for n, s, e in ctx.trace.host if n == name]
    if not steps or not ns:
        return None
    return 1e-6 * sum(ns) / steps


def _work(ctx, kernel, shape):
    """(operations, bytes) of the backward kernel ``kernel``'s work in one
    gradient call of ``shape``."""
    rows = shape.walkers * shape.eclipses
    if kernel == "k1_backward":
        return work.k1_backward(rows, shape.solved_elements,
                                ctx.eclipsed_share)
    if kernel == "k7_backward":
        parts = [work.k7_backward(rows, shape.points, n, shape.widths)
                 for n in (shape.disc_elements, shape.spot_elements)]
        return tuple(sum(p[i] for p in parts) for i in (0, 1))
    raise ValueError(f"no work count for {kernel!r}")


def backward_roofline_pct(ctx, match, kernel):
    """100 x the least time of the backward kernel ``kernel``'s work in
    the traced gradient calls over the traced time of the device kernels
    whose names hold ``match``; None where there are none, or where K1's
    work needs an eclipsed share that is not known."""
    n = len(ctx.trace_rows) if ctx.trace is not None else 0
    ks = ctx.trace.kernels(match) if n else []
    if not ks or (kernel == "k1_backward" and ctx.eclipsed_share is None):
        return None
    least = sum(work.least_seconds(*_work(ctx, kernel,
                                          layers.call_shapes(ctx, rows)))[0]
                for rows in ctx.trace_rows)
    return 100.0 * least / (sum(d for _, _, d in ks) * 1e-9)
