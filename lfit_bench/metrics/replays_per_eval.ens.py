"""CUDA-graph replays a posterior call: the program's ``lfit.replay``
ranges that start inside the traced window's ``bench.posterior`` ranges,
over those calls.  None where the trace holds no replay range (a program
without the graph route, or one that replayed nothing)."""

import bisect

from lfit_bench.trace import POSTERIOR

REPLAY = "lfit.replay"


def read(ctx):
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
