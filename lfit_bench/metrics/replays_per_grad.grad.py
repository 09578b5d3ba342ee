"""CUDA-graph replays a gradient evaluation: the program's
``lfit.replay`` ranges that start inside the traced window's
``bench.posterior`` ranges (one a gradient call), over those calls.  None
where the trace holds no replay range (a program whose gradient path
runs eagerly)."""

from lfit_bench import grad


def read(ctx):
    return grad.replays_per_call(ctx)
