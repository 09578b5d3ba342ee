"""Host ms a gradient evaluation (``value_and_grad``: the forward, the
backward pass, the zeroing of non-finite entries), from the benchmark's
host clock around each call of the window run with spans."""

from lfit_bench import layers


def read(ctx):
    return layers.host_ms_per_call(ctx)
