"""Host ms of one posterior call (dispatch of its launches, and any wait
it makes): the benchmark's span around each call."""

from lfit_bench import layers


def read(ctx):
    return layers.host_ms_per_call(ctx)
