"""Device ms of all kernels in the traced window a gradient evaluation
(copies and sets left out)."""

from lfit_bench import layers


def read(ctx):
    return layers.device_ms_per_call(ctx)
