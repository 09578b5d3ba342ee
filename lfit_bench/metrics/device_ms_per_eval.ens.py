"""All device kernels' time in the traced window per posterior call."""

from lfit_bench import layers


def read(ctx):
    return layers.device_ms_per_call(ctx)
