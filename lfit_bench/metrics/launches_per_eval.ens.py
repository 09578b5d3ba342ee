"""Device kernels in the traced window over the posterior calls in it."""

from lfit_bench import layers


def read(ctx):
    return layers.kernels_per_call(ctx)
