"""Device kernels in the traced window a gradient evaluation (the
forward's and the backward's, and the trajectory's own updates)."""

from lfit_bench import layers


def read(ctx):
    return layers.kernels_per_call(ctx)
