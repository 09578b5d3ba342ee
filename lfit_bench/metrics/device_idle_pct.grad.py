"""Percent of the traced window of the gradient cell with nothing on the
device."""

from lfit_bench import layers


def read(ctx):
    return layers.idle_pct(ctx)
