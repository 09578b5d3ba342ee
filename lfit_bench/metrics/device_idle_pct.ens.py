"""Share of the traced window in which nothing ran on the card."""

from lfit_bench import layers


def read(ctx):
    return layers.idle_pct(ctx)
