"""K7's (element_curve_kernel) share of its roofline: the disc's and the
spot's element curves (lfit_bench.work.k7) over their traced time."""

from lfit_bench import layers


def read(ctx):
    return layers.roofline_pct(ctx, "element_curve_kernel", "k7")
