"""K3's (gp_kernel) share of its roofline (lfit_bench.work.k3); nothing
where the configuration has no GP eclipse."""

from lfit_bench import layers


def read(ctx):
    return layers.roofline_pct(ctx, "gp_kernel", "k3")
