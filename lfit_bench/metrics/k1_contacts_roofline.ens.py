"""K1's (contacts_kernel) share of its roofline: the least time of the
contact solve's work (lfit_bench.work.k1, the eclipsed share the
reference found) over its traced time."""

from lfit_bench import layers


def read(ctx):
    return layers.roofline_pct(ctx, "contacts_kernel", "k1")
