"""K1's backward kernel's (contacts_backward_kernel) share of its
roofline: the least time of its work (lfit_bench.work.k1_backward, at the
eclipsed share the reference found) over its traced time."""

from lfit_bench import grad


def read(ctx):
    return grad.backward_roofline_pct(ctx, "contacts_backward_kernel",
                                      "k1_backward")
