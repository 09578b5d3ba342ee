"""K7's backward kernel's (element_curve_backward_kernel) share of its
roofline: the least time of the disc's and the spot's backward sweeps
(lfit_bench.work.k7_backward, with the exposure widths) over their traced
time."""

from lfit_bench import grad


def read(ctx):
    return grad.backward_roofline_pct(ctx, "element_curve_backward_kernel",
                                      "k7_backward")
