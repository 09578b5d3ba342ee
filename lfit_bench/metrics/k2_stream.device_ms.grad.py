"""K2's (stream_kernel, with its sensitivities on the gradient path)
device ms a gradient evaluation, from the trace.  A serial chain per
walker: a share of a roofline would say nothing."""

from lfit_bench import layers


def read(ctx):
    return layers.kernel_ms_per_call(ctx, "stream_kernel")
