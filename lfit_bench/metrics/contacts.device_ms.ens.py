"""Device ms a posterior call of the kernels launched in the program's
``lfit.flux.contacts`` span (K1, the elements, the concatenations)."""

from lfit_bench import stages


def read(ctx):
    return stages.device_ms(ctx, stages.CONTACTS)
