"""Device ms a posterior call of the kernels launched in the program's
``lfit.flux`` span outside ``lfit.flux.contacts`` (K6, K9, K10, K7, K8
and the eager work around them)."""

from lfit_bench import stages


def read(ctx):
    return stages.device_ms(ctx, stages.FLUX)
