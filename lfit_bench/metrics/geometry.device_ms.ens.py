"""Device ms a posterior call of the kernels launched in the program's
``lfit.geometry`` span (K5, K4, K2 and the eager work around them)."""

from lfit_bench import stages


def read(ctx):
    return stages.device_ms(ctx, stages.GEOMETRY)
