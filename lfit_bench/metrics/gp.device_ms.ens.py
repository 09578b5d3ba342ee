"""Device ms a posterior call of the kernels launched in the program's
``lfit.like.gp`` span (K10's distance mode, K3 and the eager work)."""

from lfit_bench import stages


def read(ctx):
    return stages.device_ms(ctx, stages.GP)
