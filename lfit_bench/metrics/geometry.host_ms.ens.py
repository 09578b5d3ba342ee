"""Host ms a posterior call in the program's ``lfit.geometry`` span: L1,
the inclination, the stream and the validity checks (K5, K4, K2)."""

from lfit_bench import stages


def read(ctx):
    return stages.host_ms(ctx, stages.GEOMETRY)
