"""Host ms a posterior call in the program's ``lfit.like.gp`` span: the
changepoints, the resets and the GP recursion."""

from lfit_bench import stages


def read(ctx):
    return stages.host_ms(ctx, stages.GP)
