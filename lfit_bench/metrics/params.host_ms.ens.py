"""Host ms a posterior call in the program's ``lfit.params`` span: the
tree's gathers and the prior table, with their host-to-device copies."""

from lfit_bench import stages


def read(ctx):
    return stages.host_ms(ctx, stages.PARAMS)
