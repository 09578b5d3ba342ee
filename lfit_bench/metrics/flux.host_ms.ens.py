"""Host ms a posterior call in the program's ``lfit.flux`` span outside
``lfit.flux.contacts``: the lobe radius, the donor grid, the WD, the
curves and the donor sums."""

from lfit_bench import stages


def read(ctx):
    return stages.host_ms(ctx, stages.FLUX)
