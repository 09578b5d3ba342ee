"""Host ms a posterior call in the program's ``lfit.flux.contacts`` span:
the disc and spot elements, the contact solve (K1) and the mirror."""

from lfit_bench import stages


def read(ctx):
    return stages.host_ms(ctx, stages.CONTACTS)
