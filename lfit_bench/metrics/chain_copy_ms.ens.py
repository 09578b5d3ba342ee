"""Host ms a step in the program's ``lfit.chain.copy`` span: the kept
row's copies to the host, which wait for the step's queued device work,
and the chunk's accept fractions."""

from lfit_bench import stages


def read(ctx):
    return stages.host_ms(ctx, stages.CHAIN_COPY, per_step=True)
