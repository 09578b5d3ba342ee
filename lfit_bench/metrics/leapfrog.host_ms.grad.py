"""Host ms an HMC step in the program's ``lfit.hmc.leapfrog`` span: the
trajectory's eager updates of position and momentum between its gradient
evaluations, its last half-step and its accept test.  None where the
program has no such span."""

from lfit_bench import grad


def read(ctx):
    return grad.span_ms_per_step(ctx, grad.LEAPFROG)
