"""Host-to-device copies a posterior call launched inside the program's
``lfit.*`` spans (the tree's and the prior table's, for the most part),
from the device trace."""

from lfit_bench import stages


def read(ctx):
    return stages.h2d_per_call(ctx)
