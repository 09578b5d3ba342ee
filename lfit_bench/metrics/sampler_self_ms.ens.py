"""Host ms an ensemble step spends outside its posterior calls (the stretch
move's draws, proposals, selects and the kept row's copy): the
benchmark's spans around each step and each posterior call."""

from lfit_bench import layers


def read(ctx):
    return layers.sampler_self_ms(ctx)
