"""What the per-layer metrics' readers (``lfit_bench/metrics/*.py``) share:
the shapes of one posterior call of a cell, and the arithmetic that turns
spans and a trace into a metric.

Each reader is a module with ``read(ctx) -> float or None``; ``ctx`` is a
:class:`Context`.  A reader that finds nothing to read returns None, and
the harness leaves its metric out of the line.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import work
from .reference.cv import CVConfig

__all__ = ["Context", "CallShape", "call_shapes", "host_ms_per_call",
           "sampler_self_ms", "kernels_per_call", "device_ms_per_call",
           "kernel_ms_per_call", "roofline_pct", "idle_pct"]


@dataclass
class Context:
    """What a traced run hands the readers.

    ``config``, ``traffic``: the cell's files; ``spans``: the host clock
    of the window run with spans, ``{"step": [s], "posterior": [s]}``;
    ``trace``: the profiled window's :class:`~lfit_bench.trace.Trace`,
    with ``trace_rows`` the
    walkers of each posterior call in it; ``eclipsed_share``: the share of
    the contact solve's elements the reference found eclipsed at the
    checked walkers."""
    config: dict
    traffic: dict
    spans: dict = field(default_factory=dict)
    trace: object = None
    trace_rows: list = field(default_factory=list)
    eclipsed_share: float | None = None


@dataclass(frozen=True)
class CallShape:
    """The sizes of one posterior call of ``walkers`` walkers."""
    walkers: int
    eclipses: int
    gp_eclipses: int
    points: int
    widths: bool
    disc_elements: int
    spot_elements: int
    solved_elements: int


def call_shapes(ctx, rows):
    """The :class:`CallShape` of a call of ``rows`` walkers of the cell's
    configuration, at its resolution (``cv_config``, else the port's
    defaults)."""
    cfg = ctx.config
    res = CVConfig(**cfg.get("cv_config", {}))
    n_disc = res.n_disc_rad * res.n_disc_az
    mirror = res.n_disc_az % 2 == 0
    return CallShape(
        walkers=rows, eclipses=cfg["n_eclipses"],
        gp_eclipses=cfg["n_eclipses"] if cfg["use_gp"] else 0,
        points=cfg["n_points"], widths=cfg["widths"] is not None,
        disc_elements=n_disc, spot_elements=res.n_spot,
        solved_elements=(n_disc // 2 if mirror else n_disc) + res.n_spot)


def host_ms_per_call(ctx):
    calls = ctx.spans.get("posterior", [])
    return 1e3 * sum(calls) / len(calls) if calls else None


def sampler_self_ms(ctx):
    """Host ms a step spends outside its posterior calls."""
    steps, calls = ctx.spans.get("step", []), ctx.spans.get("posterior", [])
    if not steps:
        return None
    return 1e3 * (sum(steps) - sum(calls)) / len(steps)


def _calls(ctx):
    return len(ctx.trace_rows) if ctx.trace is not None else 0


def kernels_per_call(ctx):
    n = _calls(ctx)
    return len(ctx.trace.kernels()) / n if n else None


def device_ms_per_call(ctx):
    n = _calls(ctx)
    if not n:
        return None
    return 1e3 * sum(d for _, _, d in ctx.trace.kernels()) * 1e-9 / n


def kernel_ms_per_call(ctx, match):
    n = _calls(ctx)
    ks = ctx.trace.kernels(match) if n else []
    return 1e3 * sum(d for _, _, d in ks) * 1e-9 / n if ks else None


def _work(ctx, kernel, shape):
    """(operations, bytes) of ``kernel``'s work in one call of ``shape``."""
    f = ctx.eclipsed_share
    rows = shape.walkers * shape.eclipses
    if kernel == "k1":
        return work.k1(rows, shape.solved_elements, f)
    if kernel == "k3":
        return work.k3(shape.walkers * shape.gp_eclipses, shape.points,
                       shape.eclipses)
    if kernel == "k7":
        parts = [work.k7(rows, shape.points, n, shape.widths)
                 for n in (shape.disc_elements, shape.spot_elements)]
        return tuple(sum(p[i] for p in parts) for i in (0, 1))
    raise ValueError(f"no work count for {kernel!r}")


def roofline_pct(ctx, match, kernel):
    """100 x the least time of ``kernel``'s work in the traced calls over
    the traced time of the device kernels whose names hold ``match``;
    None where there are none, or where the work depends on an eclipsed
    share that is not known."""
    n = _calls(ctx)
    ks = ctx.trace.kernels(match) if n else []
    if not ks or (kernel.startswith("k1") and ctx.eclipsed_share is None):
        return None
    if kernel == "k3" and not call_shapes(ctx, 1).gp_eclipses:
        return None
    least = sum(work.least_seconds(*_work(ctx, kernel,
                                          call_shapes(ctx, rows)))[0]
                for rows in ctx.trace_rows)
    return 100.0 * least / (sum(d for _, _, d in ks) * 1e-9)


def idle_pct(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
