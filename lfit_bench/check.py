"""The comparison that decides a run's ``correct``.

After the window, the sampler's state is held to the plain float64
reference (``lfit_bench/reference``), which builds the configuration's
model and data itself from the shared inputs (the configuration file and
the seed's light curves) and evaluates the walkers on the CPU:

- ``lnp_gap``: the widest gap, in nats, between the ln p the sampler
  carries for a walker and the reference's at that walker's position,
  over a sample of the walkers drawn from the seed (infinite where one
  is finite and the other not);
- ``unmoved_pct``: the share of all walkers whose position did not change
  over the window (a step that returns its state unchanged, or leaves
  some walkers out, reads high);
- the sampler's own numbers on the window's last step
  (``lfit_bench/samplers/<sampler>.py``).

Each number has a limit (``lfit_bench/cells/<workload>.json``); the run is
correct when every number is at or under its limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sample", "lnp_gap", "unmoved_pct", "judge", "reference_eval"]


def sample(seed, n_total, n):
    """Sorted indices of ``n`` of ``n_total`` walkers, drawn from
    ``seed``."""
    rng = np.random.default_rng((int(seed) & (2 ** 64 - 1), 1))
    return np.sort(rng.choice(n_total, size=min(n, n_total), replace=False))


def lnp_gap(lnp, lnp_ref):
    """Widest |lnp - lnp_ref| (nats); infinite where their finiteness
    differs, NaN counted as a gap of infinity."""
    a = np.asarray(lnp, np.float64)
    b = np.asarray(lnp_ref, np.float64)
    fa, fb = np.isfinite(a), np.isfinite(b)
    if np.any(fa != fb) or np.any(np.isnan(a)) or np.any(np.isnan(b)):
        return math.inf
    both = fa & fb
    return float(np.max(np.abs(a[both] - b[both]), initial=0.0))


def unmoved_pct(start, final):
    """Percent of walkers whose position at the window's end equals, bit
    for bit, the one at its start."""
    same = np.all(np.asarray(start) == np.asarray(final), axis=1)
    return 100.0 * float(same.mean())


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) for the numbers compared: each
    at or under its limit (a NaN never is)."""
    rows = [(k, float(v), float(limits[k])) for k, v in numbers.items()]
    return all(v <= lim for _, v, lim in rows), rows


def reference_eval(post_ref, positions):
    """The reference's (ln p, eclipsed share) at ``positions`` (n, D)."""
    x = torch.as_tensor(np.asarray(positions), dtype=torch.float64)
    lp, _, ecl = post_ref.evaluate(x)
    return lp.double().numpy(), ecl
