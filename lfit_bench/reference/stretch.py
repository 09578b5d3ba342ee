"""The stretch move's last update, worked out again in float64.

The benchmark's frozen copy of the draws and the proposal of the red-black
stretch move (Goodman & Weare 2010, emcee's two halves) that
``lfit_python_tpu_torch.sampling.ensemble`` makes.  From a generator's
state before a step it draws the same numbers in the same order (for each
half: partner indices, the uniforms that give z, the acceptance
uniforms), and from the positions before and after the step it gives each
walker's partner, its stretch factor z and its proposal in float64.  The
first half moves against the second half's positions before the step, the
second against the first half's after it, so the replay follows the
sampler through the step from its own rows; each row is itself held to
the reference's ln p by the checks that read it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Replay", "draws", "replay"]


class Replay(NamedTuple):
    """One step's stretch move for every walker (W walkers, D parameters):
    its partner's position (W, D), z (W,), the proposal (W, D), all in
    float64, and ln of its acceptance uniform (W,)."""
    partner: np.ndarray
    z: np.ndarray
    proposal: np.ndarray
    ln_u: np.ndarray


def draws(generator, n_half, n_other, dtype, device):
    """The random numbers of one half's update, in the order the sampler
    draws them: partner indices (n_half,), the uniforms that give z, and
    the acceptance uniforms, as numpy arrays."""
    j = torch.randint(0, n_other, (n_half,), generator=generator,
                      device=device)
    u = torch.rand((n_half,), generator=generator, dtype=dtype,
                   device=device)
    u_acc = torch.rand((n_half,), generator=generator, dtype=dtype,
                       device=device)
    return j.cpu().numpy(), u.cpu().numpy(), u_acc.cpu().numpy()


def replay(gen_state, before, after, a, dtype, device):
    """The :class:`Replay` of the step that took the positions ``before``
    (W, D) to ``after``, from the generator's state ``gen_state`` before
    it, the draws made in ``dtype`` on ``device``."""
    before = np.asarray(before, np.float64)
    after = np.asarray(after, np.float64)
    W = before.shape[0]
    half = W // 2
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    partner = np.empty_like(before)
    z = np.empty(W)
    ln_u = np.empty(W)
    for lo, hi, others in ((0, half, before[half:]),
                           (half, W, after[:half])):
        j, u, u_acc = draws(gen, hi - lo, others.shape[0], dtype, device)
        partner[lo:hi] = others[j]
        z[lo:hi] = ((a - 1.0) * u.astype(np.float64) + 1.0) ** 2 / a
        with np.errstate(divide="ignore"):
            ln_u[lo:hi] = np.log(u_acc.astype(np.float64))
    proposal = partner + z[:, None] * (before - partner)
    return Replay(partner, z, proposal, ln_u)

