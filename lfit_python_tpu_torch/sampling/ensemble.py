"""Affine-invariant stretch-move ensemble sampler on the card.

Port of ``lfit_python_tpu/sampling/ensemble.py``: Goodman & Weare (2010)
stretch move with the red-black (two half-ensemble) update of emcee.  For
each walker k of the moving half, a partner x_j from the other half gives
the proposal

    y = x_j + z (x_k - x_j),    z = ((a - 1) u + 1)^2 / a,  u ~ U(0, 1)

accepted with probability min(1, z^(D-1) exp(ln p(y) - ln p(x_k))).

The posterior is batched, ``(W, D) -> (W,)``, and every random draw comes
from an explicit ``torch.Generator`` on the ensemble's device.

:func:`run_sampler` keeps its chain on the device; :func:`run_chunked`,
which the command line runs, keeps the same rows on the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.tracing import CHAIN_COPY, annotate

__all__ = ["EnsembleState", "init_walkers", "ensemble_step", "run_sampler",
           "run_chunked"]


class EnsembleState(NamedTuple):
    positions: torch.Tensor   # (W, D)
    log_prob: torch.Tensor    # (W,)
    step: int                 # global step counter


@torch.inference_mode()
def init_walkers(generator, start, scatter, ln_prob_fn, n_walkers,
                 max_rounds=100) -> EnsembleState:
    """Walker ball around ``start`` (D,) with per-parameter absolute
    ``scatter`` (D,); walkers with a non-finite ln-probability are redrawn,
    and only those re-evaluated, for at most ``max_rounds`` rounds."""
    D = start.shape[0]

    def draw(n):
        noise = torch.randn((n, D), generator=generator, dtype=start.dtype,
                            device=start.device)
        return start[None, :] + scatter[None, :] * noise

    pos = draw(n_walkers)
    lp = ln_prob_fn(pos)
    for _ in range(max_rounds):
        bad = torch.nonzero(~torch.isfinite(lp)).flatten()
        if bad.numel() == 0:
            break
        fresh = draw(bad.numel())
        pos[bad] = fresh
        lp[bad] = ln_prob_fn(fresh)
    return EnsembleState(pos, lp, 0)


def stretch_draws(generator, n_half, n_other, dtype, device):
    """The random numbers of one half-ensemble update, in the order the
    sampler draws them: partner indices j (n_half,), the uniform u that
    gives z, and the acceptance uniforms."""
    j = torch.randint(0, n_other, (n_half,), generator=generator,
                      device=device)
    u = torch.rand((n_half,), generator=generator, dtype=dtype,
                   device=device)
    u_acc = torch.rand((n_half,), generator=generator, dtype=dtype,
                       device=device)
    return j, u, u_acc


def _half_update(movers, movers_lp, others, batch_ln_prob, a, j, u, u_acc):
    """Stretch-move update of one half-ensemble against the other, given
    its draws (see :func:`stretch_draws`).  Returns (new positions,
    new ln-probs, accepted mask)."""
    D = movers.shape[1]
    partners = others[j]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    prop = partners + z[:, None] * (movers - partners)
    lp_prop = batch_ln_prob(prop)
    ln_acc = (D - 1.0) * torch.log(z) + lp_prop - movers_lp
    accept = torch.log(u_acc) < ln_acc
    new = torch.where(accept[:, None], prop, movers)
    new_lp = torch.where(accept, lp_prop, movers_lp)
    return new, new_lp, accept


@torch.inference_mode()
def ensemble_step(state: EnsembleState, ln_prob_fn, generator, a=2.0):
    """One full red-black stretch-move step.  Returns (state, accept
    fraction as a 0-d tensor)."""
    pos, lp = state.positions, state.log_prob
    W = pos.shape[0]
    half = W // 2
    first, first_lp = pos[:half], lp[:half]
    second, second_lp = pos[half:], lp[half:]

    draws = stretch_draws(generator, half, W - half, pos.dtype, pos.device)
    first, first_lp, acc1 = _half_update(
        first, first_lp, second, ln_prob_fn, a, *draws)
    draws = stretch_draws(generator, W - half, half, pos.dtype, pos.device)
    second, second_lp, acc2 = _half_update(
        second, second_lp, first, ln_prob_fn, a, *draws)

    new_state = EnsembleState(torch.cat([first, second]),
                              torch.cat([first_lp, second_lp]),
                              state.step + 1)
    acc_frac = (acc1.sum() + acc2.sum()).to(pos.dtype) / W
    return new_state, acc_frac


def run_sampler(state: EnsembleState, ln_prob_fn, n_steps, generator,
                a=2.0, thin=1):
    """Run ``n_steps`` stretch-move steps.  A step is kept when its global
    step number is a multiple of ``thin``.

    Returns (final state, chain (n_kept, W, D), chain_lp (n_kept, W),
    accept fraction (n_steps,)), all on the ensemble's device."""
    thin = max(int(thin), 1)
    kept_pos, kept_lp, acc = [], [], []
    for _ in range(n_steps):
        state, frac = ensemble_step(state, ln_prob_fn, generator, a)
        acc.append(frac)
        if state.step % thin == 0:
            kept_pos.append(state.positions)
            kept_lp.append(state.log_prob)
    W, D = state.positions.shape
    like = state.positions
    chain = torch.stack(kept_pos) if kept_pos else like.new_empty((0, W, D))
    chain_lp = torch.stack(kept_lp) if kept_lp else like.new_empty((0, W))
    acc_t = torch.stack(acc) if acc else like.new_empty((0,))
    return state, chain, chain_lp, acc_t


def _extract_samples(state):
    """The rows a kept step contributes: the state's positions and
    ln-probabilities."""
    return state.positions, state.log_prob


@torch.inference_mode()
def run_chunked(state, step_fn, n_steps, thin=1, chunk_size=64,
                progress: Optional[Callable[[int, float], None]] = None,
                extract=_extract_samples):
    """Run ``step_fn(state) -> (state, aux)`` ``n_steps`` times, keeping,
    as :func:`run_sampler` does, the steps whose global number
    ``state.step`` is a multiple of ``thin`` (the phase follows the global
    counter, so the spacing stays regular across checkpoint segments).
    ``extract(state) -> (rows (W, D), ln p (W,))`` picks what a kept step
    contributes (default: the state's positions and log_prob; the tempered
    sampler keeps its cold rung), and each kept row is copied to the host
    as it is made.  ``aux`` is the step's accept fraction as a 0-d tensor
    (taken as a tuple of one), or a tuple of per-step tensors whose first
    is the accept fraction (the tempered sampler adds each rung's mean
    ln-likelihood, HMC the divergence fraction, NUTS that and the mean
    depth).

    ``progress(done, mean accept)`` is called where the JAX package's
    driver ends a chunk, so a fit's metrics lines fall on the same steps:
    after the steps up to the first kept row, then every ``chunk_size //
    thin`` kept rows, after the last kept row, and at the end.

    Returns (final state, chain (n_kept, W, D), chain_lp (n_kept, W),
    aux), as numpy arrays: aux is a tuple of each aux entry stacked over
    the steps (one empty array when ``n_steps`` is 0), so that its first
    is the accept fractions (n_steps,).
    """
    thin = max(int(thin), 1)
    step0 = int(state.step)
    rows, lp = extract(state)
    W, D = rows.shape
    dtype = rows[:0].cpu().numpy().dtype
    n_kept = (step0 + n_steps) // thin - step0 // thin
    chain = np.empty((n_kept, W, D), dtype)
    chain_lp = np.empty((n_kept, W), dtype)
    first = min((-step0) % thin, n_steps)
    last = n_steps - (n_steps - first) % thin
    span = max(chunk_size // thin, 1) * thin
    ends = {first, last, n_steps, *range(first + span, last, span)} - {0}
    k, pending, done = 0, [], []
    for i in range(1, n_steps + 1):
        state, aux = step_fn(state)
        pending.append(aux if isinstance(aux, tuple) else (aux,))
        with annotate(CHAIN_COPY):
            if state.step % thin == 0:
                rows, lp = extract(state)
                chain[k] = rows.cpu().numpy()
                chain_lp[k] = lp.cpu().numpy()
                k += 1
            chunk = ([torch.stack(col).cpu().numpy() for col in zip(*pending)]
                     if i in ends else None)
        if chunk is not None:
            done.append(chunk)
            if progress is not None:
                progress(i, float(chunk[0].mean()))
            pending = []
    if done:
        aux = tuple(np.concatenate(col) for col in zip(*done))
    else:
        aux = (np.empty(0, dtype),)
    return state, chain, chain_lp, aux
