"""Parallel-tempered ensemble sampler.

Port of ``lfit_python_tpu/sampling/pt.py``: a ladder of inverse
temperatures beta_t, each running its own stretch-move ensemble on the
tempered posterior  ln p_t = ln prior + beta_t ln like,  with walker swaps
between adjacent rungs.  The ladder is one more batch axis: positions are
``(T, W, D)``, and each half-step proposes for all rungs at once and
evaluates them in a single batched call on ``(T * H, D)`` vectors.  The
swap move exchanges aligned walker pairs (walker i of rung t with walker
i of rung t + 1) with the acceptance
min(1, exp((beta_a - beta_b)(lnL_b - lnL_a))).

``ln_prior_fn`` and ``ln_like_fn`` are batched, ``(N, D) -> (N,)``.  Where
both are bound methods of one object that has a ``parts`` method (the
port's ``Posterior``, from ``make_ln_prob_parts``), a proposal is
evaluated by one ``parts`` call: one geometry solve for both.  A
``batch_parts_fn`` evaluates the proposals in their place where one is
given (the sharded evaluator of ``parallel.mesh.sharded_pt_batch_parts``).
Every random draw comes from an explicit ``torch.Generator`` through
:func:`pt_draws`, so a test can feed :func:`_pt_update` the reference's
own draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PTState", "default_beta_ladder", "init_pt", "pt_draws",
           "pt_step", "run_pt", "log_evidence"]


class PTState(NamedTuple):
    positions: torch.Tensor   # (T, W, D)
    ln_like: torch.Tensor     # (T, W)
    ln_prior: torch.Tensor    # (T, W)
    betas: torch.Tensor       # (T,)
    step: int                 # global step counter


def default_beta_ladder(n_temps, ratio=math.sqrt(2.0)):
    """Geometric inverse-temperature ladder (T,), beta_0 = 1 (the
    posterior), as a float64 CPU tensor."""
    return torch.tensor([1.0 / ratio ** t for t in range(n_temps)],
                        dtype=torch.float64)


def parts_fn(ln_prior_fn, ln_like_fn):
    """``flat (N, D) -> (ln_prior (N,), ln_like (N,))``: the shared
    ``parts`` pass where the two functions belong to one object that has
    it, else the two calls."""
    owner = getattr(ln_prior_fn, "__self__", None)
    if owner is not None and hasattr(owner, "parts") \
            and owner is getattr(ln_like_fn, "__self__", None):
        return owner.parts

    def parts(flat):
        return ln_prior_fn(flat), ln_like_fn(flat)

    return parts


def _default_batch_parts(ln_prior_fn, ln_like_fn):
    """``pos (T, H, D) -> (ln_prior (T, H), ln_like (T, H))``: one
    :func:`parts_fn` call on the flattened ``(T * H, D)`` block."""
    parts = parts_fn(ln_prior_fn, ln_like_fn)

    def batch(pos):
        lp, ll = parts(pos.reshape(-1, pos.shape[-1]))
        return lp.reshape(pos.shape[:2]), ll.reshape(pos.shape[:2])

    return batch


@torch.inference_mode()
def init_pt(generator, start, scatter, ln_prior_fn, ln_like_fn, n_walkers,
            n_temps, betas=None, max_rounds=100,
            batch_parts_fn=None) -> PTState:
    """Walker balls around ``start`` (D,) with per-parameter ``scatter``
    (D,) at every rung.  Walkers whose prior is not finite are redrawn,
    and only those re-evaluated, for at most ``max_rounds`` rounds; the
    likelihood is evaluated once, at the end, by ``batch_parts_fn``
    where one is given."""
    if betas is None:
        betas = default_beta_ladder(n_temps)
    betas = torch.as_tensor(betas).to(dtype=start.dtype, device=start.device)
    D = start.shape[0]

    def draw(n):
        noise = torch.randn((n, D), generator=generator, dtype=start.dtype,
                            device=start.device)
        return start[None, :] + scatter[None, :] * noise

    pos = draw(n_temps * n_walkers)
    lp = ln_prior_fn(pos)
    for _ in range(max_rounds):
        bad = torch.nonzero(~torch.isfinite(lp)).flatten()
        if bad.numel() == 0:
            break
        fresh = draw(bad.numel())
        pos[bad] = fresh
        lp[bad] = ln_prior_fn(fresh)
    shape = (n_temps, n_walkers)
    if batch_parts_fn is None:
        ll = ln_like_fn(pos)
    else:
        ll = batch_parts_fn(pos.reshape(*shape, D))[1].reshape(-1)
    return PTState(pos.reshape(*shape, D), ll.reshape(shape),
                   lp.reshape(shape), betas, 0)


def pt_draws(generator, n_temps, n_walkers, dtype, device):
    """The random numbers of one PT step, in the order the sampler draws
    them: for each half-ensemble the partner indices j (T, H), the
    uniform u that gives z and the acceptance uniforms; then the swap
    sweep's uniforms (T - 1, W).  Returns (first half, second half,
    swap)."""
    half = n_walkers // 2

    def half_draws(n_half, n_other):
        j = torch.randint(0, n_other, (n_temps, n_half),
                          generator=generator, device=device)
        u = torch.rand((n_temps, n_half), generator=generator, dtype=dtype,
                       device=device)
        u_acc = torch.rand((n_temps, n_half), generator=generator,
                           dtype=dtype, device=device)
        return j, u, u_acc

    first = half_draws(half, n_walkers - half)
    second = half_draws(n_walkers - half, half)
    u_swap = torch.rand((max(n_temps - 1, 0), n_walkers),
                        generator=generator, dtype=dtype, device=device)
    return first, second, u_swap


def _pt_update(state: PTState, batch_parts_fn, a, draws):
    """One tempered stretch-move step and one adjacent-rung swap sweep,
    given its draws (see :func:`pt_draws`).  Returns (state, (accept
    fraction, per-rung mean ln-likelihood (T,)))."""
    T, W, D = state.positions.shape
    half = W // 2
    betas = state.betas
    pos, lp, ll = state.positions, state.ln_prior, state.ln_like
    n_acc = torch.zeros((), dtype=pos.dtype, device=pos.device)

    # red-black half updates
    halves = [pos[:, :half], pos[:, half:]]
    lp_h = [lp[:, :half], lp[:, half:]]
    ll_h = [ll[:, :half], ll[:, half:]]
    for s in (0, 1):
        j, u, u_acc = draws[s]
        movers, others = halves[s], halves[1 - s]           # (T, H, D)
        m_state_lp = lp_h[s] + betas[:, None] * ll_h[s]
        partners = torch.gather(others, 1, j[..., None].expand(-1, -1, D))
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        prop = partners + z[..., None] * (movers - partners)
        p_lp, p_ll = batch_parts_fn(prop)
        prop_state_lp = p_lp + betas[:, None] * p_ll
        ln_acc = (D - 1.0) * torch.log(z) + prop_state_lp - m_state_lp
        acc = torch.log(u_acc) < ln_acc
        halves[s] = torch.where(acc[..., None], prop, movers)
        lp_h[s] = torch.where(acc, p_lp, lp_h[s])
        ll_h[s] = torch.where(acc, p_ll, ll_h[s])
        n_acc = n_acc + acc.sum()
    pos = torch.cat(halves, dim=1)
    lp = torch.cat(lp_h, dim=1)
    ll = torch.cat(ll_h, dim=1)

    # swap sweep between adjacent rungs, coldest pair first: aligned
    # walker pairs, so detailed balance holds per pair and the move is
    # elementwise
    ln_u = torch.log(draws[2])
    pos_r, lp_r, ll_r = list(pos.unbind(0)), list(lp.unbind(0)), \
        list(ll.unbind(0))
    for t in range(T - 1):
        ln_acc = (betas[t] - betas[t + 1]) * (ll_r[t + 1] - ll_r[t])
        acc = ln_u[t] < ln_acc
        for rows, sel in ((pos_r, acc[:, None]), (lp_r, acc), (ll_r, acc)):
            rows[t], rows[t + 1] = (torch.where(sel, rows[t + 1], rows[t]),
                                    torch.where(sel, rows[t], rows[t + 1]))
    pos, lp, ll = torch.stack(pos_r), torch.stack(lp_r), torch.stack(ll_r)

    new_state = PTState(pos, ll, lp, betas, state.step + 1)
    # per-rung ensemble-mean ln-likelihood: the thermodynamic-integration
    # integrand <ln L>_beta that log_evidence takes
    return new_state, (n_acc / (T * W), ll.mean(dim=1))


@torch.inference_mode()
def pt_step(state: PTState, ln_prior_fn, ln_like_fn, generator, a=2.0,
            batch_parts_fn=None):
    """One PT step for all rungs.  Returns (state, (accept fraction as a
    0-d tensor, per-rung mean ln-likelihood (T,))).  ``batch_parts_fn(pos
    (T, H, D)) -> (ln_prior (T, H), ln_like (T, H))`` evaluates the
    proposals (default: one :func:`parts_fn` call on the flattened
    block)."""
    if batch_parts_fn is None:
        batch_parts_fn = _default_batch_parts(ln_prior_fn, ln_like_fn)
    T, W, _ = state.positions.shape
    draws = pt_draws(generator, T, W, state.positions.dtype,
                     state.positions.device)
    return _pt_update(state, batch_parts_fn, a, draws)


def run_pt(state: PTState, ln_prior_fn, ln_like_fn, n_steps, generator,
           a=2.0, thin=1, batch_parts_fn=None):
    """Run ``n_steps`` PT steps (``batch_parts_fn``: see :func:`pt_step`).
    A step is kept when its global step number is a multiple of
    ``thin``; only the beta = 1 (cold) rung is kept as samples.

    Returns (final state, cold positions (n_kept, W, D), cold ln
    posterior (n_kept, W), accept fraction (n_steps,), rung_ln_like
    (n_steps, T)), all on the ensemble's device.  ``rung_ln_like``
    averaged over the steps is the integrand of :func:`log_evidence`."""
    thin = max(int(thin), 1)
    kept_pos, kept_lp, acc, rung = [], [], [], []
    for _ in range(n_steps):
        state, (frac, rung_ll) = pt_step(state, ln_prior_fn, ln_like_fn,
                                         generator, a, batch_parts_fn)
        acc.append(frac)
        rung.append(rung_ll)
        if state.step % thin == 0:
            kept_pos.append(state.positions[0])
            kept_lp.append(state.ln_prior[0] + state.ln_like[0])
    T, W, D = state.positions.shape
    like = state.positions
    chain = torch.stack(kept_pos) if kept_pos else like.new_empty((0, W, D))
    chain_lp = torch.stack(kept_lp) if kept_lp else like.new_empty((0, W))
    acc_t = torch.stack(acc) if acc else like.new_empty((0,))
    rung_t = torch.stack(rung) if rung else like.new_empty((0, T))
    return state, chain, chain_lp, acc_t, rung_t


def log_evidence(betas, mean_ln_like):
    """Thermodynamic-integration evidence from the tempered ladder:
    ln Z = integral_0^1 <ln L>_beta d beta.

    ``mean_ln_like``: the ensemble-mean ln-likelihood per rung, averaged
    over production (:func:`run_pt`'s ``rung_ln_like`` over steps).
    Trapezoid over the ladder, extended to beta = 0 by constant
    extrapolation of the hottest rung.  Returns (ln_z, dln_z), the
    second the difference between the full ladder's integral and
    every other rung's."""
    betas = np.asarray(betas, np.float64)
    f = np.asarray(mean_ln_like, np.float64)
    order = np.argsort(betas)
    b, f = betas[order], f[order]
    if b[0] > 0.0:
        b = np.concatenate([[0.0], b])
        f = np.concatenate([f[:1], f])

    trapezoid = getattr(np, "trapezoid", None) or np.trapz

    def integ(bs, fs):
        return float(trapezoid(fs, bs))

    ln_z = integ(b, f)
    # half-ladder comparison: drop every other interior rung
    keep = np.ones(b.size, bool)
    keep[1:-1:2] = False
    dln_z = abs(ln_z - integ(b[keep], f[keep]))
    return ln_z, dln_z
