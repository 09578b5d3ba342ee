"""No-U-Turn Sampler (iterative multinomial NUTS), batched over chains.

Port of ``lfit_python_tpu/sampling/nuts.py``.  Each trajectory doubles
until the path makes a U-turn, so the integration length adapts to the
local geometry per chain and step.  The recursive tree of Hoffman &
Gelman (2014) is built iteratively (Phan & Pradhan; Stan's current
form): a trajectory grows leaf by leaf under two nested loops (doublings
x subtree leaves), with the sub-U-turn checks made against O(max_depth)
momentum checkpoints picked by bit tricks on the leaf index
(:func:`_leaf_to_ckpt`).  Multinomial sampling over the trajectory with
biased progressive sampling towards the new subtree (Betancourt 2017);
the generalised U-turn criterion with the endpoint half-momentum
correction.

Lockstep without ``vmap``: all chains that are still active share the
doubling count and the leaf index, so both are Python ints and the
checkpoint indices plain integer arithmetic.  Each leaf is one gradient
evaluation on all ``C`` chains; a chain that has stopped (a U-turn, a
divergence) is masked out of every update with ``where`` and its
results are discarded.  The loops end when no chain is active, which
costs one host synchronisation per leaf.  A step therefore costs the
batch's deepest trajectory.

Divergences: a leaf whose energy error exceeds ``max_delta_energy`` or
is not finite (a leapfrog step left the prior's support, where ln_prob
is -inf) gets zero multinomial weight and stops its chain; positions
never become NaN.

It shares the HMC state, gradient wrapper and dual averaging of
``sampling/hmc.py``.  Every random draw comes from a small provider
object (:class:`GeneratorDraws` is the default, on a
``torch.Generator``), so a test can replay the reference's own draws.
"""

from __future__ import annotations

import math

import torch

from .hmc import HMCState, _da_init, _da_update, init_hmc, value_and_grad

__all__ = ["GeneratorDraws", "init_nuts", "batch_nuts_trajectories",
           "nuts_step", "warmup_nuts", "run_nuts"]

_TARGET_ACCEPT = 0.8
_MAX_DELTA_ENERGY = 1000.0


class GeneratorDraws:
    """The random numbers of one NUTS trajectory of ``C`` chains in ``D``
    dimensions, from a ``torch.Generator``, in the order the trajectory
    asks for them."""

    def __init__(self, generator, n_chains, dim, dtype, device):
        self.generator = generator
        self.kw = dict(generator=generator, dtype=dtype, device=device)
        self.C, self.D = n_chains, dim

    def start(self):
        """Standard-normal momenta (C, D) and the step-size jitter
        uniforms (C,)."""
        return (torch.randn((self.C, self.D), **self.kw),
                torch.rand((self.C,), **self.kw))

    def doubling(self):
        """One doubling: the direction (C,) bool, True = forwards, and
        the uniforms (C,) of the biased take of the new subtree."""
        return (torch.rand((self.C,), **self.kw) < 0.5,
                torch.rand((self.C,), **self.kw))

    def leaf(self):
        """One leaf: the uniforms (C,) of the multinomial take."""
        return torch.rand((self.C,), **self.kw)


def init_nuts(generator, start, scatter, ln_prob_fn, n_chains,
              step_size=1e-3, max_rounds=100, vg_fn=None) -> HMCState:
    """The chain ball of :func:`~.hmc.init_hmc` (the state is shared)."""
    return init_hmc(generator, start, scatter, ln_prob_fn, n_chains,
                    step_size=step_size, max_rounds=max_rounds, vg_fn=vg_fn)


def _is_turning(inv_mass, p_left, p_right, rho):
    """Generalised U-turn test with the endpoint half-momentum
    correction, per chain: momenta and ``rho`` (C, D) -> (C,) bool."""
    rho = rho - 0.5 * (p_left + p_right)
    at_left = torch.sum(inv_mass * p_left * rho, dim=-1) <= 0.0
    at_right = torch.sum(inv_mass * p_right * rho, dim=-1) <= 0.0
    return at_left | at_right


def _leaf_to_ckpt(n: int):
    """Checkpoint index range (idx_min, idx_max) of the 0-based subtree
    leaf ``n``: idx_max = popcount(n >> 1), idx_min = idx_max - (trailing
    ones of n) + 1.  Even leaves store at idx_max; odd leaves check
    U-turns against the checkpoints idx_min..idx_max."""
    idx_max = (n >> 1).bit_count()
    n_trail = (~n & (n + 1)).bit_length() - 1
    return idx_max - n_trail + 1, idx_max


def _iterative_turning(inv_mass, p_new, rho, p_ckpts, rho_ckpts, idx_min,
                       idx_max):
    """The new (odd) leaf against every checkpointed subtree's left edge:
    that subtree's momentum sum is rho - rho_ckpt[i] + p_ckpt[i]."""
    turning = torch.zeros(p_new.shape[:-1], dtype=torch.bool,
                          device=p_new.device)
    for i in range(idx_max, idx_min - 1, -1):
        sub_rho = rho - rho_ckpts[i] + p_ckpts[i]
        turning = turning | _is_turning(inv_mass, p_ckpts[i], p_new, sub_rho)
    return turning


def _nuts_trajectory(draws, x0, lp0, g0, eps, inv_mass, vg_fn, max_depth,
                     max_delta=_MAX_DELTA_ENERGY):
    """One NUTS trajectory for every chain: ``x0``, ``g0`` (C, D), ``lp0``
    (C,), ``eps`` () and ``inv_mass`` (D,); ``draws`` provides the random
    numbers (see :class:`GeneratorDraws`).

    Returns (x, lp, g, accept_stat, divergent, depth), per chain:
    ``accept_stat`` is the mean Metropolis accept probability over the
    trajectory's new leaves (the dual-averaging statistic), ``depth`` the
    number of doublings the chain completed."""
    dtype, dev = x0.dtype, x0.device
    C = x0.shape[0]
    noise, jitter = draws.start()
    eps = (eps * (0.8 + 0.2 * jitter))[:, None]              # (C, 1)
    p0 = torch.rsqrt(torch.clamp(inv_mass, min=1e-30)) * noise

    def kinetic(p):
        return 0.5 * torch.sum(inv_mass * p * p, dim=-1)

    def sel(mask, new, old):
        return torch.where(mask[:, None] if new.dim() == 2 else mask,
                           new, old)

    h0 = -lp0 + kinetic(p0)
    neg_inf = torch.full((C,), -math.inf, dtype=dtype, device=dev)
    falses = torch.zeros((C,), dtype=torch.bool, device=dev)
    zeros = torch.zeros((C,), dtype=dtype, device=dev)
    n_ckpt = max(max_depth, 1)

    def leapfrog(x, p, g, direction):
        e = eps * direction[:, None]
        p_half = p + 0.5 * e * g
        x_new = x + e * inv_mass * p_half
        lp_new, g_new = vg_fn(x_new)
        return x_new, p_half + 0.5 * e * g_new, lp_new, g_new

    def build_subtree(active, edge, depth, direction):
        """Grow up to 2^depth leaves from ``edge`` in ``direction`` for
        the chains in ``active``; a chain leaves the loop at its first
        sub-U-turn or divergence.  Returns the subtree's momentum sum,
        its last-built state, its multinomial proposal and log weight,
        and its diagnostics, each per chain."""
        x, p, lp, g = edge
        xp, lpp, gp = x, lp, g
        rho = torch.zeros_like(p)
        lw_sum, sum_acc = neg_inf, zeros
        turning, diverging = falses, falses
        n_leaves = torch.zeros((C,), dtype=torch.int64, device=dev)
        ckpt_p = [torch.zeros_like(p) for _ in range(n_ckpt)]
        ckpt_rho = [torch.zeros_like(p) for _ in range(n_ckpt)]
        leaf = 0
        while leaf < (1 << depth) and bool(active.any()):
            u = draws.leaf()
            x_n, p_n, lp_n, g_n = leapfrog(x, p, g, direction)
            delta = h0 - (-lp_n + kinetic(p_n))              # leaf log weight
            ok = torch.isfinite(delta) & (delta > -max_delta)
            lw_leaf = torch.where(ok, delta, neg_inf)
            acc_leaf = torch.where(
                ok, torch.clamp(torch.exp(torch.clamp(delta, max=0.0)),
                                max=1.0), zeros)
            rho_n = rho + p_n
            # multinomial proposal within the subtree
            lw_new = torch.logaddexp(lw_sum, lw_leaf)
            take = (torch.log(u) < lw_leaf - lw_new) & ok & active
            xp, lpp, gp = sel(take, x_n, xp), sel(take, lp_n, lpp), \
                sel(take, g_n, gp)
            # sub-U-turn bookkeeping: even leaves store, odd leaves check
            idx_min, idx_max = _leaf_to_ckpt(leaf)
            if leaf % 2 == 0:
                ckpt_p[idx_max] = sel(active, p_n, ckpt_p[idx_max])
                ckpt_rho[idx_max] = sel(active, rho_n, ckpt_rho[idx_max])
            else:
                turning = sel(active, _iterative_turning(
                    inv_mass, p_n, rho_n, ckpt_p, ckpt_rho, idx_min,
                    idx_max), turning)
            x, p, lp, g = sel(active, x_n, x), sel(active, p_n, p), \
                sel(active, lp_n, lp), sel(active, g_n, g)
            rho = sel(active, rho_n, rho)
            lw_sum = sel(active, lw_new, lw_sum)
            sum_acc = sel(active, sum_acc + acc_leaf, sum_acc)
            diverging = sel(active, ~ok, diverging)
            n_leaves = n_leaves + active
            leaf += 1
            active = active & ~turning & ~diverging
        return dict(n_leaves=n_leaves, turning=turning, diverging=diverging,
                    edge=(x, p, lp, g), rho=rho, prop=(xp, lpp, gp),
                    lw=lw_sum, sum_acc=sum_acc)

    left = right = (x0, p0, lp0, g0)
    rho, prop, lw = p0, (x0, lp0, g0), zeros
    sum_acc = zeros
    n_leaves = torch.zeros((C,), dtype=torch.int64, device=dev)
    depth_c = torch.zeros((C,), dtype=torch.int64, device=dev)
    turning, diverging = falses, falses
    active = ~falses
    depth = 0
    while depth < max_depth and bool(active.any()):
        going_right, u_bias = draws.doubling()
        direction = torch.where(going_right, 1.0, -1.0).to(dtype)
        edge = tuple(sel(going_right, r, l) for l, r in zip(left, right))
        sub = build_subtree(active, edge, depth, direction)
        sub_ok = ~sub["turning"] & ~sub["diverging"]
        # biased progressive sampling: prefer the new subtree
        take = (torch.log(u_bias) < sub["lw"] - lw) & sub_ok & active
        prop = tuple(sel(take, n, o) for n, o in zip(sub["prop"], prop))
        lw = sel(active & sub_ok, torch.logaddexp(lw, sub["lw"]), lw)
        # merge endpoints and momentum sum; full-trajectory U-turn check
        left = tuple(sel(active & ~going_right, s, l)
                     for s, l in zip(sub["edge"], left))
        right = tuple(sel(active & going_right, s, r)
                      for s, r in zip(sub["edge"], right))
        rho = sel(active, rho + sub["rho"], rho)
        turning = sel(active, sub["turning"] | _is_turning(
            inv_mass, left[1], right[1], rho), turning)
        # a rejected (turning or diverging) subtree's leaves still count
        # in the accept statistic
        sum_acc = sel(active, sum_acc + sub["sum_acc"], sum_acc)
        n_leaves = n_leaves + sub["n_leaves"]
        depth_c = depth_c + active
        diverging = diverging | (active & sub["diverging"])
        depth += 1
        active = active & ~turning & ~diverging
    x, lp, g = prop
    accept_stat = sum_acc / torch.clamp(n_leaves.to(dtype), min=1.0)
    return x, lp, g, accept_stat, diverging, depth_c


def batch_nuts_trajectories(ln_prob_fn, max_depth,
                            max_delta_energy=_MAX_DELTA_ENERGY, vg_fn=None):
    """The chain-batched NUTS trajectory evaluator ``(draws, x (C, D),
    lp (C,), g (C, D), eps (), inv_mass (D,)) -> (x, lp, g, accept_stat,
    divergent, depth)``, each leaf's gradient evaluation by ``vg_fn(x)
    -> (ln p, grad)`` where one is given (the sharded one of
    ``parallel.mesh.sharded_value_and_grad``), else by
    :func:`~.hmc.value_and_grad` of ``ln_prob_fn``."""
    vg = value_and_grad(ln_prob_fn) if vg_fn is None else vg_fn

    def run(draws, x, lp, g, eps, inv_mass):
        return _nuts_trajectory(draws, x, lp, g, eps, inv_mass, vg,
                                max_depth, max_delta_energy)

    return run


def nuts_step(state: HMCState, ln_prob_fn, generator, max_depth=8,
              max_delta_energy=_MAX_DELTA_ENERGY, vg_fn=None):
    """One NUTS step for all chains.  Returns (state, accept_stat,
    mean_accept_stat, divergence fraction, mean depth), the last four as
    0-d tensors; accept_stat is the dual-averaging statistic (the mean
    leaf Metropolis probability), given twice as the reference does:
    NUTS has no reject step, the multinomial draw is the transition.
    ``vg_fn``: see :func:`batch_nuts_trajectories`."""
    trajectories = batch_nuts_trajectories(ln_prob_fn, max_depth,
                                           max_delta_energy, vg_fn)
    C, D = state.positions.shape
    draws = GeneratorDraws(generator, C, D, state.positions.dtype,
                           state.positions.device)
    x, lp, g, astat, div, depth = trajectories(
        draws, state.positions, state.log_prob, state.grad, state.step_size,
        state.inv_mass)
    new = state._replace(positions=x, log_prob=lp, grad=g,
                         step=state.step + 1)
    dt = x.dtype
    return new, astat.mean(), astat.mean(), div.to(dt).mean(), \
        depth.to(dt).mean()


def warmup_nuts(state: HMCState, ln_prob_fn, n_warmup, generator,
                max_depth=8, target_accept=_TARGET_ACCEPT,
                vg_fn=None) -> HMCState:
    """Stan-style two-phase warmup with NUTS as the transition:
    dual-averaged step size, then a diagonal metric from the second half
    of the phase-1 draws (pooled over chains, shrunk towards 1e-3 for few
    samples), then dual averaging again under the new metric.  Returns
    the tuned state with its step counter reset to 0."""
    n1 = max(n_warmup // 2, 1)
    n2 = max(n_warmup - n1, 1)

    def phase(state, n):
        da = _da_init(state.step_size)
        xs = []
        for _ in range(n):
            state, _, aprob, _, _ = nuts_step(
                state, ln_prob_fn, generator, max_depth, vg_fn=vg_fn)
            da = _da_update(da, aprob, target_accept)
            state = state._replace(step_size=torch.exp(da.log_eps))
            xs.append(state.positions)
        state = state._replace(step_size=torch.exp(da.log_eps_bar))
        return state, torch.stack(xs)

    state, xs1 = phase(state, n1)
    tail = xs1[n1 // 2:]
    n = tail.shape[0] * tail.shape[1]
    var = torch.var(tail, dim=(0, 1), unbiased=False)
    var = (n / (n + 5.0)) * var + (5.0 / (n + 5.0)) * 1e-3
    state = state._replace(inv_mass=var)
    state, _ = phase(state, n2)
    return state._replace(step=0)


def run_nuts(state: HMCState, ln_prob_fn, n_steps, generator, max_depth=8,
             thin=1, vg_fn=None):
    """Run ``n_steps`` NUTS steps (``vg_fn``: see
    :func:`batch_nuts_trajectories`).  A step is kept when its global step number is a
    multiple of ``thin``.

    Returns (final state, chain (n_kept, C, D), chain_lp (n_kept, C),
    accept_stat (n_steps,), divergence fraction (n_steps,), mean depth
    (n_steps,)), all on the chains' device."""
    thin = max(int(thin), 1)
    kept_pos, kept_lp, astat, div, depth = [], [], [], [], []
    for _ in range(n_steps):
        state, a, _, d, dep = nuts_step(state, ln_prob_fn, generator,
                                        max_depth, vg_fn=vg_fn)
        astat.append(a)
        div.append(d)
        depth.append(dep)
        if state.step % thin == 0:
            kept_pos.append(state.positions)
            kept_lp.append(state.log_prob)
    C, D = state.positions.shape
    like = state.positions

    def stack(items, shape):
        return torch.stack(items) if items else like.new_empty(shape)

    return (state, stack(kept_pos, (0, C, D)), stack(kept_lp, (0, C)),
            stack(astat, (0,)), stack(div, (0,)), stack(depth, (0,)))
