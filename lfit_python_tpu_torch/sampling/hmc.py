"""Hamiltonian Monte Carlo with adaptive warmup, batched over chains.

Port of ``lfit_python_tpu/sampling/hmc.py``.  Many independent chains
move together on ``(C, D)`` tensors; one gradient evaluation per
leapfrog step serves every chain.  Each trajectory has a fixed number of
leapfrog steps with the step size jittered per chain (uniform in
[0.8, 1.0] x eps); warmup is Stan's two phases (dual averaging of the
step size, then a diagonal metric from phase-1 draws and dual averaging
again).  A non-finite Hamiltonian (a step left the prior's support) is a
divergence: the proposal is rejected and counted, and positions never
become NaN.

``ln_prob_fn`` maps ``(C, D) -> (C,)`` and must be differentiable with
each chain's value depending on its own row only; where it has a
``value_and_grad`` method (the port's ``Posterior``) that is used.  Every
random draw comes from an explicit ``torch.Generator`` on the chains'
device, through :func:`trajectory_draws`, so a test can feed
:func:`_trajectory` the reference's own draws.  A trajectory's updates of
position and momentum between its gradient evaluations, and its accept
test, are the span ``lfit.hmc.leapfrog`` (``utils/tracing.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.tracing import LEAPFROG, annotate

__all__ = ["HMCState", "value_and_grad", "init_hmc", "trajectory_draws",
           "batch_trajectories", "hmc_step", "warmup_hmc", "run_hmc"]

_TARGET_ACCEPT = 0.8


class HMCState(NamedTuple):
    positions: torch.Tensor   # (C, D)
    log_prob: torch.Tensor    # (C,)
    grad: torch.Tensor        # (C, D) cached d ln_prob / d x
    step_size: torch.Tensor   # () shared leapfrog step size
    inv_mass: torch.Tensor    # (D,) diagonal inverse mass
    step: int                 # global step counter


def value_and_grad(ln_prob_fn):
    """``x (C, D) -> (ln p (C,), grad (C, D))`` for a batched
    differentiable ``ln_prob_fn``, with non-finite gradient entries
    zeroed (outside the support the divergence check does the
    rejecting)."""
    if hasattr(ln_prob_fn, "value_and_grad"):
        return ln_prob_fn.value_and_grad

    def vg(x):
        with torch.inference_mode(False), torch.enable_grad():
            xv = x.detach().clone().requires_grad_()
            lp = ln_prob_fn(xv)
            g, = torch.autograd.grad(lp.sum(), xv)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return lp.detach(), g

    return vg


def init_hmc(generator, start, scatter, ln_prob_fn, n_chains,
             step_size=1e-3, max_rounds=100, vg_fn=None) -> HMCState:
    """Chain ball around ``start`` (D,) with per-parameter ``scatter``
    (D,); chains with a non-finite ln-probability are redrawn, for at
    most ``max_rounds`` rounds, and the batch evaluated again, whose
    redrawn rows are taken (each row's value is its own): every call has
    the chains' shape, so that a redraw's size is never a key of its own
    to the posterior's graph cache (``models/graphs.py``), as the JAX
    package's init evaluates its whole batch.  ``scatter`` doubles as the
    initial diagonal scale: inv_mass starts at scatter^2.  ``vg_fn(x) ->
    (ln p, grad)`` evaluates the chains in place of
    :func:`value_and_grad` of ``ln_prob_fn``."""
    vg = value_and_grad(ln_prob_fn) if vg_fn is None else vg_fn
    D = start.shape[0]

    def draw(n):
        noise = torch.randn((n, D), generator=generator, dtype=start.dtype,
                            device=start.device)
        return start[None, :] + scatter[None, :] * noise

    pos = draw(n_chains)
    lp, g = vg(pos)
    for _ in range(max_rounds):
        bad = torch.nonzero(~torch.isfinite(lp)).flatten()
        if bad.numel() == 0:
            break
        pos[bad] = draw(bad.numel())
        lp_all, g_all = vg(pos)
        lp[bad], g[bad] = lp_all[bad], g_all[bad]
    return HMCState(pos, lp, g,
                    torch.tensor(step_size, dtype=start.dtype,
                                 device=start.device),
                    (scatter ** 2).to(start.dtype), 0)


def trajectory_draws(generator, n_chains, dim, dtype, device):
    """The random numbers of one HMC step, in the order the sampler draws
    them: standard-normal momenta (C, D), the step-size jitter uniforms
    (C,) and the acceptance uniforms (C,)."""
    noise = torch.randn((n_chains, dim), generator=generator, dtype=dtype,
                        device=device)
    jitter = torch.rand((n_chains,), generator=generator, dtype=dtype,
                        device=device)
    u_acc = torch.rand((n_chains,), generator=generator, dtype=dtype,
                       device=device)
    return noise, jitter, u_acc


def _trajectory(x0, lp0, g0, eps, inv_mass, vg_fn, n_leapfrog, noise,
                jitter, u_acc):
    """One HMC trajectory for every chain, given its draws (see
    :func:`trajectory_draws`).  Returns (x, lp, g, accept, accept_prob,
    divergent), per chain."""
    def kinetic(p):
        return 0.5 * torch.sum(inv_mass * p * p, dim=-1)

    # leapfrog with fused half-steps: one position update and one
    # gradient evaluation per step; the updates between the gradient
    # evaluations are the span LEAPFROG
    x, lp, g = x0, lp0, g0
    with annotate(LEAPFROG):
        # jittered step size per chain: breaks resonant periodic orbits
        eps = (eps * (0.8 + 0.2 * jitter))[:, None]
        p0 = torch.rsqrt(torch.clamp(inv_mass, min=1e-30)) * noise
        p = p0 + 0.5 * eps * g0
    for _ in range(n_leapfrog):
        with annotate(LEAPFROG):
            x = x + eps * inv_mass * p
        lp, g = vg_fn(x)
        with annotate(LEAPFROG):
            p = p + eps * g
    with annotate(LEAPFROG):
        p = p - 0.5 * eps * g   # undo the trailing half of the last update
        delta_h = (-lp0 + kinetic(p0)) - (-lp + kinetic(p))
        divergent = ~torch.isfinite(delta_h) | (delta_h < -1000.0)
        accept_prob = torch.where(
            divergent, torch.zeros_like(delta_h),
            torch.clamp(torch.exp(torch.clamp(delta_h, max=0.0)), max=1.0))
        accept = u_acc < accept_prob
        return (torch.where(accept[:, None], x, x0),
                torch.where(accept, lp, lp0),
                torch.where(accept[:, None], g, g0),
                accept, accept_prob, divergent)


def batch_trajectories(ln_prob_fn, n_leapfrog, vg_fn=None):
    """The chain-batched trajectory evaluator ``(draws, x (C, D), lp (C,),
    g (C, D), eps (), inv_mass (D,)) -> (x, lp, g, accept, accept_prob,
    divergent)``, each gradient evaluation by ``vg_fn`` where one is
    given (the sharded one of ``parallel.mesh.sharded_value_and_grad``),
    else by :func:`value_and_grad` of ``ln_prob_fn``."""
    vg = value_and_grad(ln_prob_fn) if vg_fn is None else vg_fn

    def run(draws, x, lp, g, eps, inv_mass):
        return _trajectory(x, lp, g, eps, inv_mass, vg, n_leapfrog, *draws)

    return run


def hmc_step(state: HMCState, ln_prob_fn, generator, n_leapfrog=16,
             traj_batch_fn=None):
    """One HMC step for all chains.  Returns (state, accept fraction,
    mean accept probability, divergence fraction), the last three as
    0-d tensors.  ``traj_batch_fn`` overrides :func:`batch_trajectories`."""
    if traj_batch_fn is None:
        traj_batch_fn = batch_trajectories(ln_prob_fn, n_leapfrog)
    C, D = state.positions.shape
    draws = trajectory_draws(generator, C, D, state.positions.dtype,
                             state.positions.device)
    x, lp, g, acc, aprob, div = traj_batch_fn(
        draws, state.positions, state.log_prob, state.grad, state.step_size,
        state.inv_mass)
    new = state._replace(positions=x, log_prob=lp, grad=g,
                         step=state.step + 1)
    dt = x.dtype
    return new, acc.to(dt).mean(), aprob.mean(), div.to(dt).mean()


class _DAState(NamedTuple):
    """Nesterov dual-averaging carry (Hoffman & Gelman 2014, sec 3.2)."""
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    m: float


def _da_init(eps0):
    log_eps = torch.log(eps0)
    zero = torch.zeros_like(log_eps)
    return _DAState(log_eps, zero, zero, math.log(10.0) + log_eps, 0.0)


def _da_update(da: _DAState, accept_prob, target=_TARGET_ACCEPT,
               gamma=0.05, t0=10.0, kappa=0.75):
    m = da.m + 1.0
    h_bar = (1.0 - 1.0 / (m + t0)) * da.h_bar \
        + (target - accept_prob) / (m + t0)
    log_eps = da.mu - math.sqrt(m) / gamma * h_bar
    w = m ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, da.mu, m)


def warmup_hmc(state: HMCState, ln_prob_fn, n_warmup, generator,
               n_leapfrog=16, target_accept=_TARGET_ACCEPT,
               traj_batch_fn=None) -> HMCState:
    """Stan-style two-phase warmup: dual-averaged step size, then a
    diagonal metric from the second half of the phase-1 draws (pooled
    over chains, shrunk towards 1e-3 for few samples), then dual
    averaging again under the new metric.  Each phase ends on the
    averaged step size.  Returns the tuned state with its step counter
    reset to 0."""
    n1 = max(n_warmup // 2, 1)
    n2 = max(n_warmup - n1, 1)

    def phase(state, n):
        da = _da_init(state.step_size)
        xs = []
        for _ in range(n):
            state, _, aprob, _ = hmc_step(state, ln_prob_fn, generator,
                                          n_leapfrog, traj_batch_fn)
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


def run_hmc(state: HMCState, ln_prob_fn, n_steps, generator, n_leapfrog=16,
            thin=1, traj_batch_fn=None):
    """Run ``n_steps`` HMC steps.  A step is kept when its global step
    number is a multiple of ``thin``.

    Returns (final state, chain (n_kept, C, D), chain_lp (n_kept, C),
    accept fraction (n_steps,), divergence fraction (n_steps,)), all on
    the chains' device."""
    thin = max(int(thin), 1)
    kept_pos, kept_lp, acc, div = [], [], [], []
    for _ in range(n_steps):
        state, a, _, d = hmc_step(state, ln_prob_fn, generator, n_leapfrog,
                                  traj_batch_fn)
        acc.append(a)
        div.append(d)
        if state.step % thin == 0:
            kept_pos.append(state.positions)
            kept_lp.append(state.log_prob)
    C, D = state.positions.shape
    like = state.positions
    chain = torch.stack(kept_pos) if kept_pos else like.new_empty((0, C, D))
    chain_lp = torch.stack(kept_lp) if kept_lp else like.new_empty((0, C))
    acc_t = torch.stack(acc) if acc else like.new_empty((0,))
    div_t = torch.stack(div) if div else like.new_empty((0,))
    return state, chain, chain_lp, acc_t, div_t
