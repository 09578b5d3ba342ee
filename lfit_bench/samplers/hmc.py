"""Hamiltonian Monte Carlo of the port as a cell's sampler:
``sampling.hmc.init_hmc`` for the start ball, with the traffic's fixed
step size and diagonal inverse mass put in, and ``sampling.hmc.hmc_step``
(the traffic's leapfrogs, the step size jittered per chain) for each
step, every gradient evaluation by the posterior's ``value_and_grad``.
The interface is the one ``samplers/ensemble.py`` describes.

Where the harness hands the step its spans (``run._Spans``, in the
traced runs), each gradient call gets the spans' host clock, its rows
and, under the profiler, the ``bench.posterior`` range, so that the
per-call readers count gradient calls; the gradient itself is the
wrapped posterior's ``value_and_grad`` in both windows.

Each step keeps a reference, not a copy, to its state before and after
and to its trajectory: each leapfrog's position and the program's ln p
and gradient there.  After the window the last step is worked out again
in float64 from the program's own gradients, the momentum noise, the
step-size jitter and the acceptance uniforms drawn again from the
generator's state before it (:func:`draws`, in the order of
``sampling.hmc.trajectory_draws``).  The numbers (limits in
``lfit_bench/cells/<workload>.json``):

- ``leapfrog_ulps``, over every chain: each leapfrog position against
  the float64 update from the previous one, x_k = x_{k-1} + eps m p_k
  with the momentum p_k followed in float64, in roundings of the
  configuration's dtype of the largest of |x_{k-1}|, |x_k| and the
  updates eps m p_j, j <= k, a coordinate (the program's momentum
  carries the rounding of each of them: where it nearly cancels, near a
  turn, the update is small and its error is not); infinite where a
  chain's row after the step is neither its trajectory's end with its
  ln p nor, bit for bit, its row before;
- ``accepted_gap``, over every chain that moved: nats by which its
  accept test fails, ln u - min(0, dH), dH from the program's ln p at
  both ends and the float64 momenta (infinite for a divergence);
- ``rejected_gap``, over every chain that stayed: nats by which it
  should have moved, min(0, dH) - ln u;
- ``grad_gap``, over the checked chains: the program's gradient at the
  final position x against the reference's, from the reference's ln p
  at x and x +- KAPPA sigma_i e_i (sigma_i the square root of the
  inverse mass, the posterior's width the sampler assumes), as the norm
  of the difference scaled by sigma over the larger of the scaled
  reference gradient's norm and sqrt(D) (the norm of the scaled gradient
  at a typical draw).  A coordinate's reference derivative is whichever
  of the central and the two one-sided differences lies nearest the
  program's: where ln p is smooth over the step they agree to
  ~KAPPA, and where an element's eclipse begins or ends inside it (a
  kink of ln p) the program's derivative is one of the one-sided ones.

The accept test is read over every chain, not only the checked ones: it
needs no reference, and a wrong test shows on a step only in the chains
whose uniform lies between the right and the wrong answer.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

__all__ = ["KAPPA", "start", "step_fn", "evals_per_step", "draws",
           "check_points", "check", "control"]

# the central differences' step, in posterior widths: the rounding of
# the float64 ln p (~1e-12 nats) over 2 KAPPA stays below 1e-8 of a
# scaled gradient of order 1, the truncation below KAPPA^2
KAPPA = 1e-4

# the last step: its state before and after and its trajectory, kept by
# reference to the tensors the step made.  Module state, as the interface
# hands the check no sampler object; the harness loads this module afresh
# for each run (run._load), so a run sees its own steps alone
_LAST = {}


def _vg(post):
    """The gradient evaluation on ``post``: its ``value_and_grad``, or
    the wrapped posterior's, with the spans' clock, rows and range
    around each call, where ``post`` is the harness's spans."""
    calls = getattr(post, "calls", None)
    if not isinstance(calls, list):
        return post.value_and_grad
    spans, inner = post, post.post.value_and_grad

    def vg(x):
        t = time.perf_counter()
        if spans.ranges:
            from torch.profiler import record_function

            from lfit_bench.trace import POSTERIOR
            with record_function(POSTERIOR):
                out = inner(x)
        else:
            out = inner(x)
        spans.calls.append(time.perf_counter() - t)
        spans.rows.append(int(x.shape[0]))
        return out

    return vg


def _stated(value, dtype):
    """``value`` as the configuration's dtype holds it, in float64."""
    return torch.as_tensor(value, dtype=dtype).double().numpy()


def start(traffic, post, start, scatter, gen):
    from lfit_python_tpu_torch.sampling import hmc

    inv_mass = torch.tensor(traffic["inv_mass"], dtype=start.dtype,
                            device=start.device)
    if inv_mass.shape != start.shape:
        raise ValueError(f"the traffic's inverse mass has "
                         f"{inv_mass.numel()} entries, the model "
                         f"{start.numel()} parameters")
    state = hmc.init_hmc(gen, start, scatter, post, traffic["chains"],
                         step_size=traffic["step_size"], vg_fn=_vg(post))
    return state._replace(inv_mass=inv_mass)


def step_fn(traffic, post, gen):
    from lfit_python_tpu_torch.sampling import hmc

    vg = _vg(post)
    n = traffic["leapfrog"]

    def step(state):
        traj = []

        def recording(x):
            lp, g = vg(x)
            traj.append((x, lp, g))
            return lp, g

        new, acc, _, div = hmc.hmc_step(
            state, post, gen, n,
            hmc.batch_trajectories(post, n, vg_fn=recording))
        _LAST.update(before=state, after=new, traj=traj)
        return new, (acc, div)

    return step


def evals_per_step(traffic):
    return traffic["chains"] * traffic["leapfrog"]


def draws(gen_state, chains, dim, dtype, device):
    """The momentum noise (C, D), the step-size jitter (C,) and the
    acceptance uniforms (C,) of the step that started at the generator's
    state ``gen_state``, in float64 (drawn in ``dtype`` on ``device``)."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    noise = torch.randn((chains, dim), generator=gen, dtype=dtype,
                        device=device)
    jitter = torch.rand((chains,), generator=gen, dtype=dtype,
                        device=device)
    u_acc = torch.rand((chains,), generator=gen, dtype=dtype, device=device)
    return tuple(a.double().cpu().numpy() for a in (noise, jitter, u_acc))


def _np(t):
    return t.detach().double().cpu().numpy()


def _kept(record):
    """The last step's rows as the harness kept them (float64) and as the
    sampler's state holds them: True where they agree bit for bit."""
    before, after = _LAST["before"], _LAST["after"]
    same = True
    for state, (pos, lp) in ((before, record["before"]),
                             (after, record["after"])):
        same &= (np.array_equal(_np(state.positions), np.asarray(
            pos, np.float64)) and np.array_equal(
                _np(state.log_prob), np.asarray(lp, np.float64),
                equal_nan=True))
    return same


def _follow(traffic, record, low=None):
    """The last trajectory of every chain, worked out again from the
    program's positions, ln p and gradients: (the largest distance of a
    leapfrog position from its update, in roundings, (C,); ln u (C,);
    min(0, dH) (C,), -inf for a divergence).  With ``low`` (a torch
    dtype) the updates and the accept test are made in it: the control."""
    before, traj = _LAST["before"], _LAST["traj"]
    x0, lp0, g0 = (_np(a) for a in (before.positions, before.log_prob,
                                    before.grad))
    C, D = x0.shape
    dtype = record["dtype"]
    noise, jitter, u_acc = draws(record["gen_state"], C, D, dtype,
                                 record["device"])
    fp = float(torch.finfo(dtype).eps)
    eps = _stated(traffic["step_size"], dtype) * (0.8 + 0.2 * jitter)
    eps = eps[:, None]
    m = _stated(traffic["inv_mass"], dtype)

    def rnd(a):
        return a if low is None else torch.as_tensor(a).to(low).double(
        ).numpy()

    p0 = noise / np.sqrt(np.maximum(m, 1e-30))
    p = p0 + 0.5 * eps * g0
    ulps = np.zeros(C)
    prev = x0
    # the largest update so far: the momentum carries each earlier
    # update's rounding into this one
    most = np.zeros_like(x0)
    for x, _, g in traj:
        x = _np(x)
        upd = eps * m * p
        most = np.maximum(most, np.abs(upd))
        want = rnd(rnd(prev) + rnd(upd))
        scale = fp * np.maximum.reduce([np.abs(prev), np.abs(x), most])
        ulps = np.maximum(ulps, np.max(np.abs(x - want)
                                       / np.maximum(scale, 1e-300), axis=1))
        p = p + eps * _np(g)
        prev = x
    lp_end = _np(traj[-1][1])
    p = p - 0.5 * eps * _np(traj[-1][2])

    def kinetic(p):
        return 0.5 * np.sum(m * p * p, axis=-1)

    with np.errstate(invalid="ignore", over="ignore"):
        dh = rnd((-rnd(lp0) + rnd(kinetic(p0)))
                 - (-rnd(lp_end) + rnd(kinetic(p))))
        divergent = ~np.isfinite(dh) | (dh < -1000.0)
        ln_a = np.where(divergent, -np.inf, np.minimum(dh, 0.0))
    with np.errstate(divide="ignore"):
        ln_u = np.log(u_acc)
    return ulps, ln_u, ln_a


def _decisions(record, ulps, ln_u, ln_a):
    """(leapfrog_ulps, accepted_gap, rejected_gap) over every chain."""
    traj = _LAST["traj"]
    x0, lp0 = (np.asarray(v, np.float64) for v in record["before"])
    x1, lp1 = (np.asarray(v, np.float64) for v in record["after"])
    moved = np.any(x1 != x0, axis=1)
    at_end = (np.all(x1 == _np(traj[-1][0]), axis=1)
              & (lp1 == _np(traj[-1][1])))
    kept = (lp1 == lp0) | (np.isnan(lp1) & np.isnan(lp0))
    if not _kept(record) or np.any(moved & ~at_end) or np.any(
            ~moved & ~kept):
        lf = math.inf
    else:
        lf = float(np.max(ulps, initial=0.0))
    with np.errstate(invalid="ignore"):
        acc = np.where(moved, ln_u - ln_a, 0.0)
        rej = np.where(~moved, ln_a - ln_u, 0.0)
    acc = np.where(np.isnan(acc), math.inf, acc)
    rej = np.where(np.isnan(rej), 0.0, rej)
    return (lf, float(np.max(acc, initial=0.0)),
            float(np.max(rej, initial=0.0)))


def check_points(traffic, record, idx):
    """(points (n (2D + 1), D): each checked chain's final position moved
    by + KAPPA sigma_i along each parameter, by - KAPPA sigma_i, and
    unmoved; the same as (n, 2D + 1, D))."""
    x = np.asarray(record["after"][0], np.float64)[idx]
    n, D = x.shape
    sigma = np.sqrt(_stated(traffic["inv_mass"], record["dtype"]))
    step = np.diag(KAPPA * sigma)
    pts = np.concatenate([x[:, None, :] + step[None],
                          x[:, None, :] - step[None], x[:, None, :]],
                         axis=1)
    return pts.reshape(-1, D), pts


def _grad_gap(traffic, record, idx, pts, lp):
    """``grad_gap`` of the program's gradients at the checked chains'
    final positions against the reference's ln p ``lp`` at ``pts``."""
    n, _, D = pts.shape
    lp = np.asarray(lp, np.float64).reshape(n, 2 * D + 1)
    d = np.arange(D)
    x = pts[:, 2 * D]
    up, down, mid = lp[:, :D], lp[:, D:2 * D], lp[:, 2 * D:]
    g = _np(_LAST["after"].grad)[idx]
    with np.errstate(invalid="ignore", divide="ignore"):
        diffs = np.stack([
            (up - down) / (pts[:, d, d] - pts[:, D + d, d]),
            (up - mid) / (pts[:, d, d] - x),
            (mid - down) / (x - pts[:, D + d, d])])
    near = np.argmin(np.where(np.isnan(diffs), np.inf,
                              np.abs(diffs - g[None])), axis=0)
    g_ref = np.take_along_axis(diffs, near[None], axis=0)[0]
    sigma = np.sqrt(_stated(traffic["inv_mass"], record["dtype"]))
    num = np.linalg.norm((g - g_ref) * sigma, axis=1)
    den = np.maximum(np.linalg.norm(g_ref * sigma, axis=1), math.sqrt(D))
    gap = num / den
    return float(np.max(np.where(np.isfinite(gap), gap, math.inf),
                        initial=0.0))


def check(traffic, record, idx, memo, lp):
    lf, acc, rej = _decisions(record, *_follow(traffic, record))
    return {"leapfrog_ulps": lf, "grad_gap": _grad_gap(traffic, record,
                                                        idx, memo, lp),
            "accepted_gap": acc, "rejected_gap": rej}


def control(traffic, record, idx, memo, lp, dtype, evaluate):
    """The numbers of the control: each leapfrog update and the accept
    test made in ``dtype`` from the program's rows, and the reference's
    gradient by central differences of ``evaluate(points, dtype)`` (the
    reference put in the program's place)."""
    ulps, ln_u, ln_a = _follow(traffic, record, low=dtype)
    lf, acc, rej = _decisions(record, ulps, ln_u, ln_a)
    lp_c = evaluate(memo.reshape(-1, memo.shape[-1]), dtype)[0]
    return {"leapfrog_ulps": lf,
            "grad_gap": _grad_gap(traffic, record, idx, memo, lp_c),
            "accepted_gap": acc, "rejected_gap": rej}
