"""The stretch-move ensemble of the port as a cell's sampler:
``sampling.ensemble.init_walkers`` for the start ball and
``sampling.ensemble.ensemble_step`` (red-black halves, the traffic's
``a``) for each step.

A sampler module gives the harness (``lfit_bench/run.py``):

- ``start(traffic, post, start, scatter, gen)``: the state before the
  warm-up step, from the ball ``start + scatter * N(0, 1)``;
- ``step_fn(traffic, post, gen)``: ``state -> (state, aux)`` for
  ``run_chunked``;
- ``evals_per_step(traffic)``: the posterior evaluations a step makes;
- ``check_points(traffic, record, idx)`` and ``check(traffic, record,
  idx, memo, lp)``: the last update of the window, held to the reference
  (the points it needs the reference's ln p at, then its numbers);
- ``control(traffic, record, idx, memo, lp, dtype, evaluate)``: the same
  numbers of the control, the step computed in the lower precision
  ``dtype``, ``evaluate(points, dtype)`` giving the reference's (ln p,
  eclipsed share) in it.

``record`` holds what the harness kept of the window's last step:
``gen_state`` (the generator's state before it), ``before`` and
``after`` (positions (W, D) and ln p (W,), numpy), the configuration's
``dtype`` and the ``device``; ``idx`` are the walkers drawn for the
check.

The numbers (limits in ``lfit_bench/cells/<workload>.json``), over the
checked walkers, with the partner, z and the uniforms drawn again from
the generator's state (:mod:`lfit_bench.reference.stretch`):

- ``proposal_ulps``: a walker that moved sits at the reference's
  proposal to this many roundings of the configuration's dtype, of the
  largest of |partner|, |before| and |after| a coordinate; one that did
  not move kept its ln p exactly (else infinite);
- ``accepted_gap``: nats by which a walker that moved should not have,
  ln u - ((D - 1) ln z + ln p after - ln p before), from the ln p the
  sampler carries: its accept test again, in float64;
- ``rejected_gap``: nats by which a walker that stayed should have moved,
  (D - 1) ln z + ln p_ref(proposal) - ln p before - ln u, with the
  reference's ln p at the proposal, which the sampler does not keep.
"""

from __future__ import annotations

import numpy as np
import torch

from lfit_bench.reference import stretch

__all__ = ["start", "step_fn", "evals_per_step", "check_points", "check",
           "control"]


def start(traffic, post, start, scatter, gen):
    from lfit_python_tpu_torch.sampling import ensemble

    return ensemble.init_walkers(gen, start, scatter, post,
                                 traffic["walkers"])


def step_fn(traffic, post, gen):
    from lfit_python_tpu_torch.sampling import ensemble

    a = traffic["a"]

    def step(state):
        return ensemble.ensemble_step(state, post, gen, a)

    return step


def evals_per_step(traffic):
    return traffic["walkers"]


def check_points(traffic, record, idx):
    """(points (n, D): the checked walkers' proposals, the
    :class:`~lfit_bench.reference.stretch.Replay`)."""
    r = stretch.replay(record["gen_state"], record["before"][0],
                       record["after"][0], traffic["a"], record["dtype"],
                       record["device"])
    return r.proposal[idx], r


def _gaps(moved, ln_u, ln_z, lp_before, lp_after, lp_prop, D):
    """(accepted_gap, rejected_gap) of walkers that ``moved`` or not."""
    with np.errstate(invalid="ignore"):
        acc = ln_u - ((D - 1.0) * ln_z + lp_after - lp_before)
        rej = (D - 1.0) * ln_z + lp_prop - lp_before - ln_u
    acc = np.where(moved & ~np.isnan(acc), acc, 0.0)
    rej = np.where(~moved & ~np.isnan(rej), rej, 0.0)
    return (float(np.max(acc, initial=0.0)), float(np.max(rej, initial=0.0)))


def check(traffic, record, idx, memo, lp):
    r = memo
    before, lp_before = (np.asarray(v, np.float64)[idx]
                         for v in record["before"])
    after, lp_after = (np.asarray(v, np.float64)[idx]
                       for v in record["after"])
    eps = float(torch.finfo(record["dtype"]).eps)
    moved = np.any(after != before, axis=1)
    kept = (lp_after == lp_before) | (np.isnan(lp_after)
                                      & np.isnan(lp_before))
    if np.any(~moved & ~kept):
        ulps = np.inf
    else:
        scale = eps * np.maximum.reduce([np.abs(r.partner[idx]),
                                         np.abs(before), np.abs(after)])
        off = np.abs(after - r.proposal[idx]) / np.maximum(scale, 1e-300)
        ulps = float(np.max(off[moved], initial=0.0))
    acc, rej = _gaps(moved, r.ln_u[idx], np.log(r.z[idx]), lp_before,
                     lp_after, lp, before.shape[1])
    return {"proposal_ulps": ulps, "accepted_gap": acc, "rejected_gap": rej}


def control(traffic, record, idx, memo, lp, dtype, evaluate):
    """The numbers of the control: the step made in ``dtype``, the
    stretch in that dtype and ln p by ``evaluate(points, dtype)`` (the
    reference put in the program's place), its proposals read whether or
    not it took them."""
    r = memo
    before = np.asarray(record["before"][0], np.float64)[idx]
    n, D = len(idx), before.shape[1]
    eps = float(torch.finfo(record["dtype"]).eps)

    def low(x):
        return torch.as_tensor(x).to(dtype)

    z_c = low(r.z[idx])
    partner_c = low(r.partner[idx])
    prop_c = (partner_c + z_c[:, None] * (low(before) - partner_c)
              ).double().numpy()
    lp_c = evaluate(np.concatenate([prop_c, before]), dtype)[0]
    ln_z_c = np.log(z_c.double().numpy())
    with np.errstate(invalid="ignore"):
        moved_c = r.ln_u[idx] < (D - 1.0) * ln_z_c + lp_c[:n] - lp_c[n:]
    scale = eps * np.maximum.reduce([np.abs(r.partner[idx]),
                                     np.abs(before), np.abs(prop_c)])
    ulps = float(np.max(np.abs(prop_c - r.proposal[idx])
                        / np.maximum(scale, 1e-300)))
    acc, rej = _gaps(moved_c, r.ln_u[idx], ln_z_c, lp_c[n:],
                     np.where(moved_c, lp_c[:n], lp_c[n:]), lp, D)
    return {"proposal_ulps": ulps, "accepted_gap": acc, "rejected_gap": rej}
