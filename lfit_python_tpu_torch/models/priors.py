"""Parameter and prior system, on tensors.

Port of ``lfit_python_tpu/models/priors.py``: the host-side declarations
(``Prior``, ``Param``, ``PriorTable``) are numpy, and ``ln_prior_table``
evaluates the five prior families branch-free on a ``(..., D)`` tensor
and selects each row by its type code.  A posterior keeps its table on
the card as :class:`PriorTensors` (:func:`prior_tensors`), so that an
evaluation copies nothing from the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["Prior", "Param", "PriorTable", "PriorTensors", "make_prior_table",
           "prior_tensors", "ln_prior_table"]

_PRIOR_CODES = {
    "uniform": 0,
    "log_uniform": 1,
    "gauss": 2,
    "gaussPos": 3,
    "mod_jeff": 4,
}


@dataclass(frozen=True)
class Prior:
    """A 2-parameter prior: uniform(lo, hi); log_uniform(lo, hi);
    gauss(mean, sigma); gaussPos(mean, sigma) [gaussian truncated at 0];
    mod_jeff(knee, hi) [p ~ 1/(x + knee), 0 <= x < hi]."""
    type: str
    p1: float
    p2: float

    def __post_init__(self):
        if self.type not in _PRIOR_CODES:
            raise ValueError(
                f"unknown prior type {self.type!r}; "
                f"expected one of {sorted(_PRIOR_CODES)}"
            )


@dataclass(frozen=True)
class Param:
    """One named model parameter."""
    name: str
    start: float
    prior: Prior
    is_var: bool = True
    # walker-ball scatter scale multiplier
    scatter: float = field(default=1.0, compare=False)


@dataclass(frozen=True)
class PriorTable:
    """Vectorised prior spec for a flat parameter vector."""
    codes: np.ndarray   # (D,) int32 prior-type codes
    p1: np.ndarray      # (D,)
    p2: np.ndarray      # (D,)


def make_prior_table(params: Sequence[Param]) -> PriorTable:
    return PriorTable(
        codes=np.asarray([_PRIOR_CODES[p.prior.type] for p in params], np.int32),
        p1=np.asarray([p.prior.p1 for p in params], np.float64),
        p2=np.asarray([p.prior.p2 for p in params], np.float64),
    )


class PriorTensors(NamedTuple):
    """A :class:`PriorTable` as tensors on one device."""
    codes: torch.Tensor   # (D,) int64
    p1: torch.Tensor      # (D,) in the values' dtype
    p2: torch.Tensor      # (D,)


def prior_tensors(table: PriorTable, dtype, device) -> PriorTensors:
    """``table`` as :class:`PriorTensors` in ``dtype`` on ``device``, made
    outside any inference mode so that a gradient may use them."""
    with torch.inference_mode(False):
        return PriorTensors(
            torch.as_tensor(table.codes, dtype=torch.int64, device=device),
            torch.as_tensor(table.p1, dtype=dtype, device=device),
            torch.as_tensor(table.p2, dtype=dtype, device=device))


def ln_prior_table(vals: torch.Tensor, table) -> torch.Tensor:
    """Sum of ln prior probabilities over the last axis of ``vals``
    ``(..., D)``; returns ``(...)``.  ``table`` is a :class:`PriorTable`
    (copied to ``vals``' device on each call) or its
    :class:`PriorTensors` on that device in ``vals``' dtype.

    Out-of-support values yield -inf.  Every family is evaluated for every
    row and the row's own family is picked by its code, so values that are
    out of another family's domain never leak into the result.
    Hyperparameter-validity masks keep a degenerate (p1, p2) pair of one
    family from poisoning another family's row (the JAX reference needs
    them for finite gradients; here they keep the two in lockstep).
    """
    v = vals
    dt, dev = v.dtype, v.device
    if isinstance(table, PriorTable):
        table = prior_tensors(table, dt, dev)
    codes, p1, p2 = table
    neg_inf = torch.full((), -math.inf, dtype=dt, device=dev)
    tiny = torch.finfo(dt).tiny
    one = torch.ones((), dtype=dt, device=dev)
    e = torch.full((), math.e, dtype=dt, device=dev)

    # uniform(lo, hi): needs hi > lo
    uni_ok = p2 > p1
    ln_uni = torch.where(
        uni_ok & (v >= p1) & (v <= p2),
        -torch.log(torch.where(uni_ok, p2 - p1, one)), neg_inf)
    # log_uniform(lo, hi): p ~ 1/x on [lo, hi]; needs 0 < lo < hi
    logu_ok = (p1 > 0.0) & (p2 > p1)
    safe_v = torch.clamp(v, min=tiny)
    ln_logu = torch.where(
        logu_ok & (v >= p1) & (v <= p2),
        -torch.log(safe_v)
        - torch.log(torch.log(torch.where(
            logu_ok, p2 / torch.clamp(p1, min=tiny), e))),
        neg_inf)
    # gauss(mean, sigma): needs sigma > 0
    g_ok = p2 > 0.0
    safe_sig = torch.where(g_ok, p2, one)
    ln_g = torch.where(
        g_ok,
        -0.5 * ((v - p1) / safe_sig) ** 2
        - torch.log(safe_sig) - 0.5 * math.log(2.0 * math.pi),
        neg_inf)
    # gaussPos: gaussian truncated to v >= 0, renormalised
    z = p1 / (math.sqrt(2.0) * safe_sig)
    ln_norm_pos = torch.log(0.5 * (1.0 + torch.special.erf(z)))
    ln_gp = torch.where(g_ok & (v >= 0.0), ln_g - ln_norm_pos, neg_inf)
    # mod_jeff(knee, hi): p ~ 1/(v + knee) on [0, hi); needs knee, hi > 0
    mj_ok = (p1 > 0.0) & (p2 > 0.0)
    ln_mj = torch.where(
        mj_ok & (v >= 0.0) & (v < p2),
        -torch.log(torch.clamp(v + p1, min=tiny))
        - torch.log(torch.log(torch.where(
            mj_ok, (p2 + p1) / torch.clamp(p1, min=tiny), e))),
        neg_inf)

    stacked = torch.stack([ln_uni, ln_logu, ln_g, ln_gp, ln_mj], dim=-1)
    idx = codes.expand(v.shape).unsqueeze(-1)
    per_param = torch.gather(stacked, -1, idx).squeeze(-1)
    return per_param.sum(dim=-1)
