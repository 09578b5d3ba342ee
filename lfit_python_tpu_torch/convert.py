"""Carry a model or a sampler state across from the JAX package.

``from_jax_model`` takes a ``lfit_python_tpu`` ``CompiledModel`` — read by
attribute, so this module imports nothing of JAX — or a dict of the same
arrays, and returns the port's :class:`~.models.tree.CompiledModel`, so
both packages evaluate the same posterior on the same data.
``state_from_numpy``, ``hmc_state_from_numpy`` and ``pt_state_from_numpy``
carry sampler states across as arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.priors import PriorTable
from .models.tree import CompiledModel
from .sampling.ensemble import EnsembleState
from .sampling.hmc import HMCState
from .sampling.pt import PTState

__all__ = ["from_jax_model", "state_from_numpy", "hmc_state_from_numpy",
           "pt_state_from_numpy"]

_ARRAYS = ("full_start", "var_idx", "var_pos", "scatter", "cv_idx",
           "cv_const", "gp_idx", "gp_mask", "data_phase", "data_flux",
           "data_err", "data_width", "data_mask")


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def from_jax_model(compiled) -> CompiledModel:
    """The port's compiled model holding the same layout, prior table and
    data as ``compiled`` (a JAX-package ``CompiledModel`` or a dict with
    its array fields, ``param_names``, ``prior_table``, ``any_complex`` and
    ``any_gp``).  Arrays are copied."""
    table = _get(compiled, "prior_table")
    prior_table = PriorTable(
        codes=np.array(_get(table, "codes"), np.int32),
        p1=np.array(_get(table, "p1"), np.float64),
        p2=np.array(_get(table, "p2"), np.float64))
    arrays = {k: np.array(_get(compiled, k)) for k in _ARRAYS}
    return CompiledModel(
        param_names=list(_get(compiled, "param_names")),
        prior_table=prior_table,
        any_complex=bool(_get(compiled, "any_complex")),
        any_gp=bool(_get(compiled, "any_gp")),
        **arrays)


def state_from_numpy(positions, log_prob, step=0, dtype=torch.float64,
                     device=None) -> EnsembleState:
    """The port's ensemble state from numpy walker positions (W, D),
    ln-probabilities (W,) and the global step count, on ``device`` (the
    CUDA card unless given; raises without one)."""
    device = resolve_device(device)
    return EnsembleState(
        torch.tensor(np.asarray(positions), dtype=dtype, device=device),
        torch.tensor(np.asarray(log_prob), dtype=dtype, device=device),
        int(step))


def hmc_state_from_numpy(state, dtype=torch.float64, device=None) -> HMCState:
    """The port's HMC state from a JAX-package ``HMCState`` (read by
    attribute) or a dict of its fields: positions (C, D), log_prob (C,),
    grad (C, D), step_size, inv_mass (D,) and step.  The PRNG key does
    not carry over: the port draws from a ``torch.Generator``.  On
    ``device``, the CUDA card unless given (raises without one)."""
    device = resolve_device(device)

    def arr(name):
        return torch.tensor(np.asarray(_get(state, name)), dtype=dtype,
                            device=device)

    return HMCState(arr("positions"), arr("log_prob"), arr("grad"),
                    arr("step_size"), arr("inv_mass"),
                    int(np.asarray(_get(state, "step"))))


def pt_state_from_numpy(state, dtype=torch.float64, device=None) -> PTState:
    """The port's parallel-tempering state from a JAX-package ``PTState``
    (read by attribute) or a dict of its fields: positions (T, W, D),
    ln_like (T, W), ln_prior (T, W), betas (T,) and step.  The PRNG key
    does not carry over: the port draws from a ``torch.Generator``.  On
    ``device``, the CUDA card unless given (raises without one)."""
    device = resolve_device(device)

    def arr(name):
        return torch.tensor(np.asarray(_get(state, name)), dtype=dtype,
                            device=device)

    return PTState(arr("positions"), arr("ln_like"), arr("ln_prior"),
                   arr("betas"), int(np.asarray(_get(state, "step"))))
