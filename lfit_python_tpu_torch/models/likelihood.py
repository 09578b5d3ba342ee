"""Posterior evaluation: priors + physical validity + per-eclipse chi^2.

Port of the chi^2 branch of ``lfit_python_tpu/models/likelihood.py``.
:func:`make_ln_prob` returns a :class:`Posterior`, a batched function
``(W, D) -> (W,)`` of sampled vectors.  One call evaluates every walker
and every eclipse at once: the core-node geometry (L1, inclination, the
gas-stream integration, the donor grid) is solved once per walker, and
the per-eclipse work runs on ``(W, E, ...)`` tensors.

:meth:`Posterior.value_and_grad` differentiates the same evaluation for
the gradient samplers: every root solve carries its implicit-function-
theorem gradient, the contact phases through K1's backward
(``ops.contacts``) and the stream impacts through K2's forward
sensitivities (``ops.stream``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops.stream import stream_impacts
from ..roche.geometry import findi, l1_potential, xl1
from ..roche.stream import stream_steps_for
from .components import donor_grid
from .cv import CVConfig, CVGeometry, cv_physical_ok, cv_total_flux
from .priors import ln_prior_table
from .tree import CompiledModel

__all__ = ["Posterior", "make_ln_prob"]


def _q_prior_floor(model: CompiledModel) -> float:
    """Support floor of the q prior, for sizing the stream scan: uniform /
    log_uniform -> p1; gauss -> mean - 6 sigma; gaussPos / mod_jeff -> 0;
    no ``q_core`` parameter -> 0."""
    try:
        i = model.param_names.index("q_core")
    except ValueError:
        return 0.0
    code = int(model.prior_table.codes[i])
    p1 = float(model.prior_table.p1[i])
    p2 = float(model.prior_table.p2[i])
    if code in (0, 1):                      # uniform, log_uniform
        return max(p1, 0.0)
    if code == 2:                           # gauss
        return max(p1 - 6.0 * p2, 0.0)
    return 0.0                              # gaussPos, mod_jeff


def _chi2_ln_like(model_flux, flux, err, mask):
    """Masked Gaussian ln-likelihood per eclipse: (..., E, P) -> (..., E)."""
    r = (flux - model_flux) / err
    per = -0.5 * (r * r + torch.log(2.0 * math.pi * err ** 2))
    return torch.where(mask, per, torch.zeros_like(per)).sum(dim=-1)


class Posterior:
    """The north-star posterior of one compiled model, with its data on
    ``device`` in ``dtype``.  Call it on a ``(W, D)`` tensor of sampled
    vectors for the ``(W,)`` ln-probabilities (-inf where a prior or the
    physical validity fails).  ``device=None`` is the CUDA card, and
    raises without one: pass ``device="cpu"`` for the CPU."""

    def __init__(self, model: CompiledModel, config: CVConfig | None = None,
                 dtype=torch.float64, device=None):
        if model.any_gp:
            raise NotImplementedError(
                "the GP flickering likelihood is not ported yet")
        if config is None:
            config = CVConfig()
        # the tree always emits 18-slot vectors -> the complex path
        self.config = config._replace(complex_spot=True)
        self.model = model
        self.dtype = dtype
        self.device = resolve_device(device)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=self.device)

        self.phase = dev(model.data_phase)
        self.flux = dev(model.data_flux)
        self.err = dev(model.data_err)
        self.mask = dev(model.data_mask, torch.bool)
        # 3-column data has no exposure widths: skip the subdivision
        self.width = dev(model.data_width) \
            if np.any(model.data_width) else None
        self.stream_steps = stream_steps_for(_q_prior_floor(model))

    def _terms(self, var):
        """(ln prior (W,), physical validity (W, E), model flux
        (W, E, P)) of sampled vectors ``var`` (W, D)."""
        model, cfg = self.model, self.config
        full = model.full_from_var(var.to(self.dtype))
        lp = ln_prior_table(full, model.prior_table)
        cvp = model.cv_params(full)                          # (W, E, 18)
        # core-node geometry, once per walker
        q, dphi = cvp[:, 0, 4], cvp[:, 0, 5]
        x1 = xl1(q)
        pl1 = l1_potential(q, x1)
        incl = findi(q, dphi, x1, pl1)
        rdisc = cvp[..., 6] * x1[:, None]
        impacts = stream_impacts(q, rdisc, x1, n_steps=self.stream_steps)
        dgrid = donor_grid(q[:, None], x1[:, None], pl1[:, None],
                           cfg.n_donor_lat, cfg.n_donor_lon)
        geom = CVGeometry(x1[:, None], pl1[:, None], incl[:, None], rdisc,
                          impacts)
        ok = cv_physical_ok(cvp, geom)
        mflux = cv_total_flux(cvp, self.phase, self.width, cfg,
                              geometry=geom, donor=dgrid)
        return lp, ok, mflux

    def model_flux(self, var):
        """Total model flux (W, E, P) of sampled vectors ``var`` (W, D)."""
        with torch.inference_mode():
            return self._terms(var)[2]

    def _ln_prob(self, var):
        lp, ok, mflux = self._terms(var)
        ll = _chi2_ln_like(mflux, self.flux, self.err, self.mask)
        ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
        total = lp + ll.sum(dim=-1)
        return torch.where(torch.isfinite(total), total,
                           torch.full_like(total, -math.inf))

    def __call__(self, var):
        with torch.inference_mode():
            return self._ln_prob(var)

    def value_and_grad(self, var):
        """``(ln p (W,), d ln p / d var (W, D))`` of sampled vectors
        ``var`` (W, D), in ``var``'s dtype.  Walkers are independent, so
        the gradient of the summed ln p is each walker's own; non-finite
        gradient entries (a walker outside the support) are zeroed."""
        with torch.inference_mode(False), torch.enable_grad():
            v = var.detach().to(self.dtype).clone().requires_grad_()
            total = self._ln_prob(v)
            grad, = torch.autograd.grad(total.sum(), v)
        grad = torch.where(torch.isfinite(grad), grad,
                           torch.zeros_like(grad))
        return total.detach().to(var.dtype), grad.to(var.dtype)


def make_ln_prob(model: CompiledModel, config: CVConfig | None = None,
                 dtype=torch.float64, device=None) -> Posterior:
    """The batched posterior ln-probability ``(W, D) -> (W,)`` of the
    sampled vector, evaluated in ``dtype`` on ``device`` (the CUDA card
    unless given; raises without one)."""
    return Posterior(model, config, dtype, device)
