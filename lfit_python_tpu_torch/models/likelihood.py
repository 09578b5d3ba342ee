"""Posterior evaluation: priors + physical validity + per-eclipse
likelihood (chi^2, or the GP "flickering" likelihood).

Port of ``lfit_python_tpu/models/likelihood.py``.  :func:`make_ln_prob`
returns a :class:`Posterior`, a batched function ``(W, D) -> (W,)`` of
sampled vectors.  One call evaluates every walker and every eclipse at
once: the core-node geometry (L1, inclination, the gas-stream
integration, the donor grid) is solved once per walker, and the
per-eclipse work runs on ``(W, E, ...)`` tensors.

:meth:`Posterior.ln_prior`, :meth:`Posterior.ln_like` and
:meth:`Posterior.parts` split the posterior for the tempered sampler
(:func:`make_ln_prob_parts`): ``ln p_beta = ln prior + beta ln like``.

:meth:`Posterior.value_and_grad` differentiates the same evaluation for
the gradient samplers: every root solve carries its implicit-function-
theorem gradient, the contact phases through K1's backward
(``ops.contacts``) and the stream impacts through K2's forward
sensitivities (``ops.stream``).

On the card the entries (the call, ``ln_prior``, ``ln_like``, ``parts``
and ``value_and_grad``) are replayed from a CUDA graph once their input's
shape has been seen (``models/graphs.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gp import segmented_matern32_ln_like
from ..ops.stream import stream_impacts
from ..roche.geometry import (findi, inscribed_radius, l1_potential,
                              origin_shadow_distance, xl1)
from ..roche.stream import stream_steps_for
from ..utils.tracing import FLUX, GEOMETRY, GP, PARAMS, annotate
from .components import DonorGrid, donor_curve_nodes, donor_grid, sum_last
from .cv import (CVConfig, CVGeometry, core_precise, cv_physical_ok,
                 cv_total_flux)
from .graphs import GraphCache
from .priors import ln_prior_table
from .tree import CompiledModel

__all__ = ["Posterior", "make_ln_prob", "make_ln_prob_parts",
           "gp_flicker_ln_like", "wd_contact_extension"]


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
    """Masked Gaussian ln-likelihood per eclipse: (..., E, P) -> (..., E),
    summed in one order whatever the batch (:func:`sum_last`)."""
    r = (flux - model_flux) / err
    per = -0.5 * (r * r + torch.log(2.0 * math.pi * err ** 2))
    return sum_last(torch.where(mask, per, torch.zeros_like(per)))


def wd_contact_extension(q, incl, dphi, rwd, x1, pl1):
    """Phase half-duration of the WD limb's ingress / egress crossing,
    broadcast over its arguments.

    The WD centre crosses the shadow terminator at phase +/- dphi/2 by
    definition of dphi; the limb's first and last contacts solve
    d(phi) = rwd, with d the signed sky-plane distance of the centre from
    the terminator (:func:`~..roche.geometry.origin_shadow_distance`).
    Two damped Newton iterations on that root with a secant slope; where
    a slope is not finite and positive (an infeasible geometry) the
    extension is 0."""
    eps = 1e-4
    phi = 0.5 * dphi
    ext = torch.zeros_like(phi + rwd)
    good = torch.ones_like(ext, dtype=torch.bool)
    for _ in range(2):
        ph = torch.stack([phi + ext, phi + ext + eps])
        d, _ = origin_shadow_distance(q, incl, ph, x1, pl1)
        slope = (d[1] - d[0]) / eps
        good = good & torch.isfinite(slope) & (slope > 1e-9)
        step = (rwd - d[0]) / torch.where(good, slope,
                                          torch.ones_like(slope))
        ext = torch.clamp(
            ext + torch.where(good, step, torch.zeros_like(step)), 0.0, 0.1)
    return torch.where(good, ext, torch.zeros_like(ext))


def gp_flicker_ln_like(cv_pars, model_flux, gp_pars, geom: CVGeometry,
                       phase, flux, err, mask):
    """GP "flickering" ln-likelihood of every eclipse: (W, E).

    The residuals (data - model) are a Matern-3/2 GP whose amplitude
    switches between exp(ln_ampin_gp) inside the white-dwarf eclipse and
    exp(ln_ampout_gp) outside, with the common timescale exp(ln_tau_gp)
    in phase units.  The changepoints are the WD limb's first and last
    contact phases, +/-(dphi/2 + ext); segment boundaries reset the
    recursion, which makes the segments independent GPs.

    ``cv_pars`` (W, E, 18), ``model_flux`` (W, E, P), ``gp_pars``
    (W, E, 3) = (ln_ampin, ln_ampout, ln_tau); ``phase``, ``flux``,
    ``err``, ``mask`` (E, P).  The changepoints are comparisons, so they
    carry no gradient: they are found under ``no_grad``."""
    with annotate(GP):
        ln_ampin, ln_ampout, ln_tau = gp_pars.unbind(dim=-1)
        q, dphi, rwd = cv_pars[..., 4], cv_pars[..., 5], cv_pars[..., 8]
        phi0 = cv_pars[..., 13]
        with torch.no_grad():
            ext = wd_contact_extension(q, geom.incl, dphi, rwd, geom.x1,
                                       geom.pl1)
            wrapped = torch.remainder(phase - phi0[..., None] + 0.5,
                                      1.0) - 0.5
            in_ecl = wrapped.abs() <= (0.5 * dphi + ext)[..., None]
            reset = torch.cat([torch.zeros_like(in_ecl[..., :1]),
                               in_ecl[..., 1:] != in_ecl[..., :-1]], dim=-1)
        resid = flux - model_flux
        sigma2 = torch.where(in_ecl, torch.exp(2.0 * ln_ampin)[..., None],
                             torch.exp(2.0 * ln_ampout)[..., None])
        c = math.sqrt(3.0) / torch.exp(ln_tau)
        return segmented_matern32_ln_like(phase, resid, err, sigma2, c,
                                          reset=reset, mask=mask)


class Posterior:
    """The posterior of one compiled model, with its data on
    ``device`` in ``dtype``.  Call it on a ``(W, D)`` tensor of sampled
    vectors for the ``(W,)`` ln-probabilities (-inf where a prior or the
    physical validity fails).  ``device=None`` is the CUDA card, and
    raises without one: pass ``device="cpu"`` for the CPU."""

    def __init__(self, model: CompiledModel, config: CVConfig | None = None,
                 dtype=torch.float64, device=None):
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
        # GP eclipses: the full-vector slots of (ln_ampin, ln_ampout,
        # ln_tau) per eclipse, and which eclipses use the GP likelihood
        self.gp_idx = dev(model.gp_idx, torch.int64)
        self.gp_mask = dev(model.gp_mask, torch.bool)
        # the index maps and the prior table, kept on the device
        self.tables = model.tensors(dtype, self.phase.device)
        self._graphs = GraphCache()

    def _core(self, var, precise=False):
        """The part of an evaluation the prior needs: (full vectors
        (W, n_full), prior table sum (W,), CV parameters (W, E, 18),
        geometry, physical validity (W, E)) of sampled vectors ``var``
        (W, D).  The core-node geometry is solved once per walker; with
        ``precise`` (the flux model's), so is its float64 solve of the
        mixed-precision mode (:func:`core_precise`)."""
        model = self.model
        with annotate(PARAMS):
            full = model.full_from_var(var.to(self.dtype))
            lp = ln_prior_table(full, self.tables.prior)
            cvp = model.cv_params(full)                      # (W, E, 18)
        with annotate(GEOMETRY):
            q, dphi = cvp[:, 0, 4], cvp[:, 0, 5]
            x1 = xl1(q)
            pl1 = l1_potential(q, x1)
            incl = findi(q, dphi, x1, pl1)
            rdisc = cvp[..., 6] * x1[:, None]
            impacts = stream_impacts(q, rdisc, x1,
                                     n_steps=self.stream_steps)
            fine = (core_precise(q, dphi, self.config, self.dtype)
                    if precise else None)
            geom = CVGeometry(x1[:, None], pl1[:, None], incl[:, None],
                              rdisc, impacts, None if fine is None
                              else tuple(a[:, None] for a in fine))
            return full, lp, cvp, geom, cv_physical_ok(cvp, geom)

    def _flux(self, cvp, geom):
        """Model flux (W, E, P) on the solved geometry.  The inscribed
        radius, the donor grid and, with ``n_donor_quad``, the donor
        curve's quadrature nodes are core-node quantities: solved once per
        walker (the prior alone needs none of them)."""
        cfg = self.config
        with annotate(FLUX):
            q = cvp[:, :1, 4]
            geom = geom._replace(r_ins=inscribed_radius(q, geom.x1,
                                                        geom.pl1))
            dgrid = donor_grid(q, geom.x1, geom.pl1, cfg.n_donor_lat,
                               cfg.n_donor_lon)
            nodes = None
            if cfg.n_donor_quad:
                nodes = donor_curve_nodes(
                    geom.incl[:, 0], DonorGrid(*(a[:, 0] for a in dgrid)),
                    cfg.ulimb_donor, cfg.n_donor_quad)       # (W, n + 1)
            return cv_total_flux(cvp, self.phase, self.width, cfg,
                                 geometry=geom, donor=dgrid,
                                 donor_curve=nodes)

    def _terms(self, var):
        """(prior table sum (W,), physical validity (W, E), ln-likelihood
        per eclipse (W, E)) of sampled vectors ``var`` (W, D): chi^2, or
        the GP likelihood for the eclipses flagged ``use_gp``.  Where the
        model has no GP eclipse nothing of the GP runs."""
        full, lp, cvp, geom, ok = self._core(var, precise=True)
        mflux = self._flux(cvp, geom)
        ll = _chi2_ln_like(mflux, self.flux, self.err, self.mask)
        if self.model.any_gp:
            gp_val = gp_flicker_ln_like(cvp, mflux, full[:, self.gp_idx],
                                        geom, self.phase, self.flux,
                                        self.err, self.mask)
            ll = torch.where(self.gp_mask, gp_val, ll)
        return lp, ok, ll

    def model_flux(self, var):
        """Total model flux (W, E, P) of sampled vectors ``var`` (W, D)."""
        with torch.inference_mode():
            _, _, cvp, geom, _ = self._core(var, precise=True)
            return self._flux(cvp, geom)

    @staticmethod
    def _prior_of(lp, ok):
        zero = torch.zeros_like(lp)
        phys = torch.where(ok, zero[:, None], zero[:, None] - math.inf)
        return lp + phys.sum(dim=-1)

    def _ln_prob(self, var):
        lp, ok, ll = self._terms(var)
        ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
        total = lp + ll.sum(dim=-1)
        return torch.where(torch.isfinite(total), total,
                           torch.full_like(total, -math.inf))

    def _forward(self, entry, fn, var):
        """``fn(var)`` under ``inference_mode``, through the graph cache."""
        with torch.inference_mode():
            return self._graphs(entry, fn, var)

    def __call__(self, var):
        return self._forward("ln_prob", self._ln_prob, var)

    def _ln_prior(self, var):
        _, lp, _, _, ok = self._core(var)
        return self._prior_of(lp, ok)

    def ln_prior(self, var):
        """Prior table plus the physical-validity checks, (W,): the
        geometry and one stream integration, no flux model."""
        return self._forward("ln_prior", self._ln_prior, var)

    def _ln_like(self, var):
        return self._terms(var)[2].sum(dim=-1)

    def ln_like(self, var):
        """The summed ln-likelihood (W,), without the validity mask (it
        may be NaN where the geometry is infeasible: the prior is -inf
        there)."""
        return self._forward("ln_like", self._ln_like, var)

    def _parts(self, var):
        lp, ok, ll = self._terms(var)
        return self._prior_of(lp, ok), ll.sum(dim=-1)

    def parts(self, var):
        """``(ln_prior(var), ln_like(var))`` from one shared pass: one
        geometry solve and one stream integration for both."""
        return self._forward("parts", self._parts, var)

    def _value_and_grad(self, var):
        with torch.enable_grad():
            v = var.detach().to(self.dtype).clone().requires_grad_()
            total = self._ln_prob(v)
            grad, = torch.autograd.grad(total.sum(), v)
        grad = torch.where(torch.isfinite(grad), grad,
                           torch.zeros_like(grad))
        return total.detach().to(var.dtype), grad.to(var.dtype)

    def value_and_grad(self, var):
        """``(ln p (W,), d ln p / d var (W, D))`` of sampled vectors
        ``var`` (W, D), in ``var``'s dtype.  Walkers are independent, so
        the gradient of the summed ln p is each walker's own; non-finite
        gradient entries (a walker outside the support) are zeroed.  The
        forward and the backward pass are one entry of the graph cache,
        in any grad mode (``_value_and_grad`` turns autograd on itself and
        returns detached tensors)."""
        with torch.inference_mode(False), torch.no_grad():
            return self._graphs("value_and_grad", self._value_and_grad, var)


def make_ln_prob(model: CompiledModel, config: CVConfig | None = None,
                 dtype=torch.float64, device=None) -> Posterior:
    """The batched posterior ln-probability ``(W, D) -> (W,)`` of the
    sampled vector, evaluated in ``dtype`` on ``device`` (the CUDA card
    unless given; raises without one)."""
    return Posterior(model, config, dtype, device)


def make_ln_prob_parts(model: CompiledModel, config: CVConfig | None = None,
                       dtype=torch.float64, device=None):
    """``(ln_prior_fn, ln_like_fn, posterior)``, each batched
    ``(W, D) -> (W,)``, for the tempered sampler: the first two are the
    :class:`Posterior`'s bound methods, so a caller that holds both can
    evaluate them in one pass through ``posterior.parts``."""
    post = Posterior(model, config, dtype, device)
    return post.ln_prior, post.ln_like, post
