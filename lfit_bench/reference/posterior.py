"""Posterior evaluation: priors + physical validity + per-eclipse
likelihood (chi^2, or the GP "flickering" likelihood).

The benchmark's frozen copy of the PyTorch port's posterior
(``models/likelihood.py``), which follows
``lfit_python_tpu/models/likelihood.py``, over the plain paths of this
folder: no kernel, no routing.  :class:`Posterior` evaluates a batch of
sampled vectors ``(W, D)`` in its dtype on its device (the CPU by
default), and :meth:`Posterior.evaluate` also returns the gradient and
the share of the contact solve's elements that were eclipsed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .components import DonorGrid, donor_curve_nodes, donor_grid, sum_last
from .cv import (CVConfig, CVGeometry, core_precise, cv_fluxes,
                 cv_physical_ok)
from .geometry import (findi, inscribed_radius, l1_potential,
                       origin_shadow_distance, xl1)
from .gp import segmented_matern32_ln_like
from .stream import stream_impacts_diff as stream_impacts
from .stream import stream_steps_for
from .priors import ln_prior_table
from .tree import CompiledModel

__all__ = ["Posterior", "gp_flicker_ln_like", "wd_contact_extension"]


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
    ln_ampin, ln_ampout, ln_tau = gp_pars.unbind(dim=-1)
    q, dphi, rwd = cv_pars[..., 4], cv_pars[..., 5], cv_pars[..., 8]
    phi0 = cv_pars[..., 13]
    with torch.no_grad():
        ext = wd_contact_extension(q, geom.incl, dphi, rwd, geom.x1,
                                   geom.pl1)
        wrapped = torch.remainder(phase - phi0[..., None] + 0.5, 1.0) - 0.5
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
    physical validity fails)."""

    def __init__(self, model: CompiledModel, config: CVConfig | None = None,
                 dtype=torch.float64, device="cpu"):
        if config is None:
            config = CVConfig()
        # the tree always emits 18-slot vectors -> the complex path
        self.config = config._replace(complex_spot=True)
        self.model = model
        self.dtype = dtype
        self.device = torch.device(device)

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

    def _core(self, var, precise=False):
        """The part of an evaluation the prior needs: (full vectors
        (W, n_full), prior table sum (W,), CV parameters (W, E, 18),
        geometry, physical validity (W, E)) of sampled vectors ``var``
        (W, D).  The core-node geometry is solved once per walker; with
        ``precise`` (the flux model's), so is its float64 solve of the
        mixed-precision mode (:func:`core_precise`)."""
        model = self.model
        full = model.full_from_var(var.to(self.dtype))
        lp = ln_prior_table(full, model.prior_table)
        cvp = model.cv_params(full)                          # (W, E, 18)
        q, dphi = cvp[:, 0, 4], cvp[:, 0, 5]
        x1 = xl1(q)
        pl1 = l1_potential(q, x1)
        incl = findi(q, dphi, x1, pl1)
        rdisc = cvp[..., 6] * x1[:, None]
        impacts = stream_impacts(q, rdisc, x1, n_steps=self.stream_steps)
        fine = (core_precise(q, dphi, self.config, self.dtype) if precise
                else None)
        geom = CVGeometry(x1[:, None], pl1[:, None], incl[:, None], rdisc,
                          impacts, None if fine is None
                          else tuple(a[:, None] for a in fine))
        return full, lp, cvp, geom, cv_physical_ok(cvp, geom)

    def _flux(self, cvp, geom):
        """Model flux (W, E, P) on the solved geometry.  The inscribed
        radius, the donor grid and, with ``n_donor_quad``, the donor
        curve's quadrature nodes are core-node quantities: solved once per
        walker (the prior alone needs none of them)."""
        cfg = self.config
        q = cvp[:, :1, 4]
        geom = geom._replace(r_ins=inscribed_radius(q, geom.x1, geom.pl1))
        dgrid = donor_grid(q, geom.x1, geom.pl1, cfg.n_donor_lat,
                           cfg.n_donor_lon)
        nodes = None
        if cfg.n_donor_quad:
            nodes = donor_curve_nodes(
                geom.incl[:, 0], DonorGrid(*(a[:, 0] for a in dgrid)),
                cfg.ulimb_donor, cfg.n_donor_quad)           # (W, n + 1)
        return cv_fluxes(cvp, self.phase, self.width, cfg, geometry=geom,
                         donor=dgrid, donor_curve=nodes)

    def _terms(self, var):
        """(prior table sum (W,), physical validity (W, E), ln-likelihood
        per eclipse (W, E)) of sampled vectors ``var`` (W, D): chi^2, or
        the GP likelihood for the eclipses flagged ``use_gp``.  Where the
        model has no GP eclipse nothing of the GP runs."""
        full, lp, cvp, geom, ok = self._core(var, precise=True)
        fluxes = self._flux(cvp, geom)
        mflux = fluxes.total
        ll = _chi2_ln_like(mflux, self.flux, self.err, self.mask)
        if self.model.any_gp:
            gp_val = gp_flicker_ln_like(cvp, mflux, full[:, self.gp_idx],
                                        geom, self.phase, self.flux,
                                        self.err, self.mask)
            ll = torch.where(self.gp_mask, gp_val, ll)
        return lp, ok, ll, fluxes.eclipsed

    def _ln_prob(self, var):
        lp, ok, ll, ecl = self._terms(var)
        ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
        total = lp + ll.sum(dim=-1)
        return torch.where(torch.isfinite(total), total,
                           torch.full_like(total, -math.inf)), ecl

    def __call__(self, var):
        with torch.inference_mode():
            return self._ln_prob(var)[0]

    def evaluate(self, var, grad=False):
        """``(ln p (W,), d ln p / d var (W, D) or None, eclipsed share)``
        of sampled vectors ``var`` (W, D), in this posterior's dtype: the
        gradient by autograd where ``grad``, with non-finite entries
        zeroed; the share of the contact solve's elements that the donor
        eclipses, over every walker and eclipse."""
        if not grad:
            with torch.inference_mode():
                total, ecl = self._ln_prob(var.to(self.dtype))
            return total, None, float(ecl.float().mean())
        with torch.inference_mode(False), torch.enable_grad():
            v = var.detach().to(self.dtype).clone().requires_grad_()
            total, ecl = self._ln_prob(v)
            g, = torch.autograd.grad(total.sum(), v)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return total.detach(), g, float(ecl.float().mean())
