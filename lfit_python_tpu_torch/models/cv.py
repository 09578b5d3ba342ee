"""CV forward-model orchestrator: parameter vectors -> light curves.

Port of ``lfit_python_tpu/models/cv.py``, with its mixed-precision mode
(``CVConfig.mixed_precision``) and its donor quadrature
(``CVConfig.n_donor_quad``).  Parameter vectors
are ``(..., 14)`` (simple spot) or ``(..., 18)`` (complex spot), in the
JAX package's order:

    0 wdFlux  1 dFlux  2 sFlux  3 rsFlux  4 q  5 dphi  6 rdisc  7 ulimb
    8 rwd  9 scale  10 az  11 fis  12 dexp  13 phi0
    [14 exp1  15 exp2  16 tilt  17 yaw]

Every function broadcasts over the leading axes ``(...)``: the posterior
evaluates all walkers and eclipses at once with ``(W, E, 18)`` vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.stream import stream_impacts
from ..roche.geometry import (earth_vector, findi, inscribed_radius,
                              l1_potential, xl1)
from ..utils.tracing import CONTACTS, annotate
from . import components as comp

__all__ = [
    "SIMPLE_PARAM_NAMES",
    "COMPLEX_PARAM_NAMES",
    "CVConfig",
    "CVFluxes",
    "CVGeometry",
    "cv_geometry",
    "core_precise",
    "cv_physical_ok",
    "cv_fluxes",
    "cv_total_flux",
]

SIMPLE_PARAM_NAMES = (
    "wdFlux", "dFlux", "sFlux", "rsFlux", "q", "dphi", "rdisc",
    "ulimb", "rwd", "scale", "az", "fis", "dexp", "phi0",
)
COMPLEX_PARAM_NAMES = SIMPLE_PARAM_NAMES + ("exp1", "exp2", "tilt", "yaw")


class CVConfig(NamedTuple):
    """Resolution knobs of the CV model (the JAX package's defaults).  The
    port routes the contact solve by dtype (float32 or float64 -> the CUDA
    kernel K1 in that dtype; float32 with ``mixed_precision`` -> K1 in
    mixed precision)."""
    complex_spot: bool = False
    n_disc_rad: int = 24
    n_disc_az: int = 40
    n_spot: int = 32
    n_donor_lat: int = 16
    n_donor_lon: int = 24
    n_exposure_sub: int = 3      # finite-exposure phase subsamples
    ulimb_donor: float = 0.9
    # donor quadrature: the posterior sums the donor elements once per
    # walker on n_donor_quad + 1 phase nodes over the half period and each
    # eclipse interpolates them (components.donor_curve_nodes /
    # donor_curve_eval; ~1e-5 of the donor flux at 256).  0: exact
    # per-phase sums, what the JAX package picks anywhere but on a TPU
    n_donor_quad: int = 0
    # mixed precision (the JAX package's --precise): a float32 posterior
    # solves the per-walker geometry (xl1, findi) again in float64, builds
    # the disc grid in float64, and evaluates the contact and white-dwarf
    # decision quantity c = Phi - Phi_L1 in float64 near the roots; the
    # element sums stay float32.  No effect on a float64 posterior.  Not
    # differentiable.
    mixed_precision: bool = False


class CVFluxes(NamedTuple):
    """Per-component and total model fluxes, each (..., P)."""
    total: torch.Tensor
    ywd: torch.Tensor
    ydisc: torch.Tensor
    yspot: torch.Tensor
    ysec: torch.Tensor


class CVGeometry(NamedTuple):
    """Per-vector geometry shared by the validity prior and the flux
    model; each field (...) except ``spot_impact`` (..., 3)."""
    x1: torch.Tensor           # L1 distance
    pl1: torch.Tensor          # L1 potential
    incl: torch.Tensor         # inclination (deg; NaN if infeasible)
    rdisc: torch.Tensor        # disc radius in separation units
    spot_impact: torch.Tensor  # stream / disc-rim impact point
    # (q, incl, x1, pl1) solved in float64 for the mixed-precision mode,
    # or None (the mode is off, or the working dtype is float64)
    precise: tuple | None = None
    # the inscribed radius of (q, x1, pl1) for the white dwarf's guard and
    # the contact solve, or None: cv_fluxes solves it once
    r_ins: torch.Tensor | None = None


def cv_geometry(pars, config: CVConfig = CVConfig()) -> CVGeometry:
    """Solve the geometry (L1, inclination, stream impact and, in the
    mixed-precision mode, :func:`core_precise`) of ``pars`` (..., 14|18)
    on its own.  The posterior solves the core node once per walker
    instead and assembles the :class:`CVGeometry` itself."""
    q, dphi, rdisc_x = pars[..., 4], pars[..., 5], pars[..., 6]
    x1 = xl1(q)
    pl1 = l1_potential(q, x1)
    incl = findi(q, dphi, x1, pl1)
    rdisc = rdisc_x * x1
    lead = rdisc.shape
    impact = stream_impacts(q.reshape(-1), rdisc.reshape(-1, 1),
                            x1.reshape(-1)).reshape(lead + (3,))
    return CVGeometry(x1, pl1, incl, rdisc, impact,
                      core_precise(q, dphi, config, pars.dtype))


def core_precise(q, dphi, config: CVConfig, dtype):
    """(q, incl, x1, pl1) solved in float64 from the working-dtype ``q``
    and ``dphi`` (...), for the mixed-precision refinements; None when the
    mode is off or ``dtype`` is already float64."""
    if not config.mixed_precision or dtype == torch.float64:
        return None
    q64 = q.to(torch.float64)
    x164 = xl1(q64)
    pl164 = l1_potential(q64, x164)
    incl64 = findi(q64, dphi.to(torch.float64), x164, pl164)
    return q64, incl64, x164, pl164


def cv_physical_ok(pars, geom: CVGeometry):
    """Physical validity: feasible (q, dphi); the WD inside the disc; the
    gas stream reaches the disc rim (bright spot on the disc)."""
    rwd = pars[..., 8]
    spot_r = torch.linalg.vector_norm(geom.spot_impact, dim=-1)
    return (torch.isfinite(geom.incl)
            & (rwd < geom.rdisc)
            & (spot_r <= geom.rdisc * (1.0 + 1e-3))
            & (spot_r > rwd))


def _expand_exposure(phases, widths, n_sub):
    """Subdivide each exposure into n_sub sub-phases: (..., P) ->
    (..., P * n_sub)."""
    offs = (torch.arange(n_sub, dtype=phases.dtype, device=phases.device)
            + 0.5) / n_sub - 0.5
    sub = phases[..., None] + widths[..., None] * offs
    return sub.reshape(sub.shape[:-2] + (-1,))


def cv_fluxes(pars, phases, widths=None, config: CVConfig = CVConfig(),
              geometry: CVGeometry | None = None, donor=None,
              donor_curve=None) -> CVFluxes:
    """Evaluate the four-component CV model over a phase grid.

    ``pars``: (..., 14) or (..., 18); ``phases``: (..., P) orbital phases;
    ``widths``: (..., P) exposure widths or None (instantaneous).
    ``geometry``: precomputed :func:`cv_geometry`; ``donor``: precomputed
    :class:`~.components.DonorGrid` (it depends only on the core q);
    ``donor_curve``: precomputed quadrature nodes
    (:func:`~.components.donor_curve_nodes`), whose leading axes are
    ``pars``' first ones: the donor term and its normaliser are then
    interpolated (:func:`~.components.donor_curve_eval`) instead of summed
    per phase.  Invalid geometry yields NaNs, which the posterior screens
    out."""
    dtype = pars.dtype
    (wdF, dF, sF, rsF, q, dphi, rdisc_x, ulimb, rwd, scale, az, fis,
     dexp, phi0) = (pars[..., i] for i in range(14))
    if config.complex_spot:
        exp1, exp2, tilt, yaw = (pars[..., i] for i in range(14, 18))
    else:
        exp1 = torch.ones_like(q)
        exp2 = torch.ones_like(q)
        tilt = torch.full_like(q, 90.0)
        yaw = torch.zeros_like(q)

    if geometry is None:
        geometry = cv_geometry(pars, config)
    x1, pl1, incl, rdisc = (geometry.x1, geometry.pl1, geometry.incl,
                            geometry.rdisc)
    precise = geometry.precise
    r_ins = geometry.r_ins
    if r_ins is None:
        r_ins = inscribed_radius(q, x1, pl1)

    dgrid = donor if donor is not None else comp.donor_grid(
        q, x1, pl1, config.n_donor_lat, config.n_donor_lon)

    # phase grid: WD and donor are smooth per-phase functions (phase
    # subsampling for the WD); disc and spot are interval-based (exact
    # analytic smearing)
    phases = phases.to(dtype)
    ph = phases - phi0[..., None]
    w = None if widths is None else widths.to(dtype)
    if w is not None:
        sub = _expand_exposure(ph, w, config.n_exposure_sub)
        n_sub = config.n_exposure_sub
    else:
        sub = ph
        n_sub = 1

    def per_walker(a):
        return a[..., None]

    # ---- white dwarf -----------------------------------------------------
    y = comp.wd_flux(per_walker(q), per_walker(incl), sub, per_walker(rwd),
                     per_walker(ulimb), per_walker(x1), per_walker(pl1),
                     r_ins=per_walker(r_ins), precise=None if precise is None
                     else tuple(per_walker(a) for a in precise))
    if n_sub > 1:
        y = y.reshape(y.shape[:-1] + (-1, n_sub)).mean(dim=-1)
    ywd = wdF[..., None] * y

    # ---- disc + spot via per-element contact intervals ------------------
    # Mirror halving: the geometry is symmetric under (y, phase) ->
    # (-y, -phase) and the disc azimuths come in mirror pairs
    # (az_j <-> 2 pi - az_j), so only half the disc azimuths plus the spot
    # strip are solved; the other half is (-phi_out, -phi_in) of its
    # partner.  In the mixed-precision mode the float64 positions take the
    # same path (the spot strip's are its float32 ones).
    with annotate(CONTACTS):
        if precise is not None:
            # the disc grid in float64, cast down: float32 rounding of
            # the element coordinates alone moves their contact phases by
            # ~1e-7 cycles, which flips elements across data phases
            f64 = torch.float64
            disc_pos64, disc_w64 = comp.disc_elements(
                rwd.to(f64), rdisc_x.to(f64) * precise[2], dexp.to(f64),
                config.n_disc_rad, config.n_disc_az)
            disc_pos, disc_w = disc_pos64.to(dtype), disc_w64.to(dtype)
        else:
            disc_pos64 = None
            disc_pos, disc_w = comp.disc_elements(
                rwd, rdisc, dexp, config.n_disc_rad, config.n_disc_az)
        spot_pos, spot_w = comp.spot_elements(
            q, rdisc, scale, az, exp1, exp2, config.n_spot,
            impact=geometry.spot_impact)
        normal = comp.spot_normal(az, tilt, yaw)
        n_rad, n_az = config.n_disc_rad, config.n_disc_az
        lead = disc_pos.shape[:-2]
        mirror = n_az % 2 == 0
        n_solve_disc = n_rad * n_az // 2 if mirror else disc_pos.shape[-2]

        def solved(disc, spot):
            if mirror:
                disc = disc.reshape(lead + (n_rad, n_az, 3))[
                    ..., :n_az // 2, :].reshape(lead + (n_solve_disc, 3))
            return torch.cat([disc, spot.expand(lead + spot.shape[-2:])],
                             dim=-2)

        all_pos = solved(disc_pos, spot_pos)
        all_pos64 = (None if disc_pos64 is None
                     else solved(disc_pos64, spot_pos.to(torch.float64)))
        intervals = comp.element_intervals(
            q, incl, all_pos, x1, pl1, precise=precise,
            positions64=all_pos64, r_ins=r_ins)
        if mirror:
            s_in, s_out, s_ecl = intervals
            half_az = n_az // 2
            di = s_in[..., :n_solve_disc].reshape(lead + (n_rad, half_az))
            do = s_out[..., :n_solve_disc].reshape(lead + (n_rad, half_az))
            de = s_ecl[..., :n_solve_disc].reshape(lead + (n_rad, half_az))
            disc_iv = (
                torch.cat([di, -torch.flip(do, dims=(-1,))], dim=-1)
                .reshape(lead + (-1,)),
                torch.cat([do, -torch.flip(di, dims=(-1,))], dim=-1)
                .reshape(lead + (-1,)),
                torch.cat([de, torch.flip(de, dims=(-1,))], dim=-1)
                .reshape(lead + (-1,)))
        else:
            disc_iv = tuple(a[..., :n_solve_disc] for a in intervals)
        spot_iv = tuple(a[..., n_solve_disc:] for a in intervals)
    disc_curve = comp.element_flux_curve(ph, w, disc_iv, disc_w)
    spot_curve = comp.element_flux_curve(ph, w, spot_iv, spot_w)
    ydisc = dF[..., None] * disc_curve
    e = earth_vector(ph, per_walker(incl))                   # (..., P, 3)
    nrm = normal[..., None, :]
    beam = torch.clamp(e[..., 0] * nrm[..., 0] + e[..., 1] * nrm[..., 1]
                       + e[..., 2] * nrm[..., 2], min=0.0)
    factor = per_walker(fis) + (1.0 - per_walker(fis)) * beam
    yspot = sF[..., None] * spot_curve * factor

    # ---- donor (smooth; never occulted), at the bin centre ---------------
    quad_ph = torch.full(ph.shape[:-1] + (1,), 0.25, dtype=dtype,
                         device=ph.device)
    if donor_curve is not None:
        raw_sec = comp.donor_curve_eval(donor_curve, ph)
        quad = comp.donor_curve_eval(donor_curve, quad_ph)
    else:
        raw_sec = comp.donor_flux(incl, ph, dgrid, config.ulimb_donor)
        quad = comp.donor_flux(incl, quad_ph, dgrid, config.ulimb_donor)
    ysec = rsF[..., None] * raw_sec / torch.clamp(quad, min=1e-30)

    total = ywd + ydisc + yspot + ysec
    return CVFluxes(total, ywd, ydisc, yspot, ysec)


def cv_total_flux(pars, phases, widths=None, config: CVConfig = CVConfig(),
                  geometry: CVGeometry | None = None, donor=None,
                  donor_curve=None):
    """Total model flux only (the likelihood hot path)."""
    return cv_fluxes(pars, phases, widths, config, geometry, donor,
                     donor_curve).total
