"""The four CV flux components, on batched tensors: the benchmark's
frozen copy of the PyTorch port's plain versions, which follow
``lfit_python_tpu/models/components.py``.  Per-walker
scalars are tensors of any leading shape ``(...)``; phase sweeps carry a
trailing phase axis ``(..., P)`` and element sets a trailing element axis
``(..., N)`` (positions ``(..., N, 3)``).  Every ``*_flux`` function returns
the normalised curve of one component, scaled by its flux parameter in
``models/cv.py``.

Everything is differentiable: the contact phases through
``contacts.element_intervals_diff``, the donor lobe radius through
its IFT tangent, and the white dwarf's edge fraction through an
``autograd.Function`` whose derivative stays finite at |x| = 1.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import contacts
from .stream import stream_impacts_diff
from .geometry import (
    _recording,
    _shadow_distance_plain,
    earth_vector,
    implicit_tangent,
    inscribed_radius,
    visible_fraction_interval,
)

__all__ = [
    "wd_flux",
    "disc_elements",
    "spot_elements",
    "spot_normal",
    "element_intervals",
    "element_flux_curve",
    "DonorGrid",
    "donor_grid",
    "donor_flux",
    "donor_curve_nodes",
    "donor_curve_eval",
]

# elements per chunk of the plain (rows, P, N) sweeps (_element_curve_plain,
# _donor_sum_plain): 2**25 f32 elements = 128 MiB per intermediate, so the
# north-star shapes (GBs if materialised whole) stay at a few hundred MiB
_CHUNK_ELEMS = 1 << 25


class _EdgeVisibleFraction(torch.autograd.Function):
    """The edge fraction with the reference's custom JVP: autograd of
    arccos at |a| = 1 gives inf * 0 = NaN, but the true derivative
    dV/da = -[2 (1-u) sqrt(1-a^2) + (pi/2) u (1-a^2)] / total is smooth
    and vanishes there."""

    @staticmethod
    def forward(ctx, x, ulimb):
        a = torch.clamp(-x, -1.0, 1.0)
        s2 = torch.clamp(1.0 - a * a, min=0.0)
        uni = torch.arccos(a) - a * torch.sqrt(s2)
        sq = 0.5 * math.pi * ((1.0 - a) - (1.0 - a ** 3) / 3.0)
        total = (1.0 - ulimb) * math.pi + ulimb * 2.0 * math.pi / 3.0
        val = ((1.0 - ulimb) * uni + ulimb * sq) / total
        ctx.save_for_backward(x, ulimb, val, s2, uni, sq, total)
        return val

    @staticmethod
    def backward(ctx, g):
        x, u, val, s2, uni, sq, total = ctx.saved_tensors
        dvda = -(2.0 * (1.0 - u) * torch.sqrt(s2)
                 + 0.5 * math.pi * u * s2) / total
        inside = (x > -1.0) & (x < 1.0)
        dvdx = torch.where(inside, -dvda, torch.zeros_like(dvda))
        dvdu = (sq - uni) / total + val * (math.pi / 3.0) / total
        return ((g * dvdx).sum_to_size(x.shape),
                (g * dvdu).sum_to_size(u.shape))


def _edge_visible_fraction(x, ulimb):
    """Visible flux fraction of a linearly limb-darkened disc cut by a
    straight shadow edge; ``x`` is the signed distance of the disc centre
    from the edge in disc radii (+1 fully visible, -1 fully occulted)."""
    return _EdgeVisibleFraction.apply(x, ulimb)


def wd_flux(q, incl_deg, phases, rwd, ulimb, xl1_val, phi_l1, r_ins=None,
            precise=None):
    """Normalised white-dwarf light curve (out of eclipse == 1): the
    smooth shadow distance of the WD centre, an inscribed-sphere guard for
    certain occultation, and the analytic edge fraction.  Broadcasts.

    ``precise``: optional (q, incl, xl1, pl1) solved in float64 (the
    mixed-precision mode): the shadow distance is refined in float64 and
    the edge fraction, ill-conditioned at |x| = 1, is finished in float64
    before the curve is cast to ``phases``' dtype.  Autograd
    differentiates through the Newton steps of :func:`_wd_curve_plain`."""
    if r_ins is None:
        r_ins = inscribed_radius(q, xl1_val, phi_l1)
    return _wd_curve_plain(q, incl_deg, phases, rwd, ulimb, xl1_val, phi_l1,
                           r_ins, precise=precise)


def _wd_curve_plain(q, incl_deg, phases, rwd, ulimb, xl1_val, phi_l1, r_ins,
                    precise=None):
    """:func:`wd_flux`'s chain in PyTorch operations: the shadow
    distance (:func:`~..roche.geometry._shadow_distance_plain`), the
    guard, the edge fraction."""
    d, clear = _shadow_distance_plain(q, incl_deg, phases, xl1_val, phi_l1,
                                      precise=precise)
    th = 2.0 * math.pi * phases
    si = torch.sin(torch.deg2rad(incl_deg))
    tstar = si * torch.cos(th)
    miss = torch.sqrt(torch.clamp(1.0 - tstar * tstar, min=0.0))
    certain_occ = (tstar > 0.0) & (miss < r_ins - rwd)
    if precise is not None:
        rwd, ulimb = rwd.to(d.dtype), ulimb.to(d.dtype)
    one = torch.ones_like(d)
    x = torch.where(clear > 0.25, one,
                    torch.where(certain_occ, -one,
                                torch.clamp(d / rwd, -1.0, 1.0)))
    frac = _edge_visible_fraction(x, ulimb)
    return frac if precise is None else frac.to(phases.dtype)


def disc_elements(rwd, rdisc, dexp, n_rad=24, n_az=40):
    """Tile the disc annulus [rwd, rdisc] into n_rad x n_az elements.

    ``rwd``, ``rdisc``, ``dexp``: (...).  Returns positions (..., N, 3) in
    the orbital plane and weights (..., N) summing to 1 (surface
    brightness ~ r^-dexp times the annulus area r dr dphi)."""
    dt, dev = rdisc.dtype, rdisc.device
    edges = torch.linspace(0.0, 1.0, n_rad + 1, dtype=dt, device=dev)
    mids = 0.5 * (edges[:-1] + edges[1:])
    span = (rdisc - rwd)[..., None]
    rmid = rwd[..., None] + span * mids                     # (..., n_rad)
    dr = (rdisc - rwd) / n_rad
    az = (torch.arange(n_az, dtype=dt, device=dev) + 0.5) * (
        2.0 * math.pi / n_az)
    r = torch.repeat_interleave(rmid, n_az, dim=-1)
    a = az.repeat(n_rad)
    pos = torch.stack([r * torch.cos(a), r * torch.sin(a),
                       torch.zeros_like(r)], dim=-1)
    w = torch.repeat_interleave(
        rmid ** (1.0 - dexp[..., None]) * dr[..., None], n_az, dim=-1)
    return pos, w / w.sum(dim=-1, keepdim=True)


def spot_elements(q, rdisc, scale, az_deg, exp1, exp2, n_elem=32,
                  max_extent=5.0, impact=None):
    """Bright-spot strip elements: from the stream / disc-rim impact point
    along the in-plane direction ``az_deg``, brightness
    (l/scale)^exp1 exp(-(l/scale)^exp2), l in (0, max_extent * scale].

    Per-walker arguments are (...); ``impact`` (..., 3) is the
    precomputed impact point (integrated from ``q`` and ``rdisc`` when
    None).  Returns positions (..., n, 3) and weights (..., n) summing to
    1."""
    if impact is None:
        lead = torch.broadcast_shapes(q.shape, rdisc.shape)
        impact = stream_impacts_diff(q.expand(lead).reshape(-1),
                                rdisc.expand(lead).reshape(-1, 1))
        impact = impact.reshape(lead + (3,))
    dt, dev = scale.dtype, scale.device
    azr = torch.deg2rad(az_deg)
    tdir = torch.stack([torch.cos(azr), torch.sin(azr),
                        torch.zeros_like(azr)], dim=-1)
    base = (torch.arange(n_elem, dtype=dt, device=dev) + 0.5) / n_elem
    ell = base * max_extent * scale[..., None]               # (..., n)
    pos = impact[..., None, :] + ell[..., None] * tdir[..., None, :]
    x = ell / scale[..., None]
    w = x ** exp1[..., None] * torch.exp(-(x ** exp2[..., None]))
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-300)
    return pos, w


def spot_normal(az_deg, tilt_deg, yaw_deg):
    """Outward emission normal (..., 3) of the beamed bright spot: the
    strip direction rotated -90 deg in the plane, turned by ``yaw`` and
    tipped by ``tilt`` out of the plane (tilt = 90: in the plane)."""
    azr = torch.deg2rad(az_deg)
    tr = torch.deg2rad(tilt_deg)
    yr = torch.deg2rad(yaw_deg)
    psi = azr - 0.5 * math.pi + yr
    return torch.stack([torch.sin(tr) * torch.cos(psi),
                        torch.sin(tr) * torch.sin(psi), torch.cos(tr)],
                       dim=-1)


def element_intervals(q, incl_deg, positions, xl1_val, phi_l1,
                      precise=None, positions64=None, r_ins=None):
    """Per-element eclipse intervals, one root-find per element.

    ``q``, ``incl_deg``, ``xl1_val``, ``phi_l1``: (...); ``positions``:
    (..., N, 3) orbital-plane points.  The leading axes are flattened into
    rows and solved in one call of ``contacts.element_intervals_diff``
    (IFT gradients in the backward).  ``precise`` is not supported here.
    ``r_ins``: the :func:`~.geometry.inscribed_radius` of (q, xl1, pl1),
    (...),
    solved here when None.  Returns (phi_in, phi_out, eclipsed), each
    (..., N)."""
    lead = positions.shape[:-2]
    n = positions.shape[-2]

    def rows(a):
        return a.expand(lead).reshape(-1)

    if r_ins is None:
        r_ins = inscribed_radius(q, xl1_val, phi_l1)
    px = positions[..., 0].reshape(-1, n).contiguous()
    py = positions[..., 1].reshape(-1, n).contiguous()
    args = (rows(q), rows(incl_deg), px, py, rows(xl1_val), rows(phi_l1),
            rows(r_ins))
    if precise is not None:
        raise ValueError("the reference has no mixed-precision solve")
    out = contacts.element_intervals_diff(*args)
    return tuple(o.reshape(lead + (n,)) for o in out)


def sum_last(x):
    """``x.sum(dim=-1)`` summed in one order whatever the number of
    outputs.  PyTorch's CUDA reduction over the last axis sizes its blocks
    by the number of outputs and splits the axis alike for every count of
    16 outputs or more; below that it may split it otherwise, and a row's
    float32 sum would then depend on the batch it came in.  So a sum with
    fewer than 16 outputs gets zero rows up to 16, which it drops."""
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    if n < 16:
        flat = torch.cat([flat, flat.new_zeros((16 - n, flat.shape[-1]))])
    return flat.sum(dim=-1)[:n].reshape(x.shape[:-1])


def _row_chunks(n_rows, per_row):
    step = max(1, _CHUNK_ELEMS // max(per_row, 1))
    for i in range(0, n_rows, step):
        yield slice(i, min(i + step, n_rows))


def _pad32(a, dim=-1, value=0):
    """``a`` padded along ``dim`` with ``value`` to a multiple of 32 (at
    least 32) entries: the sweeps' pad elements."""
    n = a.shape[dim]
    pad = max(32, -(-n // 32) * 32) - n
    if not pad:
        return a
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, a.new_full(shape, value)], dim=dim)


def _slab_sum(t):
    """``t`` summed over its last axis (a multiple of 32): 32 running sums,
    one a lane of the 32-wide slabs, each the first slab's term and then
    the next slab's added in order; then halved pairwise, entry j plus
    entry j + h for h = 16, 8, 4, 2, 1.  Every add is an elementwise op,
    so a row's sum does not depend on its batch."""
    t = t.unflatten(-1, (t.shape[-1] // 32, 32))
    acc = t[..., 0, :]
    for k in range(1, t.shape[-2]):
        acc = acc + t[..., k, :]
    h = 16
    while h:
        acc = acc[..., :h] + acc[..., h:]
        h //= 2
    return acc[..., 0]


def _element_curve_plain(ph, wd, pin, pout, ecl, w):
    """The element curve: ``ph`` (R, P), ``wd`` (R,
    P) or None, ``pin``, ``pout``, ``w`` (R, N) and ``ecl`` (R, N) bool;
    returns (R, P).  The (rows, P, N) visibility is made in chunks of rows
    to bound memory, and summed over N by :func:`_slab_sum` with N padded
    by elements that contribute an exact 0 (phi_in = phi_out = 0, not
    eclipsed, weight 0).  Differentiable by autograd."""
    P = ph.shape[-1]
    pin, pout, w = _pad32(pin), _pad32(pout), _pad32(w)
    ecl = _pad32(ecl, value=False)
    n = pin.shape[-1]
    out = []
    for s in _row_chunks(ph.shape[0], P * n):
        if wd is None:
            # instantaneous indicator: occulted iff mod(phase - phi_in, 1)
            # < dur (non-eclipsed elements have dur == 0)
            d = ph[s, :, None] - pin[s, None, :]
            rel = d - torch.floor(d)
            occ = rel < (pout[s] - pin[s])[:, None, :]
            vis = 1.0 - occ.to(ph.dtype)
        else:
            vis = visible_fraction_interval(
                ph[s, :, None], wd[s, :, None], pin[s, None, :],
                pout[s, None, :], ecl[s, None, :])
        out.append(_slab_sum(vis * w[s, None, :]))
    return torch.cat(out) if out else ph.new_zeros(ph.shape)


def element_flux_curve(phases, widths, intervals, weights):
    """Weighted visible-fraction light curve of an element set.

    ``phases`` (..., P), ``widths`` (..., P) or None, ``intervals`` from
    :func:`element_intervals` (each (..., N)), ``weights`` (..., N).
    Returns (..., P).  The leading axes are flattened into rows, each
    summed over N in one fixed order (:func:`_slab_sum`) by the chunked
    sweep :func:`_element_curve_plain`.  ``widths`` get no gradient."""
    phi_in, phi_out, ecl = intervals
    lead = torch.broadcast_shapes(phases.shape[:-1], weights.shape[:-1])
    P, N = phases.shape[-1], weights.shape[-1]
    dt = torch.promote_types(phases.dtype, weights.dtype)
    dt = torch.promote_types(dt, phi_in.dtype)

    def flat(a, last):
        return a.expand(lead + (last,)).reshape(-1, last).contiguous()

    ph, pin, pout = (flat(a.to(dt), m) for a, m in ((phases, P),
                                                     (phi_in, N),
                                                     (phi_out, N)))
    wd = None if widths is None else flat(widths.to(dt), P)
    out = _element_curve_plain(ph, wd, pin, pout, flat(ecl, N),
                               flat(weights.to(dt), N))
    return out.reshape(lead + (P,))


class DonorGrid(NamedTuple):
    positions: torch.Tensor   # (..., N, 3) element centres (binary frame)
    normals: torch.Tensor     # (..., N, 3) outward surface normals
    areas: torch.Tensor       # (..., N) element areas


# the donor grid's radius solve: float64 bisects to machine precision,
# float32 takes a few bisection steps, then safeguarded Newton steps, as
# the JAX package does
_DONOR_BISECT_F64 = 54
_DONOR_BISECT_F32 = 8
_DONOR_NEWTON_F32 = 4


@functools.lru_cache(maxsize=None)
def _directions(n_lat, n_lon, dtype, device):
    """The donor grid's directions (dx, dy, dz) from the donor centre on
    the off-pole (lat x lon) grid and their solid angles d_omega, each
    (n_lat * n_lon,): made once per grid, dtype and device and kept,
    outside any inference mode so that a graph may use them."""
    dt, dev = dtype, device
    with torch.inference_mode(False), torch.no_grad():
        th = (torch.arange(n_lat, dtype=dt, device=dev) + 0.5) / n_lat \
            * math.pi
        phl = (torch.arange(n_lon, dtype=dt, device=dev) + 0.5) / n_lon * (
            2.0 * math.pi)
        TH, PH = torch.meshgrid(th, phl, indexing="ij")
        dx = (torch.sin(TH) * torch.cos(PH)).reshape(-1)
        dy = (torch.sin(TH) * torch.sin(PH)).reshape(-1)
        dz = torch.cos(TH).reshape(-1)
        d_omega = ((math.pi / n_lat) * (2.0 * math.pi / n_lon)
                   * torch.sin(TH)).reshape(-1)
    return dx, dy, dz, d_omega


def _lobe_f(r, mu, pl1, dx, dy):
    """F(r) = Phi(c2 + r d) - Phi_L1 along the directions (dx, dy, dz)."""
    i1 = torch.rsqrt(1.0 + 2.0 * r * dx + r * r)
    cx = 1.0 + r * dx - mu
    cy = r * dy
    return (-(1.0 - mu) * i1 - mu / r - 0.5 * (cx * cx + cy * cy)) - pl1


def _lobe_fp(r, mu, dx, dy):
    """dF/dr."""
    i1 = torch.rsqrt(1.0 + 2.0 * r * dx + r * r)
    cx = 1.0 + r * dx - mu
    cy = r * dy
    return ((1.0 - mu) * (r + dx) * i1 * i1 * i1 + mu / (r * r)
            - (cx * dx + cy * dy))


def _donor_radius_loop(q, xl1_val, phi_l1, dx, dy, dz):
    """The lobe radius along each direction (dx, dy, dz) (N,) of the
    walkers' q, xl1, phi_l1 (...), and the slope dF/dr there: (r, slope),
    each (..., N), without a graph.  Bisection of F over (1e-6 rmax,
    rmax], rmax = 1 - xl1, then (float32) safeguarded Newton steps: a
    proposal outside the bracket by the strict tests takes its midpoint.
    """
    f64 = q.dtype == torch.float64
    n_bisect = _DONOR_BISECT_F64 if f64 else _DONOR_BISECT_F32
    n_newton = 0 if f64 else _DONOR_NEWTON_F32
    with torch.no_grad():
        mu = (q.detach() / (1.0 + q.detach()))[..., None]
        pl1 = phi_l1.detach()[..., None]
        rmax = (1.0 - xl1_val.detach())[..., None]
        shape = rmax.shape[:-1] + dx.shape
        lo = (torch.full_like(dx, 1e-6) * rmax).expand(shape)
        hi = rmax.expand(shape)
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            inside = _lobe_f(mid, mu, pl1, dx, dy) < 0.0
            lo = torch.where(inside, mid, lo)
            hi = torch.where(inside, hi, mid)
        r = 0.5 * (lo + hi)
        for _ in range(n_newton):
            fr = _lobe_f(r, mu, pl1, dx, dy)
            inside = fr < 0.0
            lo = torch.where(inside, r, lo)
            hi = torch.where(inside, hi, r)
            rn = r - fr / torch.clamp(_lobe_fp(r, mu, dx, dy), min=1e-12)
            bad = (rn < lo) | (rn > hi)
            r = torch.where(bad, 0.5 * (lo + hi), rn)
        return r, _lobe_fp(r, mu, dx, dy)


def _donor_grid_plain(r, mu, dx, dy, dz, d_omega):
    """The grid's elements at the radii ``r`` (..., N): positions c2 + r
    d, outward normals grad(Phi)/|grad(Phi)| and areas r^2 dOmega /
    (d . n), ``mu`` (..., 1)."""
    px = 1.0 + r * dx
    py = r * dy
    pz = r * dz
    i1 = torch.rsqrt(px * px + py * py + pz * pz)
    i2 = 1.0 / r
    i13 = i1 * i1 * i1
    i23 = i2 * i2 * i2
    gx = (1.0 - mu) * px * i13 + mu * (px - 1.0) * i23 - (px - mu)
    gy = py * ((1.0 - mu) * i13 + mu * i23 - 1.0)
    gz = pz * ((1.0 - mu) * i13 + mu * i23)
    gn = torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz), min=1e-12)
    nx, ny, nz = gx / gn, gy / gn, gz / gn
    mu_dn = torch.clamp(dx * nx + dy * ny + dz * nz, min=1e-3)
    areas = r * r * d_omega / mu_dn
    return DonorGrid(torch.stack([px, py, pz], dim=-1),
                     torch.stack([nx, ny, nz], dim=-1), areas)


def donor_grid(q, xl1_val, phi_l1, n_lat=16, n_lon=24):
    """Tile the Roche-lobe-filling donor surface: directions from the
    donor centre on an off-pole (lat x lon) grid, the lobe radius along
    each (Phi = Phi_L1), outward normals grad(Phi)/|grad(Phi)| and areas
    r^2 dOmega / (d . n).  ``q``, ``xl1_val``, ``phi_l1``: (...); returns a
    :class:`DonorGrid` of (..., n_lat * n_lon) elements.

    float64 bisects the radius to machine precision (54 steps); float32
    takes 8 bisection steps and 4 safeguarded Newton steps, as the JAX
    package does.  Either solve runs without a graph; the radius gets the
    IFT tangent of F(r) = Phi(c2 + r d) - Phi_L1."""
    dx, dy, dz, d_omega = _directions(n_lat, n_lon, q.dtype, q.device)
    recording = _recording(q, phi_l1)
    r, slope = _donor_radius_loop(q, xl1_val, phi_l1, dx, dy, dz)
    mu = (q / (1.0 + q))[..., None]
    if recording:
        r = implicit_tangent(r, _lobe_f(r, mu, phi_l1[..., None], dx, dy),
                             slope)
    return _donor_grid_plain(r, mu, dx, dy, dz, d_omega)


def _donor_sum_plain(e, normals, areas, ulimb_donor):
    """The donor sum: ``e`` (R, P, 3) unit
    vectors to the observer, ``normals`` (G, N, 3) and ``areas`` (G, N) of
    G grids, each shared by R / G consecutive rows; returns (R, P): per
    element area * mu * I(mu), mu = max(n . e, 0), summed over N by
    :func:`_slab_sum` with N padded by elements of zero normal and area.
    Made in chunks of grids to bound memory.  Differentiable by
    autograd."""
    R, P = e.shape[:2]
    G = areas.shape[0]
    nrm, areas = _pad32(normals, dim=-2), _pad32(areas)
    n = areas.shape[-1]
    e = e.reshape(G, R // G if G else 0, P, 3)
    out = []
    for s in _row_chunks(G, e.shape[1] * P * n):
        es, ns = e[s][:, :, :, None, :], nrm[s][:, None, None, :, :]
        mu = (es[..., 0] * ns[..., 0] + es[..., 1] * ns[..., 1]
              + es[..., 2] * ns[..., 2])
        mu = torch.clamp(mu, min=0.0)
        w = mu * (1.0 - ulimb_donor) + ulimb_donor * mu * mu
        out.append(_slab_sum(w * areas[s][:, None, None, :]))
    if not out:
        return e.new_zeros((R, P))
    return torch.cat(out).reshape(R, P)


def _rows_per_grid(grid_lead, lead):
    """E where the grid's leading shape ``grid_lead``, broadcast to
    ``lead``, gives row r (of ``lead`` flattened) grid r // E of its own
    flattened: its axes are ``lead``'s first ones and 1 after; else
    None."""
    g = (1,) * (len(lead) - len(grid_lead)) + tuple(grid_lead)
    j = len(lead)
    while j and g[j - 1] == 1:
        j -= 1
    if g[:j] != tuple(lead[:j]):
        return None
    return math.prod(lead[j:])


def donor_flux(incl_deg, phases, grid: DonorGrid, ulimb_donor=0.9):
    """Donor light curve, unnormalised: per element area * mu * I(mu) for
    mu = n . e(phase) > 0 (Lambertian + linear limb darkening).

    ``incl_deg`` (...), ``phases`` (..., P), ``grid`` of (..., N)
    elements; returns (..., P).  The leading axes are flattened into rows;
    a grid shared by consecutive rows (a walker's eclipses) is taken once,
    by index, not copied to each (:func:`_donor_sum_plain`)."""
    e = earth_vector(phases, incl_deg[..., None])             # (..., P, 3)
    glead = grid.areas.shape[:-1]
    lead = torch.broadcast_shapes(e.shape[:-2], glead)
    P, N = e.shape[-2], grid.areas.shape[-1]
    e = e.expand(lead + (P, 3)).reshape(-1, P, 3).contiguous()
    nrm = grid.normals.expand(glead + (N, 3))
    areas = grid.areas
    if _rows_per_grid(glead, lead) is None:
        nrm = nrm.expand(lead + (N, 3))
        areas = areas.expand(lead + (N,))
    nrm = nrm.reshape(-1, N, 3).contiguous()
    areas = areas.reshape(-1, N).contiguous()
    out = _donor_sum_plain(e, nrm.to(e.dtype), areas.to(e.dtype),
                           ulimb_donor)
    return out.reshape(lead + (P,))


def donor_curve_nodes(incl_deg, grid: DonorGrid, ulimb_donor=0.9,
                      n_quad=128):
    """The donor curve on ``n_quad + 1`` uniform nodes over the half
    period [0, 0.5]: :func:`donor_flux` at phases j / (2 n_quad).  The
    curve is even and periodic in phase and depends only on core-node
    quantities (the inclination, the donor grid), so the posterior sums
    the donor elements once per walker on these nodes and every eclipse
    interpolates (:func:`donor_curve_eval`).  ``incl_deg`` (...), ``grid``
    of (..., N) elements; returns (..., n_quad + 1)."""
    th = torch.linspace(0.0, 0.5, n_quad + 1, dtype=grid.positions.dtype,
                        device=grid.positions.device)
    return donor_flux(incl_deg, th, grid, ulimb_donor)


def donor_curve_eval(nodes, phases):
    """The quadrature donor curve at ``phases``: Catmull-Rom cubic
    interpolation on the uniform [0, 0.5] nodes, with the even-reflection
    ghosts (node -1 is node 1, node n + 1 is node n - 1: F'(0) = F'(0.5)
    = 0 by the curve's symmetry), so it is C^1 in the phase.

    ``nodes`` (L..., n + 1) and ``phases`` (L..., M..., P): the nodes'
    leading axes are the phases' first ones, e.g. per-walker nodes
    (W, n + 1) with phases (W, E, P) or (W, P).  The four taps are read
    by ``torch.gather`` on the node axis, so gradients reach the node
    values through the gather and the phase through the tap weights.
    Returns ``phases``' shape.

    The curve has a derivative kink at each element's terminator
    crossing, so the error falls ~h^1.5, not h^4: ~1e-5 of the donor flux
    at n = 256 (tests/test_torch_donor_quad.py)."""
    n = nodes.shape[-1] - 1
    lead = nodes.shape[:-1]
    if phases.shape[:len(lead)] != lead:
        raise ValueError(f"phases {tuple(phases.shape)} do not start with "
                         f"the nodes' leading axes {tuple(lead)}")
    k = nodes[..., 0].numel()
    flat = phases.reshape(k, -1)
    # fold to [0, 0.5]: periodic and even
    x = torch.abs(torch.remainder(flat + 0.5, 1.0) - 0.5) * (2.0 * n)
    j = torch.clamp(torch.floor(x), 0.0, n - 1.0)
    s = x - j
    s2 = s * s
    s3 = s2 * s
    jl = j.long()
    taps = torch.stack([(jl - 1).abs(), jl, jl + 1,
                        n - (n - (jl + 2)).abs()], dim=-1)
    g = torch.gather(nodes.reshape(k, n + 1), 1,
                     taps.reshape(k, -1)).reshape(taps.shape)
    out = (0.5 * (-s + 2.0 * s2 - s3) * g[..., 0]
           + 0.5 * (2.0 - 5.0 * s2 + 3.0 * s3) * g[..., 1]
           + 0.5 * (s + 4.0 * s2 - 3.0 * s3) * g[..., 2]
           + 0.5 * (-s2 + s3) * g[..., 3])
    return out.reshape(phases.shape)
