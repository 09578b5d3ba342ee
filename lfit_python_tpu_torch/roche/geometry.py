"""Roche-lobe geometry core, on tensors.

Port of ``lfit_python_tpu/roche/geometry.py``.  Every routine is
elementwise: scalar arguments may be tensors of any broadcastable shape —
``(W,)`` per-walker solves, ``(W, E, P)`` phase sweeps — so the JAX
package's ``vmap``s become broadcasting.  The fixed iteration counts are
the reference's, so f64 results agree with it to rounding.

Gradients: every fixed-iteration root solve runs its iterations under
``torch.no_grad()`` on detached inputs and then attaches the
implicit-function-theorem tangent with :func:`implicit_tangent` (only
when a gradient is being recorded).  Differentiating through the
iterations instead would record them all, and through the bracket ends
(``lobe_radius``'s depends on ``xl1``) it gives a wrong gradient.

Conventions (dimensionless binary units): separation a = 1, G(M1+M2) = 1,
w = 1; the white dwarf at the origin, the donor at (1, 0, 0); q = M2/M1;
orbital phase 0 is mid-eclipse; the observer direction at inclination i is
e(phi) = (sin i cos 2 pi phi, -sin i sin 2 pi phi, cos i).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "implicit_tangent",
    "roche_potential",
    "xl1",
    "l1_potential",
    "earth_vector",
    "ray_clearance",
    "findi",
    "origin_shadow_distance",
    "inscribed_radius",
    "lobe_radius",
    "contact_interval",
    "visible_fraction_interval",
]

_XL1_ITERS = 64          # bisection for the L1 point
_CLEAR_GRID = 16         # coarse scan points along the occultation ray
_CLEAR_NEWTON = 8        # Newton polish iterations for the ray minimum
_FINDI_ITERS = 54        # bisection for inclination
_LOBE_ITERS = 54         # bisection for lobe surface radius
_CLEAR_VISIBLE = 10.0    # clearance reported for rays missing the donor

# contact solver budgets, in lockstep with the reference solver and with
# the CUDA kernel (ops/csrc/contacts.cu): 8 safeguarded envelope-Newton
# iterations per edge, 3 clamped Newton steps for the conjunction
# test's ray minimum, 1 warm polish step per edge iteration
_EDGE_ITERS = 8
_EDGE_T_NEWTON = 3
_EDGE_T_WARM = 1
# the mixed-precision split (``precise``): the first _EDGE_ITERS_F32
# iterations run in the working dtype, the last _EDGE_ITERS_F64 in phase,
# carried in float64, with c = Phi - Phi_L1 evaluated in float64
_EDGE_ITERS_F32 = 5
_EDGE_ITERS_F64 = 4


def _recording(*ts):
    """True when autograd records a graph through any of ``ts``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _on_card(t):
    """True where the tensor ``t`` lies off the CPU: there the donor grid
    and the white dwarf's sweep take the kernels of ``ops.wd_donor``."""
    return t.device.type != "cpu"


def _wd_kernel_route(precise, args):
    """True where a white-dwarf sweep on ``args`` takes the kernel K10:
    its first tensor off the CPU, with no graph recorded through ``args``
    and no ``precise`` refinement (which stays in PyTorch).  A Python
    number among ``args`` then reaches K10's wrapper, which raises."""
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    return (precise is None and first is not None and _on_card(first)
            and not _recording(*args))


def implicit_tangent(x, residual, slope):
    """Attach the implicit-function-theorem tangent to a solved root with
    exactly zero primal change.

    For a root x* of F(x, theta) = 0, dx*/dtheta = -F_theta / F_x.
    ``residual`` is F(x*.detach(), theta) evaluated with theta attached,
    ``slope`` F_x at the root (its value only).  Returns
    ``x.detach() + (d - d.detach())`` with d = -residual / slope: the
    primal value is x's, the gradient the IFT one.  Where d is not finite
    (an infeasible walker, a zero slope) the tangent is zero, and the
    division is guarded so no NaN reaches ``residual``'s graph."""
    slope = slope.detach()
    ok = torch.isfinite(residual.detach() / slope)
    d = torch.where(ok, -residual / torch.where(ok, slope, 1.0),
                    torch.zeros_like(residual))
    return x.detach() + (d - d.detach())


def roche_potential(q, r):
    """Synchronous Roche potential at positions ``r`` (..., 3):
    Phi = -(1-mu)/r1 - mu/r2 - 0.5((x-mu)^2 + y^2),  mu = q/(1+q)."""
    mu = q / (1.0 + q)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    r1 = torch.sqrt(x * x + y * y + z * z)
    dx = x - 1.0
    r2 = torch.sqrt(dx * dx + y * y + z * z)
    return -(1.0 - mu) / r1 - mu / r2 - 0.5 * ((x - mu) ** 2 + y * y)


def _potential_on_axis_dx(q, x):
    """d(Phi)/dx on the line of centres for 0 < x < 1."""
    mu = q / (1.0 + q)
    return (1.0 - mu) / (x * x) - mu / ((1.0 - x) ** 2) - (x - mu)


def _solve(loop, kernel, *args):
    """``loop(*args)`` on CPU tensors; on CUDA tensors one launch of the
    ``ops.roche`` kernel ``kernel`` on the arguments broadcast to one
    contiguous shape.  The wrapper is looked up at each call (imported
    here: ``ops`` imports this module), so it can be patched."""
    if args[0].device.type == "cpu":
        return loop(*args)
    from ..ops import roche

    shape = torch.broadcast_shapes(*(a.shape for a in args))
    return getattr(roche, kernel)(*(a.expand(shape).contiguous()
                                    for a in args))


def _xl1_loop(q):
    """:func:`xl1`'s bisection of dPhi/dx over (1e-6, 1 - 1e-6): the plain
    version of K5 (``ops/csrc/roche.cu``)."""
    lo = torch.full_like(q, 1e-6)
    hi = torch.full_like(q, 1.0 - 1e-6)
    for _ in range(_XL1_ITERS):
        mid = 0.5 * (lo + hi)
        pos = _potential_on_axis_dx(q, mid) > 0.0
        lo = torch.where(pos, mid, lo)
        hi = torch.where(pos, hi, mid)
    return 0.5 * (lo + hi)


def xl1(q):
    """Distance of the inner Lagrangian point L1 from the primary
    (fixed-iteration bisection of dPhi/dx on (0, 1); K5 on CUDA tensors),
    with the IFT tangent of F = dPhi/dx on the axis."""
    recording = _recording(q)
    with torch.no_grad():
        qd = q.detach()
        x = _solve(_xl1_loop, "xl1_kernel", qd)
        if not recording:
            return x
        mu = qd / (1.0 + qd)
        slope = (-2.0 * (1.0 - mu) / x ** 3 - 2.0 * mu / (1.0 - x) ** 3
                 - 1.0)
    return implicit_tangent(x, _potential_on_axis_dx(q, x), slope)


def l1_potential(q, xl1_val=None):
    """Roche potential at the L1 point (the lobe-surface equipotential)."""
    if xl1_val is None:
        xl1_val = xl1(q)
    zero = torch.zeros_like(xl1_val)
    return roche_potential(q, torch.stack([xl1_val, zero, zero], dim=-1))


def earth_vector(phase, incl_deg):
    """Unit vector towards the observer at orbital ``phase`` (cycles) and
    inclination ``incl_deg``; shape broadcast(phase, incl) + (3,)."""
    i = torch.deg2rad(incl_deg)
    ph = 2.0 * math.pi * phase
    si = torch.sin(i)
    return torch.stack(torch.broadcast_tensors(
        si * torch.cos(ph), -si * torch.sin(ph),
        torch.cos(i) * torch.ones_like(ph)), dim=-1)


def ray_clearance(q, p, e, xl1_val, phi_l1, with_grad=False):
    """Minimum of (Phi - Phi_L1) along the sight-line from ``p`` towards
    ``e`` (both (..., 3)), restricted to the chord of the sphere of radius
    1 - xl1 around the donor.  Negative <=> occulted.  The slice uses the
    contact solver instead; this grid-scan + Newton form is its oracle.
    With ``with_grad`` also returns grad(Phi) (..., 3) at the minimising
    point, the clearance's gradient in ``p`` by the envelope theorem."""
    rad = 1.0 - xl1_val
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    wx, wy, wz = 1.0 - px, -py, -pz
    tstar = wx * ex + wy * ey + wz * ez
    d2 = (wx * wx + wy * wy + wz * wz) - tstar * tstar
    disc = rad * rad - d2
    half = torch.sqrt(torch.clamp(disc, min=1e-30))
    t_lo = torch.clamp(tstar - half, min=0.0)
    t_hi = torch.clamp(tstar + half, min=0.0)
    no_occ = (disc <= 0.0) | (tstar + half <= 1e-9)

    mu = q / (1.0 + q)
    b1 = px * ex + py * ey + pz * ez
    c1 = px * px + py * py + pz * pz
    b2 = -tstar                                 # (p - c2) . e
    c2n = wx * wx + wy * wy + wz * wz
    ax = px - mu
    ee2 = ex * ex + ey * ey

    def g_val(t, b1, b2, c1, c2n, ax, ay, ex, ey, mu):
        r1 = torch.sqrt(t * t + 2.0 * b1 * t + c1)
        r2 = torch.sqrt(t * t + 2.0 * b2 * t + c2n)
        cx = ax + t * ex
        cy = ay + t * ey
        return -(1.0 - mu) / r1 - mu / r2 - 0.5 * (cx * cx + cy * cy)

    terms = torch.broadcast_tensors(b1, b2, c1, c2n, ax, py, ex, ey, mu)
    # coarse grid scan along the chord
    frac = torch.linspace(0.0, 1.0, _CLEAR_GRID, dtype=p.dtype,
                          device=p.device)
    ts = t_lo[..., None] + (t_hi - t_lo)[..., None] * frac
    vals = g_val(ts, *(a[..., None] for a in terms))
    k = torch.argmin(vals, dim=-1, keepdim=True)
    t0 = torch.gather(ts, -1, k)[..., 0]
    h = (t_hi - t_lo) / (_CLEAR_GRID - 1)
    lo = torch.maximum(t0 - h, t_lo)
    hi = torch.minimum(t0 + h, t_hi)

    t = t0
    for _ in range(_CLEAR_NEWTON):
        i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
        i2 = torch.rsqrt(t * t + 2.0 * b2 * t + c2n)
        u1, u2 = t + b1, t + b2
        i13, i23 = i1 * i1 * i1, i2 * i2 * i2
        cx = ax + t * ex
        cy = py + t * ey
        g1 = (1.0 - mu) * u1 * i13 + mu * u2 * i23 - (cx * ex + cy * ey)
        g2 = ((1.0 - mu) * (i13 - 3.0 * u1 * u1 * i13 * i1 * i1)
              + mu * (i23 - 3.0 * u2 * u2 * i23 * i2 * i2) - ee2)
        step = torch.where(g2 > 1e-12, g1 / torch.clamp(g2, min=1e-12),
                           torch.zeros_like(g2))
        t = torch.minimum(torch.maximum(t - step, lo), hi)
    val = g_val(t, b1, b2, c1, c2n, ax, py, ex, ey, mu)
    clear = torch.where(no_occ, torch.full_like(val, _CLEAR_VISIBLE),
                        val - phi_l1)
    if not with_grad:
        return clear
    r = p + t[..., None] * e
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    i13 = torch.rsqrt(x * x + y * y + z * z) ** 3
    i23 = torch.rsqrt((x - 1.0) ** 2 + y * y + z * z) ** 3
    grad = torch.stack([(1.0 - mu) * x * i13 + mu * (x - 1.0) * i23
                        - (x - mu),
                        y * ((1.0 - mu) * i13 + mu * i23 - 1.0),
                        z * ((1.0 - mu) * i13 + mu * i23)], dim=-1)
    return clear, grad


def _origin_clearance(q, incl_deg, phases, xl1_val, phi_l1):
    """Clearance of the ray from the origin (the WD centre) at ``phases``;
    returns (clear, t_min, mu, ex, ey, ci, t_lo, t_hi, no_occ).
    Componentwise specialisation of :func:`ray_clearance` at p = 0
    (r1 = t)."""
    mu = q / (1.0 + q)
    i_rad = torch.deg2rad(incl_deg)
    si, ci = torch.sin(i_rad), torch.cos(i_rad)
    rad = 1.0 - xl1_val
    th = 2.0 * math.pi * phases
    ex = si * torch.cos(th)
    ey = -si * torch.sin(th)

    tstar = ex
    disc = rad * rad - (1.0 - tstar * tstar)
    half = torch.sqrt(torch.clamp(disc, min=1e-30))
    t_lo = torch.clamp(tstar - half, min=1e-6)
    t_hi = torch.clamp(tstar + half, min=1e-6)
    no_occ = (disc <= 0.0) | (tstar + half <= 1e-9)

    def g_val(t):
        i2 = torch.rsqrt(t * t - 2.0 * ex * t + 1.0)
        cx = t * ex - mu
        cy = t * ey
        return -(1.0 - mu) / t - mu * i2 - 0.5 * (cx * cx + cy * cy)

    ee2 = ex * ex + ey * ey
    t = torch.minimum(torch.maximum(tstar, t_lo), t_hi)
    for _ in range(4):
        i2 = torch.rsqrt(t * t - 2.0 * ex * t + 1.0)
        u2 = t - ex
        i23 = i2 * i2 * i2
        cx = t * ex - mu
        cy = t * ey
        g1 = (1.0 - mu) / (t * t) + mu * u2 * i23 - (cx * ex + cy * ey)
        g2 = (-2.0 * (1.0 - mu) / (t * t * t)
              + mu * (i23 - 3.0 * u2 * u2 * i23 * i2 * i2) - ee2)
        step = torch.where(g2 > 1e-12, g1 / torch.clamp(g2, min=1e-12),
                           torch.zeros_like(g2))
        t = torch.minimum(torch.maximum(t - step, t_lo), t_hi)
    val = g_val(t)
    v_lo = g_val(t_lo)
    v_hi = g_val(t_hi)
    t = torch.where(v_lo < val, t_lo, t)
    val = torch.minimum(val, v_lo)
    t = torch.where(v_hi < val, t_hi, t)
    val = torch.minimum(val, v_hi)
    clear = torch.where(no_occ, torch.full_like(val, _CLEAR_VISIBLE),
                        val - phi_l1)
    return clear, t, mu, ex, ey, ci, t_lo, t_hi, no_occ


def origin_shadow_distance(q, incl_deg, phases, xl1_val, phi_l1,
                           precise=None):
    """Signed sky-plane distance of the WD centre from the donor's shadow
    terminator at ``phases`` (positive = visible), and the clearance.
    Returns (distance, clearance), both broadcast(q, incl, phases).

    ``precise``: optional (q, incl, xl1, pl1) solved in float64 (the
    mixed-precision mode): the ray minimum t of the working-dtype solve
    takes two float64 Newton steps, and the clearance and the gradient
    are evaluated once in float64 there; both are then returned in
    float64 (``components.wd_flux`` finishes the edge fraction in
    float64).

    Tensors off the CPU, with no graph recorded through them and no
    ``precise``, take one launch of ``ops.wd_donor.wd_distance_kernel``
    (the kernel K10's distance mode on the card); otherwise
    :func:`_shadow_distance_plain` runs."""
    args = (q, incl_deg, phases, xl1_val, phi_l1)
    if _wd_kernel_route(precise, args):
        from ..ops import wd_donor

        return wd_donor.wd_distance_kernel(*args)
    return _shadow_distance_plain(*args, precise=precise)


def _shadow_distance_plain(q, incl_deg, phases, xl1_val, phi_l1,
                           precise=None):
    """:func:`origin_shadow_distance` in PyTorch operations: the plain
    version of the kernel K10's distance mode (``ops/csrc/wd_donor.cu``),
    and with ``precise`` its float64 refinement."""
    clear, t, mu, ex, ey, ci, t_lo, t_hi, no_occ = _origin_clearance(
        q, incl_deg, phases, xl1_val, phi_l1)
    if precise is not None:
        f64 = torch.float64
        q64, incl64, _, pl164 = (a.to(f64) for a in precise)
        mu = q64 / (1.0 + q64)
        i64 = torch.deg2rad(incl64)
        si, ci = torch.sin(i64), torch.cos(i64)
        th = 2.0 * math.pi * phases.to(f64)
        ex, ey = si * torch.cos(th), -si * torch.sin(th)
        t, t_lo, t_hi = t.to(f64), t_lo.to(f64), t_hi.to(f64)
        ee2 = ex * ex + ey * ey
        for _ in range(2):
            i2 = torch.rsqrt(t * t - 2.0 * ex * t + 1.0)
            u2 = t - ex
            i23 = i2 * i2 * i2
            cx = t * ex - mu
            cy = t * ey
            g1 = (1.0 - mu) / (t * t) + mu * u2 * i23 - (cx * ex + cy * ey)
            g2 = (-2.0 * (1.0 - mu) / (t * t * t)
                  + mu * (i23 - 3.0 * u2 * u2 * i23 * i2 * i2) - ee2)
            step = torch.where(g2 > 1e-14, g1 / torch.clamp(g2, min=1e-14),
                               torch.zeros_like(g2))
            t = torch.minimum(torch.maximum(t - step, t_lo), t_hi)
        i2 = torch.rsqrt(t * t - 2.0 * ex * t + 1.0)
        cx = t * ex - mu
        cy = t * ey
        val = -(1.0 - mu) / t - mu * i2 - 0.5 * (cx * cx + cy * cy)
        clear = torch.where(no_occ, torch.full_like(val, _CLEAR_VISIBLE),
                            val - pl164)
    # grad(Phi) at the minimising point, perpendicular to the line of sight
    rx, ry, rz = t * ex, t * ey, t * ci
    i1 = torch.rsqrt(rx * rx + ry * ry + rz * rz)
    dx = rx - 1.0
    i2 = torch.rsqrt(dx * dx + ry * ry + rz * rz)
    i13, i23 = i1 * i1 * i1, i2 * i2 * i2
    gx = (1.0 - mu) * rx * i13 + mu * dx * i23 - (rx - mu)
    gy = ry * ((1.0 - mu) * i13 + mu * i23 - 1.0)
    gz = rz * ((1.0 - mu) * i13 + mu * i23)
    gdote = gx * ex + gy * ey + gz * ci
    px_, py_, pz_ = gx - gdote * ex, gy - gdote * ey, gz - gdote * ci
    g_norm = torch.sqrt(
        torch.clamp(px_ * px_ + py_ * py_ + pz_ * pz_, min=1e-24))
    return clear / g_norm, clear


def _clear_at(i_deg, q, half_w, x1, pl1):
    return _origin_clearance(q, i_deg, half_w, x1, pl1)[0]


def _findi_loop(q, half_w, x1, pl1):
    """:func:`findi`'s bisection of the origin clearance at phase
    ``half_w`` over i in (1, 90), NaN where the clearance at i = 90 is
    not <= 0: the plain version of K4 (``ops/csrc/roche.cu``)."""
    shape = torch.broadcast_shapes(q.shape, half_w.shape, x1.shape)
    lo = torch.full(shape, 1.0, dtype=q.dtype, device=q.device)
    hi = torch.full(shape, 90.0, dtype=q.dtype, device=q.device)
    for _ in range(_FINDI_ITERS):
        mid = 0.5 * (lo + hi)
        vis = _clear_at(mid, q, half_w, x1, pl1) > 0.0  # not eclipsed
        lo = torch.where(vis, mid, lo)
        hi = torch.where(vis, hi, mid)
    i_sol = 0.5 * (lo + hi)
    feasible = _clear_at(torch.full_like(lo, 90.0), q, half_w, x1,
                         pl1) <= 0.0
    return torch.where(feasible, i_sol, torch.full_like(i_sol, math.nan))


def findi(q, dphi, xl1_val=None, phi_l1=None):
    """Inclination (deg) at which the WD centre's eclipse has full phase
    width ``dphi``: bisection of the origin clearance at phase dphi/2 over
    i in (1, 90) (K4 on CUDA tensors).  NaN where even i = 90 gives no
    eclipse that wide.

    The IFT tangent takes the clearance's slope in i from autograd of a
    detached evaluation at the root (the reference's ``jax.grad`` of the
    same function), so the nested derivative never enters the graph."""
    if xl1_val is None:
        xl1_val = xl1(q)
    if phi_l1 is None:
        phi_l1 = l1_potential(q, xl1_val)
    args = (q, 0.5 * dphi, xl1_val, phi_l1)
    fixed = tuple(a.detach() for a in args)
    with torch.no_grad():
        i_sol = _solve(_findi_loop, "findi_kernel", *fixed)
    if not _recording(*args):
        return i_sol
    # the bisection's solution is never NaN, so NaN marks the infeasible;
    # they take the tangent at i = 90, which the final select drops
    feasible = ~torch.isnan(i_sol)
    i_sol = torch.where(feasible, i_sol, torch.full_like(i_sol, 90.0))
    with torch.enable_grad():
        i0 = i_sol.clone().requires_grad_()
        slope, = torch.autograd.grad(_clear_at(i0, *fixed).sum(), i0)
    i_sol = implicit_tangent(i_sol, _clear_at(i_sol, *args), slope)
    return torch.where(feasible, i_sol, torch.full_like(i_sol, math.nan))


def _lobe_at(r, dx, dy, dz):
    return torch.stack([1.0 + r * dx, r * dy, r * dz], dim=-1)


def _lobe_loop(q, x1, pl1, dx, dy, dz):
    """:func:`lobe_radius`'s bisection of Phi(c2 + r d) - pl1 over
    (1e-6 (1 - x1), 1 - x1] along d = (dx, dy, dz): the plain version of
    K6 (``ops/csrc/roche.cu``)."""
    rmax = 1.0 - x1
    lo, hi = torch.broadcast_tensors(1e-6 * rmax, rmax, dx)[:2]
    for _ in range(_LOBE_ITERS):
        mid = 0.5 * (lo + hi)
        inside = roche_potential(q, _lobe_at(mid, dx, dy, dz)) - pl1 < 0.0
        lo = torch.where(inside, mid, lo)
        hi = torch.where(inside, hi, mid)
    return 0.5 * (lo + hi)


def lobe_radius(q, direction, xl1_val=None, phi_l1=None):
    """Roche-lobe surface radius from the donor centre along the unit
    ``direction`` (..., 3): bisection of Phi(c2 + r d) = Phi_L1 on
    (0, 1 - xl1], with the IFT tangent (F_r = grad(Phi) . d).  The
    bracket's dependence on xl1 carries no gradient."""
    return _lobe_radius(q, direction[..., 0], direction[..., 1],
                        direction[..., 2], xl1_val, phi_l1)


def _lobe_radius(q, dx, dy, dz, xl1_val=None, phi_l1=None):
    """:func:`lobe_radius` along the direction's components (dx, dy,
    dz), each broadcasting with ``q``."""
    if xl1_val is None:
        xl1_val = xl1(q)
    if phi_l1 is None:
        phi_l1 = l1_potential(q, xl1_val)
    recording = _recording(q, phi_l1)
    with torch.no_grad():
        qd, pl1 = q.detach(), phi_l1.detach()
        r = _solve(_lobe_loop, "lobe_radius_kernel", qd, xl1_val.detach(),
                   pl1, dx.detach(), dy.detach(), dz.detach())
        if not recording:
            return r
        # grad(Phi) . d at the root, in closed form
        mu = qd / (1.0 + qd)
        x, y, z = 1.0 + r * dx, r * dy, r * dz
        i1 = torch.rsqrt(x * x + y * y + z * z)
        i2 = torch.rsqrt((x - 1.0) ** 2 + y * y + z * z)
        i13, i23 = i1 ** 3, i2 ** 3
        gx = (1.0 - mu) * x * i13 + mu * (x - 1.0) * i23 - (x - mu)
        gy = (1.0 - mu) * y * i13 + mu * y * i23 - y
        gz = (1.0 - mu) * z * i13 + mu * z * i23
        slope = gx * dx + gy * dy + gz * dz
    return implicit_tangent(r, roche_potential(q, _lobe_at(r, dx, dy, dz))
                            - phi_l1, slope)


def inscribed_radius(q, xl1_val=None, phi_l1=None):
    """Radius of a donor-centred sphere certainly inside the Roche lobe:
    0.995 x the polar lobe radius (the contact solver's certain-eclipsed
    bracket end).  The pole's components are made on ``q``'s device in
    its shape (no host copy, and on the card no stream sync)."""
    zero = torch.zeros_like(q)
    return 0.995 * _lobe_radius(q, zero, zero, torch.ones_like(q), xl1_val,
                                phi_l1)


def contact_interval(q, incl_deg, px, py, xl1_val, phi_l1, r_ins,
                     precise=None, p64=None):
    """Eclipse interval (phi_in, phi_out, eclipsed) of orbital-plane
    points (px, py, 0): the plain tensor form of the contact solver.

    Port of the reference's ``_contact_interval_impl``, and the plain
    version of the CUDA kernel ``ops/csrc/contacts.cu``.  All arguments
    broadcast elementwise; ``r_ins`` is the per-walker
    :func:`inscribed_radius`.  Steps:

    1. conjunction test: the ray minimum at the conjunction direction
       (chord-midpoint seed, 3 clamped Newton steps, chord-endpoint
       insurance) sets ``eclipsed``;
    2. a two-sided analytic bracket in w = tan(theta/2): the inscribed
       sphere's hit (certainly eclipsed) and the enclosing sphere's miss
       (certainly visible);
    3. per edge, 8 safeguarded envelope-Newton iterations in w, with a
       warm-started ray minimum (1 well-guarded polish step), on-sphere
       endpoint insurance, and bisection fallback inside the bracket; the
       best *evaluated* point (smallest |c|) is returned, never the
       bracket midpoint or the last proposal.

    ``precise``: the mixed-precision mode, with (q, incl, xl1, pl1)
    solved in float64 (broadcasting like the other arguments) and ``p64``
    the points' (px, py) in float64 (None: px, py themselves).  Step 3
    then runs 5 iterations in the working dtype and 4 more per edge in
    phase, carried in float64 and restarted from the sphere bracket: each
    takes the ray minimum t and the envelope derivative in the working
    dtype and the clearance c in float64 at that t.  The best evaluated
    phase is cast to the working dtype.  Not differentiable.

    Ingress (sign -1) and egress (sign +1) run side by side on a trailing
    axis of 2 — each edge's arithmetic is unchanged.  Never-eclipsed points
    get the empty interval phi_in == phi_out == phi_c.
    """
    dtype = torch.result_type(px, py)
    mu = q / (1.0 + q)
    i_rad = torch.deg2rad(incl_deg)
    si, ci = torch.sin(i_rad), torch.cos(i_rad)
    rad = 1.0 - xl1_val
    pl1 = phi_l1
    wx, wy = 1.0 - px, -py
    ww = wx * wx + wy * wy
    c1 = px * px + py * py
    two_pi = 2.0 * math.pi
    inv_rad = 1.0 / rad
    i2_p = torch.rsqrt(ww)
    phi_c = torch.atan2(py, 1.0 - px) / two_pi

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def newton(t, ex, ey, b1, b2, px, py, c1, ww, mu):
        i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
        i2 = torch.rsqrt(t * t + 2.0 * b2 * t + ww)
        u1, u2 = t + b1, t + b2
        i13, i23 = i1 * i1 * i1, i2 * i2 * i2
        cx = px - mu + t * ex
        cy = py + t * ey
        g1 = (1.0 - mu) * u1 * i13 + mu * u2 * i23 - (cx * ex + cy * ey)
        g2 = ((1.0 - mu) * (i13 - 3.0 * u1 * u1 * i13 * i1 * i1)
              + mu * (i23 - 3.0 * u2 * u2 * i23 * i2 * i2)
              - (ex * ex + ey * ey))
        return g1, g2

    def ray_minimum(ex, ey, px, py, c1, ww, wx, wy, mu, rad):
        """(value, t, no_occ) of the ray minimum at the observer direction
        (ex, ey): chord-midpoint seed, 3 clamped Newton steps, chord-end
        insurance."""
        def g_val(t):
            i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
            i2 = torch.rsqrt(t * t + 2.0 * b2 * t + ww)
            cx = px - mu + t * ex
            cy = py + t * ey
            return -(1.0 - mu) * i1 - mu * i2 - 0.5 * (cx * cx + cy * cy)

        tstar = wx * ex + wy * ey
        disc = rad * rad - (ww - tstar * tstar)
        half = torch.sqrt(torch.clamp(disc, min=0.0))
        t_lo = torch.clamp(tstar - half, min=0.0)
        t_hi = torch.clamp(tstar + half, min=0.0)
        no_occ = disc <= 0.0
        b1 = px * ex + py * ey
        b2 = b1 - ex
        t = clip(tstar, t_lo, t_hi)
        for _ in range(_EDGE_T_NEWTON):
            g1, g2 = newton(t, ex, ey, b1, b2, px, py, c1, ww, mu)
            step = torch.where(g2 > 1e-12, g1 / torch.clamp(g2, min=1e-12),
                               torch.zeros_like(g2))
            t = clip(t - step, t_lo, t_hi)
        val = g_val(t)
        v_lo, v_hi = g_val(t_lo), g_val(t_hi)
        t = torch.where(v_lo < val, t_lo, t)
        val = torch.minimum(val, v_lo)
        t = torch.where(v_hi < val, t_hi, t)
        return torch.minimum(val, v_hi), t, no_occ

    # conjunction direction without trig: e(phi_c) = (e_A, -e_B, ci)
    iw = torch.rsqrt(ww)
    e_A = si * wx * iw
    e_B = si * py * iw

    # 1. the eclipsed? test: ray minimum at conjunction
    val, _, no_occ = ray_minimum(e_A, -e_B, px, py, c1, ww, wx, wy, mu, rad)
    c_mid = torch.where(no_occ, torch.full_like(val, _CLEAR_VISIBLE),
                        val - pl1)
    eclipsed = c_mid < 0.0

    # 2. two-sided sphere bracket in w = tan(theta/2)
    inv_den = 1.0 / torch.clamp(si * torch.sqrt(ww), min=1e-12)
    c_eff = torch.clamp(
        torch.sqrt(torch.clamp(ww - rad * rad, min=0.0)) * inv_den, 0.0, 1.0)
    w_sphere = torch.sqrt((1.0 - c_eff) / (1.0 + c_eff))
    c_ins = torch.clamp(
        torch.sqrt(torch.clamp(ww - r_ins * r_ins, min=0.0)) * inv_den,
        0.0, 1.0)
    w_inscr = torch.sqrt((1.0 - c_ins) / (1.0 + c_ins))

    # 3. both edges on a trailing axis: sign = (-1 ingress, +1 egress)
    shape = torch.broadcast_shapes(
        phi_c.shape, w_inscr.shape, w_sphere.shape, e_A.shape) + (2,)
    # (-1, 1) made on the device: a capture may hold no host copy
    sign = torch.arange(-1.0, 2.0, 2.0, dtype=phi_c.dtype,
                        device=phi_c.device)
    (px, py, c1, ww, wx, wy, mu, rad, inv_rad, i2_p, pl1, e_A, e_B, si, ci,
     phi_c_e, w_inscr_e, w_sphere_e) = (a[..., None] for a in (
         px, py, c1, ww, wx, wy, mu, rad, inv_rad, i2_p, pl1, e_A, e_B, si,
         ci, phi_c, w_inscr, w_sphere))
    lo = w_inscr_e.expand(shape)                # eclipsed end (certified)
    hi = w_sphere_e.expand(shape)               # visible end (sphere miss)
    w = 0.5 * (lo + hi)

    def e_of(w):
        den = 1.0 / (1.0 + w * w)
        cd = (1.0 - w * w) * den
        sd = (2.0 * w) * den
        ex = e_A * cd - sign * e_B * sd
        ey = -(e_B * cd + sign * e_A * sd)
        return ex, ey, den

    ex0, ey0, _ = e_of(w)
    t = wx * ex0 + wy * ey0
    w_best = w
    c_best = torch.full(shape, math.inf, dtype=w.dtype, device=w.device)
    for _ in range(_EDGE_ITERS if precise is None else _EDGE_ITERS_F32):
        ex, ey, den = e_of(w)
        tstar = wx * ex + wy * ey
        disc = rad * rad - (ww - tstar * tstar)
        half = torch.sqrt(torch.clamp(disc, min=0.0))
        t_lo = torch.clamp(tstar - half, min=0.0)
        t_hi = torch.clamp(tstar + half, min=0.0)
        no_occ = disc <= 0.0
        b1 = px * ex + py * ey
        b2 = b1 - ex
        t = clip(t, t_lo, t_hi)
        t_mid = clip(tstar, t_lo, t_hi)
        # first polish step is well-guarded: a carried t in a concave
        # region (g2 <= 0) restarts from the chord midpoint
        g1, g2 = newton(t, ex, ey, b1, b2, px, py, c1, ww, mu)
        t = torch.where(
            g2 > 1e-12, clip(t - g1 / torch.clamp(g2, min=1e-12), t_lo, t_hi),
            t_mid)
        for _ in range(_EDGE_T_WARM - 1):
            g1, g2 = newton(t, ex, ey, b1, b2, px, py, c1, ww, mu)
            step = torch.where(g2 > 1e-12, g1 / torch.clamp(g2, min=1e-12),
                               torch.zeros_like(g2))
            t = clip(t - step, t_lo, t_hi)
        # clearance with endpoint insurance (the donor term at an
        # unclipped chord endpoint is exactly -mu/rad: it lies on the
        # enclosing sphere)
        i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
        i2 = torch.rsqrt(t * t + 2.0 * b2 * t + ww)
        cx = px - mu + t * ex
        cy = py + t * ey
        val = -(1.0 - mu) * i1 - mu * i2 - 0.5 * (cx * cx + cy * cy)
        i1_lo = torch.rsqrt(t_lo * t_lo + 2.0 * b1 * t_lo + c1)
        i2_lo = torch.where(tstar - half > 0.0, inv_rad, i2_p)
        cx_lo = px - mu + t_lo * ex
        cy_lo = py + t_lo * ey
        v_lo = (-(1.0 - mu) * i1_lo - mu * i2_lo
                - 0.5 * (cx_lo * cx_lo + cy_lo * cy_lo))
        i1_hi = torch.rsqrt(t_hi * t_hi + 2.0 * b1 * t_hi + c1)
        i2_hi = torch.where(tstar + half > 0.0, inv_rad, i2_p)
        cx_hi = px - mu + t_hi * ex
        cy_hi = py + t_hi * ey
        v_hi = (-(1.0 - mu) * i1_hi - mu * i2_hi
                - 0.5 * (cx_hi * cx_hi + cy_hi * cy_hi))
        pick_lo = v_lo < val
        t = torch.where(pick_lo, t_lo, t)
        i1 = torch.where(pick_lo, i1_lo, i1)
        i2 = torch.where(pick_lo, i2_lo, i2)
        val = torch.minimum(val, v_lo)
        pick_hi = v_hi < val
        t = torch.where(pick_hi, t_hi, t)
        i1 = torch.where(pick_hi, i1_hi, i1)
        i2 = torch.where(pick_hi, i2_hi, i2)
        val = torch.minimum(val, v_hi)
        c = torch.where(no_occ, torch.full_like(val, _CLEAR_VISIBLE),
                        val - pl1)
        # keep the best EVALUATED point
        better = torch.abs(c) < c_best
        w_best = torch.where(better, w, w_best)
        c_best = torch.where(better, torch.abs(c), c_best)
        below = c < 0.0
        lo = torch.where(below, w, lo)
        hi = torch.where(below, hi, w)
        # envelope derivative dc/dphi, converted to dc/dw by sign den / pi
        rx = px + t * ex
        ry = py + t * ey
        i13, i23 = i1 * i1 * i1, i2 * i2 * i2
        gx = (1.0 - mu) * rx * i13 + mu * (rx - 1.0) * i23 - (rx - mu)
        gy = ry * ((1.0 - mu) * i13 + mu * i23 - 1.0)
        d = t * two_pi * (gx * ey - gy * ex)
        w_newton = w - (c * math.pi) / torch.where(
            torch.abs(d) > 1e-12, sign * den * d,
            torch.full_like(d, math.inf))
        inside = (w_newton - lo) * (w_newton - hi) < 0.0
        ok = inside & torch.isfinite(w_newton) & ~no_occ
        w = torch.where(ok, w_newton, 0.5 * (lo + hi))

    if precise is None:
        edge = phi_c_e + sign * (torch.atan(w_best) / math.pi)
    else:
        # float64 phase tail, restarted from the sphere bracket (a
        # working-dtype bracket may sit on the wrong side of a tangential
        # root) and seeded by the last working-dtype iterate
        f64 = torch.float64
        q64, incl64, _, pl164 = (a.to(f64)[..., None] for a in precise)
        px64, py64 = ((px, py) if p64 is None
                      else (p64[0][..., None], p64[1][..., None]))
        px64, py64 = px64.to(f64), py64.to(f64)
        mu64 = q64 / (1.0 + q64)
        si64 = torch.sin(torch.deg2rad(incl64))
        c164 = px64 * px64 + py64 * py64
        wx64, wy64 = 1.0 - px64, -py64
        c2n64 = wx64 * wx64 + wy64 * wy64

        def c_refined(t, phi):
            t = t.to(f64)
            th = 2.0 * math.pi * phi
            ex, ey = si64 * torch.cos(th), -si64 * torch.sin(th)
            b1 = px64 * ex + py64 * ey
            b2 = b1 - ex
            i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c164)
            i2 = torch.rsqrt(t * t + 2.0 * b2 * t + c2n64)
            cx = px64 - mu64 + t * ex
            cy = py64 + t * ey
            return (-(1.0 - mu64) * i1 - mu64 * i2
                    - 0.5 * (cx * cx + cy * cy)) - pl164

        def dc_dphi(t, ex, ey):
            rx = px + t * ex
            ry = py + t * ey
            rz = t * ci
            i1 = torch.rsqrt(rx * rx + ry * ry + rz * rz)
            dx = rx - 1.0
            i2 = torch.rsqrt(dx * dx + ry * ry + rz * rz)
            i13, i23 = i1 * i1 * i1, i2 * i2 * i2
            gx = (1.0 - mu) * rx * i13 + mu * dx * i23 - (rx - mu)
            gy = ry * ((1.0 - mu) * i13 + mu * i23 - 1.0)
            return t * two_pi * (gx * ey - gy * ex)

        inv_pi = 1.0 / math.pi
        lo = (phi_c_e + sign * (torch.atan(w_inscr_e) * inv_pi)).to(f64)
        hi = (phi_c_e + sign * (torch.atan(w_sphere_e) * inv_pi)).to(f64)
        phi = (phi_c_e + sign * (torch.atan(w) * inv_pi)).to(f64)
        lo, hi = torch.broadcast_tensors(lo, hi, phi)[:2]
        phi_best = phi
        c_best = torch.full(phi.shape, math.inf, dtype=f64, device=phi.device)
        for _ in range(_EDGE_ITERS_F64):
            phi32 = phi.to(dtype)
            th = two_pi * phi32
            ex, ey = si * torch.cos(th), -si * torch.sin(th)
            _, t, no_occ = ray_minimum(ex, ey, px, py, c1, ww, wx, wy, mu,
                                       rad)
            c = torch.where(no_occ, torch.full_like(phi, math.inf),
                            c_refined(t, phi))
            better = torch.abs(c) < c_best
            phi_best = torch.where(better, phi, phi_best)
            c_best = torch.where(better, torch.abs(c), c_best)
            below = c < 0.0
            lo = torch.where(below, phi, lo)
            hi = torch.where(below, hi, phi)
            d = dc_dphi(t, ex, ey).to(f64)
            phi_newton = phi - c / torch.where(
                torch.abs(d) > 1e-12, d, torch.full_like(d, math.inf))
            inside = (phi_newton - lo) * (phi_newton - hi) < 0.0
            ok = inside & torch.isfinite(phi_newton) & ~no_occ
            phi = torch.where(ok, phi_newton, 0.5 * (lo + hi))
        edge = phi_best.to(dtype)

    phi_in = torch.where(eclipsed, edge[..., 0], phi_c)
    phi_out = torch.where(eclipsed, edge[..., 1], phi_c)
    return phi_in, phi_out, eclipsed


def _edge_residual(phi, q, incl_deg, px, py, xl1_val, phi_l1):
    """Envelope clearance c(phi) = min_t Phi(r(t)) - Phi_L1 at fixed
    ``phi`` for the orbital-plane point (px, py), and the envelope
    derivative dc/dphi: the residual behind the contact phases' IFT
    gradient (``ops.contacts``).  Explicit ops and an unrolled clamped
    Newton, so autograd differentiates it in every argument; the
    arithmetic is the reference's ``_edge_residual``.  Broadcasts."""
    mu = q / (1.0 + q)
    i_rad = torch.deg2rad(incl_deg)
    si, ci = torch.sin(i_rad), torch.cos(i_rad)
    rad = 1.0 - xl1_val
    wx, wy = 1.0 - px, -py
    ww = wx * wx + wy * wy
    c1 = px * px + py * py
    two_pi = 2.0 * math.pi
    th = two_pi * phi
    ex, ey = si * torch.cos(th), -si * torch.sin(th)
    tstar = wx * ex + wy * ey
    disc = rad * rad - (ww - tstar * tstar)
    half = torch.sqrt(torch.clamp(disc, min=1e-30))
    t_lo = torch.clamp(tstar - half, min=0.0)
    t_hi = torch.clamp(tstar + half, min=0.0)
    no_occ = (disc <= 0.0) | (tstar + half <= 1e-9)
    b1 = px * ex + py * ey
    b2 = b1 - ex

    def g_val(t):
        i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
        i2 = torch.rsqrt(t * t + 2.0 * b2 * t + ww)
        cx = px - mu + t * ex
        cy = py + t * ey
        return -(1.0 - mu) * i1 - mu * i2 - 0.5 * (cx * cx + cy * cy)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    t = clip(tstar, t_lo, t_hi)
    for _ in range(_EDGE_T_NEWTON):
        i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
        i2 = torch.rsqrt(t * t + 2.0 * b2 * t + ww)
        u1, u2 = t + b1, t + b2
        i13, i23 = i1 * i1 * i1, i2 * i2 * i2
        cx = px - mu + t * ex
        cy = py + t * ey
        g1 = (1.0 - mu) * u1 * i13 + mu * u2 * i23 - (cx * ex + cy * ey)
        g2 = ((1.0 - mu) * (i13 - 3.0 * u1 * u1 * i13 * i1 * i1)
              + mu * (i23 - 3.0 * u2 * u2 * i23 * i2 * i2)
              - (ex * ex + ey * ey))
        step = torch.where(g2 > 1e-12, g1 / torch.clamp(g2, min=1e-12),
                           torch.zeros_like(g2))
        t = clip(t - step, t_lo, t_hi)
    val = g_val(t)
    v_lo, v_hi = g_val(t_lo), g_val(t_hi)
    t = torch.where(v_lo < val, t_lo, t)
    val = torch.minimum(val, v_lo)
    t = torch.where(v_hi < val, t_hi, t)
    val = torch.minimum(val, v_hi)
    c = torch.where(no_occ, torch.full_like(val, _CLEAR_VISIBLE),
                    val - phi_l1)

    rx, ry, rz = px + t * ex, py + t * ey, t * ci
    i1 = torch.rsqrt(rx * rx + ry * ry + rz * rz)
    dx = rx - 1.0
    i2 = torch.rsqrt(dx * dx + ry * ry + rz * rz)
    i13, i23 = i1 * i1 * i1, i2 * i2 * i2
    gx = (1.0 - mu) * rx * i13 + mu * dx * i23 - (rx - mu)
    gy = ry * ((1.0 - mu) * i13 + mu * i23 - 1.0)
    return c, t * two_pi * (gx * ey - gy * ex)


def visible_fraction_interval(phase, width, phi_in, phi_out, eclipsed):
    """Fraction of the exposure [phase - width/2, phase + width/2] during
    which a point with eclipse interval (phi_in, phi_out) is visible
    (exact finite-exposure smearing; handles phase wrapping)."""
    dur = phi_out - phi_in
    w = torch.clamp(width, min=1e-12)
    rel = torch.remainder(phase - 0.5 * w - phi_in, 1.0)
    ov_this = torch.minimum(torch.clamp(dur - rel, min=0.0), w)
    ov_next = torch.minimum(torch.clamp(rel + w - 1.0, min=0.0), dur)
    overlap = torch.minimum(torch.clamp(ov_this + ov_next, min=0.0), w)
    frac_occulted = torch.where(eclipsed, overlap / w,
                                torch.zeros_like(overlap))
    return 1.0 - frac_occulted
