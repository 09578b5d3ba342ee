"""Ballistic gas-stream trajectory from L1 (bright-spot position): the
benchmark's frozen copy of the PyTorch port's plain loop, which follows
``lfit_python_tpu/roche/stream.py``: a fixed-step RK4
integration of the restricted three-body equations in the corotating
frame (w = 1, z = 0 plane),

    x'' = -dPhi/dx + 2 y',    y'' = -dPhi/dy - 2 x',

started just inside L1 with a tiny velocity towards the primary.  The
bright spot is the first crossing of the stream with the disc rim
(linear interpolation between integration steps).

A Python loop of tensor ops over walkers; :func:`stream_impacts_diff`
carries the gradient from :func:`stream_impacts_sens`'s forward
sensitivities.
"""

from __future__ import annotations

import torch

from .geometry import xl1

__all__ = ["stream_steps_for", "stream_impacts", "stream_impacts_sens",
           "stream_impacts_diff",
           "stream_trajectory", "spot_position"]

# trip count sized to the stream's first radial periapsis: 4352 covers
# q >= 0.02 (the reference's measured steps-to-periapsis table); the
# posterior picks the tier from the model's q-prior floor
_N_STEPS = 4352
_DT = 8e-4
_V0 = 1e-3  # initial speed towards the primary, in units of a*w


def stream_steps_for(q_lo):
    """Scan trip count covering first periapsis for all q >= ``q_lo``:
    4352 covers q >= 0.02, 5120 covers q >= 0.002, 6144 below."""
    if q_lo >= 0.02:
        return _N_STEPS
    if q_lo >= 0.002:
        return 5120
    return 6144


def _rk4(x, y, vx, vy, mu, dt):
    """One componentwise RK4 step of the planar stream equations (the
    reference's arithmetic, with its repeated stage velocities computed
    once)."""
    omu = 1.0 - mu

    def accel(x, y, vx, vy):
        yy = y * y
        i1 = torch.rsqrt(x * x + yy)
        dx2 = x - 1.0
        i2 = torch.rsqrt(dx2 * dx2 + yy)
        i13, i23 = i1 * i1 * i1, i2 * i2 * i2
        gx = omu * x * i13 + mu * dx2 * i23 - (x - mu)
        gy = y * (omu * i13 + mu * i23 - 1.0)
        return -gx + 2.0 * vy, -gy - 2.0 * vx

    h = 0.5 * dt
    ax1, ay1 = accel(x, y, vx, vy)
    v2x, v2y = vx + h * ax1, vy + h * ay1
    ax2, ay2 = accel(x + h * vx, y + h * vy, v2x, v2y)
    v3x, v3y = vx + h * ax2, vy + h * ay2
    ax3, ay3 = accel(x + h * v2x, y + h * v2y, v3x, v3y)
    v4x, v4y = vx + dt * ax3, vy + dt * ay3
    ax4, ay4 = accel(x + dt * v3x, y + dt * v3y, v4x, v4y)
    xn = x + dt / 6.0 * (vx + 2 * v2x + 2 * v3x + v4x)
    yn = y + dt / 6.0 * (vy + 2 * v2y + 2 * v3y + v4y)
    vxn = vx + dt / 6.0 * (ax1 + 2 * ax2 + 2 * ax3 + ax4)
    vyn = vy + dt / 6.0 * (ay1 + 2 * ay2 + 2 * ay3 + ay4)
    return xn, yn, vxn, vyn


def _rk4_sens(x, y, vx, vy, mu, dmu, dt, tx, ty, tvx, tvy):
    """:func:`_rk4` (same arithmetic, so the same primal) and its tangent
    map applied to the columns ``tx, ty, tvx, tvy`` (W, K), with
    ``dmu`` (W, K) the columns' tangent of mu; the primal is (W,)."""
    omu = 1.0 - mu
    col = (lambda a: a[:, None])

    def accel(x, y, vx, vy, tx, ty, tvx, tvy):
        yy = y * y
        i1 = torch.rsqrt(x * x + yy)
        dx2 = x - 1.0
        i2 = torch.rsqrt(dx2 * dx2 + yy)
        i13, i23 = i1 * i1 * i1, i2 * i2 * i2
        s = omu * i13 + mu * i23 - 1.0
        gx = omu * x * i13 + mu * dx2 * i23 - (x - mu)
        gy = y * s
        # d(i1^3) = -3 i1^5 (x dx + y dy), d(i2^3) likewise
        x_, y_, dx2_, i13_, i23_ = (col(a) for a in (x, y, dx2, i13, i23))
        d13 = -3.0 * col(i13 * i1 * i1) * (x_ * tx + y_ * ty)
        d23 = -3.0 * col(i23 * i2 * i2) * (dx2_ * tx + y_ * ty)
        dgx = (-dmu * x_ * i13_ + col(omu) * (tx * i13_ + x_ * d13)
               + dmu * dx2_ * i23_ + col(mu) * (tx * i23_ + dx2_ * d23)
               - tx + dmu)
        ds = (-dmu * i13_ + col(omu) * d13 + dmu * i23_ + col(mu) * d23)
        dgy = ty * col(s) + y_ * ds
        return (-gx + 2.0 * vy, -gy - 2.0 * vx,
                -dgx + 2.0 * tvy, -dgy - 2.0 * tvx)

    h = 0.5 * dt
    ax1, ay1, tax1, tay1 = accel(x, y, vx, vy, tx, ty, tvx, tvy)
    v2x, v2y = vx + h * ax1, vy + h * ay1
    t2x, t2y = tvx + h * tax1, tvy + h * tay1
    ax2, ay2, tax2, tay2 = accel(x + h * vx, y + h * vy, v2x, v2y,
                                 tx + h * tvx, ty + h * tvy, t2x, t2y)
    v3x, v3y = vx + h * ax2, vy + h * ay2
    t3x, t3y = tvx + h * tax2, tvy + h * tay2
    ax3, ay3, tax3, tay3 = accel(x + h * v2x, y + h * v2y, v3x, v3y,
                                 tx + h * t2x, ty + h * t2y, t3x, t3y)
    v4x, v4y = vx + dt * ax3, vy + dt * ay3
    t4x, t4y = tvx + dt * tax3, tvy + dt * tay3
    ax4, ay4, tax4, tay4 = accel(x + dt * v3x, y + dt * v3y, v4x, v4y,
                                 tx + dt * t3x, ty + dt * t3y, t4x, t4y)
    c = dt / 6.0
    return (x + c * (vx + 2 * v2x + 2 * v3x + v4x),
            y + c * (vy + 2 * v2y + 2 * v3y + v4y),
            vx + c * (ax1 + 2 * ax2 + 2 * ax3 + ax4),
            vy + c * (ay1 + 2 * ay2 + 2 * ay3 + ay4),
            tx + c * (tvx + 2 * t2x + 2 * t3x + t4x),
            ty + c * (tvy + 2 * t2y + 2 * t3y + t4y),
            tvx + c * (tax1 + 2 * tax2 + 2 * tax3 + tax4),
            tvy + c * (tay1 + 2 * tay2 + 2 * tay3 + tay4))


def stream_impacts(q, rdiscs, xl1_val=None, n_steps=_N_STEPS, dt=_DT):
    """First stream/disc-rim crossings for E disc radii in one carry-only
    integration.

    ``q``, ``xl1_val``: (W,); ``rdiscs``: (W, E).  The state is four (W,)
    tensors and the first crossings are recorded in (W, E) tensors as
    they happen, so nothing is stacked over steps.  Where the stream
    never reaches a radius, the start point of the closest-approach step
    stands in (only walkers the physical-validity prior rejects see it).

    Returns (W, E, 3) impact points (z = 0).
    """
    if xl1_val is None:
        xl1_val = xl1(q)
    mu = q / (1.0 + q)
    x = xl1_val - 1e-5
    y = torch.zeros_like(x)
    vx = torch.full_like(x, -_V0)
    vy = torch.zeros_like(x)
    r = torch.abs(x)
    rd = rdiscs
    found = torch.zeros(rd.shape, dtype=torch.bool, device=rd.device)
    hx = torch.zeros_like(rd)
    hy = torch.zeros_like(rd)
    minr = torch.full_like(x, float("inf"))
    mx, my = x, y
    for _ in range(n_steps):
        xn, yn, vxn, vyn = _rk4(x, y, vx, vy, mu, dt)
        rn = torch.sqrt(xn * xn + yn * yn)
        den = torch.clamp(r - rn, min=1e-30)[:, None]
        take = (rn[:, None] <= rd) & ~found
        frac = torch.clamp((r[:, None] - rd) / den, 0.0, 1.0)
        hx = torch.where(take, x[:, None] + frac * (xn - x)[:, None], hx)
        hy = torch.where(take, y[:, None] + frac * (yn - y)[:, None], hy)
        found = found | take
        closer = rn < minr
        minr = torch.where(closer, rn, minr)
        mx = torch.where(closer, x, mx)
        my = torch.where(closer, y, my)
        x, y, vx, vy, r = xn, yn, vxn, vyn, rn
    out_x = torch.where(found, hx, mx[:, None])
    out_y = torch.where(found, hy, my[:, None])
    return torch.stack([out_x, out_y, torch.zeros_like(out_x)], dim=-1)


def stream_trajectory(q, xl1_val=None, n_steps=_N_STEPS, dt=_DT):
    """The stacked stream trajectory, (W, n_steps + 1, 3) for (W,) ``q``:
    the readable oracle for :func:`stream_impacts`."""
    if xl1_val is None:
        xl1_val = xl1(q)
    mu = q / (1.0 + q)
    x = xl1_val - 1e-5
    y = torch.zeros_like(x)
    vx = torch.full_like(x, -_V0)
    vy = torch.zeros_like(x)
    xs, ys = [x], [y]
    for _ in range(n_steps):
        x, y, vx, vy = _rk4(x, y, vx, vy, mu, dt)
        xs.append(x)
        ys.append(y)
    xs = torch.stack(xs, dim=-1)
    ys = torch.stack(ys, dim=-1)
    return torch.stack([xs, ys, torch.zeros_like(xs)], dim=-1)


def spot_position(q, rdisc, traj=None):
    """First crossing of the stream with radius ``rdisc`` (W,), from the
    stacked trajectory (W, S, 3); the closest-approach point where the
    stream never gets that close.  Returns (W, 3)."""
    if traj is None:
        traj = stream_trajectory(q)
    r = torch.linalg.vector_norm(traj, dim=-1)
    below = r <= rdisc[:, None]
    idx = torch.argmax(below.to(torch.int8), dim=-1)
    hit = below.any(dim=-1)
    idx = torch.where(hit, torch.clamp(idx, min=1), torch.argmin(r, dim=-1))
    rows = torch.arange(r.shape[0], device=r.device)
    r_a, r_b = r[rows, idx - 1], r[rows, idx]
    frac = torch.where(hit, (r_a - rdisc) / torch.clamp(r_a - r_b, min=1e-30),
                       torch.zeros_like(r_a))
    frac = torch.clamp(frac, 0.0, 1.0)
    a, b = traj[rows, idx - 1], traj[rows, idx]
    return a + frac[:, None] * (b - a)


def stream_impacts_sens(q, rdiscs, xl1_val, n_steps=_N_STEPS, dt=_DT):
    """:func:`stream_impacts` and its forward sensitivities, the plain
    version of K2's sensitivity mode (port of the reference's
    ``_stream_impacts_impl(with_sens=True)``).

    Two first-variation columns, d/dq at fixed x0 and d/dx0 (x0 = xl1 -
    1e-5), are integrated with the primal; at each first crossing the
    linear interpolation's derivative gives d(impact)/d{q, x0, rdisc_e}.
    Where the stream never reaches a radius, the closest-approach step's
    start carries its columns and the rdisc derivative is 0.  Detached
    arithmetic: the caller attaches the result (``ops.stream``).

    Returns (impacts, jq, jx0, jrd), each (W, E, 3) with z = 0."""
    q, rd, xl1_val = q.detach(), rdiscs.detach(), xl1_val.detach()
    mu = q / (1.0 + q)
    dmu = torch.stack([1.0 / ((1.0 + q) * (1.0 + q)),
                       torch.zeros_like(q)], dim=-1)        # (W, 2)
    x = xl1_val - 1e-5
    y = torch.zeros_like(x)
    vx = torch.full_like(x, -_V0)
    vy = torch.zeros_like(x)
    r = torch.abs(x)
    # tangent columns (W, 2): [d/dq, d/dx0]; dx/dx0 = 1 at the start
    tx = torch.zeros_like(dmu)
    tx[:, 1] = 1.0
    ty = torch.zeros_like(dmu)
    tvx = torch.zeros_like(dmu)
    tvy = torch.zeros_like(dmu)
    found = torch.zeros(rd.shape, dtype=torch.bool, device=rd.device)
    hx = torch.zeros_like(rd)
    hy = torch.zeros_like(rd)
    jx = torch.zeros(rd.shape + (2,), dtype=rd.dtype, device=rd.device)
    jy = torch.zeros_like(jx)
    rdx = torch.zeros_like(rd)
    rdy = torch.zeros_like(rd)
    minr = torch.full_like(x, float("inf"))
    mx, my = x, y
    mtx, mty = tx, ty
    for _ in range(n_steps):
        xn, yn, vxn, vyn, txn, tyn, tvxn, tvyn = _rk4_sens(
            x, y, vx, vy, mu, dmu, dt, tx, ty, tvx, tvy)
        rn = torch.sqrt(xn * xn + yn * yn)
        den = torch.clamp(r - rn, min=1e-30)[:, None]
        take = (rn[:, None] <= rd) & ~found
        frac_raw = (r[:, None] - rd) / den
        frac = torch.clamp(frac_raw, 0.0, 1.0)
        ddx, ddy = (xn - x)[:, None], (yn - y)[:, None]
        hx = torch.where(take, x[:, None] + frac * ddx, hx)
        hy = torch.where(take, y[:, None] + frac * ddy, hy)
        # d frac = (dr den - (r - rd) (dr - drn)) / den^2 inside (0, 1)
        in_rng = ((frac_raw > 0.0) & (frac_raw < 1.0))[..., None]
        dr = (x[:, None] * tx + y[:, None] * ty) / torch.clamp(
            r, min=1e-30)[:, None]
        drn = (xn[:, None] * txn + yn[:, None] * tyn) / torch.clamp(
            rn, min=1e-30)[:, None]
        den3 = den[..., None]
        dfrac = ((dr[:, None] * den3 - (r[:, None] - rd)[..., None]
                  * (dr - drn)[:, None]) / (den3 * den3))
        dfrac = torch.where(in_rng, dfrac, torch.zeros_like(dfrac))
        f3 = frac[..., None]
        take3 = take[..., None]
        jx = torch.where(take3, tx[:, None] + dfrac * ddx[..., None]
                         + f3 * (txn - tx)[:, None], jx)
        jy = torch.where(take3, ty[:, None] + dfrac * ddy[..., None]
                         + f3 * (tyn - ty)[:, None], jy)
        dfr = torch.where(in_rng[..., 0], -1.0 / den, torch.zeros_like(rd))
        rdx = torch.where(take, dfr * ddx, rdx)
        rdy = torch.where(take, dfr * ddy, rdy)
        found = found | take
        closer = rn < minr
        minr = torch.where(closer, rn, minr)
        mx = torch.where(closer, x, mx)
        my = torch.where(closer, y, my)
        mtx = torch.where(closer[:, None], tx, mtx)
        mty = torch.where(closer[:, None], ty, mty)
        x, y, vx, vy, r = xn, yn, vxn, vyn, rn
        tx, ty, tvx, tvy = txn, tyn, tvxn, tvyn

    def xyz(ox, oy):
        return torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)

    zero = torch.zeros_like(rd)
    return (xyz(torch.where(found, hx, mx[:, None]),
                torch.where(found, hy, my[:, None])),
            xyz(torch.where(found, jx[..., 0], mtx[:, None, 0]),
                torch.where(found, jy[..., 0], mty[:, None, 0])),
            xyz(torch.where(found, jx[..., 1], mtx[:, None, 1]),
                torch.where(found, jy[..., 1], mty[:, None, 1])),
            xyz(torch.where(found, rdx, zero), torch.where(found, rdy, zero)))


class _StreamImpacts(torch.autograd.Function):
    """Impacts whose backward applies the forward sensitivities: dq =
    sum g.jq, dx1 = sum g.jx0, drd[e] = sum_k g[e, k] jrd[e, k]."""

    @staticmethod
    def forward(ctx, q, rd, x1, n_steps, dt):
        impacts, jq, jx0, jrd = stream_impacts_sens(q, rd, x1, n_steps, dt)
        ctx.save_for_backward(jq, jx0, jrd)
        return impacts

    @staticmethod
    def backward(ctx, g):
        jq, jx0, jrd = ctx.saved_tensors
        return ((g * jq).sum(dim=(-2, -1)), (g * jrd).sum(dim=-1),
                (g * jx0).sum(dim=(-2, -1)), None, None)


def stream_impacts_diff(q, rdiscs, xl1_val=None, n_steps=_N_STEPS, dt=_DT):
    """:func:`stream_impacts`, differentiable in (q, rdiscs, xl1_val)
    where a graph is recorded.  ``q``, ``xl1_val``: (W,); ``rdiscs``:
    (W, E).  Returns (W, E, 3)."""
    if xl1_val is None:
        xl1_val = xl1(q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, rdiscs, xl1_val)):
        return _StreamImpacts.apply(q, rdiscs, xl1_val, int(n_steps),
                                    float(dt))
    return stream_impacts(q, rdiscs, xl1_val, n_steps, dt)
