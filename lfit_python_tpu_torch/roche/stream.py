"""Ballistic gas-stream trajectory from L1 (bright-spot position).

Port of ``lfit_python_tpu/roche/stream.py`` (primal only): a fixed-step
RK4 integration of the restricted three-body equations in the corotating
frame (w = 1, z = 0 plane),

    x'' = -dPhi/dx + 2 y',    y'' = -dPhi/dy - 2 x',

started just inside L1 with a tiny velocity towards the primary.  The
bright spot is the first crossing of the stream with the disc rim
(linear interpolation between integration steps).

The integration is a plain Python loop of tensor ops over walkers: in
eager PyTorch every op is a launch, so the scan costs ~200 launches per
RK4 step.  It is the port's first candidate for a kernel of its own.
"""

from __future__ import annotations

import torch

from .geometry import xl1

__all__ = ["stream_steps_for", "stream_impacts", "stream_trajectory",
           "spot_position"]

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
