"""Celerite-style O(n) Gaussian-process likelihood (Matern-3/2) in plain
PyTorch: the benchmark's frozen copy of the PyTorch port's plain
recursion, which follows ``lfit_python_tpu/ops/gp.py``.

The Matern-3/2 kernel in celerite's ``Matern32Term`` form, a J = 2
semi-separable complex pair

    k(tau) = e^{-c tau} (a cos(d tau) + b sin(d tau)),
    a = sigma^2, c = sqrt3 / rho, d = eps c, b = a / eps   (eps = 0.01)

whose Cholesky factor is a recursion over the points with a symmetric
2 x 2 state S and a 2-vector f (Foreman-Mackey et al. 2017).  Per-point
amplitudes with ``reset`` marking segment starts give independent
per-segment GPs.  Shapes: ``t``, ``yerr``, ``mask`` (E, P); ``y``,
``sigma2``, ``reset`` (W, E, P); ``c`` (W, E); the result (W, E).
"""

from __future__ import annotations

import math

import torch

__all__ = ["segmented_matern32_ln_like"]

_EPS = 0.01  # celerite Matern32Term eps


def _angles_decay(t, c):
    """cos(d t), sin(d t) and the inter-step decay exp(-c dt) of the
    complex pair, each (W, E, P), for ``t`` (E, P) and ``c`` (W, E)."""
    ang = (_EPS * c)[..., None] * t
    dt = torch.diff(t, dim=-1, prepend=t[..., :1])
    return torch.cos(ang), torch.sin(ang), torch.exp(-c[..., None] * dt)


def _recursion(y, sigma2, cd, sd, phi, reset, yerr, mask):
    """The recursion over the P points on (W, E) tensors."""
    # segment resets: no correlation across the boundary; padded points:
    # do not advance the decay state
    phi = torch.where(reset, torch.zeros_like(phi), phi)
    phi = torch.where(mask, phi, torch.ones_like(phi))
    a = sigma2
    b = sigma2 * (1.0 / _EPS)
    U0 = a * cd + b * sd
    U1 = a * sd - b * cd
    A = yerr * yerr + sigma2                     # diag of K
    two_pi = 2.0 * math.pi
    zero = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    S00 = S01 = S11 = f0 = f1 = ll = zero
    for n in range(y.shape[-1]):
        ph, u0, u1 = phi[..., n], U0[..., n], U1[..., n]
        m = mask[..., n]
        # propagate
        S00 = ph * S00 * ph
        S01 = ph * S01 * ph
        S11 = ph * S11 * ph
        f0 = ph * f0
        f1 = ph * f1
        su0 = S00 * u0 + S01 * u1
        su1 = S01 * u0 + S11 * u1
        D = torch.clamp(A[..., n] - (su0 * u0 + su1 * u1), min=1e-30)
        w0 = (cd[..., n] - su0) / D
        w1 = (sd[..., n] - su1) / D
        z = y[..., n] - (u0 * f0 + u1 * f1)
        inc = -0.5 * (z * z / D + torch.log(two_pi * D))
        # update the state for the next point
        S00 = torch.where(m, S00 + D * (w0 * w0), S00)
        S01 = torch.where(m, S01 + D * (w0 * w1), S01)
        S11 = torch.where(m, S11 + D * (w1 * w1), S11)
        f0 = torch.where(m, f0 + w0 * z, f0)
        f1 = torch.where(m, f1 + w1 * z, f1)
        ll = ll + torch.where(m, inc, torch.zeros_like(inc))
    return ll


def segmented_matern32_ln_like(t, y, yerr, sigma2, c, reset=None, mask=None):
    """ln N(y | 0, K + diag(yerr^2)) with the Matern-3/2 kernel, O(P) per
    series; returns (W, E).  ``reset`` is True where the recursion
    restarts (the first point of a segment); ``mask`` is False for padded
    points, which contribute nothing and do not advance the recursion.
    Autograd differentiates the loop as it stands."""
    W, E, P = y.shape
    if reset is None:
        reset = torch.zeros((), dtype=torch.bool, device=y.device)
    if mask is None:
        mask = torch.ones((), dtype=torch.bool, device=y.device)
    t, yerr = t.expand(E, P), yerr.expand(E, P)
    sigma2, c = sigma2.expand(W, E, P), c.expand(W, E)
    reset, mask = reset.expand(W, E, P), mask.expand(E, P)
    cd, sd, phi = _angles_decay(t, c)
    return _recursion(y, sigma2, cd, sd, phi, reset, yerr, mask)
