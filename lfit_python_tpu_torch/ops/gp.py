"""Celerite-style O(n) Gaussian-process likelihood (Matern-3/2): the
recursion K3 as a CUDA kernel with its reverse pass, their wrapper and
the plain version.

Port of ``lfit_python_tpu/ops/gp.py``.  The Matern-3/2 kernel is used in
celerite's ``Matern32Term`` form, a J = 2 semi-separable complex pair

    k(tau) = e^{-c tau} (a cos(d tau) + b sin(d tau)),
    a = sigma^2, c = sqrt3 / rho, d = eps c, b = a / eps   (eps = 0.01)

whose Cholesky factor is a recursion over the points with a symmetric
2 x 2 state S and a 2-vector f (Foreman-Mackey et al. 2017).  Per-point
amplitudes with ``reset`` marking segment starts give independent
per-segment GPs (the GP-eclipse changepoint model).

The reference is per series and vmapped; the port is batched over
``W`` walkers and ``E`` eclipses:

    t, yerr, mask   : (E, P)     times, errors, valid points (shared)
    y, sigma2, reset: (W, E, P)  residuals, amplitudes^2, segment starts
    c               : (W, E)     sqrt3 / timescale

and returns the ln-likelihoods ``(W, E)``.  ``sigma2`` and ``reset`` may
be given in any shape that broadcasts to ``(W, E, P)``.

K3 (``csrc/gp.cu``) is a kernel of the port's own: on the TPU the
recursion was an XLA ``lax.scan`` (``lfit_python_tpu/ops/gp.py:88-109``).
It takes ``t`` and ``c`` and makes the angles' cosines and sines and the
decay factors itself, point by point, so a call is one launch; the plain
version makes them with PyTorch (:func:`_angles_decay`) before its loop.
Under autograd the forward kernel also keeps the state each series
enters each point with, and the backward is a second kernel that walks
each series back (the adjoint of the loop, written out by hand), makes
the same angles and decay with the same device function, and folds their
adjoints into the one gradient of each series' ``c`` as it goes.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["segmented_matern32_ln_like", "segmented_matern32_plain",
           "segmented_matern32_kernel", "matern32_gp_ln_like",
           "matern32_cov", "LAUNCHES", "BACKWARD_LAUNCHES"]

_EPS = 0.01  # celerite Matern32Term eps

# number of K3 launches (the forward kernel) in this process
LAUNCHES = 0
# number of launches of K3's reverse kernel in this process
BACKWARD_LAUNCHES = 0

_fns = None


def _angles_decay(t, c):
    """cos(d t), sin(d t) and the inter-step decay exp(-c dt) of the
    complex pair, each (W, E, P), for ``t`` (E, P) and ``c`` (W, E)."""
    ang = (_EPS * c)[..., None] * t
    dt = torch.diff(t, dim=-1, prepend=t[..., :1])
    return torch.cos(ang), torch.sin(ang), torch.exp(-c[..., None] * dt)


def _kernel():
    """(forward launcher, backward launcher) of the built ``gp.cu``."""
    global _fns
    if _fns is None:
        from ._build import load_library

        lib = load_library("gp")
        fwd, bwd = lib.gp_launch, lib.gp_backward_launch
        fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        _fns = fwd, bwd
    return _fns


def _recursion_plain(y, sigma2, cd, sd, phi, reset, yerr, mask):
    """The recursion over the P points on (W, E) tensors, the steps K3
    repeats (K3 makes ``cd``, ``sd`` and ``phi`` itself).  ``y``,
    ``sigma2``, ``cd``, ``sd``, ``phi``, ``reset``: (W, E, P); ``yerr``,
    ``mask``: (E, P)."""
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


def _prepare(t, y, yerr, sigma2, c, reset, mask):
    """Inputs broadcast to the batched layout: t, yerr, mask (E, P);
    y, sigma2, reset (W, E, P); c (W, E)."""
    W, E, P = y.shape
    if reset is None:
        reset = torch.zeros((), dtype=torch.bool, device=y.device)
    if mask is None:
        mask = torch.ones((), dtype=torch.bool, device=y.device)
    if not isinstance(sigma2, torch.Tensor):
        sigma2 = torch.full((), float(sigma2), dtype=y.dtype, device=y.device)
    return (t.expand(E, P), yerr.expand(E, P), sigma2.expand(W, E, P),
            c.expand(W, E), reset.expand(W, E, P), mask.expand(E, P))


def segmented_matern32_plain(t, y, yerr, sigma2, c, reset=None, mask=None):
    """Plain PyTorch version of :func:`segmented_matern32_ln_like`: a
    Python loop over the points, which autograd differentiates as it
    stands."""
    t, yerr, sigma2, c, reset, mask = _prepare(t, y, yerr, sigma2, c, reset,
                                               mask)
    cd, sd, phi = _angles_decay(t, c)
    return _recursion_plain(y, sigma2, cd, sd, phi, reset, yerr, mask)


def _checked(t, y, yerr, sigma2, c, reset, mask):
    """The kernels' inputs, checked and contiguous, in their order: y,
    sigma2, t, c, reset, yerr, mask."""
    W, E, P = y.shape
    for name, a, shape in (("y", y, (W, E, P)), ("sigma2", sigma2, (W, E, P)),
                           ("t", t, (E, P)), ("c", c, (W, E)),
                           ("yerr", yerr, (E, P))):
        if a.dtype not in (torch.float32, torch.float64) \
                or a.dtype != y.dtype:
            raise TypeError(f"K3 takes float32 or float64 of one dtype, "
                            f"got {name}: {a.dtype}, y: {y.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"K3: {name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
    for name, a, shape in (("reset", reset, (W, E, P)),
                           ("mask", mask, (E, P))):
        if a.dtype != torch.bool:
            raise TypeError(f"K3 takes a bool {name}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"K3: {name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
    tensors = [a.contiguous() for a in (y, sigma2, t, c, reset, yerr, mask)]
    for a in tensors:
        if a.device != y.device:
            raise ValueError(f"K3: a tensor on {a.device}, y on {y.device}")
    return tensors


def _launch(which, y, pointers):
    """One launch of the forward (0) or the reverse (1) kernel on ``y``'s
    device and current stream."""
    W, E, P = y.shape
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()[which](int(y.dtype == torch.float64), *pointers,
                               W, E, P, stream)
    if err != 0:
        raise RuntimeError(f"K3 {('forward', 'backward')[which]} launch "
                           f"failed: cudaError {err}")


def _forward(tensors, save=None):
    """One launch of ``gp_kernel`` on the checked inputs of the recursion:
    the ln-likelihoods (W, E).  ``save`` (5, P, W * E), if given, receives
    the state each series enters each point with."""
    global LAUNCHES
    y = tensors[0]
    W, E, _ = y.shape
    out = torch.empty((W, E), dtype=y.dtype, device=y.device)
    if W and E:
        _launch(0, y, [a.data_ptr() for a in tensors]
                + [out.data_ptr(), None if save is None else save.data_ptr()])
        LAUNCHES += 1
    return out


def _backward(tensors, save, g):
    """One launch of ``gp_backward_kernel``: the cotangents of ``y`` and
    ``sigma2`` (W, E, P) and of ``c`` (W, E) for the cotangent ``g`` of the
    ln-likelihoods, from the forward's inputs and its ``save``."""
    global BACKWARD_LAUNCHES
    y = tensors[0]
    gy, gsigma2 = torch.empty_like(y), torch.empty_like(y)
    gc = torch.empty(y.shape[:2], dtype=y.dtype, device=y.device)
    if y.numel():
        g = g.to(y.dtype).contiguous()
        _launch(1, y, [a.data_ptr() for a in tensors]
                + [save.data_ptr(), g.data_ptr(), gy.data_ptr(),
                   gsigma2.data_ptr(), gc.data_ptr()])
        BACKWARD_LAUNCHES += 1
    else:
        gc.zero_()
    return gy, gsigma2, gc


def _recursion_kernel(t, y, yerr, sigma2, c, reset, mask):
    """K3 on the prepared inputs (:func:`_prepare`'s shapes), outside
    autograd: one launch of ``gp_kernel``, no gradient.  float32 or
    float64 CUDA tensors of one dtype."""
    return _forward(_checked(t, y, yerr, sigma2, c, reset, mask))


class _Recursion(torch.autograd.Function):
    """K3 on the card, from the prepared inputs ``t``, ``yerr``, ``mask``
    (E, P), ``y``, ``sigma2``, ``reset`` (W, E, P) and ``c`` (W, E): the
    forward kernel (which makes the angles and the decay itself); for the
    cotangents of ``y``, ``sigma2`` and ``c``, the reverse kernel.  One
    launch each, one thread per (walker, eclipse) series.  The forward
    keeps the per-point state (5 x P x series numbers) only when one of
    those three requires a gradient; ``t`` and ``yerr`` get none."""

    @staticmethod
    def forward(ctx, t, y, yerr, sigma2, c, reset, mask):
        tensors = _checked(t, y, yerr, sigma2, c, reset, mask)
        W, E, P = y.shape
        save = None
        if any(ctx.needs_input_grad[i] for i in (1, 3, 4)):
            save = torch.empty((5, P, W * E), dtype=y.dtype, device=y.device)
        out = _forward(tensors, save)
        if save is not None:
            ctx.save_for_backward(*tensors, save)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *tensors, save = ctx.saved_tensors
        gy, gsigma2, gc = _backward(tensors, save, g)
        need = ctx.needs_input_grad
        return (None, gy if need[1] else None, None,
                gsigma2 if need[3] else None, gc if need[4] else None,
                None, None)


def segmented_matern32_kernel(t, y, yerr, sigma2, c, reset=None, mask=None):
    """:func:`segmented_matern32_ln_like` through K3: one launch for all
    series, and one of the reverse kernel on a backward pass.  float32 or
    float64 CUDA tensors (raises otherwise); tensors on the CPU take the
    plain version.  ``t`` and ``yerr`` get no gradient (raises if one
    asks)."""
    if y.device.type == "cpu":
        return segmented_matern32_plain(t, y, yerr, sigma2, c, reset, mask)
    if y.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {y.device}")
    if y.dim() != 3:
        raise ValueError(f"K3: y has shape {tuple(y.shape)}, expected "
                         "(W, E, P)")
    for name, a in (("t", t), ("yerr", yerr)):
        if isinstance(a, torch.Tensor) and a.requires_grad \
                and torch.is_grad_enabled():
            raise ValueError(f"K3 has no gradient for {name}")
    t, yerr, sigma2, c, reset, mask = _prepare(t, y, yerr, sigma2, c, reset,
                                               mask)
    return _Recursion.apply(t, y, yerr, sigma2, c, reset, mask)


def segmented_matern32_ln_like(t, y, yerr, sigma2, c, reset=None, mask=None):
    """ln N(y | 0, K + diag(yerr^2)) with the Matern-3/2 kernel, O(P) per
    series; returns (W, E).

    ``reset`` is True where the recursion restarts (the first point of a
    segment); ``mask`` is False for padded points, which contribute
    nothing and do not advance the recursion.

    Routing: CUDA tensors go to the kernel K3, whose backward is its
    reverse kernel (a build or launch failure raises); only tensors on
    the CPU, where no kernel exists, take the plain loop, which autograd
    differentiates as it stands."""
    return segmented_matern32_kernel(t, y, yerr, sigma2, c, reset=reset,
                                     mask=mask)


def matern32_gp_ln_like(t, y, yerr, sigma, rho, mask=None):
    """Stationary Matern-3/2 GP marginal likelihood: ``sigma`` and
    ``rho`` (W, E) amplitudes and timescales."""
    c = math.sqrt(3.0) / rho
    return segmented_matern32_ln_like(t, y, yerr, (sigma * sigma)[..., None],
                                      c, mask=mask)


def matern32_cov(t, sigma, rho):
    """Dense Matern-3/2 covariance of one series ``t`` (P,) (test oracle;
    the eps-embedded form the recursion uses)."""
    tau = (t[:, None] - t[None, :]).abs()
    c = math.sqrt(3.0) / rho
    d = _EPS * c
    a = sigma * sigma
    b = a / _EPS
    return torch.exp(-c * tau) * (a * torch.cos(d * tau)
                                  + b * torch.sin(d * tau))
