"""The contact-interval solver K1: CUDA kernel wrapper and plain version.

Port of ``lfit_python_tpu/ops/pallas_contacts.py``.  Rows are flattened
(walker, eclipse) pairs; every function here takes

    q, incl, x1, pl1, r_ins : (R,)  per-row scalars (mass ratio,
                                    inclination in degrees, L1 distance,
                                    L1 potential, inscribed radius)
    px, py                  : (R, N) orbital-plane element coordinates

and returns ``(phi_in, phi_out, eclipsed)``, each (R, N).

Routing (:func:`element_intervals`) is a dtype rule, as in the JAX
package: float32 goes to :func:`element_intervals_kernel`, float64 to
:func:`element_intervals_plain`.  The kernel wrapper launches the
hand-written CUDA kernel ``csrc/contacts.cu`` for CUDA tensors and raises
on anything it cannot take; only for tensors on the CPU, where no kernel
exists, does it run the plain version.

:func:`element_intervals_diff` is the differentiable form (port of
``contacts_op_diff``, ``pallas_contacts.py:448-494``): the same forward,
and a backward that takes the implicit-function-theorem gradient of the
contact phases at the solved roots from ``roche.geometry._edge_residual``
in plain PyTorch, as the reference's backward is plain XLA.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..roche.geometry import _edge_residual, contact_interval

__all__ = ["element_intervals", "element_intervals_diff",
           "element_intervals_kernel", "element_intervals_plain",
           "LAUNCHES", "BACKWARD_CALLS"]

# number of K1 launches made by element_intervals_kernel in this process
LAUNCHES = 0
# number of backward passes of element_intervals_diff in this process
BACKWARD_CALLS = 0

_fn = None


def element_intervals_plain(q, incl, px, py, x1, pl1, r_ins):
    """Plain PyTorch contact intervals (``roche.geometry.contact_interval``
    broadcast over rows and elements), in the inputs' dtype."""
    col = (lambda a: a[:, None])
    return contact_interval(col(q), col(incl), px, py, col(x1), col(pl1),
                            col(r_ins))


def _kernel_fn():
    global _fn
    if _fn is None:
        from ._build import load_library

        fn = load_library("contacts").contacts_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def element_intervals_kernel(q, incl, px, py, x1, pl1, r_ins):
    """K1 on the card: one launch for all rows.  float32 CUDA tensors only
    (raises otherwise); tensors on the CPU take the plain version."""
    global LAUNCHES
    if px.device.type == "cpu":
        return element_intervals_plain(q, incl, px, py, x1, pl1, r_ins)
    if px.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {px.device}")
    rows, n = px.shape
    for name, t, shape in (("px", px, (rows, n)), ("py", py, (rows, n)),
                           ("q", q, (rows,)), ("incl", incl, (rows,)),
                           ("x1", x1, (rows,)), ("pl1", pl1, (rows,)),
                           ("r_ins", r_ins, (rows,))):
        if t.dtype != torch.float32:
            raise TypeError(f"K1 takes float32, got {name}: {t.dtype}")
        if t.device != px.device:
            raise ValueError(f"K1: {name} on {t.device}, px on {px.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K1: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("px", px), ("py", py)):
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")
    i_rad = torch.deg2rad(incl)
    # per-row scalars, same arithmetic as the plain version's setup
    scal = torch.stack([q / (1.0 + q), torch.sin(i_rad), torch.cos(i_rad),
                        1.0 - x1, pl1, r_ins], dim=-1).contiguous()
    phi_in = torch.empty((rows, n), dtype=torch.float32, device=px.device)
    phi_out = torch.empty_like(phi_in)
    eclipsed = torch.empty((rows, n), dtype=torch.bool, device=px.device)
    if rows == 0 or n == 0:
        return phi_in, phi_out, eclipsed
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(scal.data_ptr(), px.data_ptr(), py.data_ptr(),
                           phi_in.data_ptr(), phi_out.data_ptr(),
                           eclipsed.data_ptr(), rows, n, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return phi_in, phi_out, eclipsed


def element_intervals(q, incl, px, py, x1, pl1, r_ins):
    """Contact intervals by the dtype rule: float32 -> K1, float64 ->
    the plain version."""
    if px.dtype == torch.float32:
        return element_intervals_kernel(q, incl, px, py, x1, pl1, r_ins)
    return element_intervals_plain(q, incl, px, py, x1, pl1, r_ins)


class _ContactIntervals(torch.autograd.Function):
    """:func:`element_intervals` with IFT gradients.  At a contact root
    phi* of c(phi; theta) = 0, dphi*/dtheta = -(dc/dtheta) / (dc/dphi):
    the backward evaluates the residual at the detached roots of both
    edges at once, takes dc/dphi's value (non-finite coefficients
    zeroed) and the VJP of c in (q, incl, px, py, x1, pl1) by autograd.
    Non-eclipsed elements carry phi_c = atan2(py, 1 - px) / 2 pi and its
    gradient; ``r_ins`` shapes only the bracket and gets none."""

    @staticmethod
    def forward(ctx, q, incl, px, py, x1, pl1, r_ins):
        phi_in, phi_out, ecl = element_intervals(q, incl, px, py, x1, pl1,
                                                 r_ins)
        ctx.mark_non_differentiable(ecl)
        ctx.save_for_backward(q, incl, px, py, x1, pl1, phi_in, phi_out,
                              ecl)
        return phi_in, phi_out, ecl

    @staticmethod
    def backward(ctx, g_in, g_out, _):
        global BACKWARD_CALLS
        BACKWARD_CALLS += 1
        q, incl, px, py, x1, pl1, phi_in, phi_out, ecl = ctx.saved_tensors
        zero = torch.zeros_like(g_in)
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_()
                      for a in (q, incl, px, py, x1, pl1)]
            lq, li, lpx, lpy, lx1, lpl1 = leaves
            row = (lambda a: a[:, None, None])
            phi = torch.stack([phi_in, phi_out], dim=-1)     # (R, N, 2)
            c, dcdphi = _edge_residual(phi, row(lq), row(li), lpx[..., None],
                                       lpy[..., None], row(lx1), row(lpl1))
            coeff = -1.0 / dcdphi.detach()
            coeff = torch.where(torch.isfinite(coeff), coeff,
                                torch.zeros_like(coeff))
            g = torch.stack([torch.where(ecl, g_in, zero),
                             torch.where(ecl, g_out, zero)], dim=-1)
            grads = torch.autograd.grad(c, leaves, g * coeff,
                                        allow_unused=True)
        grads = [torch.zeros_like(a) if d is None else d
                 for a, d in zip(leaves, grads)]
        # never-eclipsed: phi_in = phi_out = atan2(py, 1 - px) / 2 pi
        g_c = torch.where(ecl, zero, g_in + g_out) / (2.0 * math.pi)
        wx = 1.0 - px
        r2 = wx * wx + py * py
        grads[2] = grads[2] + g_c * py / r2
        grads[3] = grads[3] + g_c * wx / r2
        return (*grads, None)


def element_intervals_diff(q, incl, px, py, x1, pl1, r_ins):
    """:func:`element_intervals` carrying IFT gradients to (q, incl, px,
    py, x1, pl1); the forward is :func:`element_intervals` (K1 for
    float32 on the card)."""
    return _ContactIntervals.apply(q, incl, px, py, x1, pl1, r_ins)
