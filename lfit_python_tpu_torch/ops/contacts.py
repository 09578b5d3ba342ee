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
contact phases at the solved roots of ``roche.geometry._edge_residual``.
The backward of both dtypes goes to :func:`contact_backward_kernel`,
which launches the hand-written CUDA kernel ``csrc/contacts_backward.cu``
(a reverse sweep of the residual, one pass in float32 and in float64) for
CUDA tensors and raises on a build or launch failure; only tensors on the
CPU take :func:`_contact_backward_plain`, autograd on the residual in
plain PyTorch, as the reference's backward is plain XLA.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..roche.geometry import _edge_residual, contact_interval

__all__ = ["element_intervals", "element_intervals_diff",
           "element_intervals_kernel", "element_intervals_plain",
           "contact_backward_kernel", "LAUNCHES", "BACKWARD_CALLS",
           "BACKWARD_LAUNCHES"]

# number of K1 launches made by element_intervals_kernel in this process
LAUNCHES = 0
# number of backward passes of element_intervals_diff in this process
BACKWARD_CALLS = 0
# number of launches of K1's backward kernel in this process
BACKWARD_LAUNCHES = 0

_fn = None
_bwd_fn = None


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


def _contact_backward_plain(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl,
                            g_in, g_out):
    """The gradients of the contact phases in (q, incl, px, py, x1, pl1)
    for the cotangents ``g_in``, ``g_out``, in plain PyTorch: the residual
    at the roots of both edges at once, dc/dphi's value (non-finite
    coefficients zeroed) and the VJP of c by autograd."""
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
    return tuple(grads)


def _backward_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        from ._build import load_library

        fn = load_library("contacts_backward").contacts_backward_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def contact_backward_kernel(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl,
                            g_in, g_out):
    """:func:`_contact_backward_plain` on the card: one launch of
    ``contacts_backward_kernel`` for all rows, both edges of an element in
    one thread (a reverse sweep of the residual), the per-row sums in a
    fixed order.  float32 or float64 CUDA tensors of one dtype (raises
    otherwise); tensors on the CPU take the plain version."""
    global BACKWARD_LAUNCHES
    if px.device.type == "cpu":
        return _contact_backward_plain(q, incl, px, py, x1, pl1, phi_in,
                                       phi_out, ecl, g_in, g_out)
    if px.device.type != "cuda":
        raise ValueError(f"K1's backward runs on CUDA tensors, got "
                         f"{px.device}")
    rows, n = px.shape
    named = (("q", q, (rows,)), ("incl", incl, (rows,)), ("x1", x1, (rows,)),
             ("pl1", pl1, (rows,)), ("px", px, (rows, n)),
             ("py", py, (rows, n)), ("phi_in", phi_in, (rows, n)),
             ("phi_out", phi_out, (rows, n)), ("g_in", g_in, (rows, n)),
             ("g_out", g_out, (rows, n)), ("eclipsed", ecl, (rows, n)))
    for name, t, shape in named:
        want = torch.bool if name == "eclipsed" else px.dtype
        if px.dtype not in (torch.float32, torch.float64) or t.dtype != want:
            raise TypeError(f"K1's backward takes float32 or float64 of one "
                            f"dtype and bool flags, got {name}: {t.dtype}, "
                            f"px: {px.dtype}")
        if t.device != px.device:
            raise ValueError(f"K1's backward: {name} on {t.device}, px on "
                             f"{px.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K1's backward: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    (q, incl, x1, pl1, px, py, phi_in, phi_out, g_in, g_out,
     ecl) = (t.contiguous() for _, t, _ in named)
    dpx, dpy = torch.empty_like(px), torch.empty_like(py)
    drow = torch.empty((4, rows), dtype=px.dtype, device=px.device)
    if rows == 0 or n == 0:
        return (drow[0].zero_(), drow[1].zero_(), dpx, dpy, drow[2].zero_(),
                drow[3].zero_())
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_kernel_fn()(
            int(px.dtype == torch.float64), q.data_ptr(), incl.data_ptr(),
            x1.data_ptr(), px.data_ptr(), py.data_ptr(), phi_in.data_ptr(),
            phi_out.data_ptr(), g_in.data_ptr(), g_out.data_ptr(),
            ecl.data_ptr(), dpx.data_ptr(), dpy.data_ptr(), drow.data_ptr(),
            rows, n, stream)
    if err != 0:
        raise RuntimeError(f"K1 backward launch failed: cudaError {err}")
    BACKWARD_LAUNCHES += 1
    return drow[0], drow[1], dpx, dpy, drow[2], drow[3]


class _ContactIntervals(torch.autograd.Function):
    """:func:`element_intervals` with IFT gradients.  At a contact root
    phi* of c(phi; theta) = 0, dphi*/dtheta = -(dc/dtheta) / (dc/dphi):
    the backward evaluates the residual at the detached roots of both
    edges, takes dc/dphi's value (non-finite coefficients zeroed) and the
    VJP of c in (q, incl, px, py, x1, pl1), in either dtype through
    :func:`contact_backward_kernel` (the kernel for CUDA tensors, the
    plain backward for CPU ones).  Non-eclipsed elements carry
    phi_c = atan2(py, 1 - px) / 2 pi and its gradient; ``r_ins`` shapes
    only the bracket and gets none."""

    @staticmethod
    def forward(ctx, q, incl, px, py, x1, pl1, r_ins):
        phi_in, phi_out, ecl = element_intervals(q, incl, px, py, x1, pl1,
                                                 r_ins)
        ctx.mark_non_differentiable(ecl)
        ctx.save_for_backward(q, incl, px, py, x1, pl1, phi_in, phi_out,
                              ecl)
        return phi_in, phi_out, ecl

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_in, g_out, _):
        global BACKWARD_CALLS
        BACKWARD_CALLS += 1
        return (*contact_backward_kernel(*ctx.saved_tensors, g_in, g_out),
                None)


def element_intervals_diff(q, incl, px, py, x1, pl1, r_ins):
    """:func:`element_intervals` carrying IFT gradients to (q, incl, px,
    py, x1, pl1); the forward is :func:`element_intervals` (K1 for
    float32 on the card)."""
    return _ContactIntervals.apply(q, incl, px, py, x1, pl1, r_ins)
