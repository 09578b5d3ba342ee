"""The contact-interval solver K1: CUDA kernel wrappers and plain version.

Port of ``lfit_python_tpu/ops/pallas_contacts.py``, and of the JAX
package's float64 and mixed-precision contact solves
(``lfit_python_tpu/roche/geometry.py::_contact_interval_impl``).  Rows are
flattened (walker, eclipse) pairs; every function here takes

    q, incl, x1, pl1, r_ins : (R,)  per-row scalars (mass ratio,
                                    inclination in degrees, L1 distance,
                                    L1 potential, inscribed radius)
    px, py                  : (R, N) orbital-plane element coordinates

and returns ``(phi_in, phi_out, eclipsed)``, each (R, N).  The
mixed-precision mode takes two more: ``precise``, the rows' (q, incl, x1,
pl1) solved in float64 (each (R,)), and ``p64``, the elements' (px, py) in
float64 (each (R, N)).

Routing (:func:`element_intervals`): float32 and float64 go to
:func:`element_intervals_kernel`, float32 with ``precise`` to
:func:`element_intervals_mixed_kernel`.  Each wrapper launches an
instantiation of the hand-written CUDA kernel ``csrc/contacts.cu`` for
CUDA tensors (``contacts_kernel<float>``, ``contacts_kernel<double>``,
``contacts_mixed_kernel``) and raises on anything it cannot take; only for
tensors on the CPU, where no kernel exists, does it run the plain version
:func:`element_intervals_plain`.

:func:`element_intervals_diff` is the differentiable form (port of
``contacts_op_diff``, ``pallas_contacts.py:448-494``): the same forward,
and a backward that takes the implicit-function-theorem gradient of the
contact phases at the solved roots of ``roche.geometry._edge_residual``.
The backward of both dtypes goes to :func:`contact_backward_kernel`,
which launches the hand-written CUDA kernel ``csrc/contacts_backward.cu``
(a reverse sweep of the residual, one pass in float32 and in float64) for
CUDA tensors and raises on a build or launch failure; only tensors on the
CPU take :func:`_contact_backward_plain`, autograd on the residual in
plain PyTorch, as the reference's backward is plain XLA.  The
mixed-precision mode has no gradient, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..roche.geometry import _edge_residual, contact_interval

__all__ = ["element_intervals", "element_intervals_diff",
           "element_intervals_kernel", "element_intervals_mixed_kernel",
           "element_intervals_plain", "contact_backward_kernel", "LAUNCHES",
           "F64_LAUNCHES", "MIXED_LAUNCHES", "BACKWARD_CALLS",
           "BACKWARD_LAUNCHES"]

# launches made in this process of K1 in float32 (element_intervals_kernel
# on float32 tensors), in float64, and in mixed precision
# (element_intervals_mixed_kernel)
LAUNCHES = 0
F64_LAUNCHES = 0
MIXED_LAUNCHES = 0
# number of backward passes of element_intervals_diff in this process
BACKWARD_CALLS = 0
# number of launches of K1's backward kernel in this process
BACKWARD_LAUNCHES = 0

_fn = None
_mixed_fn = None
_bwd_fn = None


def element_intervals_plain(q, incl, px, py, x1, pl1, r_ins, precise=None,
                            p64=None):
    """Plain PyTorch contact intervals (``roche.geometry.contact_interval``
    broadcast over rows and elements), in the inputs' dtype; in mixed
    precision with ``precise`` and ``p64``."""
    col = (lambda a: a[:, None])
    if precise is not None:
        precise = tuple(col(a) for a in precise)
    return contact_interval(col(q), col(incl), px, py, col(x1), col(pl1),
                            col(r_ins), precise=precise, p64=p64)


def _library(name, entry, argtypes):
    """The C entry point ``entry`` of ``csrc/<name>.cu`` (built on first
    use), typed with ``argtypes`` and an int cudaError return."""
    from ._build import load_library

    fn = getattr(load_library(name), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn():
    global _fn
    if _fn is None:
        _fn = _library("contacts", "contacts_launch",
                       [ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _fn


def _mixed_kernel_fn():
    global _mixed_fn
    if _mixed_fn is None:
        _mixed_fn = _library("contacts", "contacts_mixed_launch",
                             [ctypes.c_void_p] * 9
                             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return _mixed_fn


def _check_inputs(tag, px, named):
    """Raise unless every ``(name, tensor, shape, dtype)`` of ``named``
    lies on ``px``'s CUDA device with that shape and dtype; returns the
    tensors, contiguous."""
    if px.device.type != "cuda":
        raise ValueError(f"{tag} runs on CUDA tensors, got {px.device}")
    out = []
    for name, t, shape, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{tag} takes {dtype} {name}, got {t.dtype}")
        if t.device != px.device:
            raise ValueError(f"{tag}: {name} on {t.device}, px on "
                             f"{px.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{tag}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        out.append(t.contiguous())
    return out


def _row_scalars(q, incl, x1, pl1, r_ins):
    """(R, 6) per-row scalars [mu, sin i, cos i, 1 - x1, Phi_L1, r_ins],
    with the plain version's setup arithmetic."""
    i_rad = torch.deg2rad(incl)
    return torch.stack([q / (1.0 + q), torch.sin(i_rad), torch.cos(i_rad),
                        1.0 - x1, pl1, r_ins], dim=-1).contiguous()


def element_intervals_kernel(q, incl, px, py, x1, pl1, r_ins):
    """K1 on the card: one launch of ``contacts_kernel<float>`` or
    ``<double>`` for all rows.  float32 or float64 CUDA tensors of one
    dtype, px and py contiguous (raises otherwise); tensors on the CPU
    take the plain version."""
    global LAUNCHES, F64_LAUNCHES
    if px.device.type == "cpu":
        return element_intervals_plain(q, incl, px, py, x1, pl1, r_ins)
    rows, n = px.shape
    dt = px.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64, got px: {dt}")
    for name, t in (("px", px), ("py", py)):
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")
    q, incl, x1, pl1, r_ins, px, py = _check_inputs("K1", px, (
        ("q", q, (rows,), dt), ("incl", incl, (rows,), dt),
        ("x1", x1, (rows,), dt), ("pl1", pl1, (rows,), dt),
        ("r_ins", r_ins, (rows,), dt), ("px", px, (rows, n), dt),
        ("py", py, (rows, n), dt)))
    scal = _row_scalars(q, incl, x1, pl1, r_ins)
    phi_in = torch.empty((rows, n), dtype=dt, device=px.device)
    phi_out = torch.empty_like(phi_in)
    eclipsed = torch.empty((rows, n), dtype=torch.bool, device=px.device)
    if rows == 0 or n == 0:
        return phi_in, phi_out, eclipsed
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(int(dt == torch.float64), scal.data_ptr(),
                           px.data_ptr(), py.data_ptr(), phi_in.data_ptr(),
                           phi_out.data_ptr(), eclipsed.data_ptr(), rows, n,
                           stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    if dt == torch.float64:
        F64_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return phi_in, phi_out, eclipsed


def element_intervals_mixed_kernel(q, incl, px, py, x1, pl1, r_ins, precise,
                                   p64):
    """K1 in mixed precision on the card: one launch of
    ``contacts_mixed_kernel`` for all rows.  float32 CUDA tensors, with
    ``precise`` = the rows' (q, incl, x1, pl1) and ``p64`` = (px, py) in
    float64 on the same device (raises otherwise); tensors on the CPU
    take the plain version."""
    global MIXED_LAUNCHES
    if px.device.type == "cpu":
        return element_intervals_plain(q, incl, px, py, x1, pl1, r_ins,
                                       precise, p64)
    rows, n = px.shape
    f32, f64 = torch.float32, torch.float64
    q64, incl64, _, pl164 = precise
    (q, incl, x1, pl1, r_ins, px, py, q64, incl64, pl164, px64,
     py64) = _check_inputs("K1 (mixed precision)", px, (
        ("q", q, (rows,), f32), ("incl", incl, (rows,), f32),
        ("x1", x1, (rows,), f32), ("pl1", pl1, (rows,), f32),
        ("r_ins", r_ins, (rows,), f32), ("px", px, (rows, n), f32),
        ("py", py, (rows, n), f32), ("q64", q64, (rows,), f64),
        ("incl64", incl64, (rows,), f64), ("pl164", pl164, (rows,), f64),
        ("px64", p64[0], (rows, n), f64), ("py64", p64[1], (rows, n), f64)))
    scal = _row_scalars(q, incl, x1, pl1, r_ins)
    # the float64 scalars c = Phi - Phi_L1 is evaluated from
    scal64 = torch.stack([q64 / (1.0 + q64),
                          torch.sin(torch.deg2rad(incl64)), pl164],
                         dim=-1).contiguous()
    phi_in = torch.empty((rows, n), dtype=f32, device=px.device)
    phi_out = torch.empty_like(phi_in)
    eclipsed = torch.empty((rows, n), dtype=torch.bool, device=px.device)
    if rows == 0 or n == 0:
        return phi_in, phi_out, eclipsed
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _mixed_kernel_fn()(
            scal.data_ptr(), scal64.data_ptr(), px.data_ptr(), py.data_ptr(),
            px64.data_ptr(), py64.data_ptr(), phi_in.data_ptr(),
            phi_out.data_ptr(), eclipsed.data_ptr(), rows, n, stream)
    if err != 0:
        raise RuntimeError(f"K1 (mixed precision) launch failed: cudaError "
                           f"{err}")
    MIXED_LAUNCHES += 1
    return phi_in, phi_out, eclipsed


def element_intervals(q, incl, px, py, x1, pl1, r_ins, precise=None,
                      p64=None):
    """Contact intervals by the dtype rule: float32 and float64 -> K1 in
    that dtype; float32 with ``precise`` and ``p64`` -> K1 in mixed
    precision."""
    if precise is not None:
        return element_intervals_mixed_kernel(q, incl, px, py, x1, pl1,
                                              r_ins, precise, p64)
    return element_intervals_kernel(q, incl, px, py, x1, pl1, r_ins)


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
        _bwd_fn = _library("contacts_backward", "contacts_backward_launch",
                           [ctypes.c_int] + [ctypes.c_void_p] * 13
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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
    py, x1, pl1); the forward is :func:`element_intervals` (K1 in the
    inputs' dtype on the card)."""
    return _ContactIntervals.apply(q, incl, px, py, x1, pl1, r_ins)
