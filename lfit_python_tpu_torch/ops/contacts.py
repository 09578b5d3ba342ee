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
"""

from __future__ import annotations

import ctypes

import torch

from ..roche.geometry import contact_interval

__all__ = ["element_intervals", "element_intervals_kernel",
           "element_intervals_plain", "LAUNCHES"]

# number of K1 launches made by element_intervals_kernel in this process
LAUNCHES = 0

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
