"""The flux curves' two sweeps K7 and K8 and their backward kernels: CUDA
kernel wrappers.

K7 (``element_curve_kernel`` in ``csrc/sweeps.cu``) sums the visibility
of every disc or spot element at every phase, weighted, over the elements:
the curve of :func:`~..models.components.element_flux_curve`; K8
(``donor_sum_kernel``) sums the donor's limb-darkened projected areas:
:func:`~..models.components.donor_flux`.  Each has a backward kernel
(``element_curve_backward_kernel``, ``donor_sum_backward_kernel``) that
recomputes each term's derivative rather than storing the (rows, P, N)
terms.  They are kernels of the port's own: on the TPU each sweep is an
XLA fusion feeding a reduction (``lfit_python_tpu/models/components.py``:
``element_flux_curve`` :346-378, ``donor_flux`` :598-626).  Their plain
versions are :func:`~..models.components._element_curve_plain` and
:func:`~..models.components._donor_sum_plain`, chunked (rows, P, N) chains
that sum over the elements in the kernels' order (``_slab_sum``), so each
forward kernel gives its plain version's bits; the plain backward is
autograd on the plain forward.

The ``*_kernel`` wrappers take contiguous tensors of one device and one
float dtype (float32 or float64; ``ecl`` bool) in the shapes each names.
CUDA tensors launch the kernel on the current stream (no host sync; raises
on anything the kernel cannot take, or if the launch fails); CPU tensors,
where no kernel exists, run the plain version.  :func:`element_curve` and
:func:`donor_sum` are the differentiable entry points: on the card an
``autograd.Function`` over the forward and backward kernels (which saves
nothing under ``torch.inference_mode``), on the CPU the plain forward under
autograd.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from ..models import components as plain

__all__ = ["element_curve", "element_curve_kernel",
           "element_curve_backward_kernel", "donor_sum", "donor_sum_kernel",
           "donor_sum_backward_kernel", "CURVE_LAUNCHES",
           "CURVE_BACKWARD_LAUNCHES", "DONOR_LAUNCHES",
           "DONOR_BACKWARD_LAUNCHES"]

# number of launches of each kernel in this process
CURVE_LAUNCHES = 0
CURVE_BACKWARD_LAUNCHES = 0
DONOR_LAUNCHES = 0
DONOR_BACKWARD_LAUNCHES = 0

_fns = None


def _kernel():
    """{name: launcher} of the built ``sweeps.cu``."""
    global _fns
    if _fns is None:
        from ._build import load_library

        lib = load_library("sweeps")
        i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
        fns = {"curve": (lib.element_curve_launch,
                         [i, i] + [p] * 7 + [i] * 3 + [p]),
               "curve_backward": (lib.element_curve_backward_launch,
                                  [i, i] + [p] * 11 + [i] * 3 + [p]),
               "donor": (lib.donor_sum_launch,
                         [i] + [p] * 3 + [d, d, p] + [i] * 4 + [p]),
               "donor_backward": (lib.donor_sum_backward_launch,
                                  [i] + [p] * 3 + [d, d] + [p] * 4
                                  + [i] * 4 + [p])}
        for fn, types in fns.values():
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _fns = {name: fn for name, (fn, _) in fns.items()}
    return _fns


def _checked(tag, floats, flags=()):
    """True where the tensors lie on the CPU; raises unless ``floats``
    ((name, tensor, shape) with None for a tensor that is not given) are
    float32 or float64 of one dtype and ``flags`` bool, each of its shape,
    all contiguous and on one device, the CPU or a CUDA card."""
    given = [(n, t, s, False) for n, t, s in floats if t is not None]
    first_name, first = given[0][:2]
    for name, t, shape, flag in given + [(*f, True) for f in flags]:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{tag}: {name} is not a tensor")
        want = torch.bool if flag else first.dtype
        if t.dtype != want or want not in (torch.bool, torch.float32,
                                           torch.float64):
            raise TypeError(f"{tag} takes float32 or float64 of one dtype "
                            f"and bool flags, got {name}: {t.dtype}, "
                            f"{first_name}: {first.dtype}")
        if t.device != first.device:
            raise ValueError(f"{tag}: {name} on {t.device}, {first_name} on "
                             f"{first.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{tag}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{tag}: {name} is not contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{tag} runs on CUDA tensors, got {first.device}")
    return first.device.type == "cpu"


def _curve_checked(tag, ph, wd, pin, pout, ecl, w, g=None):
    if not isinstance(ph, torch.Tensor) or ph.dim() != 2 \
            or not isinstance(pin, torch.Tensor) or pin.dim() != 2:
        raise ValueError(f"{tag} takes phases (R, P) and intervals (R, N)")
    rp, rn = ph.shape, (ph.shape[0], pin.shape[1])
    return _checked(tag, [("ph", ph, rp), ("wd", wd, rp), ("pin", pin, rn),
                          ("pout", pout, rn), ("w", w, rn), ("g", g, rp)],
                    [("ecl", ecl, rn)])


def _donor_checked(tag, e, nrm, areas, ulimb, g=None):
    if not isinstance(e, torch.Tensor) or e.dim() != 3 \
            or not isinstance(areas, torch.Tensor) or areas.dim() != 2:
        raise ValueError(f"{tag} takes directions (R, P, 3) and areas "
                         "(G, N)")
    if not isinstance(ulimb, numbers.Real) or isinstance(ulimb, bool):
        raise TypeError(f"{tag}: the limb darkening is a number, got "
                        f"{type(ulimb).__name__}")
    (R, P), (G, N) = e.shape[:2], areas.shape
    if (G == 0) != (R == 0) or (G and R % G):
        raise ValueError(f"{tag}: {R} rows do not share {G} grids evenly")
    return _checked(tag, [("e", e, (R, P, 3)), ("nrm", nrm, (G, N, 3)),
                          ("areas", areas, (G, N)), ("g", g, (R, P))])


def _launch(name, ref, *args):
    """One launch of ``name``'s kernel with the launcher's arguments
    ``args`` (tensors by pointer); raises if it fails."""
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()[name](
            int(ref.dtype == torch.float64),
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if err != 0:
        raise RuntimeError(f"the {name} sweep kernel's launch failed: "
                           f"cudaError {err}")


def _sizes_fit(R, P, N):
    if R * P >= 1 << 31 or 3 * R * N >= 1 << 31:
        raise ValueError(f"the sweep kernels take fewer than 2**31 outputs "
                         f"and inputs, got {R} rows x {P} phases x {N} "
                         f"elements")


def element_curve_kernel(ph, wd, pin, pout, ecl, w):
    """K7: sum over n of the visibility of element n (interval ``pin``,
    ``pout``, ``ecl``) at phase ``ph`` (over the exposure ``wd``, or at an
    instant where it is None) times its weight ``w``, per row: (R, P)."""
    global CURVE_LAUNCHES
    if _curve_checked("K7", ph, wd, pin, pout, ecl, w):
        return plain._element_curve_plain(ph, wd, pin, pout, ecl, w)
    (R, P), N = ph.shape, pin.shape[1]
    out = torch.empty_like(ph)
    if out.numel() == 0:
        return out
    _sizes_fit(R, P, N)
    _launch("curve", ph, int(wd is not None), ph, wd, pin, pout, ecl, w,
            out, R, P, N)
    CURVE_LAUNCHES += 1
    return out


def _curve_backward_plain(ph, wd, pin, pout, ecl, w, g):
    """Autograd on :func:`~..models.components._element_curve_plain`."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (ph, pin, pout, w)]
        out = plain._element_curve_plain(leaves[0], wd, leaves[1],
                                         leaves[2], ecl, leaves[3])
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    if wd is None:
        return None, None, None, grads[3]
    return tuple(torch.zeros_like(a) if d is None else d
                 for a, d in zip(leaves, grads))


def element_curve_backward_kernel(ph, wd, pin, pout, ecl, w, g):
    """K7's backward kernel: the cotangents (d ph, d pin, d pout, d w) of
    :func:`element_curve_kernel`'s inputs for the cotangent ``g`` (R, P)
    of its output, as autograd takes them on the plain version; without
    widths the visibility is an indicator, and the first three are
    None."""
    global CURVE_BACKWARD_LAUNCHES
    if _curve_checked("K7's backward", ph, wd, pin, pout, ecl, w, g):
        return _curve_backward_plain(ph, wd, pin, pout, ecl, w, g)
    (R, P), N = ph.shape, pin.shape[1]
    g_w = torch.empty_like(w)
    g_ph, g_pin, g_pout = ((None,) * 3 if wd is None else
                           (torch.empty_like(ph), torch.empty_like(pin),
                            torch.empty_like(pout)))
    if ph.numel() == 0 or g_w.numel() == 0:
        return tuple(None if a is None else a.zero_()
                     for a in (g_ph, g_pin, g_pout, g_w))
    _sizes_fit(R, P, N)
    _launch("curve_backward", ph, int(wd is not None), ph, wd, pin, pout,
            ecl, w, g, g_ph, g_pin, g_pout, g_w, R, P, N)
    CURVE_BACKWARD_LAUNCHES += 1
    return g_ph, g_pin, g_pout, g_w


class _Curve(torch.autograd.Function):
    """K7 on the card, and K7's backward kernel for the cotangents of
    ``ph``, ``pin``, ``pout`` and ``w`` (``wd`` and ``ecl`` get none).
    Saves its inputs only when one of those requires a gradient."""

    @staticmethod
    def forward(ctx, ph, wd, pin, pout, ecl, w):
        out = element_curve_kernel(ph, wd, pin, pout, ecl, w)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(ph, wd, pin, pout, ecl, w)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ph, wd, pin, pout, ecl, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        if wd is None and not need[5]:
            return (None,) * 6
        g_ph, g_pin, g_pout, g_w = element_curve_backward_kernel(
            ph, wd, pin, pout, ecl, w, g.contiguous())
        return (g_ph if need[0] else None, None,
                g_pin if need[2] else None, g_pout if need[3] else None,
                None, g_w if need[5] else None)


def element_curve(ph, wd, pin, pout, ecl, w):
    """:func:`element_curve_kernel`, differentiable in ``ph``, ``pin``,
    ``pout`` and ``w`` (without widths in ``w`` alone: the indicator's
    derivative is 0): through the ``autograd.Function`` of K7 and its
    backward kernel on CUDA tensors, the plain version under autograd on
    the CPU.  The exposure widths ``wd`` are data: raises if they require
    a gradient."""
    if wd is not None and wd.requires_grad and torch.is_grad_enabled():
        raise ValueError("K7 has no gradient for the exposure widths")
    if _curve_checked("K7", ph, wd, pin, pout, ecl, w):
        return plain._element_curve_plain(ph, wd, pin, pout, ecl, w)
    return _Curve.apply(ph, wd, pin, pout, ecl, w)


def donor_sum_kernel(e, nrm, areas, ulimb):
    """K8: sum over n of area[n] * mu (1 - ulimb + ulimb mu), mu = max(e .
    nrm[n], 0), for the direction ``e`` (R, P, 3) of each row and phase
    against the grid (``nrm`` (G, N, 3), ``areas`` (G, N)) the row shares
    with R / G - 1 neighbours (row r takes grid r // (R / G)): (R, P)."""
    global DONOR_LAUNCHES
    if _donor_checked("K8", e, nrm, areas, ulimb):
        return plain._donor_sum_plain(e, nrm, areas, ulimb)
    (R, P), (G, N) = e.shape[:2], areas.shape
    out = torch.empty((R, P), dtype=e.dtype, device=e.device)
    if out.numel() == 0:
        return out
    _sizes_fit(R, P, N)
    _launch("donor", e, e, nrm, areas, ctypes.c_double(1.0 - ulimb),
            ctypes.c_double(ulimb), out, R, P, N, R // G)
    DONOR_LAUNCHES += 1
    return out


def _donor_backward_plain(e, nrm, areas, ulimb, g):
    """Autograd on :func:`~..models.components._donor_sum_plain`."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (e, nrm, areas)]
        out = plain._donor_sum_plain(*leaves, ulimb)
        return torch.autograd.grad(out, leaves, g)


def donor_sum_backward_kernel(e, nrm, areas, ulimb, g):
    """K8's backward kernel: the cotangents (d e, d nrm, d areas) of
    :func:`donor_sum_kernel`'s inputs for the cotangent ``g`` (R, P) of
    its output, as autograd takes them on the plain version; a grid's
    summed over the rows that share it."""
    global DONOR_BACKWARD_LAUNCHES
    if _donor_checked("K8's backward", e, nrm, areas, ulimb, g):
        return _donor_backward_plain(e, nrm, areas, ulimb, g)
    (R, P), (G, N) = e.shape[:2], areas.shape
    out = (torch.empty_like(e), torch.empty_like(nrm),
           torch.empty_like(areas))
    if e.numel() == 0 or areas.numel() == 0:
        return tuple(a.zero_() for a in out)
    _sizes_fit(R, P, N)
    _launch("donor_backward", e, e, nrm, areas, ctypes.c_double(1.0 - ulimb),
            ctypes.c_double(ulimb), g, *out, R, P, N, R // G)
    DONOR_BACKWARD_LAUNCHES += 1
    return out


class _Donor(torch.autograd.Function):
    """K8 on the card, and K8's backward kernel for the cotangents of
    ``e``, ``nrm`` and ``areas``.  Saves its inputs only when one of them
    requires a gradient."""

    @staticmethod
    def forward(ctx, e, nrm, areas, ulimb):
        out = donor_sum_kernel(e, nrm, areas, ulimb)
        ctx.ulimb = ulimb
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(e, nrm, areas)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        e, nrm, areas = ctx.saved_tensors
        grads = donor_sum_backward_kernel(e, nrm, areas, ctx.ulimb,
                                          g.contiguous())
        return (*(d if need else None
                  for d, need in zip(grads, ctx.needs_input_grad)), None)


def donor_sum(e, nrm, areas, ulimb):
    """:func:`donor_sum_kernel`, differentiable in ``e``, ``nrm`` and
    ``areas``: through the ``autograd.Function`` of K8 and its backward
    kernel on CUDA tensors, the plain version under autograd on the
    CPU.  ``ulimb`` is a number (the model's configuration)."""
    if _donor_checked("K8", e, nrm, areas, ulimb):
        return plain._donor_sum_plain(e, nrm, areas, ulimb)
    return _Donor.apply(e, nrm, areas, ulimb)
