"""The core geometry's bisections K4-K6: CUDA kernel wrappers.

K4 (``findi_kernel``), K5 (``xl1_kernel``) and K6 (``lobe_radius_kernel``)
in ``csrc/roche.cu`` are kernels of the port's own: on the TPU each solve
was an XLA ``lax.fori_loop`` (``lfit_python_tpu/roche/geometry.py``:
``findi`` :283-325, ``xl1`` :114-143, ``lobe_radius`` :1140-1176).  Their
plain versions are the iteration loops of :mod:`..roche.geometry`
(``_findi_loop``, ``_xl1_loop``, ``_lobe_loop``), which
:func:`~..roche.geometry.findi`, :func:`~..roche.geometry.xl1` and
:func:`~..roche.geometry.lobe_radius` run under ``no_grad`` on CPU
tensors and replace by one call here on CUDA tensors; the
implicit-function-theorem tangents stay in PyTorch.  Each kernel runs a
group of 2^d lanes per solve that evaluates the bisection's next d levels
at once (a k-section) and walks them from one ballot, d fixed when
``roche.cu`` is built (``FINDI_DEPTH``, ``XL1_DEPTH``, ``LOBE_DEPTH``).
Each repeats its loop's operations in order, so it gives the loop's
bits.

Every wrapper takes tensors of one shape, one float dtype and one device,
contiguous, and returns the solution in that shape.  CUDA tensors launch
the kernel on the current stream (no host sync; raises on anything the
kernel cannot take, or if the launch fails); CPU tensors, where no kernel
exists, run the plain loop.
"""

from __future__ import annotations

import ctypes

import torch

from ..roche import geometry as plain

__all__ = ["findi_kernel", "xl1_kernel", "lobe_radius_kernel",
           "FINDI_LAUNCHES", "XL1_LAUNCHES", "LOBE_LAUNCHES"]

# number of launches of each kernel in this process
FINDI_LAUNCHES = 0
XL1_LAUNCHES = 0
LOBE_LAUNCHES = 0

_fns = None


def _kernel():
    """{name: launcher} of the built ``roche.cu``."""
    global _fns
    if _fns is None:
        from ._build import load_library

        lib = load_library("roche")
        fns = {"findi": (lib.findi_launch, 4), "xl1": (lib.xl1_launch, 1),
               "lobe_radius": (lib.lobe_radius_launch, 6)}
        for fn, n_in in fns.values():
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (n_in + 1)
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _fns = {name: fn for name, (fn, _) in fns.items()}
    return _fns


def _checked(tag, names, ts):
    """True where ``ts`` lie on the CPU; raises unless they are float32 or
    float64 tensors of one dtype, shape and device, contiguous, on the CPU
    or a CUDA card."""
    first = ts[0]
    for name, t in zip(names, ts):
        if t.dtype not in (torch.float32, torch.float64) \
                or t.dtype != first.dtype:
            raise TypeError(f"{tag} takes float32 or float64 of one dtype, "
                            f"got {name}: {t.dtype}, {names[0]}: "
                            f"{first.dtype}")
        if t.device != first.device:
            raise ValueError(f"{tag}: {name} on {t.device}, {names[0]} on "
                             f"{first.device}")
        if t.shape != first.shape:
            raise ValueError(f"{tag}: {name} has shape {tuple(t.shape)}, "
                             f"{names[0]} {tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{tag}: {name} is not contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{tag} runs on CUDA tensors, got {first.device}")
    return first.device.type == "cpu"


def _launch(name, ts, iters):
    """One launch of ``name``'s kernel on the checked CUDA tensors ``ts``:
    the output, or raises.  Counts nothing when there is nothing to
    solve."""
    out = torch.empty_like(ts[0])
    n = out.numel()
    if n == 0:
        return out, False
    if n > 1 << 30:
        raise ValueError(f"{name}_kernel takes at most 2**30 solves, got {n}")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()[name](int(out.dtype == torch.float64),
                              *(t.data_ptr() for t in ts), out.data_ptr(), n,
                              int(iters), stream)
    if err != 0:
        raise RuntimeError(f"{name}_kernel launch failed: cudaError {err}")
    return out, True


def findi_kernel(q, half_w, x1, pl1):
    """K4: the inclination (deg) whose origin clearance at phase
    ``half_w`` is zero, by :func:`~..roche.geometry._findi_loop`'s
    bisection; NaN where even i = 90 gives no eclipse that wide."""
    global FINDI_LAUNCHES
    args = (q, half_w, x1, pl1)
    if _checked("K4", ("q", "half_w", "x1", "pl1"), args):
        return plain._findi_loop(*args)
    out, launched = _launch("findi", args, plain._FINDI_ITERS)
    FINDI_LAUNCHES += launched
    return out


def xl1_kernel(q):
    """K5: the L1 point's distance from the primary, by
    :func:`~..roche.geometry._xl1_loop`'s bisection, in groups of
    2^``XL1_DEPTH`` lanes a solve."""
    global XL1_LAUNCHES
    if _checked("K5", ("q",), (q,)):
        return plain._xl1_loop(q)
    out, launched = _launch("xl1", (q,), plain._XL1_ITERS)
    XL1_LAUNCHES += launched
    return out


def lobe_radius_kernel(q, x1, pl1, dx, dy, dz):
    """K6: the Roche lobe's radius from the donor's centre along the unit
    direction (``dx``, ``dy``, ``dz``), by
    :func:`~..roche.geometry._lobe_loop`'s bisection."""
    global LOBE_LAUNCHES
    args = (q, x1, pl1, dx, dy, dz)
    if _checked("K6", ("q", "x1", "pl1", "dx", "dy", "dz"), args):
        return plain._lobe_loop(*args)
    out, launched = _launch("lobe_radius", args, plain._LOBE_ITERS)
    LOBE_LAUNCHES += launched
    return out
