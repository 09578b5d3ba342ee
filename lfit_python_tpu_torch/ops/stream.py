"""The gas-stream scan K2: CUDA kernel wrapper, and the differentiable
stream impacts the posterior calls.

K2 (``csrc/stream.cu``) is a kernel of the port's own: on the TPU the
scan was an XLA ``lax.scan`` with a ``custom_jvp``
(``lfit_python_tpu/roche/stream.py:140-325``).  Its plain version is
``roche/stream.py`` (:func:`~..roche.stream.stream_impacts` and
:func:`~..roche.stream.stream_impacts_sens`).  Every function here takes

    q, x1 : (W,)    mass ratio, L1 distance per walker
    rd    : (W, E)  disc radii whose first stream crossings are wanted

and returns (W, E, 3) impact points (z = 0); with sensitivities also
d(impact)/dq at fixed x0, d(impact)/dx0 and d(impact)/d rdisc_e, each
(W, E, 3).

:func:`stream_impacts_kernel` launches K2 for CUDA tensors of either
float dtype and raises on anything it cannot take; only for tensors on
the CPU, where no kernel exists, does it run the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..roche import stream as plain
from ..roche.geometry import _recording, xl1

__all__ = ["stream_impacts", "stream_impacts_kernel", "LAUNCHES",
           "SENS_LAUNCHES"]

# number of K2 launches in this process, and how many of them also
# integrated the sensitivities
LAUNCHES = 0
SENS_LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load_library

        lib = load_library("stream")
        fn = lib.stream_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.stream_max_e.restype = ctypes.c_int
        _fn = (fn, lib.stream_max_e())
    return _fn


def _plain(q, rd, x1, n_steps, dt, with_sens):
    if with_sens:
        return plain.stream_impacts_sens(q, rd, x1, n_steps, dt)
    return (plain.stream_impacts(q, rd, x1, n_steps, dt),)


def stream_impacts_kernel(q, rd, x1, n_steps=plain._N_STEPS, dt=plain._DT,
                          with_sens=False):
    """K2 on the card: one launch for all walkers.  Returns a tuple:
    (impacts,) or, with ``with_sens``, (impacts, jq, jx0, jrd).  float32
    or float64 CUDA tensors of one dtype, contiguous, E up to the
    kernel's maximum (raises otherwise); tensors on the CPU take the
    plain version."""
    global LAUNCHES, SENS_LAUNCHES
    if rd.device.type == "cpu":
        return _plain(q, rd, x1, n_steps, dt, with_sens)
    if rd.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {rd.device}")
    if rd.dim() != 2:
        raise ValueError(f"K2: rd has shape {tuple(rd.shape)}, expected "
                         "(W, E)")
    W, E = rd.shape
    for name, t, shape in (("q", q, (W,)), ("x1", x1, (W,)),
                           ("rd", rd, (W, E))):
        if t.dtype not in (torch.float32, torch.float64) \
                or t.dtype != rd.dtype:
            raise TypeError(f"K2 takes float32 or float64 of one dtype, "
                            f"got {name}: {t.dtype}, rd: {rd.dtype}")
        if t.device != rd.device:
            raise ValueError(f"K2: {name} on {t.device}, rd on {rd.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"K2: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"K2: {name} is not contiguous")
    fn, max_e = _kernel()
    if E > max_e:
        raise ValueError(f"K2 takes at most {max_e} disc radii, got {E}")
    outs = [torch.empty((W, E, 2), dtype=rd.dtype, device=rd.device)
            for _ in range(4 if with_sens else 1)]
    if W and E:
        ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
        with torch.cuda.device(rd.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(int(rd.dtype == torch.float64), q.data_ptr(),
                     x1.data_ptr(), rd.data_ptr(), *ptrs, W, E, int(n_steps),
                     float(dt), int(with_sens), stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: cudaError {err}")
        LAUNCHES += 1
        SENS_LAUNCHES += int(with_sens)
    return tuple(torch.cat([o, torch.zeros_like(o[..., :1])], dim=-1)
                 for o in outs)


class _StreamImpacts(torch.autograd.Function):
    """Impacts whose backward applies the forward sensitivities, the
    transpose of the reference's ``_stream_impacts_jvp``: dq = sum g.jq,
    dx1 = sum g.jx0, drd[e] = sum_k g[e, k] jrd[e, k].  The forward
    integrates the sensitivities only when a gradient is required."""

    @staticmethod
    def forward(ctx, q, rd, x1, n_steps, dt):
        sens = any(ctx.needs_input_grad[:3])
        out = stream_impacts_kernel(q, rd, x1, n_steps, dt, with_sens=sens)
        ctx.save_for_backward(*out[1:])
        return out[0]

    @staticmethod
    def backward(ctx, g):
        jq, jx0, jrd = ctx.saved_tensors
        return ((g * jq).sum(dim=(-2, -1)), (g * jrd).sum(dim=-1),
                (g * jx0).sum(dim=(-2, -1)), None, None)


def stream_impacts(q, rdiscs, xl1_val=None, n_steps=plain._N_STEPS,
                   dt=plain._DT):
    """First stream/disc-rim crossings of E disc radii per walker,
    differentiable in (q, rdiscs, xl1_val): K2 on CUDA tensors, the plain
    loop on the CPU.  ``q``, ``xl1_val``: (W,); ``rdiscs``: (W, E).
    Returns (W, E, 3)."""
    if xl1_val is None:
        xl1_val = xl1(q)
    args = (q.contiguous(), rdiscs.contiguous(), xl1_val.contiguous())
    if _recording(*args):
        return _StreamImpacts.apply(*args, int(n_steps), float(dt))
    return stream_impacts_kernel(*args, n_steps, dt)[0]
