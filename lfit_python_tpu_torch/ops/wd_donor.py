"""The donor grid's radius solve K9 and the white dwarf's sweep K10: CUDA
kernel wrappers.

K9 (``donor_grid_kernel`` in ``csrc/wd_donor.cu``) solves the Roche
lobe's radius along each direction of the donor grid, a block a walker
with its lanes across the directions, and writes its slope and, unless a
gradient is being recorded, the grid's positions, normals and areas:
:func:`~..models.components.donor_grid`.  K10 (``wd_curve_kernel``)
computes the white dwarf's visible fraction at every (row, phase), a
group of lanes a row (a row's parameters read and its phase-independent
terms made once): :func:`~..models.components.wd_flux`; its distance mode
returns the shadow distance and the clearance of
:func:`~..roche.geometry.origin_shadow_distance`.  They are kernels of the
port's own: on the TPU each is an XLA program with its loops fused
(``lfit_python_tpu/models/components.py``: ``donor_grid`` :391-500,
``wd_flux`` :145-191; ``lfit_python_tpu/roche/geometry.py``:
``origin_shadow_distance`` :361-492).  Their plain versions are
:func:`~..models.components._donor_radius_loop` with
:func:`~..models.components._donor_grid_plain`,
:func:`~..models.components._wd_curve_plain` and
:func:`~..roche.geometry._shadow_distance_plain`, whose operations each
kernel repeats in order, so it gives their bits.

CUDA tensors launch the kernel on the current stream (no host sync;
raises on anything the kernel cannot take, or if the launch fails); CPU
tensors, where no kernel exists, run the plain version and count nothing.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models import components as plain
from ..roche import geometry

__all__ = ["donor_grid_kernel", "wd_curve_kernel", "wd_distance_kernel",
           "DONOR_GRID_LAUNCHES", "WD_LAUNCHES"]

# number of launches of each kernel in this process (K10: both modes)
DONOR_GRID_LAUNCHES = 0
WD_LAUNCHES = 0

# most solves or points a launch takes
_MAX_N = 1 << 30
# K10's inputs, in the kernel's order (wd_donor.cu's WD_PH ... WD_RINS)
_WD_INPUTS = ("phases", "q", "incl", "x1", "pl1", "rwd", "ulimb", "r_ins")

_fns = None


def _kernel():
    """{name: launcher} of the built ``wd_donor.cu``."""
    global _fns
    if _fns is None:
        from ._build import load_library

        lib = load_library("wd_donor")
        i, p = ctypes.c_int, ctypes.c_void_p
        fns = {"donor_grid": (lib.donor_grid_launch, [i, p, p, p]),
               "wd_curve": (lib.wd_curve_launch, [i, i, p, p, p])}
        for fn, types in fns.values():
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _fns = {name: fn for name, (fn, _) in fns.items()}
    return _fns


def _on_cpu(tag, ts):
    """True where the tensors ``ts`` ({name: tensor}) lie on the CPU;
    raises unless they are float32 or float64 tensors of one dtype on one
    device, the CPU or a CUDA card."""
    (first_name, first), *_ = ts.items()
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{tag}: {name} is not a tensor")
        if t.dtype not in (torch.float32, torch.float64) \
                or t.dtype != first.dtype:
            raise TypeError(f"{tag} takes float32 or float64 of one dtype, "
                            f"got {name}: {t.dtype}, {first_name}: "
                            f"{first.dtype}")
        if t.device != first.device:
            raise ValueError(f"{tag}: {name} on {t.device}, {first_name} on "
                             f"{first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{tag} runs on CUDA tensors, got {first.device}")
    return first.device.type == "cpu"


def _launch(name, ref, *args):
    """One launch of ``name``'s kernel: the launcher's arguments ``args``
    after the dtype flag (ints and ctypes arrays), on ``ref``'s device and
    current stream; raises if it fails."""
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()[name](int(ref.dtype == torch.float64), *args,
                              stream)
    if err != 0:
        raise RuntimeError(f"the {name} kernel's launch failed: cudaError "
                           f"{err}")


def _pointers(ts):
    return (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))


def _ints(vals):
    return (ctypes.c_longlong * len(vals))(*(int(v) for v in vals))


def _fits(tag, n):
    if n > _MAX_N:
        raise ValueError(f"{tag} takes at most 2**30 solves or points, got "
                         f"{n}")


def donor_grid_kernel(q, x1, pl1, dx, dy, dz, d_omega, grid=True):
    """K9: the lobe radius r along each unit direction (``dx``, ``dy``,
    ``dz``: (N,), contiguous) of each walker (``q``, ``x1``, ``pl1``: (W,),
    any stride), by :func:`~..models.components._donor_radius_loop`'s
    solve: (r, slope, grid).  With ``grid`` (a forward evaluation) r and
    slope are None and ``grid`` is the
    :class:`~..models.components.DonorGrid` of (W, N) elements at the
    radii, ``d_omega`` (N,) the directions' solid angles; else r and the
    slope dF/dr there, each (W, N), and ``grid`` None."""
    global DONOR_GRID_LAUNCHES
    walker = {"q": q, "x1": x1, "pl1": pl1}
    direction = {"dx": dx, "dy": dy, "dz": dz, "d_omega": d_omega}
    on_cpu = _on_cpu("K9", {**walker, **direction})
    W, N = (t.shape[0] if t.dim() else -1 for t in (q, dx))
    for names, n, what in ((walker, W, "W"), (direction, N, "N")):
        for name, t in names.items():
            if tuple(t.shape) != (n,):
                raise ValueError(f"K9: {name} has shape {tuple(t.shape)}, "
                                 f"expected ({what},) = ({n},)")
    if not all(t.is_contiguous() for t in direction.values()):
        raise ValueError("K9: the directions are not contiguous")
    if on_cpu:
        r, slope = plain._donor_radius_loop(q, x1, pl1, dx, dy, dz)
        if not grid:
            return r, slope, None
        return None, None, plain._donor_grid_plain(
            r, (q / (1.0 + q))[:, None], dx, dy, dz, d_omega)
    if grid:
        r = slope = None
        out = (q.new_empty((W, N, 3)), q.new_empty((W, N, 3)),
               q.new_empty((W, N)))
    else:
        r, slope, out = q.new_empty((W, N)), q.new_empty((W, N)), None
    if W * N:
        _fits("K9", W * N)
        _launch("donor_grid", q,
                _pointers((q, x1, pl1, dx, dy, dz, d_omega, r, slope,
                           *(out or (None,) * 3))),
                _ints((q.stride(0), x1.stride(0), pl1.stride(0), W, N)))
        DONOR_GRID_LAUNCHES += 1
    return r, slope, None if out is None else plain.DonorGrid(*out)


def _in_place(t, shape):
    """(div, mod, stride) for reading ``t`` broadcast to ``shape`` in
    place at the flat index i: element ((i / div) % mod) * stride of the
    tensor, div 1 dividing nothing and mod 0 wrapping nothing; None unless
    its dimensions of more than one element are one run of ``shape``'s
    dimensions, none of them broadcast, whose strides merge into one (a
    parameter per row or per walker, a column of the parameter table, the
    phases)."""
    e = t.expand(shape)
    real = [k for k in range(len(shape)) if shape[k] > 1 and e.stride(k)]
    if not real:
        return 1, 0, 0
    lo, hi = real[0], real[-1] + 1
    if real != [k for k in range(lo, hi) if shape[k] > 1] or any(
            e.stride(a) != e.stride(b) * shape[b]
            for a, b in zip(real, real[1:])):
        return None
    mod = math.prod(shape[lo:hi]) if math.prod(shape[:lo]) > 1 else 0
    return math.prod(shape[hi:]), mod, e.stride(real[-1])


def _index_map(t, shape):
    """(tensor, div, mod, stride): ``t`` and its :func:`_in_place` map
    where it has one; else a contiguous copy of ``t`` broadcast to
    ``shape``, (1, 0, 1)."""
    m = _in_place(t, shape)
    if m is None:
        return t.expand(shape).contiguous(), 1, 0, 1
    return (t, *m)


def _row_layout(ins, shape):
    """(P, row shape, {name: (tensor, div, mod, stride)}): K10's rows of
    P phases and each input's map in row units.  The rows are ``shape``'s
    leading dimensions and P its last where no parameter varies along it
    (each read once a row); else (the changepoints' (2, rows) stack) each
    point is a row of one phase.  A parameter is read at its row's first
    phase; the phases in place where a row's are one apart, else from a
    contiguous copy."""
    P = shape[-1] if shape else 1
    if P > 1 and any(t.expand(shape).stride(-1)
                     for n, t in ins.items() if n != "phases"):
        P = 1
    rows = shape[:-1] if P > 1 else shape
    maps = {}
    for n, t in ins.items():
        e = t.expand(shape)
        if P == 1:
            maps[n] = _index_map(e, shape)
            continue
        m = _in_place(e[..., 0], rows)
        if n == "phases" and (m is None or e.stride(-1) != 1):
            maps[n] = (e.contiguous(), 1, 0, P)
        else:
            maps[n] = (e, *m) if m is not None else \
                _index_map(e[..., 0], rows)
    return P, rows, maps


def _wd_launch(tag, distance, ins):
    """K10 on the broadcast of ``ins`` (the kernel's inputs by name, in
    its order): the fraction, or (``distance``) d and clear."""
    global WD_LAUNCHES
    shape = torch.broadcast_shapes(*(t.shape for t in ins.values()))
    ref = ins["phases"]
    out = ref.new_empty(shape)
    out2 = torch.empty_like(out) if distance else None
    n = out.numel()
    if n:
        _fits(tag, n)
        P, rows, maps = _row_layout(ins, shape)
        maps = list(maps.values())
        maps += [(None, 1, 0, 0)] * (len(_WD_INPUTS) - len(maps))
        _launch("wd_curve", ref, int(distance),
                _pointers([m[0] for m in maps] + [out, out2]),
                _ints([m[k] for k in (1, 2, 3) for m in maps]
                      + [n // P, P]))
        WD_LAUNCHES += 1
    return (out, out2) if distance else out


def wd_curve_kernel(q, incl_deg, phases, rwd, ulimb, xl1_val, phi_l1,
                    r_ins):
    """K10: the white dwarf's visible fraction at ``phases`` (out of
    eclipse 1), :func:`~..models.components._wd_curve_plain` without the
    precise refinement; every argument a tensor, broadcast together
    (a per-row parameter is read in place, not expanded)."""
    ins = dict(zip(_WD_INPUTS, (phases, q, incl_deg, xl1_val, phi_l1, rwd,
                                ulimb, r_ins)))
    if _on_cpu("K10", ins):
        return plain._wd_curve_plain(q, incl_deg, phases, rwd, ulimb,
                                     xl1_val, phi_l1, r_ins)
    return _wd_launch("K10", False, ins)


def wd_distance_kernel(q, incl_deg, phases, xl1_val, phi_l1):
    """K10's distance mode: (d, clear) of
    :func:`~..roche.geometry._shadow_distance_plain` without the precise
    refinement, broadcast over the arguments."""
    ins = dict(zip(_WD_INPUTS, (phases, q, incl_deg, xl1_val, phi_l1)))
    if _on_cpu("K10", ins):
        return geometry._shadow_distance_plain(q, incl_deg, phases, xl1_val,
                                               phi_l1)
    return _wd_launch("K10", True, ins)
