"""Operations and bytes of the port's kernels, from their shapes and the
algorithm: the benchmark's yardstick for a kernel's roofline share.

The counts per term are a frozen copy of the hand counts PERF.md gave
each kernel when it was ported (each add, multiply, divide, sqrt, rsqrt,
sin, cos, atan, compare and select as one operation).  They count what
the algorithm needs, not what a build executes: no SASS count and no
issue floor, so a change to a kernel's build changes its time and not its
yardstick.  Bytes count each input read once and each output written
once.  Where the work depends on the data (K1's eclipsed elements), the
caller gives the share that these inputs need.

A roofline share is the least time, the larger of operations over the
peak rate and bytes over the memory bandwidth, divided by the traced
time.  The peaks are the published ones of one NVIDIA H100 SXM, dense,
outside the tensor cores, at its full power limit of 700 W.
"""

from __future__ import annotations

__all__ = ["PEAK_OPS", "PEAK_BYTES", "least_seconds", "k1", "k1_backward",
           "k2", "k3", "k7", "k7_backward"]

# operations a second, by dtype, and bytes a second of HBM3
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
_ITEM = {"float32": 4, "float64": 8}

# K1 (contacts_kernel): per element the setup and the conjunction test;
# per eclipsed element the bracket, 16 edge steps and the atans
K1_OPS_ELEMENT = 287
K1_OPS_ECLIPSED = 3401
# K1's backward: per eclipsed edge the residual at its root (281) and its
# adjoint at twice that, and dc/dphi (40); per element the never-eclipsed
# phase's gradient and the masks
K1_BWD_OPS_EDGE = 321 + 2 * 281
K1_BWD_OPS_ELEMENT = 15
# K2 (stream_kernel): per RK4 step, and per step for each of the two
# tangent columns of the sensitivities
K2_OPS_STEP = 180
K2_OPS_STEP_COLUMN = 248
# K3 (gp_kernel): per point the recursion (64) and the angle and decay (7)
K3_OPS_POINT = 64 + 7
# K7 (element_curve_kernel) per term (rows x phases x elements): the
# instantaneous indicator 8, the exposure overlap 17; its backward 8 and
# 36
K7_OPS_TERM = {False: 8, True: 17}
K7_BWD_OPS_TERM = {False: 8, True: 36}


def least_seconds(ops, nbytes, dtype="float32"):
    """(least seconds the card could take, what sets it) for ``ops``
    operations of ``dtype`` moving ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def k1(rows, n, eclipsed_share, dtype="float32"):
    """(operations, bytes) of the contact solve on ``rows`` x ``n``
    elements of which ``eclipsed_share`` are eclipsed: px, py in;
    phi_in, phi_out, the flag out; six scalars a row."""
    isz = _ITEM[dtype]
    n_el = rows * n
    ops = n_el * K1_OPS_ELEMENT + eclipsed_share * n_el * K1_OPS_ECLIPSED
    return ops, n_el * (4 * isz + 1) + rows * 6 * isz


def k1_backward(rows, n, eclipsed_share, dtype="float32"):
    """(operations, bytes) of K1's backward on ``rows`` x ``n`` elements:
    px, py, both phases, both cotangents and the flags in; d px, d py
    out (the per-row sums are a few bytes a row)."""
    isz = _ITEM[dtype]
    n_el = rows * n
    ops = (2 * eclipsed_share * n_el * K1_BWD_OPS_EDGE
           + n_el * K1_BWD_OPS_ELEMENT)
    return ops, n_el * (6 * isz + 1 + 2 * isz)


def k2(walkers, radii, steps, sens=False, dtype="float32"):
    """(operations, bytes) of the stream scan of ``walkers`` over
    ``steps`` RK4 steps with ``radii`` disc radii a walker: q, x1 and the
    radii in; an impact point (and three Jacobians with ``sens``) out."""
    isz = _ITEM[dtype]
    ops = walkers * steps * (K2_OPS_STEP
                             + (2 * K2_OPS_STEP_COLUMN if sens else 0))
    return ops, isz * (walkers * (2 + radii)
                       + walkers * radii * 2 * (4 if sens else 1))


def k3(series, points, eclipses, dtype="float32"):
    """(operations, bytes) of the GP recursion over ``series`` (walker,
    eclipse) series of ``points`` points: y, sigma2 and reset per point
    and c per series in; t, yerr and mask per eclipse point; one
    ln-likelihood per series out."""
    isz = _ITEM[dtype]
    ops = series * points * K3_OPS_POINT
    nbytes = (series * points * (2 * isz + 1) + series * isz
              + eclipses * points * (2 * isz + 1) + series * isz)
    return ops, nbytes


def k7(rows, phases, n, widths, dtype="float32"):
    """(operations, bytes) of the element curve on ``rows`` x ``phases``
    x ``n`` terms: the phases (and widths) per row and phase, both
    contact phases and the weight per element, the flag per element in;
    the curve out."""
    isz = _ITEM[dtype]
    w = int(bool(widths))
    ops = rows * phases * n * K7_OPS_TERM[bool(widths)]
    return ops, isz * (rows * phases * (2 + w) + 3 * rows * n) + rows * n


def k7_backward(rows, phases, n, widths, dtype="float32"):
    """(operations, bytes) of the element curve's backward: the forward's
    inputs and the curve's cotangent in; d ph (and d width) per row and
    phase, d phi_in, d phi_out and d w per element out."""
    isz = _ITEM[dtype]
    w = int(bool(widths))
    ops = rows * phases * n * K7_BWD_OPS_TERM[bool(widths)]
    nbytes = (isz * (rows * phases * (2 + 2 * w) + 3 * rows * n
                     + rows * n * (1 + 2 * w)) + rows * n)
    return ops, nbytes
