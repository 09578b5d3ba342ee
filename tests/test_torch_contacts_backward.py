"""K1's backward kernel (``ops/csrc/contacts_backward.cu``) on the CPU.

The kernel takes the contact phases' implicit-function-theorem gradient
as a reverse sweep: each edge runs the residual's forward once, keeping
its Newton iterates, then carries one adjoint back through it with
PyTorch's own backward rules (clamp, minimum / maximum at ties and NaNs,
where).  Two stand-ins for the kernel run here:

- ``mirror_backward``, the kernel's arithmetic step by step in PyTorch;
- the kernel source's own arithmetic, compiled as C++ with ``g++`` behind
  a shim header (``__device__`` and friends as empty macros) and driven by
  a host loop over rows and threads that sums each row in the kernel's
  order for the block of each dtype (skipped where there is no ``g++``).

Both are held to the plain backward (autograd on
``roche.geometry._edge_residual``) at rtol 1e-9 in float64, on the
contact batch of tests/test_torch_grad.py, on rows that hit every branch
of the residual and on rows with non-finite inputs at non-eclipsed
elements (whose edges the kernel skips only where the inputs are
finite), and to ``jax.grad`` through the JAX package at the tolerances
tests/test_torch_grad.py states.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.ops.pallas_contacts import contacts_op_diff
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.ops import contacts
from lfit_python_tpu_torch.roche import geometry as tg
from jax_fresh_compiles import fresh_jax_compiles  # noqa: F401

NAMES = ("q", "incl", "px", "py", "x1", "pl1")
SOURCE = (Path(contacts.__file__).resolve().parent / "csrc"
          / "contacts_backward.cu")
N_NEWTON = 3


# ---- the kernel's rules, in PyTorch --------------------------------------

def tmin(a, b):
    return torch.minimum(a, b)


def tmax(a, b):
    return torch.maximum(a, b)


def clip(x, lo, hi):
    return tmin(tmax(x, lo), hi)


def min_adj(a, b, g):
    """PyTorch's backward of minimum(a, b) for the adjoint g."""
    h = torch.where(a == b, g * 0.5, g)
    z = torch.zeros_like(g)
    return torch.where(a > b, z, h), torch.where(a < b, z, h)


def max_adj(a, b, g):
    h = torch.where(a == b, g * 0.5, g)
    z = torch.zeros_like(g)
    return torch.where(a < b, z, h), torch.where(a > b, z, h)


def pick(c, a, b):
    return torch.where(c, a, b)


class Adj:
    """The adjoints one edge's sweep gathers (the kernel's ``struct
    Adj``)."""

    def __init__(self, like):
        for k in ("t_lo", "t_hi", "b1", "b2", "ex", "ey", "ee", "mu", "px",
                  "py", "c1", "ww"):
            setattr(self, k, torch.zeros_like(like))


def mirror_backward(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl, g_in,
                    g_out, flags=None):
    """``contacts_backward.cu`` step by step: q, incl, x1, pl1 (R,), the
    rest (R, N).  Returns the six gradients; ``flags`` collects, per edge,
    which branches each element took."""
    R, N = px.shape

    def col(a):
        return a[:, None].expand(R, N)

    mu = col(q) / (1.0 + col(q))
    one_mu = 1.0 - mu
    ir = col(incl) / 180.0
    si, ci = torch.sin(math.pi * ir), torch.cos(math.pi * ir)
    rad = 1.0 - col(x1)
    wx, wy = 1.0 - px, -py
    ww = wx * wx + wy * wy
    c1 = px * px + py * py
    finite = (torch.isfinite(col(q)) & torch.isfinite(col(incl))
              & torch.isfinite(col(x1)) & torch.isfinite(px)
              & torch.isfinite(py) & torch.isfinite(phi_in)
              & torch.isfinite(phi_out))
    run = ecl | ~finite
    zero = torch.zeros_like(px)
    ge = [zero] * 6                   # px, py, wx, wy, ww, c1
    acc = {k: zero for k in ("mu", "si", "rad", "pl1")}

    for phi, g in ((phi_in, g_in), (phi_out, g_out)):
        g = torch.where(ecl, g, zero)
        sn, cs = torch.sin(math.pi * (2.0 * phi)), torch.cos(math.pi * (2.0 * phi))
        ex, ey = si * cs, -si * sn
        tstar = wx * ex + wy * ey
        disc = rad * rad - (ww - tstar * tstar)
        half = torch.sqrt(torch.clamp(disc, min=1e-30))
        hi_raw = tstar + half
        t_lo = torch.clamp(tstar - half, min=0.0)
        t_hi = torch.clamp(hi_raw, min=0.0)
        no_occ = (disc <= 0.0) | (hi_raw <= 1e-9)
        b1 = px * ex + py * ey
        b2 = b1 - ex
        ee = ex * ex + ey * ey

        def terms(t):
            i1 = torch.rsqrt(t * t + 2.0 * b1 * t + c1)
            i2 = torch.rsqrt(t * t + 2.0 * b2 * t + ww)
            u1, u2 = t + b1, t + b2
            i13, i23 = i1 * i1 * i1, i2 * i2 * i2
            cx = px - mu + t * ex
            cy = py + t * ey
            g1 = one_mu * u1 * i13 + mu * u2 * i23 - (cx * ex + cy * ey)
            g2 = (one_mu * (i13 - 3.0 * u1 * u1 * i13 * i1 * i1)
                  + mu * (i23 - 3.0 * u2 * u2 * i23 * i2 * i2) - ee)
            return i1, i2, u1, u2, i13, i23, cx, cy, g1, g2

        def g_val(t):
            i1, i2, *_, cx, cy, _, _ = terms(t)
            return -one_mu * i1 - mu * i2 - 0.5 * (cx * cx + cy * cy)

        def ray_adj(t, i1, i2, g_i1, g_i2, g_cx, g_cy, a):
            g_a1 = -0.5 * g_i1 * (i1 * i1 * i1)
            g_a2 = -0.5 * g_i2 * (i2 * i2 * i2)
            a.c1 = a.c1 + g_a1
            a.ww = a.ww + g_a2
            a.b1 = a.b1 + 2.0 * t * g_a1
            a.b2 = a.b2 + 2.0 * t * g_a2
            a.px = a.px + g_cx
            a.mu = a.mu - g_cx
            a.ex = a.ex + t * g_cx
            a.py = a.py + g_cy
            a.ey = a.ey + t * g_cy
            return ((2.0 * t + 2.0 * b1) * g_a1 + (2.0 * t + 2.0 * b2) * g_a2
                    + ex * g_cx + ey * g_cy)

        def g_val_adj(t, gb, a):
            i1, i2, *_, cx, cy, _, _ = terms(t)
            a.mu = a.mu + gb * (i1 - i2)
            return ray_adj(t, i1, i2, -gb * one_mu, -gb * mu, -gb * cx,
                           -gb * cy, a)

        ts = [clip(tstar, t_lo, t_hi)]
        guard = torch.zeros_like(ecl)
        for _ in range(N_NEWTON):
            *_, g1, g2 = terms(ts[-1])
            ok = g2 > 1e-12
            guard |= ~ok
            step = pick(ok, g1 / torch.clamp(g2, min=1e-12), zero)
            ts.append(clip(ts[-1] - step, t_lo, t_hi))
        t3 = ts[-1]
        val, v_lo, v_hi = g_val(t3), g_val(t_lo), g_val(t_hi)
        tv = pick(v_lo < val, t_lo, t3)
        m1 = tmin(val, v_lo)
        tv = pick(v_hi < m1, t_hi, tv)
        rx, ry, rz = px + tv * ex, py + tv * ey, tv * ci
        j1 = torch.rsqrt(rx * rx + ry * ry + rz * rz)
        dx = rx - 1.0
        j2 = torch.rsqrt(dx * dx + ry * ry + rz * rz)
        j13, j23 = j1 * j1 * j1, j2 * j2 * j2
        gx = (1.0 - mu) * rx * j13 + mu * dx * j23 - (rx - mu)
        gy = ry * ((1.0 - mu) * j13 + mu * j23 - 1.0)
        dcdphi = tv * 6.283185307179586 * (gx * ey - gy * ex)
        coeff = -1.0 / dcdphi
        bad = ~torch.isfinite(coeff)
        coeff = pick(bad, zero, coeff)
        w = pick(no_occ, zero, g * coeff)

        a = Adj(px)
        g_m1, g_hi = min_adj(m1, v_hi, w)
        g_val3, g_lo = min_adj(val, v_lo, g_m1)
        a.t_lo = a.t_lo + g_val_adj(t_lo, g_lo, a)
        a.t_hi = a.t_hi + g_val_adj(t_hi, g_hi, a)
        gt = g_val_adj(t3, g_val3, a)
        for t in reversed(ts[:-1]):
            i1, i2, u1, u2, i13, i23, cx, cy, g1, g2 = terms(t)
            ok = g2 > 1e-12
            g2c = torch.clamp(g2, min=1e-12)
            quot = g1 / g2c
            x = t - pick(ok, quot, zero)
            g_m, g_hi = min_adj(tmax(x, t_lo), t_hi, gt)
            g_x, g_lo = max_adj(x, t_lo, g_m)
            a.t_lo = a.t_lo + g_lo
            a.t_hi = a.t_hi + g_hi
            g_q = pick(ok, -g_x, zero)
            g_g1 = g_q / g2c
            g_g2 = pick(g2 >= 1e-12, -g_q * (quot / g2c), zero)
            i12, i22 = i1 * i1, i2 * i2
            h1 = i13 - 3.0 * u1 * u1 * i13 * i12
            h2 = i23 - 3.0 * u2 * u2 * i23 * i22
            g_u1 = one_mu * i13 * (g_g1 - 6.0 * u1 * i12 * g_g2)
            g_u2 = mu * i23 * (g_g1 - 6.0 * u2 * i22 * g_g2)
            g_i1 = 3.0 * one_mu * i12 * (u1 * g_g1
                                         + (1.0 - 5.0 * u1 * u1 * i12) * g_g2)
            g_i2 = 3.0 * mu * i22 * (u2 * g_g1
                                     + (1.0 - 5.0 * u2 * u2 * i22) * g_g2)
            a.mu = a.mu + (u2 * i23 - u1 * i13) * g_g1 + (h2 - h1) * g_g2
            a.ex = a.ex - cx * g_g1
            a.ey = a.ey - cy * g_g1
            a.ee = a.ee - g_g2
            a.b1 = a.b1 + g_u1
            a.b2 = a.b2 + g_u2
            gt = g_x + g_u1 + g_u2 + ray_adj(t, i1, i2, g_i1, g_i2,
                                              -ex * g_g1, -ey * g_g1, a)
        g_m0, g_hi = min_adj(tmax(tstar, t_lo), t_hi, gt)
        g_ts, g_lo = max_adj(tstar, t_lo, g_m0)
        a.t_lo = a.t_lo + g_lo
        a.t_hi = a.t_hi + g_hi
        g_lraw = pick(tstar - half >= 0.0, a.t_lo, zero)
        g_hraw = pick(hi_raw >= 0.0, a.t_hi, zero)
        g_half = g_hraw - g_lraw
        g_disc = pick(disc >= 1e-30, g_half / (2.0 * half), zero)
        g_ts = g_ts + g_lraw + g_hraw + 2.0 * tstar * g_disc
        g_b1 = a.b1 + a.b2
        g_ex = a.ex + wx * g_ts + 2.0 * ex * a.ee - a.b2 + px * g_b1
        g_ey = a.ey + wy * g_ts + 2.0 * ey * a.ee + py * g_b1
        # the kernel skips a non-eclipsed element whose inputs are finite
        contrib = {"mu": a.mu, "si": cs * g_ex - sn * g_ey,
                   "rad": 2.0 * rad * g_disc, "pl1": -w}
        for k, v in contrib.items():
            acc[k] = acc[k] + pick(run, v, zero)
        for i, v in enumerate((a.px + ex * g_b1, a.py + ey * g_b1, ex * g_ts,
                               ey * g_ts, a.ww - g_disc, a.c1)):
            ge[i] = ge[i] + pick(run, v, zero)
        if flags is not None:
            flags.append({"clamped at t_lo": (t3 == t_lo) & ~no_occ,
                          "clamped at t_hi": (t3 == t_hi) & ~no_occ,
                          "no_occ": no_occ, "g2 <= 1e-12": guard,
                          "non-finite coeff": bad})
    g_wx = ge[2] + 2.0 * wx * ge[4]
    g_wy = ge[3] + 2.0 * wy * ge[4]
    dpx = ge[0] + 2.0 * px * ge[5] - g_wx
    dpy = ge[1] + 2.0 * py * ge[5] - g_wy
    g_c = torch.where(ecl, zero, g_in + g_out) / 6.283185307179586
    r2 = wx * wx + py * py
    dpx = dpx + g_c * py / r2
    dpy = dpy + g_c * wx / r2
    s = {k: v.sum(-1) for k, v in acc.items()}
    den = 1.0 + q
    return (s["mu"] / den - s["mu"] * (q / den / den),
            s["si"] * torch.cos(math.pi * (incl / 180.0)) * 0.017453292519943295,
            dpx, dpy, -s["rad"], s["pl1"])


# ---- the kernel source's arithmetic, compiled as C++ --------------------

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __launch_bounds__(...)
static inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
static inline double rsqrt(double v) { return 1.0 / std::sqrt(v); }
static inline void sincospi(double v, double* s, double* c) {
  *s = std::sin(M_PI * v);
  *c = std::cos(M_PI * v);
}
static inline void sincospif(float v, float* s, float* c) {
  *s = (float)std::sin(M_PI * (double)v);
  *c = (float)std::cos(M_PI * (double)v);
}
"""

_HOST = r"""
}  // namespace

#include <vector>

// threads: 1 for one thread a row, 0 for the block the kernel gives the
// dtype, whose threads stride over the row and whose sums are added in the
// kernel's order (a warp's lanes by the shuffle tree, then the warps)
template <typename T>
static void host_rows(int threads, const T* q, const T* incl, const T* x1,
                      const T* px, const T* py, const T* phi_in,
                      const T* phi_out, const T* g_in, const T* g_out,
                      const unsigned char* ecl, T* dpx, T* dpy, T* drow,
                      int rows, int n) {
  const int nt = threads ? threads
                         : (sizeof(T) == 4 ? kThreadsF32 : kThreadsF64);
  std::vector<T> acc[4];
  for (auto& a : acc) a.resize(nt);
  for (int row = 0; row < rows; ++row) {
    const size_t k = (size_t)row * n;
    for (int t = 0; t < nt; ++t) {
      RowAcc<T> a = {0, 0, 0, 0};
      row_thread(q[row], incl[row], x1[row], px + k, py + k, phi_in + k,
                 phi_out + k, g_in + k, g_out + k, ecl + k, dpx + k, dpy + k,
                 t, nt, n, a);
      acc[0][t] = a.mu;
      acc[1][t] = a.si;
      acc[2][t] = a.rad;
      acc[3][t] = a.pl1;
    }
    T s[4];
    for (int i = 0; i < 4; ++i) {
      if (nt == 1) {
        s[i] = acc[i][0];
        continue;
      }
      for (int w = 0; w < nt / 32; ++w) {
        T* v = acc[i].data() + 32 * w;
        for (int off = 16; off > 0; off >>= 1)
          for (int lane = 0; lane + off < 32; ++lane) v[lane] += v[lane + off];
      }
      s[i] = acc[i][0];
      for (int w = 1; w < nt / 32; ++w) s[i] += acc[i][32 * w];
    }
    row_finish(q[row], incl[row], s, drow[row], drow[(size_t)rows + row],
               drow[2 * (size_t)rows + row], drow[3 * (size_t)rows + row]);
  }
}

extern "C" void contacts_backward_host(
    int is_double, int threads, const void* q, const void* incl,
    const void* x1, const void* px, const void* py, const void* phi_in,
    const void* phi_out, const void* g_in, const void* g_out,
    const void* ecl, void* dpx, void* dpy, void* drow, int rows, int n) {
  const unsigned char* e = (const unsigned char*)ecl;
  if (is_double)
    host_rows<double>(threads, (const double*)q, (const double*)incl,
                      (const double*)x1, (const double*)px, (const double*)py,
                      (const double*)phi_in, (const double*)phi_out,
                      (const double*)g_in, (const double*)g_out, e,
                      (double*)dpx, (double*)dpy, (double*)drow, rows, n);
  else
    host_rows<float>(threads, (const float*)q, (const float*)incl,
                     (const float*)x1, (const float*)px, (const float*)py,
                     (const float*)phi_in, (const float*)phi_out,
                     (const float*)g_in, (const float*)g_out, e, (float*)dpx,
                     (float*)dpy, (float*)drow, rows, n);
}
"""


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The kernel source up to its ``__global__`` kernel, built by g++ with
    a host loop in the kernel's place: ``run(threads)`` gives a function
    with ``_contact_backward_plain``'s signature that takes each row on one
    thread (1), or on a block of ``threads`` threads that sums in the
    kernel's order (0: the block the kernel gives the inputs' dtype)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source's arithmetic")
    build = tmp_path_factory.mktemp("contacts_backward")
    (build / "cuda_runtime.h").write_text(_SHIM)
    head, marker, _ = SOURCE.read_text().partition(
        "// ---- kernel and launcher")
    assert marker, "the kernel source lost its marker line"
    (build / "host.cpp").write_text(head + _HOST)
    so = build / "libhost.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{build}", "-o", str(so),
                    str(build / "host.cpp")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).contacts_backward_host
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                   + [ctypes.c_int, ctypes.c_int])
    fn.restype = None

    def run(threads):
        def backward(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl, g_in,
                     g_out):
            rows, n = px.shape
            ins = [a.contiguous() for a in (q, incl, x1, px, py, phi_in,
                                            phi_out, g_in, g_out, ecl)]
            dpx, dpy = torch.empty_like(px), torch.empty_like(py)
            drow = torch.empty((4, rows), dtype=px.dtype)
            fn(int(px.dtype == torch.float64), threads,
               *[a.data_ptr() for a in ins], dpx.data_ptr(), dpy.data_ptr(),
               drow.data_ptr(), rows, n)
            return drow[0], drow[1], dpx, dpy, drow[2], drow[3]
        return backward

    return run


STAND_INS = {"mirror": None,
             "compiled source, one thread a row": 1,
             "compiled source, the block of the dtype": 0,
             "compiled source, a block of 64": 64}


@pytest.fixture(params=list(STAND_INS))
def stand_in(request):
    """The kernel's stand-ins on the CPU: the mirror, and the compiled
    source with each row on one thread, on the block the kernel gives each
    dtype (128 threads in float32, 32 in float64: the card's order of the
    row sums), and on a block of 64 (another order of the sums)."""
    if request.param == "mirror":
        return mirror_backward
    return request.getfixturevalue("compiled")(STAND_INS[request.param])


# ---- inputs -------------------------------------------------------------

def solved_rows(dtype, rows=3, n=160, seed=9):
    """Rows around the north-star geometry with the roots the port's plain
    solver finds, and random cotangents on both edges."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(0.15 + 0.02 * rng.standard_normal(rows), dtype=dtype)
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    incl = tg.findi(q, torch.full_like(q, 0.04), x1, pl1)
    r = rng.uniform(0.05, 0.4, (rows, n))
    th = rng.uniform(0, 2 * np.pi, (rows, n))
    px = torch.tensor(r * np.cos(th), dtype=dtype)
    py = torch.tensor(r * np.sin(th), dtype=dtype)
    pin, pout, ecl = contacts.element_intervals_plain(
        q, incl, px, py, x1, pl1, tg.inscribed_radius(q, x1, pl1))
    g = torch.tensor(rng.standard_normal((2, rows, n)), dtype=dtype)
    return q, incl, px, py, x1, pl1, pin, pout, ecl, g[0], g[1]


def branch_rows(dtype, rows=6, n=203, seed=11):
    """Rows over the whole parameter range, elements out to the lobe, and
    phases off the roots: every branch of the residual is taken (the
    iterate clamped at either chord end, no occultation, the g2 guard, a
    non-finite coefficient, never-eclipsed elements); n is no multiple of
    32."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.uniform(0.08, 0.8, rows), dtype=dtype)
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    incl = torch.tensor(rng.uniform(60, 89.9, rows), dtype=dtype)
    r = rng.uniform(0.02, 0.95, (rows, n))
    th = rng.uniform(0, 2 * np.pi, (rows, n))
    px = torch.tensor(r * np.cos(th), dtype=dtype)
    py = torch.tensor(r * np.sin(th), dtype=dtype)
    phi_c = torch.atan2(py, 1 - px) / (2 * np.pi)
    pin = phi_c - torch.tensor(rng.uniform(0, 0.2, (rows, n)), dtype=dtype)
    pout = phi_c + torch.tensor(rng.uniform(0, 0.2, (rows, n)), dtype=dtype)
    ecl = torch.tensor(rng.uniform(size=(rows, n)) < 0.8)
    g = torch.tensor(rng.standard_normal((2, rows, n)), dtype=dtype)
    return q, incl, px, py, x1, pl1, pin, pout, ecl, g[0], g[1]


BATCHES = {"solved rows": solved_rows, "branch rows": branch_rows,
           "one element": lambda dt: branch_rows(dt, rows=2, n=1, seed=5),
           "one row of 37": lambda dt: solved_rows(dt, rows=1, n=37, seed=3)}


@pytest.mark.parametrize("batch", list(BATCHES))
def test_f64_matches_autograd_on_the_residual(stand_in, batch):
    """All six gradients within rtol 1e-9 of the plain backward."""
    args = BATCHES[batch](torch.float64)
    ref = contacts._contact_backward_plain(*args)
    got = stand_in(*args)
    for g, r, name in zip(got, ref, NAMES):
        assert g.shape == r.shape
        np.testing.assert_allclose(
            g.numpy(), r.numpy(), rtol=1e-9,
            atol=1e-12 * max(float(r.abs().max()), 1e-300), err_msg=name)


def nonfinite_rows(dtype):
    """The branch rows with non-finite inputs: NaN px and an infinite
    phase at non-eclipsed elements (rows 0 and 1), a NaN q (row 2), and
    a NaN cotangent at a non-eclipsed element (row 3)."""
    args = [a.clone() for a in branch_rows(dtype)]
    q, px, phi_in, ecl, g_in = args[0], args[2], args[6], args[8], args[9]
    off = torch.nonzero(~ecl)
    (r0, j0), (r1, j1), (r3, j3) = (off[off[:, 0] == r][0] for r in (0, 1, 3))
    px[r0, j0] = float("nan")
    phi_in[r1, j1] = float("inf")
    q[2] = float("nan")
    g_in[r3, j3] = float("nan")
    return args


def test_f64_non_finite_inputs_at_non_eclipsed_elements(stand_in):
    """A non-eclipsed element's edges are skipped only where its inputs
    are finite: where one is not, the plain backward's zero cotangent
    meets NaN partials, and the kernel's sums must carry the same NaNs.
    Non-finite pattern equal to the plain backward's, the rest within
    rtol 1e-9."""
    args = nonfinite_rows(torch.float64)
    ref = contacts._contact_backward_plain(*args)
    got = stand_in(*args)
    for g, r, name in zip(got, ref, NAMES):
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(g), fin), name
        assert not bool(fin.all()) or name == "pl1", name
        np.testing.assert_allclose(
            g[fin].numpy(), r[fin].numpy(), rtol=1e-9,
            atol=1e-12 * float(r[fin].abs().max()), err_msg=name)


def test_branch_rows_take_every_branch():
    args = branch_rows(torch.float64)
    flags = []
    mirror_backward(*args, flags=flags)
    ecl = args[8]
    assert 0 < int(ecl.sum()) < ecl.numel()
    for name in flags[0]:
        hit = sum(int((f[name] & ecl).sum()) for f in flags)
        assert hit > 0, f"no eclipsed edge with: {name}"
    assert args[2].shape[1] % 32 != 0


def test_x1_gradient_is_zero_while_the_iterate_stays_inside_the_chord():
    """x1 reaches c only through the chord ends, and those only through
    clamps and selects: on the solved rows no iterate is clamped, and the
    gradient in x1 is exactly 0 in the plain backward and in the mirror;
    on the branch rows some are, and it is not."""
    args = solved_rows(torch.float64)
    flags = []
    got = mirror_backward(*args, flags=flags)
    assert not any(bool(f[k].any()) for f in flags
                   for k in ("clamped at t_lo", "clamped at t_hi"))
    assert bool((got[4] == 0).all())
    assert bool((contacts._contact_backward_plain(*args)[4] == 0).all())
    assert float(mirror_backward(*branch_rows(torch.float64))[4].abs()
                 .max()) > 0


@pytest.mark.parametrize("batch", ["solved rows", "branch rows"])
def test_f32_within_the_card_gate_of_the_plain_backward(stand_in, batch):
    """float32 at the bound the kernel is held to on the card: each entry
    within 1e-5 + 2e-3 |g| of the plain float32 backward, or no farther
    from the float64 plain backward than 3x the plain float32 backward's
    largest distance from it in that output (two float32 evaluations that
    round their angles differently differ by about as much as each errs);
    the same non-finite pattern."""
    a64 = BATCHES[batch](torch.float64)
    a32 = [a if a.dtype == torch.bool else a.float() for a in a64]
    a64 = [a if a.dtype == torch.bool else a.double() for a in a32]
    plain = contacts._contact_backward_plain(*a32)
    ref = contacts._contact_backward_plain(*a64)
    got = stand_in(*a32)
    for g, p, r, name in zip(got, plain, ref, NAMES):
        assert torch.equal(torch.isfinite(g), torch.isfinite(p)), name
        d = (g.double() - p.double()).abs()
        e_g, e_p = (g.double() - r).abs(), (p.double() - r).abs()
        ok = (d <= 1e-5 + 2e-3 * p.double().abs()) | (e_g <= 3 * e_p.max())
        assert bool(ok.all()), (name, float(d.max()))


@pytest.fixture(scope="module")
def contact_batch():
    """tests/test_torch_grad.py's batch: one row, 160 elements."""
    rng = np.random.default_rng(9)
    q, dphi = 0.15, 0.04
    x1 = float(jg.xl1(q))
    pl1 = float(jg.l1_potential(q))
    incl = float(jg.findi(q, dphi))
    n = 160
    r = rng.uniform(0.05, 0.4, n)
    th = rng.uniform(0, 2 * np.pi, n)
    return (q, incl, r * np.cos(th), r * np.sin(th), x1, pl1,
            rng.standard_normal((2, n)))


def _torch_rows(batch, dtype):
    q, incl, px, py, x1, pl1, _ = batch
    one = (lambda v: torch.tensor([v], dtype=dtype))
    q, incl, x1, pl1 = one(q), one(incl), one(x1), one(pl1)
    px = torch.tensor(px[None], dtype=dtype)
    py = torch.tensor(py[None], dtype=dtype)
    roots = contacts.element_intervals(q, incl, px, py, x1, pl1,
                                       tg.inscribed_radius(q, x1, pl1))
    return [q, incl, px, py, x1, pl1, *roots]


def test_f64_matches_jax_grad_of_contact_interval(stand_in, contact_batch):
    """Random cotangents on both edges of every element, eclipsed or not,
    against jax.grad of the XLA solver's custom JVP (rtol 1e-8, as
    tests/test_torch_grad.py)."""
    q, incl, px, py, x1, pl1, cot = contact_batch

    def f(qq, ii, pxx, pyy, xv, pll):
        def one(a, b):
            return jg.contact_interval(qq, ii, jnp.stack(
                [a, b, jnp.zeros_like(a)]), xv, pll)[:2]
        pin, pout = jax.vmap(one)(pxx, pyy)
        return jnp.sum(cot[0] * pin + cot[1] * pout)

    ref = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
        q, incl, px, py, x1, pl1)
    rows = _torch_rows(contact_batch, torch.float64)
    c = torch.tensor(cot)[:, None]
    got = stand_in(*rows, c[0], c[1])
    assert 20 < int(rows[8].sum()) < rows[8].numel()       # both branches
    for g, r, name in zip(got, ref, NAMES):
        np.testing.assert_allclose(g.numpy().reshape(-1),
                                   np.atleast_1d(np.asarray(r)), rtol=1e-8,
                                   atol=1e-12, err_msg=name)


def test_f32_matches_contacts_op_diff_interpret(stand_in, contact_batch):
    """float32 against the Pallas kernel's IFT wrapper in interpret mode,
    on the summed eclipse widths at rtol 1e-4 (tests/test_torch_grad.py's
    objective and bound)."""
    q, incl, px, py, x1, pl1, _ = contact_batch
    f32 = jnp.float32
    pxj, pyj = jnp.asarray(px, f32), jnp.asarray(py, f32)

    def f(qq, ii, xv, pll):
        pin, pout, ecl = jax.vmap(contacts_op_diff,
                                  in_axes=(0, 0, None, None, 0, 0))(
            qq[None], ii[None], pxj, pyj, xv[None], pll[None])
        return jnp.sum(jnp.where(ecl[0], pout[0] - pin[0], 0.0))

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a, f32) for a in (q, incl, x1, pl1)))
    rows = _torch_rows(contact_batch, torch.float32)
    one = torch.ones_like(rows[2])
    got = stand_in(*rows, -one, one)
    for g, r, name in zip([got[i] for i in (0, 1, 4, 5)], ref,
                          ("q", "incl", "x1", "pl1")):
        np.testing.assert_allclose(g.numpy(), np.atleast_1d(np.asarray(r)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_autograd_function_on_the_cpu_takes_the_plain_backward(dtype):
    """Both dtypes go to the kernel's wrapper, which on CPU tensors is the
    plain backward: the gradients equal it bit for bit, one backward call
    is counted, and no kernel launch."""
    args = solved_rows(dtype, rows=2, n=24)
    q, incl, px, py, x1, pl1 = args[:6]
    leaves = [a.clone().requires_grad_() for a in (q, incl, px, py, x1, pl1)]
    before = (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES)
    pin, pout, _ = contacts.element_intervals_diff(
        *leaves, tg.inscribed_radius(q, x1, pl1))
    grads = torch.autograd.grad((pin * args[9] + pout * args[10]).sum(),
                                leaves)
    assert (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1])
    for a, b in zip(grads, contacts._contact_backward_plain(*args)):
        assert a.dtype == dtype
        assert torch.equal(a, b)


def test_wrapper_on_the_cpu_is_the_plain_backward():
    """On CPU tensors the kernel's wrapper and the autograd.Function take
    the plain backward and count no kernel launch."""
    args = solved_rows(torch.float32, rows=2, n=40)
    before = (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES)
    for a, b in zip(contacts.contact_backward_kernel(*args),
                    contacts._contact_backward_plain(*args)):
        assert torch.equal(a, b)
    q, incl, px, py, x1, pl1 = args[:6]
    leaves = [a.clone().requires_grad_() for a in (q, incl, px, py, x1, pl1)]
    pin, pout, _ = contacts.element_intervals_diff(
        *leaves, tg.inscribed_radius(q, x1, pl1))
    grads = torch.autograd.grad((pin * args[9] + pout * args[10]).sum(),
                                leaves)
    assert (contacts.BACKWARD_CALLS, contacts.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1])
    for a, b in zip(grads, contacts._contact_backward_plain(*args)):
        assert torch.equal(a, b)
