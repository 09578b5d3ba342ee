"""K1's backward kernel (``ops/csrc/contacts_backward.cu``) on the CPU.

The kernel takes the contact phases' implicit-function-theorem gradient
by carrying five tangents (q, incl, px, py, x1) through the edge residual
in forward mode, with one rule per operation that is the transpose of
PyTorch's backward of it.  Two stand-ins for the kernel run here:

- ``mirror_backward``, the kernel's arithmetic step by step in PyTorch;
- the kernel source's own arithmetic, compiled as C++ with ``g++`` behind
  a shim header (``__device__`` and friends as empty macros) and driven by
  a host loop over rows and elements (skipped where there is no ``g++``).

Both are held to the plain backward (autograd on
``roche.geometry._edge_residual``) at rtol 1e-9 in float64, on the
contact batch of tests/test_torch_grad.py and on rows that hit every
branch of the residual, and to ``jax.grad`` through the JAX package at
the tolerances tests/test_torch_grad.py states.
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

K = 5                                   # q, incl, px, py, x1
NAMES = ("q", "incl", "px", "py", "x1", "pl1")
SOURCE = (Path(contacts.__file__).resolve().parent / "csrc"
          / "contacts_backward.cu")


class Dual:
    """A value and its derivatives in the five directions: the twin of
    the kernel's ``struct Dual``, rule for rule."""

    def __init__(self, v, d=None):
        self.v = v
        self.d = (torch.zeros(v.shape + (K,), dtype=v.dtype) if d is None
                  else d)

    @staticmethod
    def seed(v, k, dv):
        out = Dual(v)
        out.d[..., k] = dv
        return out

    def __add__(self, o):
        return Dual(self.v + o.v, self.d + o.d)

    def __sub__(self, o):
        return Dual(self.v - o.v, self.d - o.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        return Dual(self.v * o.v,
                    self.d * o.v[..., None] + self.v[..., None] * o.d)

    def __truediv__(self, o):
        v = self.v / o.v
        return Dual(v, (self.d - v[..., None] * o.d) * (1.0 / o.v)[..., None])


def cadd(c, a):
    return Dual(c + a.v, a.d)


def csub(c, a):
    return Dual(c - a.v, -a.d)


def cmul(c, a):
    c = torch.as_tensor(c, dtype=a.v.dtype)
    return Dual(c * a.v, c[..., None] * a.d)


def rsqrt(a):
    v = torch.rsqrt(a.v)
    return Dual(v, (-0.5 * (v * v * v))[..., None] * a.d)


def sqrt(a):
    v = torch.sqrt(a.v)
    return Dual(v, (0.5 / v)[..., None] * a.d)


def clamp_min(a, lo):
    return Dual(torch.clamp(a.v, min=lo),
                torch.where((a.v >= lo)[..., None], a.d,
                            torch.zeros_like(a.d)))


def _pick(a, b, drop_a, drop_b, v):
    z = torch.zeros_like(a.d)
    s = (torch.where(drop_a[..., None], z, a.d)
         + torch.where(drop_b[..., None], z, b.d))
    return Dual(v, torch.where((a.v == b.v)[..., None], 0.5 * s, s))


def dmax(a, b):
    return _pick(a, b, a.v < b.v, a.v > b.v, torch.maximum(a.v, b.v))


def dmin(a, b):
    return _pick(a, b, a.v > b.v, a.v < b.v, torch.minimum(a.v, b.v))


def clip(x, lo, hi):
    return dmin(dmax(x, lo), hi)


def where(c, a, b):
    return Dual(torch.where(c, a.v, b.v), torch.where(c[..., None], a.d, b.d))


def mirror_backward(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl, g_in,
                    g_out, flags=None):
    """``contacts_backward.cu`` step by step: q, incl, x1, pl1 (R,), the
    rest (R, N).  Returns the six gradients; ``flags`` collects, per edge,
    which branches each element took."""
    R, N = px.shape
    dt = px.dtype

    def col(a):
        return a[:, None].expand(R, N).contiguous()

    qd = Dual.seed(col(q), 0, 1.0)
    mu = qd / cadd(1.0, qd)
    ir = col(incl) / 180.0
    sn, cs = torch.sin(math.pi * ir), torch.cos(math.pi * ir)
    si = Dual.seed(sn, 1, cs * 0.017453292519943295)
    ci = cs
    rad = Dual.seed(1.0 - col(x1), 4, -1.0)
    pxd, pyd = Dual.seed(px, 2, 1.0), Dual.seed(py, 3, 1.0)
    wx, wy = csub(1.0, pxd), -pyd
    ww = wx * wx + wy * wy
    c1 = pxd * pxd + pyd * pyd
    two_pi = 6.283185307179586

    def g_val(t, ex, ey, b1, b2):
        i1 = rsqrt(t * t + cmul(2.0, b1) * t + c1)
        i2 = rsqrt(t * t + cmul(2.0, b2) * t + ww)
        cx = pxd - mu + t * ex
        cy = pyd + t * ey
        return -csub(1.0, mu) * i1 - mu * i2 - cmul(0.5, cx * cx + cy * cy)

    grads = torch.zeros((R, N, K + 1), dtype=dt)
    for phi, g in ((phi_in, g_in), (phi_out, g_out)):
        g = torch.where(ecl, g, torch.zeros_like(g))
        s_, c_ = (torch.sin(math.pi * (2.0 * phi)),
                  torch.cos(math.pi * (2.0 * phi)))
        ex, ey = cmul(c_, si), -cmul(s_, si)
        tstar = wx * ex + wy * ey
        disc = rad * rad - (ww - tstar * tstar)
        half = sqrt(clamp_min(disc, 1e-30))
        hi_raw = tstar + half
        t_lo = clamp_min(tstar - half, 0.0)
        t_hi = clamp_min(hi_raw, 0.0)
        no_occ = (disc.v <= 0.0) | (hi_raw.v <= 1e-9)
        b1 = pxd * ex + pyd * ey
        b2 = b1 - ex
        one_mu = csub(1.0, mu)
        ee = ex * ex + ey * ey
        t = clip(tstar, t_lo, t_hi)
        guard = torch.zeros_like(ecl)
        for _ in range(3):
            i1 = rsqrt(t * t + cmul(2.0, b1) * t + c1)
            i2 = rsqrt(t * t + cmul(2.0, b2) * t + ww)
            u1, u2 = t + b1, t + b2
            i13, i23 = i1 * i1 * i1, i2 * i2 * i2
            cx = pxd - mu + t * ex
            cy = pyd + t * ey
            g1 = one_mu * u1 * i13 + mu * u2 * i23 - (cx * ex + cy * ey)
            g2 = (one_mu * (i13 - cmul(3.0, u1) * u1 * i13 * i1 * i1)
                  + mu * (i23 - cmul(3.0, u2) * u2 * i23 * i2 * i2) - ee)
            ok = g2.v > 1e-12
            guard |= ~ok
            step = where(ok, g1 / clamp_min(g2, 1e-12),
                         Dual(torch.zeros_like(g2.v)))
            t = clip(t - step, t_lo, t_hi)
        val = g_val(t, ex, ey, b1, b2)
        v_lo, v_hi = g_val(t_lo, ex, ey, b1, b2), g_val(t_hi, ex, ey, b1, b2)
        tv = torch.where(v_lo.v < val.v, t_lo.v, t.v)
        val = dmin(val, v_lo)
        tv = torch.where(v_hi.v < val.v, t_hi.v, tv)
        val = dmin(val, v_hi)
        dc = torch.where(no_occ[..., None], torch.zeros_like(val.d), val.d)
        dc_pl1 = torch.where(no_occ, 0.0, -1.0).to(dt)
        rx, ry, rz = px + tv * ex.v, py + tv * ey.v, tv * ci
        j1 = torch.rsqrt(rx * rx + ry * ry + rz * rz)
        dx = rx - 1.0
        j2 = torch.rsqrt(dx * dx + ry * ry + rz * rz)
        j13, j23 = j1 * j1 * j1, j2 * j2 * j2
        gx = (1.0 - mu.v) * rx * j13 + mu.v * dx * j23 - (rx - mu.v)
        gy = ry * ((1.0 - mu.v) * j13 + mu.v * j23 - 1.0)
        dcdphi = tv * two_pi * (gx * ey.v - gy * ex.v)
        coeff = -1.0 / dcdphi
        bad = ~torch.isfinite(coeff)
        coeff = torch.where(bad, torch.zeros_like(coeff), coeff)
        w = g * coeff
        grads[..., :K] += w[..., None] * dc
        grads[..., K] += w * dc_pl1
        if flags is not None:
            flags.append({"clamped at t_lo": (t.v == t_lo.v) & ~no_occ,
                          "clamped at t_hi": (t.v == t_hi.v) & ~no_occ,
                          "no_occ": no_occ, "g2 <= 1e-12": guard,
                          "non-finite coeff": bad})
    g_c = torch.where(ecl, torch.zeros_like(g_in), g_in + g_out) / two_pi
    wxv = 1.0 - px
    r2 = wxv * wxv + py * py
    return (grads[..., 0].sum(-1), grads[..., 1].sum(-1),
            grads[..., 2] + g_c * py / r2, grads[..., 3] + g_c * wxv / r2,
            grads[..., 4].sum(-1), grads[..., 5].sum(-1))


# ---- the kernel source's arithmetic, compiled as C++ --------------------

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __launch_bounds__(n)
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

// passes: 0 as the kernel routes its dtype, 1 one pass, 2 two passes
template <typename T>
static void host_rows(int passes, const T* q, const T* incl, const T* x1,
                      const T* px, const T* py, const T* phi_in,
                      const T* phi_out, const T* g_in, const T* g_out,
                      const unsigned char* ecl, T* dpx, T* dpy, T* drow,
                      int rows, int n) {
  for (int row = 0; row < rows; ++row) {
    const size_t k = (size_t)row * n;
    T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#define ROW(fn) fn(q[row], incl[row], x1[row], px + k, py + k, phi_in + k, \
                   phi_out + k, g_in + k, g_out + k, ecl + k, dpx + k,     \
                   dpy + k, 0, 1, n, a0, a1, a2, a3)
    if (passes == 0) {
      ROW(row_grad);
    } else if (passes == 1) {
      ROW(row_pass<AllSlots>);
    } else {
      ROW(row_pass<RowSlots>);
      ROW(row_pass<ElemSlots>);
    }
#undef ROW
    drow[row] = a0;
    drow[(size_t)rows + row] = a1;
    drow[2 * (size_t)rows + row] = a2;
    drow[3 * (size_t)rows + row] = a3;
  }
}

extern "C" void contacts_backward_host(
    int is_double, int passes, const void* q, const void* incl,
    const void* x1, const void* px, const void* py, const void* phi_in,
    const void* phi_out, const void* g_in, const void* g_out,
    const void* ecl, void* dpx, void* dpy, void* drow, int rows, int n) {
  const unsigned char* e = (const unsigned char*)ecl;
  if (is_double)
    host_rows<double>(passes, (const double*)q, (const double*)incl,
                      (const double*)x1, (const double*)px, (const double*)py,
                      (const double*)phi_in, (const double*)phi_out,
                      (const double*)g_in, (const double*)g_out, e,
                      (double*)dpx, (double*)dpy, (double*)drow, rows, n);
  else
    host_rows<float>(passes, (const float*)q, (const float*)incl,
                     (const float*)x1, (const float*)px, (const float*)py,
                     (const float*)phi_in, (const float*)phi_out,
                     (const float*)g_in, (const float*)g_out, e, (float*)dpx,
                     (float*)dpy, (float*)drow, rows, n);
}
"""


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The kernel source up to its ``__global__`` kernel, built by g++ with
    a host loop in the kernel's place: ``run(passes)`` gives a function
    with ``_contact_backward_plain``'s signature that takes the inputs in
    one pass (1), in two (2), or as the kernel routes their dtype (0)."""
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

    def run(passes):
        def backward(q, incl, px, py, x1, pl1, phi_in, phi_out, ecl, g_in,
                     g_out):
            rows, n = px.shape
            ins = [a.contiguous() for a in (q, incl, x1, px, py, phi_in,
                                            phi_out, g_in, g_out, ecl)]
            dpx, dpy = torch.empty_like(px), torch.empty_like(py)
            drow = torch.empty((4, rows), dtype=px.dtype)
            fn(int(px.dtype == torch.float64), passes,
               *[a.data_ptr() for a in ins], dpx.data_ptr(), dpy.data_ptr(),
               drow.data_ptr(), rows, n)
            return drow[0], drow[1], dpx, dpy, drow[2], drow[3]
        return backward

    return run


STAND_INS = {"mirror": None, "compiled source": 0,
             "compiled source, one pass": 1,
             "compiled source, two passes": 2}


@pytest.fixture(params=list(STAND_INS))
def stand_in(request):
    """The kernel's stand-ins on the CPU: the mirror, and the compiled
    source as the kernel routes each dtype and in each pass structure (on
    the card float32 runs one pass and float64 two; here both run both)."""
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
