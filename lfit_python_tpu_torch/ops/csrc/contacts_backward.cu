// The backward of the eclipse contact-interval solver (K1) for NVIDIA
// Hopper (sm_90a): the implicit-function-theorem gradient of the contact
// phases in (q, incl, px, py, x1, pl1).
//
// Replaces the reverse half of the TPU kernel's wrapper,
// lfit_python_tpu/ops/pallas_contacts.py::contacts_op_diff (:448-494, a
// plain-XLA JVP of the edge residual around the Pallas forward).  Its plain
// PyTorch version is lfit_python_tpu_torch/ops/contacts.py::
// _contact_backward_plain: autograd on roche/geometry.py::_edge_residual.
//
// What it computes.  At a contact root phi* of c(phi; theta) = 0 the phase
// moves as d phi* / d theta = -(dc/dtheta) / (dc/dphi).  For each
// (row, element) and each of its two edges the kernel evaluates the
// envelope residual c at the solved root as _edge_residual does (chord
// ends from the enclosing sphere, 3 clamped Newton steps in the ray
// parameter t, the end-point selects, the no-occultation branch), its
// phase derivative dc/dphi, and the whole row of its Jacobian dc/dtheta,
// and adds g * (-1 / dcdphi) * dc/dtheta to the gradients (a non-finite
// coefficient counts as 0).  A never-eclipsed element carries phi_c =
// atan2(py, 1 - px) / 2 pi and that function's gradient.  d px and d py are
// per element; d q, d incl, d x1 and d pl1 are sums over the row.
//
// How dc/dtheta is taken: forward mode.  c is one number per edge and
// theta five (pl1 enters as -1), so the tangents are carried beside every
// value through the unrolled Newton steps (struct Dual).  Each rule below
// is the linear map whose transpose is PyTorch's backward of the same
// operation, also where that is a convention and not calculus: clamp
// passes a tangent where x >= its floor, minimum / maximum pass the
// smaller / larger side's and half of each at a tie (with a NaN on either
// side, both), where() passes the selected side's.  The chord ends reach c
// only through such clamps and selects, which is why d c / d x1 is exactly
// 0 wherever the Newton iterate stays inside the chord: nothing is dropped
// on the strength of the envelope theorem, the rules make it so.  float32
// carries all five tangents in one pass; float64, at two registers a
// number, would spill them, and takes (q, incl, x1) and (px, py) in two
// passes over the same templates (struct Slots).
//
// What bounds it on the card: instructions, not bytes.  An element moves 33
// bytes (px, py, two phases, two cotangents and a flag in, d px and d py
// out) against a few thousand operations for its two edges; the bytes of
// the main path's 1280 x 512 call are 0.006 ms at 3.35 TB/s.
//
// What the design does about it: one thread owns one element at a time
// and does both of its edges in registers; nothing is indexed at run time,
// so nothing lives in local memory (ptxas: 0 bytes stack frame).  One
// block of 128 threads owns one row and strides over its elements (any
// n >= 1), so the four row sums are one block's: each thread adds its own
// elements in order, a warp adds its lanes by shuffles, and threads 0-3
// each add one sum's four warp totals from shared memory.  No atomics: the same inputs
// give the same bits on every run.
//
// Closeness to the plain version: not bit for bit.  The sums run in
// another order, and the angles come from sincospi(2 phi) and
// sincospi(incl / 180), which need no Payne-Hanek reduction (sinf / cosf
// carry one with a local-memory array) and round the angle once less than
// sin(2 pi phi).  Two float32 evaluations that round their angles
// differently differ by about as much as each errs against float64, most
// where 1 / dcdphi is large (near-grazing elements): measured on an H100,
// the kernel is as close to the float64 plain backward as the plain
// float32 backward is, and up to 1.4x that far from the latter (PERF.md).
// Built with --fmad=false like K1.  The float64 instantiation exists for
// the tests and chip_smoke.py, which hold it to autograd at 1e-9; the
// main paths run float32.  A row with a NaN input gives NaN in all its
// gradients but d pl1 (the plain backward, whose masks yield exact zeros,
// also leaves 0 in d x1); the posterior zeroes non-finite gradients.
//
// Arrays, row-major: q, incl, x1 (R,) of T (pl1 enters c as -pl1: its
// value is not needed); px, py, phi_in, phi_out, g_in, g_out (R, N) of T;
// eclipsed (R, N) of bytes (0 / 1); outputs dpx, dpy (R, N) of T and drow
// (4, R) of T = d q, d incl, d x1, d pl1.

#include <cuda_runtime.h>
#include <math.h>

#define KB_FN __device__ __forceinline__

namespace {

// Which of the five inputs a pass differentiates, and in which tangent
// slot each sits (-1: not in this pass).  float32 takes all five in one
// pass.  float64 holds two registers a number, and all five spill (ptxas:
// a 64-byte stack frame); it takes the row's inputs and the element's in
// two passes over the same arithmetic.
template <int Q, int I, int PX, int PY, int X1, int N_> struct Slots {
  static constexpr int q = Q, incl = I, px = PX, py = PY, x1 = X1, n = N_;
};
using AllSlots = Slots<0, 1, 2, 3, 4, 5>;
using RowSlots = Slots<0, 1, -1, -1, 2, 3>;
using ElemSlots = Slots<-1, -1, 0, 1, -1, 2>;

constexpr int kTNewton = 3;       // lockstep with geometry._EDGE_T_NEWTON
constexpr int kBlock = 128;

KB_FN float rsqrt_(float v) { return rsqrtf(v); }
KB_FN double rsqrt_(double v) { return rsqrt(v); }
KB_FN float sqrt_(float v) { return sqrtf(v); }
KB_FN double sqrt_(double v) { return sqrt(v); }
// sin(pi v), cos(pi v)
KB_FN void sincospi_(float v, float& s, float& c) { sincospif(v, &s, &c); }
KB_FN void sincospi_(double v, double& s, double& c) { sincospi(v, &s, &c); }
template <typename T> KB_FN bool finite_(T v) { return v - v == (T)0; }

// a value and its derivatives in N directions
template <typename T, int N> struct Dual {
  T v;
  T d[N];
};

template <int N, typename T> KB_FN Dual<T, N> lift(T v) {
  Dual<T, N> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (T)0;
  return r;
}

// the input of slot K, or a function of it alone with derivative dv; an
// input that has no slot in this pass (K < 0) is a constant
template <int N, int K, typename T> KB_FN Dual<T, N> seed(T v, T dv) {
  Dual<T, N> r = lift<N>(v);
  if constexpr (K >= 0) r.d[K] = dv;
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

// a constant and a Dual
template <typename T, int N> KB_FN Dual<T, N> cadd(T c, const Dual<T, N>& a) {
  Dual<T, N> r = a;
  r.v = c + a.v;
  return r;
}
template <typename T, int N> KB_FN Dual<T, N> csub(T c, const Dual<T, N>& a) {
  Dual<T, N> r = -a;
  r.v = c - a.v;
  return r;
}
template <typename T, int N> KB_FN Dual<T, N> cmul(T c, const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c * a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = c * a.d[k];
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  const T rb = (T)1 / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * rb;
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> rsqrt_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = rsqrt_(a.v);
  const T f = (T)-0.5 * (r.v * r.v * r.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = f * a.d[k];
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> sqrt_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt_(a.v);
  const T f = (T)0.5 / r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = f * a.d[k];
  return r;
}

// torch.clamp(min=lo): NaN passes through; a tangent passes where v >= lo
template <typename T, int N> KB_FN Dual<T, N> clamp_min(const Dual<T, N>& a, T lo) {
  Dual<T, N> r;
  r.v = a.v < lo ? lo : a.v;
  const bool pass = a.v >= lo;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = pass ? a.d[k] : (T)0;
  return r;
}

// torch.maximum / torch.minimum: NaN propagates; the tangent of the side
// that loses is dropped, a tie takes half of each
template <typename T, int N> KB_FN Dual<T, N> dmax(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = (a.v > b.v || a.v != a.v) ? a.v : b.v;
  const bool drop_a = a.v < b.v, drop_b = a.v > b.v, tie = a.v == b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T s = (drop_a ? (T)0 : a.d[k]) + (drop_b ? (T)0 : b.d[k]);
    r.d[k] = tie ? (T)0.5 * s : s;
  }
  return r;
}

template <typename T, int N> KB_FN Dual<T, N> dmin(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = (a.v < b.v || a.v != a.v) ? a.v : b.v;
  const bool drop_a = a.v > b.v, drop_b = a.v < b.v, tie = a.v == b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T s = (drop_a ? (T)0 : a.d[k]) + (drop_b ? (T)0 : b.d[k]);
    r.d[k] = tie ? (T)0.5 * s : s;
  }
  return r;
}

template <typename T, int N>
KB_FN Dual<T, N> clip(const Dual<T, N>& x, const Dual<T, N>& lo, const Dual<T, N>& hi) {
  return dmin(dmax(x, lo), hi);
}

// what an element's two edges share
template <typename T, int N> struct Elem {
  Dual<T, N> mu, si, rad, px, py, wx, wy, ww, c1;
  T ci;
};

// g(t) = Phi(p + t e) along the ray
template <typename T, int N>
KB_FN Dual<T, N> g_val(const Elem<T, N>& s, const Dual<T, N>& t,
                       const Dual<T, N>& ex, const Dual<T, N>& ey,
                       const Dual<T, N>& b1, const Dual<T, N>& b2) {
  const Dual<T, N> i1 = rsqrt_(t * t + cmul((T)2, b1) * t + s.c1);
  const Dual<T, N> i2 = rsqrt_(t * t + cmul((T)2, b2) * t + s.ww);
  const Dual<T, N> cx = s.px - s.mu + t * ex;
  const Dual<T, N> cy = s.py + t * ey;
  return -csub((T)1, s.mu) * i1 - s.mu * i2
         - cmul((T)0.5, cx * cx + cy * cy);
}

// One edge: the residual's derivatives dc[k] in the pass's N directions
// and in pl1 (dc_pl1), and the value of dc/dphi, at the phase ``phi``.
template <typename T, int N>
KB_FN void edge_residual(const Elem<T, N>& s, T phi, T (&dc)[N], T& dc_pl1,
                         T& dcdphi) {
  const T two_pi = (T)6.283185307179586;
  T sn, cs;
  sincospi_((T)2 * phi, sn, cs);
  const Dual<T, N> ex = cmul(cs, s.si);
  const Dual<T, N> ey = -cmul(sn, s.si);
  const Dual<T, N> tstar = s.wx * ex + s.wy * ey;
  const Dual<T, N> disc = s.rad * s.rad - (s.ww - tstar * tstar);
  const Dual<T, N> half = sqrt_(clamp_min(disc, (T)1e-30));
  const Dual<T, N> hi_raw = tstar + half;
  const Dual<T, N> t_lo = clamp_min(tstar - half, (T)0);
  const Dual<T, N> t_hi = clamp_min(hi_raw, (T)0);
  const bool no_occ = disc.v <= (T)0 || hi_raw.v <= (T)1e-9;
  const Dual<T, N> b1 = s.px * ex + s.py * ey;
  const Dual<T, N> b2 = b1 - ex;
  const Dual<T, N> one_mu = csub((T)1, s.mu);
  const Dual<T, N> ee = ex * ex + ey * ey;

  Dual<T, N> t = clip(tstar, t_lo, t_hi);
#pragma unroll
  for (int it = 0; it < kTNewton; ++it) {
    const Dual<T, N> i1 = rsqrt_(t * t + cmul((T)2, b1) * t + s.c1);
    const Dual<T, N> i2 = rsqrt_(t * t + cmul((T)2, b2) * t + s.ww);
    const Dual<T, N> u1 = t + b1, u2 = t + b2;
    const Dual<T, N> i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
    const Dual<T, N> cx = s.px - s.mu + t * ex;
    const Dual<T, N> cy = s.py + t * ey;
    const Dual<T, N> g1 = one_mu * u1 * i13 + s.mu * u2 * i23
                          - (cx * ex + cy * ey);
    const Dual<T, N> g2 =
        one_mu * (i13 - cmul((T)3, u1) * u1 * i13 * i1 * i1)
        + s.mu * (i23 - cmul((T)3, u2) * u2 * i23 * i2 * i2) - ee;
    // where(g2 > 1e-12, g1 / clamp(g2, 1e-12), 0)
    Dual<T, N> step = lift<N>((T)0);
    if (g2.v > (T)1e-12) step = g1 / clamp_min(g2, (T)1e-12);
    t = clip(t - step, t_lo, t_hi);
  }
  Dual<T, N> val = g_val(s, t, ex, ey, b1, b2);
  const Dual<T, N> v_lo = g_val(s, t_lo, ex, ey, b1, b2);
  const Dual<T, N> v_hi = g_val(s, t_hi, ex, ey, b1, b2);
  T tv = t.v;                          // the minimiser: its value is all
  tv = v_lo.v < val.v ? t_lo.v : tv;   // dc/dphi needs
  val = dmin(val, v_lo);
  tv = v_hi.v < val.v ? t_hi.v : tv;
  val = dmin(val, v_hi);
  // c = where(no_occ, clear, val - pl1)
#pragma unroll
  for (int k = 0; k < N; ++k) dc[k] = no_occ ? (T)0 : val.d[k];
  dc_pl1 = no_occ ? (T)0 : (T)-1;

  // the envelope derivative dc/dphi at the minimiser, values only
  const T mu = s.mu.v, exv = ex.v, eyv = ey.v;
  const T rx = s.px.v + tv * exv, ry = s.py.v + tv * eyv, rz = tv * s.ci;
  const T j1 = rsqrt_(rx * rx + ry * ry + rz * rz);
  const T dx = rx - (T)1;
  const T j2 = rsqrt_(dx * dx + ry * ry + rz * rz);
  const T j13 = j1 * j1 * j1, j23 = j2 * j2 * j2;
  const T gx = ((T)1 - mu) * rx * j13 + mu * dx * j23 - (rx - mu);
  const T gy = ry * (((T)1 - mu) * j13 + mu * j23 - (T)1);
  dcdphi = tv * two_pi * (gx * eyv - gy * exv);
}

// The row's scalars as Duals: mu = q / (1 + q), sin and cos of the
// inclination (degrees), the enclosing sphere's radius 1 - x1.
template <typename S, typename T>
KB_FN void row_setup(T q, T incl, T x1, Elem<T, S::n>& s) {
  const Dual<T, S::n> qd = seed<S::n, S::q>(q, (T)1);
  s.mu = qd / cadd((T)1, qd);
  T sn, cs;
  sincospi_(incl / (T)180, sn, cs);
  s.si = seed<S::n, S::incl>(sn, cs * (T)0.017453292519943295);
  s.ci = cs;
  s.rad = seed<S::n, S::x1>((T)1 - x1, (T)-1);
}

// One element in the pass S: its gradient in px and py (added to dpx, dpy)
// and its share of the row's four sums (added to aq, ai, ax1, apl1), each
// by the pass that holds its input; d pl1 goes with q, the never-eclipsed
// phase's gradient with px.
template <typename S, typename T>
KB_FN void element_grad(Elem<T, S::n>& s, T px, T py, T phi_in, T phi_out,
                        T g_in, T g_out, bool ecl, T& dpx, T& dpy, T& aq,
                        T& ai, T& ax1, T& apl1) {
  constexpr int N = S::n;
  s.px = seed<N, S::px>(px, (T)1);
  s.py = seed<N, S::py>(py, (T)1);
  s.wx = csub((T)1, s.px);
  s.wy = -s.py;
  s.ww = s.wx * s.wx + s.wy * s.wy;
  s.c1 = s.px * s.px + s.py * s.py;
#pragma unroll 1
  for (int edge = 0; edge < 2; ++edge) {
    const T phi = edge ? phi_out : phi_in;
    const T g = ecl ? (edge ? g_out : g_in) : (T)0;
    T dc[N], dc_pl1, dcdphi;
    edge_residual(s, phi, dc, dc_pl1, dcdphi);
    T coeff = (T)-1 / dcdphi;
    coeff = finite_(coeff) ? coeff : (T)0;
    const T w = g * coeff;
    if constexpr (S::q >= 0) {
      aq += w * dc[S::q];
      apl1 += w * dc_pl1;
    }
    if constexpr (S::incl >= 0) ai += w * dc[S::incl];
    if constexpr (S::px >= 0) dpx += w * dc[S::px];
    if constexpr (S::py >= 0) dpy += w * dc[S::py];
    if constexpr (S::x1 >= 0) ax1 += w * dc[S::x1];
  }
  if constexpr (S::px >= 0) {
    // never eclipsed: phi_in = phi_out = atan2(py, 1 - px) / 2 pi
    const T g_c = (ecl ? (T)0 : g_in + g_out) / (T)6.283185307179586;
    const T wx = (T)1 - px;
    const T r2 = wx * wx + py * py;
    dpx += g_c * py / r2;
    dpy += g_c * wx / r2;
  }
}

// One row's elements j0, j0 + stride, ... in the pass S.
template <typename S, typename T>
KB_FN void row_pass(T q, T incl, T x1, const T* __restrict__ px,
                    const T* __restrict__ py, const T* __restrict__ phi_in,
                    const T* __restrict__ phi_out,
                    const T* __restrict__ g_in, const T* __restrict__ g_out,
                    const unsigned char* __restrict__ eclipsed,
                    T* __restrict__ dpx, T* __restrict__ dpy, int j0,
                    int stride, int n, T& aq, T& ai, T& ax1, T& apl1) {
  Elem<T, S::n> s;
  row_setup<S>(q, incl, x1, s);
#pragma unroll 1
  for (int j = j0; j < n; j += stride) {
    T gx = (T)0, gy = (T)0;
    element_grad<S>(s, px[j], py[j], phi_in[j], phi_out[j], g_in[j],
                    g_out[j], eclipsed[j] != 0, gx, gy, aq, ai, ax1, apl1);
    if constexpr (S::px >= 0) {
      dpx[j] = gx;
      dpy[j] = gy;
    }
  }
}

// One row's elements j0, j0 + stride, ...: one pass in float32, two in
// float64.
template <typename T>
KB_FN void row_grad(T q, T incl, T x1, const T* __restrict__ px,
                    const T* __restrict__ py, const T* __restrict__ phi_in,
                    const T* __restrict__ phi_out,
                    const T* __restrict__ g_in, const T* __restrict__ g_out,
                    const unsigned char* __restrict__ eclipsed,
                    T* __restrict__ dpx, T* __restrict__ dpy, int j0,
                    int stride, int n, T& aq, T& ai, T& ax1, T& apl1) {
  if constexpr (sizeof(T) == 4) {
    row_pass<AllSlots>(q, incl, x1, px, py, phi_in, phi_out, g_in, g_out,
                       eclipsed, dpx, dpy, j0, stride, n, aq, ai, ax1, apl1);
  } else {
    row_pass<RowSlots>(q, incl, x1, px, py, phi_in, phi_out, g_in, g_out,
                       eclipsed, dpx, dpy, j0, stride, n, aq, ai, ax1, apl1);
    row_pass<ElemSlots>(q, incl, x1, px, py, phi_in, phi_out, g_in, g_out,
                        eclipsed, dpx, dpy, j0, stride, n, aq, ai, ax1, apl1);
  }
}

// ---- kernel and launcher ------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBlock)
contacts_backward_kernel(const T* __restrict__ q, const T* __restrict__ incl,
                         const T* __restrict__ x1, const T* __restrict__ px,
                         const T* __restrict__ py,
                         const T* __restrict__ phi_in,
                         const T* __restrict__ phi_out,
                         const T* __restrict__ g_in,
                         const T* __restrict__ g_out,
                         const unsigned char* __restrict__ eclipsed,
                         T* __restrict__ dpx, T* __restrict__ dpy,
                         T* __restrict__ drow, int rows, int n) {
  const int row = blockIdx.x;
  const size_t k0 = (size_t)row * n;
  T aq = (T)0, ai = (T)0, ax1 = (T)0, apl1 = (T)0;
  row_grad(q[row], incl[row], x1[row], px + k0, py + k0, phi_in + k0,
           phi_out + k0, g_in + k0, g_out + k0, eclipsed + k0, dpx + k0,
           dpy + k0, (int)threadIdx.x, kBlock, n, aq, ai, ax1, apl1);
  // the row's sums, in a fixed order: lanes by shuffles, then the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    aq += __shfl_down_sync(0xffffffffu, aq, off);
    ai += __shfl_down_sync(0xffffffffu, ai, off);
    ax1 += __shfl_down_sync(0xffffffffu, ax1, off);
    apl1 += __shfl_down_sync(0xffffffffu, apl1, off);
  }
  __shared__ T part[4 * (kBlock / 32)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[4 * warp] = aq;
    part[4 * warp + 1] = ai;
    part[4 * warp + 2] = ax1;
    part[4 * warp + 3] = apl1;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    T sum = part[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kBlock / 32; ++w) sum += part[4 * w + threadIdx.x];
    drow[(size_t)threadIdx.x * rows + row] = sum;
  }
}

}  // namespace

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
// is_double selects float64 (1) or float32 (0) for every float array.
extern "C" int contacts_backward_launch(
    int is_double, const void* q, const void* incl, const void* x1,
    const void* px, const void* py, const void* phi_in, const void* phi_out, const void* g_in, const void* g_out,
    const void* eclipsed, void* dpx, void* dpy, void* drow, int rows, int n,
    void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* e = (const unsigned char*)eclipsed;
  if (is_double)
    contacts_backward_kernel<double><<<rows, kBlock, 0, st>>>(
        (const double*)q, (const double*)incl, (const double*)x1,
        (const double*)px, (const double*)py,
        (const double*)phi_in, (const double*)phi_out, (const double*)g_in,
        (const double*)g_out, e, (double*)dpx, (double*)dpy, (double*)drow,
        rows, n);
  else
    contacts_backward_kernel<float><<<rows, kBlock, 0, st>>>(
        (const float*)q, (const float*)incl, (const float*)x1,
        (const float*)px, (const float*)py,
        (const float*)phi_in, (const float*)phi_out, (const float*)g_in,
        (const float*)g_out, e, (float*)dpx, (float*)dpy, (float*)drow, rows,
        n);
  return (int)cudaGetLastError();
}
