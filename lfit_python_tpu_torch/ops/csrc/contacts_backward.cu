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
// parameter t, the end-point selects, the no-occultation branch) and its
// phase derivative dc/dphi, and passes the adjoint w = g * (-1 / dcdphi)
// (a non-finite coefficient counts as 0) back through c into the gradients.
// A never-eclipsed element carries phi_c = atan2(py, 1 - px) / 2 pi and
// that function's gradient.  d px and d py are per element; d q, d incl,
// d x1 and d pl1 are sums over the row.
//
// How dc/dtheta is taken: reverse mode.  c is one number per edge, so an
// edge runs the residual's forward once, keeping its chord, its end values
// and its 4 Newton iterates (struct Edge), then sweeps back from c with one
// adjoint, recomputing each Newton step's terms from its iterate (struct
// Step) rather than keeping them.  The sweep's rules are PyTorch's backward
// rules themselves, also where they are a convention and not calculus:
// clamp passes the adjoint where x >= its floor; minimum / maximum pass it
// to the smaller / larger side, half to each at a tie and all to both with
// a NaN on either side; where() passes it to the selected side (the
// guarded Newton step's other branch gets 0, which still meets the divide's
// rule, as in autograd).  The chord ends reach c only through such clamps
// and selects, which is why d c / d x1 is exactly 0 wherever the Newton
// iterate stays inside the chord.  The row's inputs enter as mu, sin(incl)
// and the sphere's radius; their adjoints are summed over the row first and
// mapped to q, incl and x1 once, as autograd does at a broadcast.
//
// Skipped work.  A non-eclipsed element's edges have cotangent 0 (the
// plain backward masks g by the flag), so their residual is not evaluated:
// the plain backward gives exactly 0 there as long as its partials are
// finite, which they are for finite inputs (short of a ray through a
// star's centre).  Where an input of the element or its row is not finite,
// the edges run with adjoint 0, and the NaNs reach the sums as they do in
// autograd.
//
// What bounds it on the card: instructions, not bytes.  An element moves 33
// bytes (px, py, two phases, two cotangents and a flag in, d px and d py
// out) against ~1,500 operations for its two edges; the bytes of the main
// path's 1280 x 512 call are 0.006 ms at 3.35 TB/s.
//
// What the design does about it: one thread owns one element at a time
// and does both of its edges in registers; nothing is indexed at run time,
// so nothing lives in local memory (ptxas: 0 bytes stack frame in both
// dtypes, one pass each).  One block owns one row and strides over its
// elements (any n >= 1).  The block's shape follows the register count,
// measured on an H100 against the 1280 x 512 rows of the main path
// (PERF.md): float32 needs 142 registers unbounded, and 118 with no spill
// when asked for 4 blocks of 128 threads an SM, so a row is 128 threads of
// 4 elements each and 528 rows are resident at once (1280 rows in 2.4
// waves: 89.8 us); blocks of 64 with 8 an SM (1.2 waves, the second a
// fifth full) took 106.7 us, one warp a row 108.8 us, and 96 registers
// (all rows in one wave) spill 72-80 bytes.  float64 takes 32 threads a
// row at 244-254 registers, no spill.  The four row sums are the block's:
// each thread adds its own elements in order, a warp adds its lanes by
// shuffles, and thread 0 adds the warp totals from shared memory in order.
// No atomics: the same inputs give the same bits on every run.
//
// Closeness to the plain version: not bit for bit.  The sums run in
// another order, and the angles come from sincospi(2 phi) and
// sincospi(incl / 180), which need no Payne-Hanek reduction (sinf / cosf
// carry one with a local-memory array) and round the angle once less than
// sin(2 pi phi).  Two float32 evaluations that round their angles
// differently differ by about as much as each errs against float64, most
// where 1 / dcdphi is large (near-grazing elements), which is what the
// float32 gate of PERF.md allows.  Built with --fmad=false like K1.  A row
// with a NaN input gives NaN in all its gradients but d pl1; the posterior
// zeroes non-finite gradients.
//
// Arrays, row-major: q, incl, x1 (R,) of T (pl1 enters c as -pl1: its
// value is not needed); px, py, phi_in, phi_out, g_in, g_out (R, N) of T;
// eclipsed (R, N) of bytes (0 / 1); outputs dpx, dpy (R, N) of T and drow
// (4, R) of T = d q, d incl, d x1, d pl1.

#include <cuda_runtime.h>
#include <math.h>

#define KB_FN __device__ __forceinline__

namespace {

constexpr int kTNewton = 3;       // lockstep with geometry._EDGE_T_NEWTON
constexpr int kThreadsF32 = 128;  // threads per row (one block), float32
constexpr int kThreadsF64 = 32;   // and float64
constexpr int kMinBlocksF32 = 4;  // resident blocks an SM asked of ptxas
constexpr int kMinBlocksF64 = 1;

KB_FN float rsqrt_(float v) { return rsqrtf(v); }
KB_FN double rsqrt_(double v) { return rsqrt(v); }
KB_FN float sqrt_(float v) { return sqrtf(v); }
KB_FN double sqrt_(double v) { return sqrt(v); }
// sin(pi v), cos(pi v)
KB_FN void sincospi_(float v, float& s, float& c) { sincospif(v, &s, &c); }
KB_FN void sincospi_(double v, double& s, double& c) { sincospi(v, &s, &c); }
template <typename T> KB_FN bool finite_(T v) { return v - v == (T)0; }

// torch.clamp(min=lo), torch.minimum, torch.maximum: NaN propagates
template <typename T> KB_FN T clamp_min(T v, T lo) { return v < lo ? lo : v; }
template <typename T> KB_FN T tmin(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T> KB_FN T tmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T> KB_FN T clip(T x, T lo, T hi) { return tmin(tmax(x, lo), hi); }

// PyTorch's backward of minimum(a, b) / maximum(a, b) for the adjoint g:
// the losing side gets 0, a tie halves g, a NaN on either side passes g
// to both
template <typename T> KB_FN void min_adj(T a, T b, T g, T& ga, T& gb) {
  const T h = a == b ? g * (T)0.5 : g;
  ga = a > b ? (T)0 : h;
  gb = a < b ? (T)0 : h;
}
template <typename T> KB_FN void max_adj(T a, T b, T g, T& ga, T& gb) {
  const T h = a == b ? g * (T)0.5 : g;
  ga = a < b ? (T)0 : h;
  gb = a > b ? (T)0 : h;
}

// the row's scalars: mu = q / (1 + q), sin and cos of the inclination,
// the enclosing sphere's radius 1 - x1
template <typename T> struct Row { T mu, one_mu, si, ci, rad; };
// the element's: px, py, w = (1, 0) - p, |w|^2, |p|^2
template <typename T> struct Elem { T px, py, wx, wy, ww, c1; };

// what an edge's forward keeps for its reverse sweep (the chord is made
// again at its end, by chord(), rather than kept)
template <typename T> struct Edge {
  T sn, cs, ex, ey, t_lo, t_hi, b1, b2, ee;
  T t[kTNewton + 1];              // t[0] the clipped start, t[k + 1] step k's
  bool no_occ;
};

// the ray's chord of the enclosing sphere: its closest approach tstar,
// disc = rad^2 - |w - tstar e|^2, half = sqrt(clamp(disc, 1e-30)) and the
// far end tstar + half before its clamp
template <typename T> struct Chord { T tstar, disc, half, hi_raw; };

// the adjoints one edge's sweep gathers before they reach the element's
// and the row's; those of px, py, |p|^2, |w|^2 and mu go straight to the
// element's (g.px, ...) and the row's (g.mu) sums
template <typename T> struct Adj { T t_lo, t_hi, b1, b2, ex, ey, ee; };

// an element's adjoints of px, py, wx, wy, ww, c1, and the row's of mu
template <typename T> struct Sink { T px, py, wx, wy, ww, c1, mu; };

// a thread's running sums of the row's adjoints: mu, sin(incl), the
// sphere's radius, pl1
template <typename T> struct RowAcc { T mu, si, rad, pl1; };

// the terms of one Newton step at the iterate t
template <typename T> struct Step { T i1, i2, u1, u2, i13, i23, cx, cy, g1, g2; };

template <typename T>
KB_FN Step<T> newton_terms(const Row<T>& r, const Elem<T>& el,
                           const Edge<T>& e, T t) {
  Step<T> s;
  s.i1 = rsqrt_(t * t + (T)2 * e.b1 * t + el.c1);
  s.i2 = rsqrt_(t * t + (T)2 * e.b2 * t + el.ww);
  s.u1 = t + e.b1;
  s.u2 = t + e.b2;
  s.i13 = s.i1 * s.i1 * s.i1;
  s.i23 = s.i2 * s.i2 * s.i2;
  s.cx = el.px - r.mu + t * e.ex;
  s.cy = el.py + t * e.ey;
  s.g1 = r.one_mu * s.u1 * s.i13 + r.mu * s.u2 * s.i23
         - (s.cx * e.ex + s.cy * e.ey);
  s.g2 = r.one_mu * (s.i13 - (T)3 * s.u1 * s.u1 * s.i13 * s.i1 * s.i1)
         + r.mu * (s.i23 - (T)3 * s.u2 * s.u2 * s.i23 * s.i2 * s.i2) - e.ee;
  return s;
}

// g(t) = Phi(p + t e) along the ray
template <typename T>
KB_FN T g_val(const Row<T>& r, const Elem<T>& el, const Edge<T>& e, T t) {
  const T i1 = rsqrt_(t * t + (T)2 * e.b1 * t + el.c1);
  const T i2 = rsqrt_(t * t + (T)2 * e.b2 * t + el.ww);
  const T cx = el.px - r.mu + t * e.ex;
  const T cy = el.py + t * e.ey;
  return -r.one_mu * i1 - r.mu * i2 - (T)0.5 * (cx * cx + cy * cy);
}

template <typename T>
KB_FN Chord<T> chord(const Row<T>& r, const Elem<T>& el, T ex, T ey) {
  Chord<T> h;
  h.tstar = el.wx * ex + el.wy * ey;
  h.disc = r.rad * r.rad - (el.ww - h.tstar * h.tstar);
  h.half = sqrt_(clamp_min(h.disc, (T)1e-30));
  h.hi_raw = h.tstar + h.half;
  return h;
}

// The forward of one edge at the phase phi: the chord's clamped ends, the
// no-occultation flag and the Newton iterates.
template <typename T>
KB_FN Edge<T> edge_forward(const Row<T>& r, const Elem<T>& el, T phi) {
  Edge<T> e;
  sincospi_((T)2 * phi, e.sn, e.cs);
  e.ex = r.si * e.cs;
  e.ey = -r.si * e.sn;
  const Chord<T> h = chord(r, el, e.ex, e.ey);
  e.t_lo = clamp_min(h.tstar - h.half, (T)0);
  e.t_hi = clamp_min(h.hi_raw, (T)0);
  e.no_occ = h.disc <= (T)0 || h.hi_raw <= (T)1e-9;
  e.b1 = el.px * e.ex + el.py * e.ey;
  e.b2 = e.b1 - e.ex;
  e.ee = e.ex * e.ex + e.ey * e.ey;
  e.t[0] = clip(h.tstar, e.t_lo, e.t_hi);
#pragma unroll
  for (int k = 0; k < kTNewton; ++k) {
    const Step<T> s = newton_terms(r, el, e, e.t[k]);
    // where(g2 > 1e-12, g1 / clamp(g2, 1e-12), 0)
    const T step = s.g2 > (T)1e-12 ? s.g1 / clamp_min(s.g2, (T)1e-12) : (T)0;
    e.t[k + 1] = clip(e.t[k] - step, e.t_lo, e.t_hi);
  }
  return e;
}

// The adjoints of i1 = rsqrt(t^2 + 2 b1 t + c1), i2 = rsqrt(t^2 + 2 b2 t
// + ww), cx = px - mu + t ex and cy = py + t ey at t, passed on to what
// they are made of; returns the part that reaches t.
template <typename T>
KB_FN T ray_adj(const Edge<T>& e, T t, T i1, T i2, T g_i1, T g_i2, T g_cx,
                T g_cy, Adj<T>& a, Sink<T>& k) {
  const T g_a1 = (T)-0.5 * g_i1 * (i1 * i1 * i1);
  const T g_a2 = (T)-0.5 * g_i2 * (i2 * i2 * i2);
  k.c1 += g_a1;
  k.ww += g_a2;
  a.b1 += (T)2 * t * g_a1;
  a.b2 += (T)2 * t * g_a2;
  k.px += g_cx;
  k.mu -= g_cx;
  a.ex += t * g_cx;
  k.py += g_cy;
  a.ey += t * g_cy;
  return ((T)2 * t + (T)2 * e.b1) * g_a1 + ((T)2 * t + (T)2 * e.b2) * g_a2
         + e.ex * g_cx + e.ey * g_cy;
}

// g(t) in reverse for its adjoint g: returns the adjoint of t
template <typename T>
KB_FN T g_val_adj(const Row<T>& r, const Elem<T>& el, const Edge<T>& e, T t,
                  T g, Adj<T>& a, Sink<T>& k) {
  const T i1 = rsqrt_(t * t + (T)2 * e.b1 * t + el.c1);
  const T i2 = rsqrt_(t * t + (T)2 * e.b2 * t + el.ww);
  const T cx = el.px - r.mu + t * e.ex;
  const T cy = el.py + t * e.ey;
  k.mu += g * (i1 - i2);
  return ray_adj(e, t, i1, i2, -g * r.one_mu, -g * r.mu, -g * cx, -g * cy, a,
                 k);
}

// Newton step k, t -> clip(t - step, t_lo, t_hi), in reverse: its terms
// again from the iterate t, then the adjoint g of the next iterate back to
// t (returned) and to what the step is made of.
template <typename T>
KB_FN T newton_adj(const Row<T>& r, const Elem<T>& el, const Edge<T>& e, T t,
                   T g, Adj<T>& a, Sink<T>& k) {
  const Step<T> s = newton_terms(r, el, e, t);
  const bool ok = s.g2 > (T)1e-12;
  const T g2c = clamp_min(s.g2, (T)1e-12);
  const T quot = s.g1 / g2c;
  const T x = t - (ok ? quot : (T)0);
  T g_m, g_x, g_lo, g_hi;
  min_adj(tmax(x, e.t_lo), e.t_hi, g, g_m, g_hi);
  max_adj(x, e.t_lo, g_m, g_x, g_lo);
  a.t_lo += g_lo;
  a.t_hi += g_hi;
  // the where() passes -g_x to the quotient only where it was taken
  const T g_q = ok ? -g_x : (T)0;
  const T g_g1 = g_q / g2c;
  const T g_g2 = s.g2 >= (T)1e-12 ? -g_q * (quot / g2c) : (T)0;
  // g1 and g2 back to their terms
  const T i12 = s.i1 * s.i1, i22 = s.i2 * s.i2;
  const T h1 = s.i13 - (T)3 * s.u1 * s.u1 * s.i13 * i12;
  const T h2 = s.i23 - (T)3 * s.u2 * s.u2 * s.i23 * i22;
  const T g_u1 = r.one_mu * s.i13 * (g_g1 - (T)6 * s.u1 * i12 * g_g2);
  const T g_u2 = r.mu * s.i23 * (g_g1 - (T)6 * s.u2 * i22 * g_g2);
  const T g_i1 = (T)3 * r.one_mu * i12
                 * (s.u1 * g_g1 + ((T)1 - (T)5 * s.u1 * s.u1 * i12) * g_g2);
  const T g_i2 = (T)3 * r.mu * i22
                 * (s.u2 * g_g1 + ((T)1 - (T)5 * s.u2 * s.u2 * i22) * g_g2);
  k.mu += (s.u2 * s.i23 - s.u1 * s.i13) * g_g1 + (h2 - h1) * g_g2;
  a.ex -= s.cx * g_g1;
  a.ey -= s.cy * g_g1;
  a.ee -= g_g2;
  a.b1 += g_u1;
  a.b2 += g_u2;
  return g_x + g_u1 + g_u2
         + ray_adj(e, t, s.i1, s.i2, g_i1, g_i2, -e.ex * g_g1, -e.ey * g_g1, a,
                   k);
}

// One edge at the phase phi with the cotangent g of that phase: the
// residual's forward, dc/dphi, and the reverse sweep of w = g * (-1 /
// dcdphi) into the element's adjoints and the thread's row sums (k, acc).
template <typename T>
KB_FN void edge_grad(const Row<T>& r, const Elem<T>& el, T phi, T g,
                     Sink<T>& k, RowAcc<T>& acc) {
  const Edge<T> e = edge_forward(r, el, phi);
  const T t3 = e.t[kTNewton];
  const T val = g_val(r, el, e, t3);
  const T v_lo = g_val(r, el, e, e.t_lo);
  const T v_hi = g_val(r, el, e, e.t_hi);
  T tv = v_lo < val ? e.t_lo : t3;       // the minimiser: its value is all
  const T m1 = tmin(val, v_lo);          // dc/dphi needs
  tv = v_hi < m1 ? e.t_hi : tv;

  // the envelope derivative dc/dphi at the minimiser, values only
  const T mu = r.mu;
  const T rx = el.px + tv * e.ex, ry = el.py + tv * e.ey, rz = tv * r.ci;
  const T j1 = rsqrt_(rx * rx + ry * ry + rz * rz);
  const T dx = rx - (T)1;
  const T j2 = rsqrt_(dx * dx + ry * ry + rz * rz);
  const T j13 = j1 * j1 * j1, j23 = j2 * j2 * j2;
  const T gx = ((T)1 - mu) * rx * j13 + mu * dx * j23 - (rx - mu);
  const T gy = ry * (((T)1 - mu) * j13 + mu * j23 - (T)1);
  const T dcdphi = tv * (T)6.283185307179586 * (gx * e.ey - gy * e.ex);
  T coeff = (T)-1 / dcdphi;
  coeff = finite_(coeff) ? coeff : (T)0;
  // c = where(no_occ, clear, min(min(val, v_lo), v_hi) - pl1)
  const T w = e.no_occ ? (T)0 : g * coeff;
  acc.pl1 -= w;

  Adj<T> a = {};
  T g_m1, g_val3, g_lo, g_hi;
  min_adj(m1, v_hi, w, g_m1, g_hi);
  min_adj(val, v_lo, g_m1, g_val3, g_lo);
  a.t_lo += g_val_adj(r, el, e, e.t_lo, g_lo, a, k);
  a.t_hi += g_val_adj(r, el, e, e.t_hi, g_hi, a, k);
  T gt = g_val_adj(r, el, e, t3, g_val3, a, k);
#pragma unroll
  for (int i = kTNewton - 1; i >= 0; --i)
    gt = newton_adj(r, el, e, e.t[i], gt, a, k);
  // t[0] = clip(tstar, t_lo, t_hi)
  const Chord<T> h = chord(r, el, e.ex, e.ey);
  T g_m0, g_ts;
  min_adj(tmax(h.tstar, e.t_lo), e.t_hi, gt, g_m0, g_hi);
  max_adj(h.tstar, e.t_lo, g_m0, g_ts, g_lo);
  a.t_lo += g_lo;
  a.t_hi += g_hi;
  // the chord: t_lo = clamp(tstar - half, 0), t_hi = clamp(tstar + half,
  // 0), half = sqrt(clamp(disc, 1e-30)), disc = rad^2 - (ww - tstar^2)
  const T g_lraw = h.tstar - h.half >= (T)0 ? a.t_lo : (T)0;
  const T g_hraw = h.hi_raw >= (T)0 ? a.t_hi : (T)0;
  const T g_half = g_hraw - g_lraw;
  const T g_disc = h.disc >= (T)1e-30 ? g_half / ((T)2 * h.half) : (T)0;
  g_ts += g_lraw + g_hraw + (T)2 * h.tstar * g_disc;
  acc.rad += (T)2 * r.rad * g_disc;
  // tstar = w . e, ee = e . e, b2 = b1 - ex, b1 = p . e
  const T g_b1 = a.b1 + a.b2;
  const T g_ex = a.ex + el.wx * g_ts + (T)2 * e.ex * a.ee - a.b2
                 + el.px * g_b1;
  const T g_ey = a.ey + el.wy * g_ts + (T)2 * e.ey * a.ee + el.py * g_b1;
  // ex = si cos(2 pi phi), ey = -si sin(2 pi phi)
  acc.si += e.cs * g_ex - e.sn * g_ey;
  k.px += e.ex * g_b1;
  k.py += e.ey * g_b1;
  k.wx += e.ex * g_ts;
  k.wy += e.ey * g_ts;
  k.ww -= g_disc;
}

template <typename T> KB_FN Row<T> row_setup(T q, T incl, T x1) {
  Row<T> r;
  r.mu = q / ((T)1 + q);
  r.one_mu = (T)1 - r.mu;
  sincospi_(incl / (T)180, r.si, r.ci);
  r.rad = (T)1 - x1;
  return r;
}

// one element's inputs
template <typename T> struct ElemIn {
  T px, py, phi_in, phi_out, g_in, g_out;
  bool ecl;
};

// One element: its gradient in px and py (returned in dpx, dpy) and its
// share of the row's sums (added to acc).
template <typename T>
KB_FN void element_grad(const Row<T>& r, bool row_finite, const ElemIn<T>& in,
                        T& dpx, T& dpy, RowAcc<T>& acc) {
  Elem<T> el;
  el.px = in.px;
  el.py = in.py;
  el.wx = (T)1 - in.px;
  el.wy = -in.py;
  el.ww = el.wx * el.wx + el.wy * el.wy;
  el.c1 = in.px * in.px + in.py * in.py;
  Sink<T> k = {(T)0, (T)0, (T)0, (T)0, (T)0, (T)0, (T)0};
  const bool finite = row_finite && finite_(in.px) && finite_(in.py)
                      && finite_(in.phi_in) && finite_(in.phi_out);
  if (in.ecl || !finite) {
    edge_grad(r, el, in.phi_in, in.ecl ? in.g_in : (T)0, k, acc);
    edge_grad(r, el, in.phi_out, in.ecl ? in.g_out : (T)0, k, acc);
  }
  acc.mu += k.mu;
  const T g_wx = k.wx + (T)2 * el.wx * k.ww;
  const T g_wy = k.wy + (T)2 * el.wy * k.ww;
  dpx = k.px + (T)2 * in.px * k.c1 - g_wx;
  dpy = k.py + (T)2 * in.py * k.c1 - g_wy;
  // never eclipsed: phi_in = phi_out = atan2(py, 1 - px) / 2 pi
  const T g_c = (in.ecl ? (T)0 : in.g_in + in.g_out) / (T)6.283185307179586;
  const T r2 = el.wx * el.wx + in.py * in.py;
  dpx += g_c * in.py / r2;
  dpy += g_c * el.wx / r2;
}

// One thread's elements j0, j0 + stride, ... of a row: d px and d py
// written, the row's adjoints added to acc.
template <typename T>
KB_FN void row_thread(T q, T incl, T x1, const T* __restrict__ px,
                      const T* __restrict__ py, const T* __restrict__ phi_in,
                      const T* __restrict__ phi_out,
                      const T* __restrict__ g_in, const T* __restrict__ g_out,
                      const unsigned char* __restrict__ eclipsed,
                      T* __restrict__ dpx, T* __restrict__ dpy, int j0,
                      int stride, int n, RowAcc<T>& acc) {
  const Row<T> r = row_setup(q, incl, x1);
  const bool row_finite = finite_(q) && finite_(incl) && finite_(x1);
#pragma unroll 1
  for (int j = j0; j < n; j += stride) {
    const ElemIn<T> in = {px[j], py[j], phi_in[j], phi_out[j], g_in[j],
                          g_out[j], eclipsed[j] != 0};
    T gx, gy;
    element_grad(r, row_finite, in, gx, gy, acc);
    dpx[j] = gx;
    dpy[j] = gy;
  }
}

// The row's four gradients from its summed adjoints s = (mu, sin(incl),
// radius, pl1): mu = q / (1 + q), sin of incl in degrees, radius 1 - x1.
template <typename T>
KB_FN void row_finish(T q, T incl, const T (&s)[4], T& dq, T& dincl, T& dx1,
                      T& dpl1) {
  const T den = (T)1 + q;
  dq = s[0] / den - s[0] * (q / den / den);
  T sn, cs;
  sincospi_(incl / (T)180, sn, cs);
  dincl = s[1] * cs * (T)0.017453292519943295;
  dx1 = -s[2];
  dpl1 = s[3];
}

// ---- kernel and launcher ------------------------------------------------

template <typename T, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  constexpr int kWarps = kThreads / 32;
  const int row = blockIdx.x;
  const size_t k0 = (size_t)row * n;
  RowAcc<T> acc = {(T)0, (T)0, (T)0, (T)0};
  row_thread(q[row], incl[row], x1[row], px + k0, py + k0, phi_in + k0,
             phi_out + k0, g_in + k0, g_out + k0, eclipsed + k0, dpx + k0,
             dpy + k0, (int)threadIdx.x, kThreads, n, acc);
  // the row's sums, in a fixed order: lanes by shuffles, then the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc.mu += __shfl_down_sync(0xffffffffu, acc.mu, off);
    acc.si += __shfl_down_sync(0xffffffffu, acc.si, off);
    acc.rad += __shfl_down_sync(0xffffffffu, acc.rad, off);
    acc.pl1 += __shfl_down_sync(0xffffffffu, acc.pl1, off);
  }
  __shared__ T part[4][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = acc.mu;
    part[1][warp] = acc.si;
    part[2][warp] = acc.rad;
    part[3][warp] = acc.pl1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = part[i][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s[i] += part[i][w];
    }
    row_finish(q[row], incl[row], s, drow[row], drow[(size_t)rows + row],
               drow[2 * (size_t)rows + row], drow[3 * (size_t)rows + row]);
  }
}

}  // namespace

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
// is_double selects float64 (1) or float32 (0) for every float array.
extern "C" int contacts_backward_launch(
    int is_double, const void* q, const void* incl, const void* x1,
    const void* px, const void* py, const void* phi_in, const void* phi_out,
    const void* g_in, const void* g_out, const void* eclipsed, void* dpx,
    void* dpy, void* drow, int rows, int n, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* e = (const unsigned char*)eclipsed;
  if (is_double)
    contacts_backward_kernel<double, kThreadsF64, kMinBlocksF64>
        <<<rows, kThreadsF64, 0, st>>>(
        (const double*)q, (const double*)incl, (const double*)x1,
        (const double*)px, (const double*)py, (const double*)phi_in,
        (const double*)phi_out, (const double*)g_in, (const double*)g_out, e,
        (double*)dpx, (double*)dpy, (double*)drow, rows, n);
  else
    contacts_backward_kernel<float, kThreadsF32, kMinBlocksF32>
        <<<rows, kThreadsF32, 0, st>>>(
        (const float*)q, (const float*)incl, (const float*)x1,
        (const float*)px, (const float*)py, (const float*)phi_in,
        (const float*)phi_out, (const float*)g_in, (const float*)g_out, e,
        (float*)dpx, (float*)dpy, (float*)drow, rows, n);
  return (int)cudaGetLastError();
}
