// Eclipse contact-interval solver (K1) for NVIDIA Hopper (sm_90a), in
// float32, in float64 and in mixed precision.
//
// Replaces the TPU kernel lfit_python_tpu/ops/pallas_contacts.py::_kernel
// together with its launcher element_intervals_pallas (the setup before
// the kernel and the arctan epilogue after it), and, for float64 and the
// mixed-precision mode, the plain XLA solver the JAX package runs there
// (lfit_python_tpu/roche/geometry.py::_contact_interval_impl).  The plain
// PyTorch version of the same algorithm is lfit_python_tpu_torch/roche/
// geometry.py::contact_interval (with ``precise`` for the mixed mode); the
// two are held to each other by the tests and by chip_smoke.py.
//
// For each (row, element) — a row is one (walker, eclipse) pair, an
// element an orbital-plane point (px, py, 0) of the disc or bright spot —
// the kernel finds the phase interval during which the donor's Roche lobe
// occults the point:
//   1. conjunction test: ray minimum at the conjunction direction (chord
//      midpoint seed, 3 clamped Newton steps, chord-endpoint insurance);
//   2. two-sided analytic bracket in w = tan(theta/2) from the inscribed
//      (certainly eclipsed) and enclosing (certainly visible) spheres;
//   3. per edge, 8 safeguarded envelope-Newton iterations in w with a
//      warm-started ray minimum, on-sphere endpoint insurance and
//      bisection fallback, returning the best EVALUATED point;
//   4. one atan per edge converts w back to phase.
// contacts_kernel<T> runs these in T (float or double).  The mixed kernel
// runs 1, 2 and the first 5 iterations of 3 in float32, then 4 iterations
// per edge in phase, carried in double and restarted from the original
// sphere bracket: each evaluates the decision quantity c = Phi - Phi_L1 in
// double from the row's double-solved (q, incl, Phi_L1) and the element's
// double position, at the float32 ray minimum t (the envelope theorem
// makes c first-order insensitive to t's error); t and the envelope
// derivative, which only steer Newton, stay float32.  The best evaluated
// phase is rounded to float32 at the end.
//
// What bounds it on the card: issued instructions, not bytes.  An element
// reads 8-24 bytes and writes 9-17, and an eclipsed one then does
// thousands of dependent scalar operations on them (the north star's
// 5120 x 512 call moves 45-90 MB, 13-27 us at 3.35 TB/s, and is 93%
// eclipsed).  So there is nothing for shared memory, TMA or the tensor
// cores (wgmma, or DMMA for float64) to do: no tile is reused and no
// product has a second dimension.  Each instantiation is bounded by the
// instructions it issues (its SASS counts and their time at each pipe's
// rate are in PERF.md, from tools/k1_sass_counts.py):
//   * float32: FP32 arithmetic and the selects around it.  Built with
//     --fmad=false, so every product and sum is rounded as the plain
//     version's separate tensor ops round it (and K2, built with the same
//     flags, stays bit-identical to its plain loop).  Its bits are the
//     plain version's but for rsqrt, atan and atan2.
//   * float64: the FP64 pipe, at half the FP32 rate, and sm_90 has no
//     double SFU: each double rsqrt, sqrt, divide and atan is a MUFU
//     estimate and a DFMA sequence.  So its arithmetic is fused
//     explicitly (mad() below: fma() is fused whatever --fmad says) in
//     the plain formula's own order; the divides by pi and 2 pi are
//     products by the reciprocal; the two quotients that only steer the
//     next iterate (the t-Newton step, the w-Newton step) take the
//     reciprocal estimate refined by one cubic DFMA step (steer(), ~1
//     ulp) instead of the IEEE divide with its range checks and slow
//     path.  Quotients that are part of a result (den in e_of, which
//     feeds e and so c) keep full rounding.  It stays within ~1e-13
//     cycles of the plain version's separately rounded ops (median
//     ~1e-16).
//   * mixed: the FP32 pipe for its float32 iterations and ray minima,
//     the FP64 pipe for its double c.  Its angles come from sincospi /
//     sincospif of 2 phi (an exact argument: no Payne-Hanek reduction, so
//     no array in local memory), c_refined is fused as above, and the two
//     edges' double tails run interleaved in one loop, as the float32
//     edges do, so that each thread has two dependency chains.
//
// What the design does about it: one thread owns one (row, element) and
// keeps all state in registers (no shared memory, nothing spilled to
// device memory between iterations; ptxas reports no stack frame for any
// instantiation); the ingress and egress chains are independent, so they
// are interleaved in one loop body to give the scheduler two dependency
// chains per thread, as the TPU kernel does.  Blocks of 128 threads cover
// a row's elements; the grid is (rows, ceil(N / 128)) and the kernel
// masks the ragged edge itself.  Visible elements share warps with
// eclipsed ones, but they idle only ~7% of the lanes that run the edge
// loop, and an idle lane costs no issue slot.  Compacting the eclipsed
// elements into a work list for a second, persistent pass (bit-identical)
// was measured slower on an H100: its conjunction-test pass alone costs
// 15% of this kernel, and the edge pass over the list is no faster than
// this kernel's whole run (PERF.md).
//
// Rounding: min / max / clip propagate NaN as torch.minimum /
// torch.maximum do, so an infeasible walker (NaN inclination) yields the
// same empty interval as the plain version.

#include <cuda_runtime.h>
#include <math.h>

#define K1_FN __device__ __forceinline__

namespace {

constexpr int kEdgeIters = 8;     // lockstep with geometry._EDGE_ITERS
constexpr int kEdgeItersF32 = 5;  // mixed: geometry._EDGE_ITERS_F32
constexpr int kEdgeItersF64 = 4;  // mixed: geometry._EDGE_ITERS_F64
constexpr int kTNewton = 3;       // lockstep with geometry._EDGE_T_NEWTON
constexpr double kPi = 3.14159265358979323846;
constexpr double kTwoPi = 6.28318530717958647692;
constexpr double kInvPi = 0.318309886183790671538;
constexpr double kInvTwoPi = 0.159154943091895335769;
constexpr int kBlock = 128;
// __launch_bounds__(kBlock, kMinBlocks): asking for one block per SM
// lets ptxas give the float64 instantiation 96 registers and no stack
// frame; without a minimum it holds it to 95 and spills (PERF.md)
constexpr int kMinBlocks = 1;

K1_FN float rsqrt_(float v) { return rsqrtf(v); }
K1_FN double rsqrt_(double v) { return rsqrt(v); }
K1_FN float sqrt_(float v) { return sqrtf(v); }
K1_FN double sqrt_(double v) { return sqrt(v); }
K1_FN float atan_(float v) { return atanf(v); }
K1_FN double atan_(double v) { return atan(v); }
K1_FN float atan2_(float y, float x) { return atan2f(y, x); }
K1_FN double atan2_(double y, double x) { return atan2(y, x); }
K1_FN float fabs_(float v) { return fabsf(v); }
K1_FN double fabs_(double v) { return fabs(v); }

// ---- arithmetic by type ---------------------------------------------
// float32 rounds every product and sum (the plain version's bits);
// float64 fuses.  Each call below is written so that its float32 form is
// the operation tree the plain formula has.

// a * b + c
K1_FN float mad(float a, float b, float c) { return a * b + c; }
K1_FN double mad(double a, double b, double c) { return fma(a, b, c); }

// t * t + 2 b t + c, |p + t e|^2 from b = p . e and c = |p|^2
K1_FN float dist2(float t, float b, float c) {
    return t * t + 2.0f * b * t + c;
}
K1_FN double dist2(double t, double b, double c) {
    return fma(t, t, fma(2.0 * b, t, c));
}

// x / pi and x / (2 pi)
K1_FN float over_pi(float x) { return x / float(kPi); }
K1_FN double over_pi(double x) { return x * kInvPi; }
K1_FN float over_two_pi(float x) { return x / float(kTwoPi); }
K1_FN double over_two_pi(double x) { return x * kInvTwoPi; }

// 1 / d to ~1 ulp for a positive or negative normal d: the reciprocal
// estimate (rcp.approx.ftz.f64, ~2^-22 relative; a float32 reciprocal on
// a host build) and one cubic Newton step, r (1 + e + e^2), e = 1 - d r
K1_FN double rcp_(double d) {
#ifdef __CUDA_ARCH__
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
#else
    double r = (double)(1.0f / (float)d);
#endif
    const double e = fma(-d, r, 1.0);
    return fma(fma(e, e, e), r, r);
}

// x - n / d for a quotient that only steers the next iterate.  float64
// takes the reciprocal above.  d = inf (the plain version's zero step at
// a flat derivative) then gives NaN and so the bisection that the zero
// step leads to: that iterate sits on an end of its bracket.
K1_FN float steer(float x, float n, float d) { return x - n / d; }
K1_FN double steer(double x, double n, double d) {
    return fma(-n, rcp_(d), x);
}

// NaN-propagating min / max, as torch.minimum / torch.maximum
template <typename T> K1_FN T nmax(T a, T b) {
    return (a > b || a != a) ? a : b;
}
template <typename T> K1_FN T nmin(T a, T b) {
    return (a < b || a != a) ? a : b;
}
template <typename T> K1_FN T clip(T x, T lo, T hi) {
    return nmin(nmax(x, lo), hi);
}

template <typename T> struct Elem {
    T px, py, c1, ww, wx, wy, mu, rad, inv_rad, i2_p, pl1;
};

// g(t) = Phi(p + t e) along the ray, from its two inverse distances:
// -(1 - mu) i1 - mu i2 - (cx^2 + cy^2) / 2
template <typename T>
K1_FN T g_from(const Elem<T>& s, T t, T ex, T ey, T i1, T i2) {
    T cx = mad(t, ex, s.px - s.mu);
    T cy = mad(t, ey, s.py);
    T pot = mad(-(T(1) - s.mu), i1, -(s.mu * i2));
    return mad(T(-0.5), mad(cx, cx, cy * cy), pot);
}

template <typename T>
K1_FN T g_val(const Elem<T>& s, T t, T ex, T ey, T b1, T b2) {
    T i1 = rsqrt_(dist2(t, b1, s.c1));
    T i2 = rsqrt_(dist2(t, b2, s.ww));
    return g_from(s, t, ex, ey, i1, i2);
}

// first and second t-derivatives of g at t
template <typename T>
K1_FN void g_derivs(const Elem<T>& s, T t, T ex, T ey, T b1, T b2, T& g1,
                    T& g2) {
    T i1 = rsqrt_(dist2(t, b1, s.c1));
    T i2 = rsqrt_(dist2(t, b2, s.ww));
    T u1 = t + b1, u2 = t + b2;
    T i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
    T cx = mad(t, ex, s.px - s.mu);
    T cy = mad(t, ey, s.py);
    g1 = mad((T(1) - s.mu) * u1, i13, (s.mu * u2) * i23)
         - mad(cx, ex, cy * ey);
    // (1 - mu) (i1^3 - 3 u1^2 i1^5) + mu (i2^3 - 3 u2^2 i2^5) - |e|^2
    T h1 = mad(-(T(3) * u1 * u1 * i13 * i1), i1, i13);
    T h2 = mad(-(T(3) * u2 * u2 * i23 * i2), i2, i23);
    g2 = mad(T(1) - s.mu, h1, s.mu * h2) - mad(ex, ex, ey * ey);
}

// the chord of the enclosing sphere along e: its midpoint tstar, clipped
// ends, whether the ray misses it, and b1 = p . e, b2 = b1 - ex
template <typename T> struct Chord {
    T tstar, half, t_lo, t_hi, b1, b2;
    bool no_occ;
};

template <typename T>
K1_FN Chord<T> chord(const Elem<T>& s, T ex, T ey) {
    Chord<T> h;
    h.tstar = mad(s.wx, ex, s.wy * ey);
    // rad^2 - (ww - tstar^2)
    T disc = mad(s.rad, s.rad, -mad(-h.tstar, h.tstar, s.ww));
    h.half = sqrt_(nmax(disc, T(0)));
    h.t_lo = nmax(h.tstar - h.half, T(0));
    h.t_hi = nmax(h.tstar + h.half, T(0));
    h.no_occ = disc <= T(0);
    h.b1 = mad(s.px, ex, s.py * ey);
    h.b2 = h.b1 - ex;
    return h;
}

// the ray minimum at the observer direction (ex, ey): chord-midpoint
// seed, kTNewton clamped Newton steps, chord-endpoint insurance.  Returns
// its value; t is where it lies, no_occ whether the ray misses the
// enclosing sphere.
template <typename T>
K1_FN T ray_min(const Elem<T>& s, T ex, T ey, T& t, bool& no_occ) {
    const Chord<T> h = chord(s, ex, ey);
    no_occ = h.no_occ;
    t = clip(h.tstar, h.t_lo, h.t_hi);
    for (int it = 0; it < kTNewton; ++it) {
        T g1, g2;
        g_derivs(s, t, ex, ey, h.b1, h.b2, g1, g2);
        // t - g1 / g2 where g2 > 1e-12, else t (a zero step)
        t = clip((g2 > T(1e-12)) ? steer(t, g1, nmax(g2, T(1e-12))) : t,
                 h.t_lo, h.t_hi);
    }
    T val = g_val(s, t, ex, ey, h.b1, h.b2);
    T v_lo = g_val(s, h.t_lo, ex, ey, h.b1, h.b2);
    T v_hi = g_val(s, h.t_hi, ex, ey, h.b1, h.b2);
    if (v_lo < val) t = h.t_lo;
    val = nmin(val, v_lo);
    if (v_hi < val) t = h.t_hi;
    return nmin(val, v_hi);
}

template <typename T> struct Edge {
    T sign, w, lo, hi, w_best, c_best, t;
};

// observer direction at phi_c + sign atan(w) / pi, rational in w
template <typename T>
K1_FN void e_of(T e_A, T e_B, T sign, T w, T& ex, T& ey, T& den) {
    den = T(1) / mad(w, w, T(1));
    T cd = mad(-w, w, T(1)) * den;
    T sd = (T(2) * w) * den;
    ex = mad(e_A, cd, -((sign * e_B) * sd));
    ey = -mad(e_B, cd, (sign * e_A) * sd);
}

// one safeguarded envelope-Newton iteration of one edge
template <typename T>
K1_FN void edge_step(const Elem<T>& s, T e_A, T e_B, Edge<T>& g) {
    T ex, ey, den;
    e_of(e_A, e_B, g.sign, g.w, ex, ey, den);
    const Chord<T> h = chord(s, ex, ey);
    const T t_lo = h.t_lo, t_hi = h.t_hi;
    T t = clip(g.t, t_lo, t_hi);
    T t_mid = clip(h.tstar, t_lo, t_hi);
    // warm polish step, well-guarded: a carried t in a concave region
    // (g2 <= 0) restarts from the chord midpoint
    T g1, g2;
    g_derivs(s, t, ex, ey, h.b1, h.b2, g1, g2);
    t = (g2 > T(1e-12)) ? clip(steer(t, g1, nmax(g2, T(1e-12))), t_lo, t_hi)
                        : t_mid;
    // clearance with endpoint insurance (on-sphere identity: the donor
    // term at an unclipped chord endpoint is exactly -mu / rad)
    T i1 = rsqrt_(dist2(t, h.b1, s.c1));
    T i2 = rsqrt_(dist2(t, h.b2, s.ww));
    T val = g_from(s, t, ex, ey, i1, i2);
    T i1_lo = rsqrt_(dist2(t_lo, h.b1, s.c1));
    T i2_lo = (h.tstar - h.half > T(0)) ? s.inv_rad : s.i2_p;
    T v_lo = g_from(s, t_lo, ex, ey, i1_lo, i2_lo);
    T i1_hi = rsqrt_(dist2(t_hi, h.b1, s.c1));
    T i2_hi = (h.tstar + h.half > T(0)) ? s.inv_rad : s.i2_p;
    T v_hi = g_from(s, t_hi, ex, ey, i1_hi, i2_hi);
    if (v_lo < val) { t = t_lo; i1 = i1_lo; i2 = i2_lo; }
    val = nmin(val, v_lo);
    if (v_hi < val) { t = t_hi; i1 = i1_hi; i2 = i2_hi; }
    val = nmin(val, v_hi);
    T c = h.no_occ ? T(10) : val - s.pl1;
    // keep the best evaluated point
    T ac = fabs_(c);
    if (ac < g.c_best) { g.w_best = g.w; g.c_best = ac; }
    if (c < T(0)) g.lo = g.w; else g.hi = g.w;
    // envelope derivative dc/dphi, converted to dc/dw by sign den / pi
    T rx = mad(t, ex, s.px);
    T ry = mad(t, ey, s.py);
    T i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
    T gx = mad((T(1) - s.mu) * rx, i13, (s.mu * (rx - T(1))) * i23)
           - (rx - s.mu);
    T gy = ry * (mad(T(1) - s.mu, i13, s.mu * i23) - T(1));
    T d = (t * T(kTwoPi)) * mad(gx, ey, -(gy * ex));
    T dd = (fabs_(d) > T(1e-12)) ? g.sign * den * d : T(INFINITY);
    T w_newton = steer(g.w, c * T(kPi), dd);
    bool inside = (w_newton - g.lo) * (w_newton - g.hi) < T(0);
    bool ok = inside && isfinite(w_newton) && !h.no_occ;
    g.w = ok ? w_newton : T(0.5) * (g.lo + g.hi);
    g.t = t;
}

// An element's setup, its conjunction test and its sphere bracket.
// sc: the row's [mu, sin i, cos i, 1 - xl1, Phi_L1, r_ins].
template <typename T> struct Setup {
    Elem<T> s;
    T phi_c, e_A, e_B, w_inscr, w_sphere;
    bool ecl;
};

template <typename T>
K1_FN Setup<T> setup(const T* sc, T px, T py) {
    Setup<T> u;
    Elem<T>& s = u.s;
    s.mu = sc[0];
    const T si = sc[1];
    s.rad = sc[3];
    s.pl1 = sc[4];
    const T r_ins = sc[5];
    s.px = px;
    s.py = py;
    s.wx = T(1) - s.px;
    s.wy = -s.py;
    s.ww = mad(s.wx, s.wx, s.wy * s.wy);
    s.c1 = mad(s.px, s.px, s.py * s.py);
    s.inv_rad = T(1) / s.rad;
    s.i2_p = rsqrt_(s.ww);
    u.phi_c = over_two_pi(atan2_(s.py, T(1) - s.px));

    // conjunction direction without trig: e(phi_c) = (e_A, -e_B, cos i)
    const T iw = rsqrt_(s.ww);
    u.e_A = si * s.wx * iw;
    u.e_B = si * s.py * iw;

    // 1. the eclipsed? test
    T t;
    bool no_occ;
    T val = ray_min(s, u.e_A, -u.e_B, t, no_occ);
    T c_mid = no_occ ? T(10) : val - s.pl1;
    u.ecl = c_mid < T(0);

    // 2. two-sided sphere bracket in w = tan(theta / 2)
    const T inv_den = T(1) / nmax(si * sqrt_(s.ww), T(1e-12));
    const T c_eff = clip(sqrt_(nmax(mad(-s.rad, s.rad, s.ww), T(0)))
                         * inv_den, T(0), T(1));
    u.w_sphere = sqrt_((T(1) - c_eff) / (T(1) + c_eff));
    const T c_ins = clip(sqrt_(nmax(mad(-r_ins, r_ins, s.ww), T(0)))
                         * inv_den, T(0), T(1));
    u.w_inscr = sqrt_((T(1) - c_ins) / (T(1) + c_ins));
    return u;
}

// 3. the ingress (sign -1) and egress (sign +1) edges after n_iters
// interleaved envelope-Newton iterations
template <typename T>
K1_FN void edges(const Setup<T>& u, int n_iters, Edge<T>& a, Edge<T>& b) {
    const T w0 = T(0.5) * (u.w_inscr + u.w_sphere);
    a = Edge<T>{T(-1), w0, u.w_inscr, u.w_sphere, w0, T(INFINITY), T(0)};
    b = Edge<T>{T(+1), w0, u.w_inscr, u.w_sphere, w0, T(INFINITY), T(0)};
    T ex, ey, den;
    e_of(u.e_A, u.e_B, a.sign, w0, ex, ey, den);
    a.t = mad(u.s.wx, ex, u.s.wy * ey);
    e_of(u.e_A, u.e_B, b.sign, w0, ex, ey, den);
    b.t = mad(u.s.wx, ex, u.s.wy * ey);
#pragma unroll 1
    for (int it = 0; it < n_iters; ++it) {
        edge_step(u.s, u.e_A, u.e_B, a);
        edge_step(u.s, u.e_A, u.e_B, b);
    }
}

// one element in T: (phi_in, phi_out, eclipsed)
template <typename T>
K1_FN void solve_element(const T* sc, T px, T py, T& pin, T& pout,
                         bool& ecl) {
    const Setup<T> u = setup(sc, px, py);
    ecl = u.ecl;
    pin = u.phi_c;
    pout = u.phi_c;
    if (u.ecl) {
        Edge<T> a, b;
        edges(u, kEdgeIters, a, b);
        // 4. one atan per edge back to phase
        pin = u.phi_c + T(-1) * over_pi(atan_(a.w_best));
        pout = u.phi_c + over_pi(atan_(b.w_best));
    }
}

// ---- the mixed-precision tail ---------------------------------------

// the row's double-solved scalars and the element's double position
struct Exact {
    double mu, si, pl1, px, py, c1, ww;
};

// c = Phi(p + t e(phi)) - Phi_L1 in double at the float32 ray minimum t
K1_FN double c_refined(const Exact& x, float t32, double phi) {
    const double t = (double)t32;
    double s, c;
    sincospi(2.0 * phi, &s, &c);
    const double ex = x.si * c, ey = -x.si * s;
    const double b1 = fma(x.px, ex, x.py * ey);
    const double b2 = b1 - ex;
    const double i1 = rsqrt(dist2(t, b1, x.c1));
    const double i2 = rsqrt(dist2(t, b2, x.ww));
    const double cx = fma(t, ex, x.px - x.mu);
    const double cy = fma(t, ey, x.py);
    const double pot = fma(-(1.0 - x.mu), i1, -(x.mu * i2));
    return fma(-0.5, fma(cx, cx, cy * cy), pot) - x.pl1;
}

// envelope derivative dc/dphi = grad(Phi) . t de/dphi, in float32
K1_FN float dc_dphi(const Elem<float>& s, float ci, float t, float ex,
                    float ey) {
    float rx = s.px + t * ex;
    float ry = s.py + t * ey;
    float rz = t * ci;
    float i1 = rsqrtf(rx * rx + ry * ry + rz * rz);
    float dx = rx - 1.0f;
    float i2 = rsqrtf(dx * dx + ry * ry + rz * rz);
    float i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
    float gx = (1.0f - s.mu) * rx * i13 + s.mu * dx * i23 - (rx - s.mu);
    float gy = ry * ((1.0f - s.mu) * i13 + s.mu * i23 - 1.0f);
    return t * float(kTwoPi) * (gx * ey - gy * ex);
}

// one edge's double tail: the phase iterate, its bracket and the best
// evaluated phase
struct Tail {
    double phi, lo, hi, best, c_best;
};

// the tail's start from the float32 iterate w and the sphere bracket
K1_FN Tail tail_start(const Setup<float>& u, float sign, float w) {
    const float inv_pi = float(1.0 / kPi);
    Tail g;
    g.phi = (double)(u.phi_c + sign * (atanf(w) * inv_pi));
    g.lo = (double)(u.phi_c + sign * (atanf(u.w_inscr) * inv_pi));
    g.hi = (double)(u.phi_c + sign * (atanf(u.w_sphere) * inv_pi));
    g.best = g.phi;
    g.c_best = INFINITY;
    return g;
}

// one iteration of an edge's tail, in phase
K1_FN void tail_step(const Setup<float>& u, const Exact& x, float si,
                     float ci, Tail& g) {
    float s32, c32;
    sincospif(2.0f * (float)g.phi, &s32, &c32);
    const float ex = si * c32, ey = -si * s32;
    float t;
    bool no_occ;
    ray_min(u.s, ex, ey, t, no_occ);
    const double c = no_occ ? (double)INFINITY : c_refined(x, t, g.phi);
    if (fabs(c) < g.c_best) { g.best = g.phi; g.c_best = fabs(c); }
    if (c < 0.0) g.lo = g.phi; else g.hi = g.phi;
    const double d = (double)dc_dphi(u.s, ci, t, ex, ey);
    // phi - c / d; a flat derivative (the plain version's division by
    // inf) keeps phi, which sits on a bracket end: the bisection below
    const double phi_newton = (fabs(d) > 1e-12) ? steer(g.phi, c, d)
                                                : g.phi;
    const bool inside = (phi_newton - g.lo) * (phi_newton - g.hi) < 0.0;
    const bool ok = inside && isfinite(phi_newton) && !no_occ;
    g.phi = ok ? phi_newton : 0.5 * (g.lo + g.hi);
}

// one element in mixed precision.  sc as for solve_element<float>;
// sc64: the row's double [mu, sin i, Phi_L1]
K1_FN void solve_element_mixed(const float* sc, const double* sc64,
                               float px, float py, double px64,
                               double py64, float& pin, float& pout,
                               bool& ecl) {
    const Setup<float> u = setup(sc, px, py);
    ecl = u.ecl;
    pin = u.phi_c;
    pout = u.phi_c;
    if (u.ecl) {
        Edge<float> a, b;
        edges(u, kEdgeItersF32, a, b);
        Exact x;
        x.mu = sc64[0];
        x.si = sc64[1];
        x.pl1 = sc64[2];
        x.px = px64;
        x.py = py64;
        x.c1 = fma(px64, px64, py64 * py64);
        const double wx = 1.0 - px64, wy = -py64;
        x.ww = fma(wx, wx, wy * wy);
        // the last kEdgeItersF64 iterations of both edges, interleaved,
        // carried in double and restarted from the sphere bracket
        Tail ta = tail_start(u, -1.0f, a.w);
        Tail tb = tail_start(u, +1.0f, b.w);
#pragma unroll 1
        for (int it = 0; it < kEdgeItersF64; ++it) {
            tail_step(u, x, sc[1], sc[2], ta);
            tail_step(u, x, sc[1], sc[2], tb);
        }
        pin = (float)ta.best;
        pout = (float)tb.best;
    }
}

// ---- kernel and launcher ------------------------------------------------

// scal: (rows, 6) of T = [mu, sin i, cos i, 1 - xl1, Phi_L1, r_ins]
template <typename T>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
contacts_kernel(const T* __restrict__ scal, const T* __restrict__ px_in,
                const T* __restrict__ py_in, T* __restrict__ phi_in,
                T* __restrict__ phi_out,
                unsigned char* __restrict__ eclipsed, int n) {
    const int row = blockIdx.x;
    const int j = blockIdx.y * kBlock + threadIdx.x;
    if (j >= n) return;
    const long long k = (long long)row * n + j;
    T pin, pout;
    bool ecl;
    solve_element(scal + 6LL * row, px_in[k], py_in[k], pin, pout, ecl);
    phi_in[k] = pin;
    phi_out[k] = pout;
    eclipsed[k] = ecl ? 1 : 0;
}

// scal as above in float32, scal64: (rows, 3) of double = [mu, sin i,
// Phi_L1] solved in double; px64, py64 the double positions
__global__ void __launch_bounds__(kBlock, kMinBlocks)
contacts_mixed_kernel(const float* __restrict__ scal,
                      const double* __restrict__ scal64,
                      const float* __restrict__ px_in,
                      const float* __restrict__ py_in,
                      const double* __restrict__ px64,
                      const double* __restrict__ py64,
                      float* __restrict__ phi_in,
                      float* __restrict__ phi_out,
                      unsigned char* __restrict__ eclipsed, int n) {
    const int row = blockIdx.x;
    const int j = blockIdx.y * kBlock + threadIdx.x;
    if (j >= n) return;
    const long long k = (long long)row * n + j;
    float pin, pout;
    bool ecl;
    solve_element_mixed(scal + 6LL * row, scal64 + 3LL * row, px_in[k],
                        py_in[k], px64[k], py64[k], pin, pout, ecl);
    phi_in[k] = pin;
    phi_out[k] = pout;
    eclipsed[k] = ecl ? 1 : 0;
}

}  // namespace

// Launches K1 on ``stream`` for ``rows`` x ``n`` elements and returns
// cudaGetLastError() (0 on success).  All pointers are device pointers to
// contiguous arrays of float64 (is_double = 1) or float32 (0), uint8 for
// ``eclipsed``.
extern "C" int contacts_launch(int is_double, const void* scal,
                               const void* px, const void* py, void* phi_in,
                               void* phi_out, unsigned char* eclipsed,
                               int rows, int n, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    dim3 grid(rows, (n + kBlock - 1) / kBlock);
    cudaStream_t st = (cudaStream_t)stream;
    if (is_double)
        contacts_kernel<double><<<grid, kBlock, 0, st>>>(
            (const double*)scal, (const double*)px, (const double*)py,
            (double*)phi_in, (double*)phi_out, eclipsed, n);
    else
        contacts_kernel<float><<<grid, kBlock, 0, st>>>(
            (const float*)scal, (const float*)px, (const float*)py,
            (float*)phi_in, (float*)phi_out, eclipsed, n);
    return (int)cudaGetLastError();
}

// The mixed-precision K1: float32 scal, px, py and outputs; double scal64,
// px64, py64.
extern "C" int contacts_mixed_launch(const float* scal, const double* scal64,
                                     const float* px, const float* py,
                                     const double* px64, const double* py64,
                                     float* phi_in, float* phi_out,
                                     unsigned char* eclipsed, int rows, int n,
                                     void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    dim3 grid(rows, (n + kBlock - 1) / kBlock);
    contacts_mixed_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        scal, scal64, px, py, px64, py64, phi_in, phi_out, eclipsed, n);
    return (int)cudaGetLastError();
}
