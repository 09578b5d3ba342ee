// Eclipse contact-interval solver (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lfit_python_tpu/ops/pallas_contacts.py::_kernel
// together with its launcher element_intervals_pallas (the setup before
// the kernel and the arctan epilogue after it).  The plain PyTorch version
// of the same algorithm is lfit_python_tpu_torch/roche/geometry.py::
// contact_interval; the two are held to each other by the tests and by
// chip_smoke.py.
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
//
// What bounds it on the card: issued instructions, not bytes.  At the
// north-star shape (5120 rows x 512 elements) the kernel reads 8 bytes
// and writes 9 per element (44.6 MB, 13 us at 3.35 TB/s), while every
// element needs ~287 operations for its setup and conjunction test and
// an eclipsed one ~3,400 more for its bracket, 16 edge steps and atans
// (counted by hand from this source, each rsqrt, sqrt, divide and atan
// as one).  About 93% of the north-star's elements are eclipsed, so a
// call is ~9 GFLOP: ~135 us at the f32 peak of 67 TFLOP/s, which counts
// a fused multiply-add as two; --fmad=false forbids those, and each
// divide, sqrt and atan is several instructions.
//
// What the design does about it: one thread owns one (row, element) and
// keeps all state in registers (no shared memory, nothing spilled to
// device memory between iterations); the ingress and egress chains are
// independent, so they are interleaved in one loop body to give the
// scheduler two dependency chains per thread, as the TPU kernel does.
// Blocks of 128 threads cover a row's elements; the grid is
// (rows, ceil(N / 128)) and the kernel masks the ragged edge itself.
// Visible elements share warps with eclipsed ones, but they idle only
// ~7% of the lanes that run the edge loop, and an idle lane costs no
// issue slot.  Compacting the eclipsed elements into a work list for a
// second, persistent pass (bit-identical) was measured slower on an
// H100: its conjunction-test pass alone costs 15% of this kernel, and
// the edge pass over the list is no faster than this kernel's whole
// run (PERF.md).
//
// Rounding: built with --fmad=false, so every product and sum is rounded
// as the plain version's separate tensor ops round it.  min / max / clip
// propagate NaN as torch.minimum / torch.maximum do, so an infeasible
// walker (NaN inclination) yields the same empty interval as the plain
// version.  What still differs at the ulp level: rsqrtf, atanf, atan2f.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kEdgeIters = 8;     // lockstep with geometry._EDGE_ITERS
constexpr int kTNewton = 3;       // lockstep with geometry._EDGE_T_NEWTON
constexpr float kClearVisible = 10.0f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kBlock = 128;

// NaN-propagating min / max, as torch.minimum / torch.maximum
__device__ __forceinline__ float nmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
    return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
    return nmin(nmax(x, lo), hi);
}

struct Elem {
    float px, py, c1, ww, wx, wy, mu, rad, inv_rad, i2_p, pl1;
};

// g(t) = Phi(p + t e) along the ray, from its two inverse distances
__device__ __forceinline__ float g_from(const Elem& s, float t, float ex,
                                        float ey, float i1, float i2) {
    float cx = s.px - s.mu + t * ex;
    float cy = s.py + t * ey;
    return -(1.0f - s.mu) * i1 - s.mu * i2 - 0.5f * (cx * cx + cy * cy);
}

__device__ __forceinline__ float g_val(const Elem& s, float t, float ex,
                                       float ey, float b1, float b2) {
    float i1 = rsqrtf(t * t + 2.0f * b1 * t + s.c1);
    float i2 = rsqrtf(t * t + 2.0f * b2 * t + s.ww);
    return g_from(s, t, ex, ey, i1, i2);
}

// first and second t-derivatives of g at t
__device__ __forceinline__ void g_derivs(const Elem& s, float t, float ex,
                                         float ey, float b1, float b2,
                                         float& g1, float& g2) {
    float i1 = rsqrtf(t * t + 2.0f * b1 * t + s.c1);
    float i2 = rsqrtf(t * t + 2.0f * b2 * t + s.ww);
    float u1 = t + b1, u2 = t + b2;
    float i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
    float cx = s.px - s.mu + t * ex;
    float cy = s.py + t * ey;
    g1 = (1.0f - s.mu) * u1 * i13 + s.mu * u2 * i23 - (cx * ex + cy * ey);
    g2 = (1.0f - s.mu) * (i13 - 3.0f * u1 * u1 * i13 * i1 * i1)
         + s.mu * (i23 - 3.0f * u2 * u2 * i23 * i2 * i2)
         - (ex * ex + ey * ey);
}

struct Edge {
    float sign, w, lo, hi, w_best, c_best, t;
};

// observer direction at phi_c + sign atan(w) / pi, rational in w
__device__ __forceinline__ void e_of(float e_A, float e_B, float sign,
                                     float w, float& ex, float& ey,
                                     float& den) {
    den = 1.0f / (1.0f + w * w);
    float cd = (1.0f - w * w) * den;
    float sd = (2.0f * w) * den;
    ex = e_A * cd - sign * e_B * sd;
    ey = -(e_B * cd + sign * e_A * sd);
}

// one safeguarded envelope-Newton iteration of one edge
__device__ __forceinline__ void edge_step(const Elem& s, float e_A,
                                          float e_B, Edge& g) {
    float ex, ey, den;
    e_of(e_A, e_B, g.sign, g.w, ex, ey, den);
    float tstar = s.wx * ex + s.wy * ey;
    float disc = s.rad * s.rad - (s.ww - tstar * tstar);
    float half = sqrtf(nmax(disc, 0.0f));
    float t_lo = nmax(tstar - half, 0.0f);
    float t_hi = nmax(tstar + half, 0.0f);
    bool no_occ = disc <= 0.0f;
    float b1 = s.px * ex + s.py * ey;
    float b2 = b1 - ex;
    float t = clip(g.t, t_lo, t_hi);
    float t_mid = clip(tstar, t_lo, t_hi);
    // warm polish step, well-guarded: a carried t in a concave region
    // (g2 <= 0) restarts from the chord midpoint
    float g1, g2;
    g_derivs(s, t, ex, ey, b1, b2, g1, g2);
    t = (g2 > 1e-12f) ? clip(t - g1 / nmax(g2, 1e-12f), t_lo, t_hi) : t_mid;
    // clearance with endpoint insurance (on-sphere identity: the donor
    // term at an unclipped chord endpoint is exactly -mu / rad)
    float i1 = rsqrtf(t * t + 2.0f * b1 * t + s.c1);
    float i2 = rsqrtf(t * t + 2.0f * b2 * t + s.ww);
    float val = g_from(s, t, ex, ey, i1, i2);
    float i1_lo = rsqrtf(t_lo * t_lo + 2.0f * b1 * t_lo + s.c1);
    float i2_lo = (tstar - half > 0.0f) ? s.inv_rad : s.i2_p;
    float v_lo = g_from(s, t_lo, ex, ey, i1_lo, i2_lo);
    float i1_hi = rsqrtf(t_hi * t_hi + 2.0f * b1 * t_hi + s.c1);
    float i2_hi = (tstar + half > 0.0f) ? s.inv_rad : s.i2_p;
    float v_hi = g_from(s, t_hi, ex, ey, i1_hi, i2_hi);
    if (v_lo < val) { t = t_lo; i1 = i1_lo; i2 = i2_lo; }
    val = nmin(val, v_lo);
    if (v_hi < val) { t = t_hi; i1 = i1_hi; i2 = i2_hi; }
    val = nmin(val, v_hi);
    float c = no_occ ? kClearVisible : val - s.pl1;
    // keep the best evaluated point
    float ac = fabsf(c);
    if (ac < g.c_best) { g.w_best = g.w; g.c_best = ac; }
    if (c < 0.0f) g.lo = g.w; else g.hi = g.w;
    // envelope derivative dc/dphi, converted to dc/dw by sign den / pi
    float rx = s.px + t * ex;
    float ry = s.py + t * ey;
    float i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
    float gx = (1.0f - s.mu) * rx * i13 + s.mu * (rx - 1.0f) * i23
               - (rx - s.mu);
    float gy = ry * ((1.0f - s.mu) * i13 + s.mu * i23 - 1.0f);
    float d = t * kTwoPi * (gx * ey - gy * ex);
    float dd = (fabsf(d) > 1e-12f) ? g.sign * den * d : INFINITY;
    float w_newton = g.w - (c * kPi) / dd;
    bool inside = (w_newton - g.lo) * (w_newton - g.hi) < 0.0f;
    bool ok = inside && isfinite(w_newton) && !no_occ;
    g.w = ok ? w_newton : 0.5f * (g.lo + g.hi);
    g.t = t;
}

// scal: (rows, 6) = [mu, sin i, cos i, 1 - xl1, Phi_L1, r_ins]
__global__ void __launch_bounds__(kBlock)
contacts_kernel(const float* __restrict__ scal,
                const float* __restrict__ px_in,
                const float* __restrict__ py_in,
                float* __restrict__ phi_in, float* __restrict__ phi_out,
                unsigned char* __restrict__ eclipsed, int n) {
    const int row = blockIdx.x;
    const int j = blockIdx.y * kBlock + threadIdx.x;
    if (j >= n) return;
    const long long k = (long long)row * n + j;
    const float* sc = scal + 6LL * row;

    Elem s;
    s.mu = sc[0];
    const float si = sc[1];
    s.rad = sc[3];
    s.pl1 = sc[4];
    const float r_ins = sc[5];
    s.px = px_in[k];
    s.py = py_in[k];
    s.wx = 1.0f - s.px;
    s.wy = -s.py;
    s.ww = s.wx * s.wx + s.wy * s.wy;
    s.c1 = s.px * s.px + s.py * s.py;
    s.inv_rad = 1.0f / s.rad;
    s.i2_p = rsqrtf(s.ww);
    const float phi_c = atan2f(s.py, 1.0f - s.px) / kTwoPi;

    // conjunction direction without trig: e(phi_c) = (e_A, -e_B, cos i)
    const float iw = rsqrtf(s.ww);
    const float e_A = si * s.wx * iw;
    const float e_B = si * s.py * iw;

    // 1. the eclipsed? test
    bool ecl;
    {
        const float ex = e_A, ey = -e_B;
        float tstar = s.wx * ex + s.wy * ey;
        float disc = s.rad * s.rad - (s.ww - tstar * tstar);
        float half = sqrtf(nmax(disc, 0.0f));
        float t_lo = nmax(tstar - half, 0.0f);
        float t_hi = nmax(tstar + half, 0.0f);
        bool no_occ = disc <= 0.0f;
        float b1 = s.px * ex + s.py * ey;
        float b2 = b1 - ex;
        float t = clip(tstar, t_lo, t_hi);
        for (int it = 0; it < kTNewton; ++it) {
            float g1, g2;
            g_derivs(s, t, ex, ey, b1, b2, g1, g2);
            float step = (g2 > 1e-12f) ? g1 / nmax(g2, 1e-12f) : 0.0f;
            t = clip(t - step, t_lo, t_hi);
        }
        float val = g_val(s, t, ex, ey, b1, b2);
        val = nmin(val, g_val(s, t_lo, ex, ey, b1, b2));
        val = nmin(val, g_val(s, t_hi, ex, ey, b1, b2));
        float c_mid = no_occ ? kClearVisible : val - s.pl1;
        ecl = c_mid < 0.0f;
    }

    float pin = phi_c, pout = phi_c;
    if (ecl) {
        // 2. two-sided sphere bracket in w = tan(theta / 2)
        const float inv_den = 1.0f / nmax(si * sqrtf(s.ww), 1e-12f);
        const float c_eff = clip(
            sqrtf(nmax(s.ww - s.rad * s.rad, 0.0f)) * inv_den, 0.0f, 1.0f);
        const float w_sphere = sqrtf((1.0f - c_eff) / (1.0f + c_eff));
        const float c_ins = clip(
            sqrtf(nmax(s.ww - r_ins * r_ins, 0.0f)) * inv_den, 0.0f, 1.0f);
        const float w_inscr = sqrtf((1.0f - c_ins) / (1.0f + c_ins));
        const float w0 = 0.5f * (w_inscr + w_sphere);

        // 3. ingress (sign -1) and egress (sign +1), interleaved
        Edge a{-1.0f, w0, w_inscr, w_sphere, w0, INFINITY, 0.0f};
        Edge b{+1.0f, w0, w_inscr, w_sphere, w0, INFINITY, 0.0f};
        float ex, ey, den;
        e_of(e_A, e_B, a.sign, w0, ex, ey, den);
        a.t = s.wx * ex + s.wy * ey;
        e_of(e_A, e_B, b.sign, w0, ex, ey, den);
        b.t = s.wx * ex + s.wy * ey;
#pragma unroll 1
        for (int it = 0; it < kEdgeIters; ++it) {
            edge_step(s, e_A, e_B, a);
            edge_step(s, e_A, e_B, b);
        }
        // 4. one atan per edge back to phase
        pin = phi_c + (-1.0f) * (atanf(a.w_best) / kPi);
        pout = phi_c + (atanf(b.w_best) / kPi);
    }
    phi_in[k] = pin;
    phi_out[k] = pout;
    eclipsed[k] = ecl ? 1 : 0;
}

}  // namespace

// Launches K1 on ``stream`` for ``rows`` x ``n`` elements and returns
// cudaGetLastError() (0 on success).  All pointers are device pointers to
// contiguous float32 (uint8 for ``eclipsed``) arrays.
extern "C" int contacts_launch(const float* scal, const float* px,
                               const float* py, float* phi_in,
                               float* phi_out, unsigned char* eclipsed,
                               int rows, int n, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    dim3 grid(rows, (n + kBlock - 1) / kBlock);
    contacts_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        scal, px, py, phi_in, phi_out, eclipsed, n);
    return (int)cudaGetLastError();
}
