// K4-K6: the core geometry's fixed-iteration bisections.
//
//   K4 findi_kernel        inclination (deg) at which the white dwarf's
//                          centre is eclipsed for a full phase width 2 half_w
//   K5 xl1_kernel          the inner Lagrangian point's distance from the
//                          primary
//   K6 lobe_radius_kernel  the Roche lobe's radius from the donor's centre
//                          along a unit direction (the pole: the inscribed
//                          radius / 0.995)
//
// Replace no TPU kernel: on the TPU each is an XLA lax.fori_loop fused
// into one executable: findi (lfit_python_tpu/roche/geometry.py:283-325,
// its clearance origin_shadow_distance), xl1 (:114-143) and lobe_radius
// (:1140-1176; inscribed_radius :539-556).  Their plain PyTorch versions
// are lfit_python_tpu_torch/roche/geometry.py's _findi_loop, _xl1_loop and
// _lobe_loop, the iterations of findi, xl1 and lobe_radius, whose
// arithmetic each kernel repeats operation for operation.
//
// What bounds them: the dependent chain of each solve, not operations or
// bytes.  A solve is 54-64 bisection steps, each of which needs the last
// one's bracket; K4's step also runs the clearance's 4 clamped Newton steps
// in the ray parameter t, one after another, and evaluates g three times.
// The inputs and the output are 8-40 bytes a solve, and the main paths run
// 256-1024 solves (up to 5120 for the radius), so neither the card's peak
// rate nor its memory rate can be approached: the floor is the chain's
// latency (chip_smoke.py's chain model, PERF.md section 6).
//
// What the design does about it.  Each kernel shortens the chain by
// k-section: a group of G = 2^D lanes runs one solve, and the next D
// levels of the bisection are a complete binary tree of 2^D - 1
// midpoints, each of which a lane computes exactly as the loop would, by
// replaying its path from the round's bracket.  The lanes test
// their midpoints at once, one __ballot_sync gathers the signs, and every
// lane walks the D levels from that mask: each level reads the sign at
// the node the loop would have visited, so the walk is the loop's D steps,
// bit for bit, whatever the function's shape (a NaN test is false, as in
// torch.where).  K4's 54 dependent clearance evaluations (and the
// feasibility test, which lane 0 makes in the last round) become 11
// rounds at D = 5, K5's 64 steps 13.  The terms that do not change from
// step to step (mu, 1 - mu, the squared sphere radius, the phase angle's
// cos and sin) are computed once, in every lane; each is the value the
// plain version recomputes, so no bit moves.  D is a template parameter of
// the schedule; the card's kernels are built at one depth each,
// FINDI_DEPTH, XL1_DEPTH and LOBE_DEPTH, the depths measured fastest on the
// H100 (PERF.md section 6).  A build may set them (-DXL1_DEPTH=d), as
// tools/torch_roche_depths.py does to time the other depths.
//
// Bit-identity with the plain version: each expression below is one
// PyTorch operation per operator, in the plain version's order; built
// with --fmad=false, so no multiply-add is contracted (PyTorch's eager
// ops round each operation).  Python's double constants enter PyTorch's
// kernels rounded to the tensor's type, and so they are written here as
// T(double); torch.deg2rad multiplies by pi / 180 so rounded.  sin and
// cos are sinf / cosf (sin / cos in float64), as PyTorch's; rsqrt is
// rsqrtf.  torch.minimum / maximum / clamp propagate NaN and so do nmin,
// nmax and clamp_min; a comparison with NaN is false, as in torch.where.
// sin / cos (float64) carry a Payne-Hanek slow path for |x| > 105615 with
// an array in local memory (ptxas: K4's float64 stack frame, 40 bytes);
// the angles here are within [0, pi / 2] and [-2 pi, 2 pi] for |half_w| <=
// 1 and never take it.
//
// Everything above the "kernel and launcher" line is plain arithmetic with
// no warp intrinsic: a solve takes a ballot, ballot(vote), that returns
// the round's mask from each lane's vote(lane), so a host loop over the
// lanes can stand in for the warp (tests/test_torch_roche_kernels.py).
//
// Arrays, all of one type T and n elements: findi q, half_w, x1, pl1 ->
// incl; xl1 q -> x1; lobe_radius q, x1, pl1, dx, dy, dz -> r.

#include <cuda_runtime.h>
#include <math.h>

#define ROCHE_FN __device__ __forceinline__

template <typename T> ROCHE_FN T rsqrt_(T v);
template <> ROCHE_FN float rsqrt_<float>(float v) { return rsqrtf(v); }
template <> ROCHE_FN double rsqrt_<double>(double v) { return rsqrt(v); }
template <typename T> ROCHE_FN T sqrt_(T v);
template <> ROCHE_FN float sqrt_<float>(float v) { return sqrtf(v); }
template <> ROCHE_FN double sqrt_<double>(double v) { return sqrt(v); }
template <typename T> ROCHE_FN T sin_(T v);
template <> ROCHE_FN float sin_<float>(float v) { return sinf(v); }
template <> ROCHE_FN double sin_<double>(double v) { return sin(v); }
template <typename T> ROCHE_FN T cos_(T v);
template <> ROCHE_FN float cos_<float>(float v) { return cosf(v); }
template <> ROCHE_FN double cos_<double>(double v) { return cos(v); }

// torch.minimum / torch.maximum / torch.clamp(min=) semantics: NaN passes
template <typename T> ROCHE_FN T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> ROCHE_FN T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> ROCHE_FN T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}

// torch.deg2rad's factor (ATen's M_PI_180) and 2 pi, as Python doubles
#define ROCHE_PI_180 0.017453292519943295769236907684886127134428718885417
#define ROCHE_TWO_PI (2.0 * 3.141592653589793)

// ---- the k-section schedule of K4-K6 -------------------------------------

// the depth D of the kernels' groups (G = 2^D lanes a solve, 1 <= D <= 5),
// measured fastest on the H100 for each kernel (PERF.md section 6)
#ifndef FINDI_DEPTH
#define FINDI_DEPTH 5
#endif
#ifndef XL1_DEPTH
#define XL1_DEPTH 5
#endif
#ifndef LOBE_DEPTH
#define LOBE_DEPTH 3
#endif

// the midpoint that the bisection tests at heap node `node` (1 <= node <
// 2^D) of a round's subtree over (lo, hi): each bit of node below its
// leading one, the most significant first, is a step of the loop that
// keeps the upper half (1) or the lower (0), in the loop's own expression
template <int D, typename T>
ROCHE_FN T node_mid(T lo, T hi, unsigned node) {
  int level = 0;
#pragma unroll
  for (int k = 1; k < D; ++k) level += node >= (1u << k);
#pragma unroll
  for (int b = D - 2; b >= 0; --b) {
    if (b < level) {
      const T mid = T(0.5) * (lo + hi);
      const bool up = (node >> b) & 1u;
      lo = up ? mid : lo;
      hi = up ? hi : mid;
    }
  }
  return T(0.5) * (lo + hi);
}

// r steps of the loop from (lo, hi), each keeping the upper half where bit
// `node` of mask is set: the test at the midpoint the step bisects
template <typename T>
ROCHE_FN void walk(T& lo, T& hi, unsigned mask, int r) {
  unsigned node = 1;
  for (int k = 0; k < r; ++k) {
    const T mid = T(0.5) * (lo + hi);
    const bool up = (mask >> node) & 1u;
    lo = up ? mid : lo;
    hi = up ? hi : mid;
    node = 2 * node + up;
  }
}

// the loop's `iters` steps over (lo, hi) in rounds of r = min(D, steps
// left) levels: round(r, last) returns the round's mask over the current
// (lo, hi), last telling the last round, and the walk takes the r steps
// from it.  At least one round runs, so that a test of the last round
// (K4's feasibility) is made at iters = 0 too
template <int D, typename T, typename Round>
ROCHE_FN void ksection(T& lo, T& hi, int iters, Round round) {
  int done = 0;
  do {
    const int r = iters - done < D ? iters - done : D;
    walk(lo, hi, round(r, done + r >= iters), r);
    done += r;
  } while (done < iters);
}

// ---- K5: _xl1_loop ------------------------------------------------------

// d(Phi)/dx on the line of centres at mid, > 0: the loop keeps the upper
// half, (1 - mu) / (x x) - mu / ((1 - x) ** 2) - (x - mu) > 0
template <typename T> ROCHE_FN bool xl1_up(T mu, T omu, T mid) {
  const T a = T(1) - mid;
  const T f = omu / (mid * mid) - mu / (a * a) - (mid - mu);
  return f > T(0);
}

// bisection of d(Phi)/dx on the line of centres over (1e-6, 1 - 1e-6) in
// groups of 2^D lanes: lanes 1 .. 2^r - 1 vote at their nodes' midpoints
template <int D, typename T, typename Ballot>
ROCHE_FN T xl1_solve(T q, int iters, Ballot ballot) {
  const T mu = q / (T(1) + q);
  const T omu = T(1) - mu;
  T lo = T(1e-6), hi = T(1.0 - 1e-6);
  ksection<D>(lo, hi, iters, [&](int r, bool) {
    return ballot([&](unsigned lane) {
      return lane >= 1u && lane < (1u << r)
             && xl1_up(mu, omu, node_mid<D>(lo, hi, lane));
    });
  });
  return T(0.5) * (lo + hi);
}

// ---- K4: _findi_loop ----------------------------------------------------

// the terms of _origin_clearance that do not depend on the inclination
template <typename T> struct Origin {
  T mu, omu, rr, cth, sth, pl1;
};

template <typename T>
ROCHE_FN Origin<T> origin_setup(T q, T half_w, T x1, T pl1) {
  Origin<T> s;
  s.mu = q / (T(1) + q);
  s.omu = T(1) - s.mu;
  const T rad = T(1) - x1;
  s.rr = rad * rad;
  const T th = T(ROCHE_TWO_PI) * half_w;
  s.cth = cos_(th);
  s.sth = sin_(th);
  s.pl1 = pl1;
  return s;
}

// g(t) = Phi(t e) along the ray from the origin (r1 = t)
template <typename T>
ROCHE_FN T origin_g(const Origin<T>& s, T t, T ex, T ey) {
  const T i2 = rsqrt_(t * t - T(2) * ex * t + T(1));
  const T cx = t * ex - s.mu;
  const T cy = t * ey;
  return -s.omu / t - s.mu * i2 - T(0.5) * (cx * cx + cy * cy);
}

// _origin_clearance(q, incl_deg, half_w, x1, pl1)[0]: the clearance of the
// ray from the origin at inclination incl_deg, with 4 clamped Newton steps
// for its minimum and the chord's two end values as insurance
template <typename T>
ROCHE_FN T origin_clearance(const Origin<T>& s, T incl_deg) {
  const T i_rad = incl_deg * T(ROCHE_PI_180);
  const T si = sin_(i_rad);
  const T ex = si * s.cth;
  const T ey = -si * s.sth;
  const T tstar = ex;
  const T disc = s.rr - (T(1) - tstar * tstar);
  const T half = sqrt_(clamp_min(disc, T(1e-30)));
  const T t_lo = clamp_min(tstar - half, T(1e-6));
  const T t_hi = clamp_min(tstar + half, T(1e-6));
  const bool no_occ = (disc <= T(0)) | (tstar + half <= T(1e-9));
  const T ee2 = ex * ex + ey * ey;
  T t = nmin(nmax(tstar, t_lo), t_hi);
  for (int k = 0; k < 4; ++k) {
    const T i2 = rsqrt_(t * t - T(2) * ex * t + T(1));
    const T u2 = t - ex;
    const T i23 = i2 * i2 * i2;
    const T cx = t * ex - s.mu;
    const T cy = t * ey;
    const T g1 = s.omu / (t * t) + s.mu * u2 * i23 - (cx * ex + cy * ey);
    const T g2 = T(-2.0) * s.omu / (t * t * t)
                 + s.mu * (i23 - T(3) * u2 * u2 * i23 * i2 * i2) - ee2;
    const T step = g2 > T(1e-12) ? g1 / clamp_min(g2, T(1e-12)) : T(0);
    t = nmin(nmax(t - step, t_lo), t_hi);
  }
  T val = origin_g(s, t, ex, ey);
  const T v_lo = origin_g(s, t_lo, ex, ey);
  const T v_hi = origin_g(s, t_hi, ex, ey);
  val = nmin(val, v_lo);
  val = nmin(val, v_hi);
  return no_occ ? T(10.0) : val - s.pl1;
}

// the vote of lane `lane` in a round of depth r over (lo, hi): lanes 1 ..
// 2^r - 1 are the round's heap nodes, each true where the clearance at its
// midpoint is > 0 (not eclipsed: the loop keeps the upper half); lane 0
// tests the clearance at i = 90 in the last round (so that no call of
// sin's slow path comes after it while its result is live: float64 then
// spills nothing) and sets `feasible` where it is <= 0; every other lane
// votes false
template <int D, typename T>
ROCHE_FN bool findi_vote(const Origin<T>& s, T lo, T hi, unsigned lane, int r,
                         bool last, bool& feasible) {
  const bool node = lane >= 1u && lane < (1u << r);
  if (!node && !(lane == 0u && last)) return false;
  const T c = origin_clearance(s, node ? node_mid<D>(lo, hi, lane) : T(90));
  if (!node) {
    feasible = c <= T(0);
    return false;
  }
  return c > T(0);
}

// bisection of the clearance at phase half_w over i in (1, 90) in groups
// of 2^D lanes: clearance > 0 (not eclipsed) keeps the upper half; NaN
// unless the clearance at i = 90 is <= 0 (lane 0's result; lane 0 stores)
template <int D, typename T, typename Ballot>
ROCHE_FN T findi_solve(T q, T half_w, T x1, T pl1, int iters, Ballot ballot) {
  const Origin<T> s = origin_setup(q, half_w, x1, pl1);
  T lo = T(1), hi = T(90);
  bool feasible = false;
  ksection<D>(lo, hi, iters, [&](int r, bool last) {
    return ballot([&](unsigned lane) {
      return findi_vote<D>(s, lo, hi, lane, r, last, feasible);
    });
  });
  const T i_sol = T(0.5) * (lo + hi);
  return feasible ? i_sol : T(NAN);
}

// ---- K6: _lobe_loop -----------------------------------------------------

// the terms of the lobe's potential that do not depend on the radius
template <typename T> struct Lobe {
  T mu, nomu, pl1, dx, dy, dz;
};

// roche_potential(q, c2 + mid d) - pl1 < 0: inside the lobe
template <typename T>
ROCHE_FN bool lobe_inside(const Lobe<T>& s, T mid) {
  const T x = T(1) + mid * s.dx;
  const T y = mid * s.dy;
  const T z = mid * s.dz;
  const T r1 = sqrt_(x * x + y * y + z * z);
  const T ddx = x - T(1);
  const T r2 = sqrt_(ddx * ddx + y * y + z * z);
  const T e = x - s.mu;
  const T pot = s.nomu / r1 - s.mu / r2 - T(0.5) * (e * e + y * y);
  return pot - s.pl1 < T(0);
}

// bisection of roche_potential(q, c2 + r d) - pl1 over (1e-6 rmax, rmax],
// rmax = 1 - x1, in groups of 2^D lanes: below 0 (inside the lobe) keeps
// the upper half; lanes 1 .. 2^r - 1 vote at their nodes' midpoints
template <int D, typename T, typename Ballot>
ROCHE_FN T lobe_solve(T q, T x1, T pl1, T dx, T dy, T dz, int iters,
                      Ballot ballot) {
  Lobe<T> s;
  s.mu = q / (T(1) + q);
  s.nomu = -(T(1) - s.mu);
  s.pl1 = pl1;
  s.dx = dx;
  s.dy = dy;
  s.dz = dz;
  const T rmax = T(1) - x1;
  T lo = T(1e-6) * rmax, hi = rmax;
  ksection<D>(lo, hi, iters, [&](int r, bool) {
    return ballot([&](unsigned lane) {
      return lane >= 1u && lane < (1u << r)
             && lobe_inside(s, node_mid<D>(lo, hi, lane));
    });
  });
  return T(0.5) * (lo + hi);
}

// ---- kernel and launcher ------------------------------------------------

// K4-K6: blocks of GROUP_BLOCK threads, one group of G = 2^D lanes a
// solve (G <= 32, so a group never straddles a warp).  Every lane of a
// warp reaches each __ballot_sync with the full mask: a lane past the last
// solve solves a copy of it and stores nothing.  A group reads its own
// bits of the warp's ballot by shifting them down to bit 0.
#define GROUP_BLOCK 128

template <int D> struct Group {
  int solve;       // the solve of this lane's group
  unsigned lane;   // this lane's index in its group
  int shift;       // the group's first lane in its warp
  __device__ Group() {
    const long long t = (long long)blockIdx.x * GROUP_BLOCK + threadIdx.x;
    solve = (int)(t >> D);
    lane = threadIdx.x & ((1u << D) - 1u);
    shift = (int)(threadIdx.x & 31u & ~((1u << D) - 1u));
  }
  template <typename Vote> __device__ unsigned ballot(Vote vote) const {
    return __ballot_sync(0xffffffffu, vote(lane)) >> shift;
  }
};

template <typename T>
__global__ void __launch_bounds__(GROUP_BLOCK)
findi_kernel(const T* __restrict__ q, const T* __restrict__ half_w,
             const T* __restrict__ x1, const T* __restrict__ pl1,
             T* __restrict__ out, int n, int iters) {
  const Group<FINDI_DEPTH> g;
  const int i = g.solve < n ? g.solve : n - 1;
  const T r = findi_solve<FINDI_DEPTH>(
      q[i], half_w[i], x1[i], pl1[i], iters,
      [&](auto vote) { return g.ballot(vote); });
  if (g.solve < n && g.lane == 0u) out[i] = r;
}

template <typename T>
__global__ void __launch_bounds__(GROUP_BLOCK)
xl1_kernel(const T* __restrict__ q, T* __restrict__ out, int n, int iters) {
  const Group<XL1_DEPTH> g;
  const int i = g.solve < n ? g.solve : n - 1;
  const T r = xl1_solve<XL1_DEPTH>(
      q[i], iters, [&](auto vote) { return g.ballot(vote); });
  if (g.solve < n && g.lane == 0u) out[i] = r;
}

template <typename T>
__global__ void __launch_bounds__(GROUP_BLOCK)
lobe_radius_kernel(const T* __restrict__ q, const T* __restrict__ x1,
                   const T* __restrict__ pl1, const T* __restrict__ dx,
                   const T* __restrict__ dy, const T* __restrict__ dz,
                   T* __restrict__ out, int n, int iters) {
  const Group<LOBE_DEPTH> g;
  const int i = g.solve < n ? g.solve : n - 1;
  const T r = lobe_solve<LOBE_DEPTH>(
      q[i], x1[i], pl1[i], dx[i], dy[i], dz[i], iters,
      [&](auto vote) { return g.ballot(vote); });
  if (g.solve < n && g.lane == 0u) out[i] = r;
}

static bool bad_size(int n, int iters) {
  return n < 1 || n > (1 << 30) || iters < 0;
}

static dim3 group_grid(int n, int depth) {
  return dim3((unsigned)((((long long)n << depth) + GROUP_BLOCK - 1)
                         / GROUP_BLOCK));
}

// Each launcher runs on ``stream`` and returns the cudaError_t of the
// launch (0 = ok); is_double selects float64 (1) or float32 (0) for every
// array.
extern "C" int findi_launch(int is_double, const void* q, const void* half_w,
                            const void* x1, const void* pl1, void* out, int n,
                            int iters, void* stream) {
  if (bad_size(n, iters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = group_grid(n, FINDI_DEPTH);
  if (is_double)
    findi_kernel<double><<<grid, GROUP_BLOCK, 0, s>>>(
        (const double*)q, (const double*)half_w, (const double*)x1,
        (const double*)pl1, (double*)out, n, iters);
  else
    findi_kernel<float><<<grid, GROUP_BLOCK, 0, s>>>(
        (const float*)q, (const float*)half_w, (const float*)x1,
        (const float*)pl1, (float*)out, n, iters);
  return (int)cudaGetLastError();
}

extern "C" int xl1_launch(int is_double, const void* q, void* out, int n,
                          int iters, void* stream) {
  if (bad_size(n, iters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = group_grid(n, XL1_DEPTH);
  if (is_double)
    xl1_kernel<double><<<grid, GROUP_BLOCK, 0, s>>>(
        (const double*)q, (double*)out, n, iters);
  else
    xl1_kernel<float><<<grid, GROUP_BLOCK, 0, s>>>(
        (const float*)q, (float*)out, n, iters);
  return (int)cudaGetLastError();
}

extern "C" int lobe_radius_launch(int is_double, const void* q,
                                  const void* x1, const void* pl1,
                                  const void* dx, const void* dy,
                                  const void* dz, void* out, int n, int iters,
                                  void* stream) {
  if (bad_size(n, iters)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = group_grid(n, LOBE_DEPTH);
  if (is_double)
    lobe_radius_kernel<double><<<grid, GROUP_BLOCK, 0, s>>>(
        (const double*)q, (const double*)x1, (const double*)pl1,
        (const double*)dx, (const double*)dy, (const double*)dz,
        (double*)out, n, iters);
  else
    lobe_radius_kernel<float><<<grid, GROUP_BLOCK, 0, s>>>(
        (const float*)q, (const float*)x1, (const float*)pl1,
        (const float*)dx, (const float*)dy, (const float*)dz, (float*)out, n,
        iters);
  return (int)cudaGetLastError();
}
