// K9-K10: the donor grid's radius solve and the white dwarf's sweep.
//
//   K9  donor_grid_kernel  the Roche lobe's radius along each direction of
//                          the donor grid, a solve a (walker, direction):
//                          without a recorded graph the grid itself
//                          (positions, outward normals and areas), with
//                          one the radius and the slope of the lobe's
//                          potential there
//   K10 wd_curve_kernel    the white dwarf's visible fraction at each
//                          (row, phase): the ray clearance of the origin,
//                          its shadow distance, the inscribed-sphere guard
//                          and the limb-darkened edge fraction; or (the
//                          distance mode) the shadow distance and the
//                          clearance alone
//
// Replace no TPU kernel: on the TPU each is an XLA program with its loops
// fused: donor_grid (lfit_python_tpu/models/components.py:391-500; its
// lax.fori_loops of 54 bisections in float64, :447, or 8 bisections, :459,
// then 4 safeguarded Newton steps, :473, in float32) and wd_flux (:145-191)
// with origin_shadow_distance (lfit_python_tpu/roche/geometry.py:361-492:
// the 4 clamped Newton steps unrolled) and the edge fraction (:58).  Their
// plain PyTorch versions are lfit_python_tpu_torch/models/components.py's
// _donor_radius_loop and _donor_grid_plain, and _wd_curve_plain with
// roche/geometry.py's _shadow_distance_plain: eager chains of some 550 and
// 370 launches an evaluation, whose arithmetic each kernel repeats
// operation for operation.
//
// What bounds them.  K9 at the north star is 1024 walkers x 384
// directions = 393,216 solves of 8 bisections and 4 Newton steps
// (float32: some 470 operations a solve with the grid) writing the grid's
// 7 values each (11 MB): the bytes take ~3.3 us, the operations ~2.8 us
// at the card's peak.  K10 is
// 5120 rows x 128 phases = 655,360 points of ~330 operations reading a
// phase and writing one value (5 MB).  Neither kernel has a dependent
// chain longer than a few hundred operations, so a thread a solve or a
// point fills the card, and the first design is that: one thread each, no
// shared memory, no warp intrinsic.
//
// What the design does about the eager chains' costs.  Each per-walker or
// per-row input is read where the thread needs it through an index map
// (K10: element ((i / div) % mod) * stride of the input for point i; K9:
// walker w at w * stride), so no parameter is expanded to (rows, P) and
// copied, and a strided view (a column of the parameter table) is read in
// place.  K9 writes the grid's positions and normals as (W, N, 3) at once,
// with no stack of three components.
//
// Bit-identity with the plain versions: each expression below is one
// PyTorch operation per operator, in the plain version's order; built
// with --fmad=false, so no multiply-add is contracted (PyTorch's eager ops
// round each operation).  Python's double constants enter PyTorch's
// kernels rounded to the tensor's type, and so they are written here as
// T(double); torch.deg2rad multiplies by pi / 180 so rounded.  A division
// by a Python number on a CUDA tensor is a product by the reciprocal,
// rounded in the tensor's type (ATen's div_true_kernel_cuda for a CPU
// scalar): (1 - a ** 3) / 3.0 is a product by T(1) / T(3).  a ** 3 is a *
// a * a (ATen's pow specialises the exponent 3), 1.0 / r is r's reciprocal
// (Tensor.__rtruediv__) times 1.  sin, cos and acos are sinf, cosf and
// acosf (sin, cos, acos in float64), as PyTorch's; rsqrt is rsqrtf.
// torch.minimum / maximum / clamp propagate NaN and so do nmin, nmax,
// clamp_min and clamp_nan; a comparison with NaN is false, as in
// torch.where.  sin / cos carry a Payne-Hanek slow path with an array in
// local memory for |x| > 105615 (float64; 48039 float32), which no angle
// here reaches.
//
// Everything above the "kernel and launcher" line is plain arithmetic with
// no CUDA intrinsic: a host loop can run it (tests/test_torch_wd_donor.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define WD_FN __device__ __forceinline__

template <typename T> WD_FN T rsqrt_(T v);
template <> WD_FN float rsqrt_<float>(float v) { return rsqrtf(v); }
template <> WD_FN double rsqrt_<double>(double v) { return rsqrt(v); }
template <typename T> WD_FN T sqrt_(T v);
template <> WD_FN float sqrt_<float>(float v) { return sqrtf(v); }
template <> WD_FN double sqrt_<double>(double v) { return sqrt(v); }
template <typename T> WD_FN T sin_(T v);
template <> WD_FN float sin_<float>(float v) { return sinf(v); }
template <> WD_FN double sin_<double>(double v) { return sin(v); }
template <typename T> WD_FN T cos_(T v);
template <> WD_FN float cos_<float>(float v) { return cosf(v); }
template <> WD_FN double cos_<double>(double v) { return cos(v); }
template <typename T> WD_FN T acos_(T v);
template <> WD_FN float acos_<float>(float v) { return acosf(v); }
template <> WD_FN double acos_<double>(double v) { return acos(v); }

// torch.minimum / torch.maximum / torch.clamp semantics: NaN passes
template <typename T> WD_FN T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> WD_FN T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> WD_FN T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}
template <typename T> WD_FN T clamp_nan(T v, T lo, T hi) {
  return v != v ? v : (v < lo ? lo : (v > hi ? hi : v));
}

// torch.deg2rad's factor (ATen's M_PI_180), and pi, 2 pi and pi / 2 as
// Python computes them in doubles
#define WD_PI_180 0.017453292519943295769236907684886127134428718885417
#define WD_PI 3.141592653589793
#define WD_TWO_PI (2.0 * 3.141592653589793)
#define WD_HALF_PI (0.5 * 3.141592653589793)
// roche/geometry.py's _CLEAR_VISIBLE: the clearance of a ray that misses
// the donor's sphere
#define WD_CLEAR_VISIBLE 10.0

// ---- K9: the donor grid -------------------------------------------------

// the terms of the lobe's potential along one direction that do not
// depend on the radius
template <typename T> struct Lobe {
  T mu, omu, pl1, dx, dy, dz;
};

// components._lobe_f: Phi(c2 + r d) - pl1
template <typename T> WD_FN T lobe_f(const Lobe<T>& s, T r) {
  const T i1 = rsqrt_(T(1) + T(2) * r * s.dx + r * r);
  const T cx = T(1) + r * s.dx - s.mu;
  const T cy = r * s.dy;
  return -s.omu * i1 - s.mu / r - T(0.5) * (cx * cx + cy * cy) - s.pl1;
}

// components._lobe_fp: d(Phi(c2 + r d)) / dr
template <typename T> WD_FN T lobe_fp(const Lobe<T>& s, T r) {
  const T i1 = rsqrt_(T(1) + T(2) * r * s.dx + r * r);
  const T cx = T(1) + r * s.dx - s.mu;
  const T cy = r * s.dy;
  return s.omu * (r + s.dx) * i1 * i1 * i1 + s.mu / (r * r)
         - (cx * s.dx + cy * s.dy);
}

// the solve's steps in each type, the plain loop's (components.py:
// _DONOR_BISECT_F64, _DONOR_BISECT_F32, _DONOR_NEWTON_F32); a build may
// set others with -D (tests/test_torch_wd_donor.py runs each against the
// loop run for as many steps)
#ifndef WD_BISECT_F64
#define WD_BISECT_F64 54
#endif
#ifndef WD_BISECT_F32
#define WD_BISECT_F32 8
#endif
#ifndef WD_NEWTON_F32
#define WD_NEWTON_F32 4
#endif
template <typename T> struct DonorSteps;
template <> struct DonorSteps<double> {
  static constexpr int bisections = WD_BISECT_F64, newtons = 0;
};
template <> struct DonorSteps<float> {
  static constexpr int bisections = WD_BISECT_F32, newtons = WD_NEWTON_F32;
};

// components._donor_radius_loop's radius at one (walker, direction):
// DonorSteps<T>::bisections steps over (1e-6 rmax, rmax), rmax = 1 - x1,
// then DonorSteps<T>::newtons safeguarded Newton steps (a proposal outside
// the bracket, by the strict tests rn < lo or rn > hi, takes the
// bracket's midpoint; a NaN proposal passes them, as in torch.where)
template <typename T> WD_FN T lobe_root(const Lobe<T>& s, T x1) {
  const T rmax = T(1) - x1;
  T lo = T(1e-6) * rmax, hi = rmax;
  for (int k = 0; k < DonorSteps<T>::bisections; ++k) {
    const T mid = T(0.5) * (lo + hi);
    const bool inside = lobe_f(s, mid) < T(0);
    lo = inside ? mid : lo;
    hi = inside ? hi : mid;
  }
  T r = T(0.5) * (lo + hi);
  for (int k = 0; k < DonorSteps<T>::newtons; ++k) {
    const T fr = lobe_f(s, r);
    const bool inside = fr < T(0);
    lo = inside ? r : lo;
    hi = inside ? hi : r;
    const T rn = r - fr / clamp_min(lobe_fp(s, r), T(1e-12));
    const bool bad = (rn < lo) | (rn > hi);
    r = bad ? T(0.5) * (lo + hi) : rn;
  }
  return r;
}

// K9's arrays.  q, x1, pl1 are per walker, walker w at w * stride; dx, dy,
// dz, d_omega per direction (n_dir, contiguous); r, slope (W, N), pos and
// nrm (W, N, 3) and area (W, N), contiguous.  r null: no radius and slope
// (the grid alone, on a forward evaluation); pos null: no grid
template <typename T> struct DonorArgs {
  const T *q, *x1, *pl1, *dx, *dy, *dz, *d_omega;
  T *r, *slope, *pos, *nrm, *area;
  long long sq, sx1, spl1, n_walkers, n_dir;
};

// solve i = w * n_dir + j: the radius along direction j of walker w and,
// where r is given, it and its slope; where pos is given,
// components._donor_grid_plain's element
template <typename T>
WD_FN void donor_solve_at(const DonorArgs<T>& a, long long i) {
  const long long w = i / a.n_dir, j = i - w * a.n_dir;
  const T q = a.q[w * a.sq];
  Lobe<T> s;
  s.mu = q / (T(1) + q);
  s.omu = T(1) - s.mu;
  s.pl1 = a.pl1[w * a.spl1];
  s.dx = a.dx[j];
  s.dy = a.dy[j];
  s.dz = a.dz[j];
  const T r = lobe_root(s, a.x1[w * a.sx1]);
  if (a.r != nullptr) {
    a.r[i] = r;
    a.slope[i] = lobe_fp(s, r);
  }
  if (a.pos == nullptr) return;
  const T px = T(1) + r * s.dx;
  const T py = r * s.dy;
  const T pz = r * s.dz;
  const T i1 = rsqrt_(px * px + py * py + pz * pz);
  const T i2 = T(1) / r;
  const T i13 = i1 * i1 * i1;
  const T i23 = i2 * i2 * i2;
  const T gx = s.omu * px * i13 + s.mu * (px - T(1)) * i23 - (px - s.mu);
  const T gy = py * (s.omu * i13 + s.mu * i23 - T(1));
  const T gz = pz * (s.omu * i13 + s.mu * i23);
  const T gn = clamp_min(sqrt_(gx * gx + gy * gy + gz * gz), T(1e-12));
  const T nx = gx / gn, ny = gy / gn, nz = gz / gn;
  const T mu_dn = clamp_min(s.dx * nx + s.dy * ny + s.dz * nz, T(1e-3));
  a.pos[3 * i] = px;
  a.pos[3 * i + 1] = py;
  a.pos[3 * i + 2] = pz;
  a.nrm[3 * i] = nx;
  a.nrm[3 * i + 1] = ny;
  a.nrm[3 * i + 2] = nz;
  a.area[i] = r * r * a.d_omega[j] / mu_dn;
}

// ---- K10: the white dwarf's sweep ---------------------------------------

// g(t) = Phi(t e) along the ray from the origin (r1 = t)
template <typename T> WD_FN T origin_g(T mu, T omu, T ex, T ey, T t) {
  const T i2 = rsqrt_(t * t - T(2) * ex * t + T(1));
  const T cx = t * ex - mu;
  const T cy = t * ey;
  return -omu / t - mu * i2 - T(0.5) * (cx * cx + cy * cy);
}

// geometry._shadow_distance_plain at one point (no precise refinement):
// the clearance of the ray from the origin towards the observer at
// inclination incl (deg) and phase ph, from the chord midpoint by 4
// clamped Newton steps with the chord's end values as insurance; then
// grad(Phi) at the minimum, perpendicular to the line of sight, and the
// signed sky distance d = clear / |grad_perp|.  ex = sin(i) cos(2 pi ph),
// which wd_flux's guard calls tstar, is returned too
template <typename T>
WD_FN void origin_shadow(T q, T incl, T ph, T x1, T pl1, T& d, T& clear,
                         T& ex_out) {
  const T mu = q / (T(1) + q);
  const T omu = T(1) - mu;
  const T i_rad = incl * T(WD_PI_180);
  const T si = sin_(i_rad), ci = cos_(i_rad);
  const T rad = T(1) - x1;
  const T th = T(WD_TWO_PI) * ph;
  const T ex = si * cos_(th);
  const T ey = -si * sin_(th);
  const T tstar = ex;
  const T disc = rad * rad - (T(1) - tstar * tstar);
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
    const T cx = t * ex - mu;
    const T cy = t * ey;
    const T g1 = omu / (t * t) + mu * u2 * i23 - (cx * ex + cy * ey);
    const T g2 = T(-2.0) * omu / (t * t * t)
                 + mu * (i23 - T(3) * u2 * u2 * i23 * i2 * i2) - ee2;
    const T step = g2 > T(1e-12) ? g1 / clamp_min(g2, T(1e-12)) : T(0);
    t = nmin(nmax(t - step, t_lo), t_hi);
  }
  T val = origin_g(mu, omu, ex, ey, t);
  const T v_lo = origin_g(mu, omu, ex, ey, t_lo);
  const T v_hi = origin_g(mu, omu, ex, ey, t_hi);
  t = v_lo < val ? t_lo : t;
  val = nmin(val, v_lo);
  t = v_hi < val ? t_hi : t;
  val = nmin(val, v_hi);
  clear = no_occ ? T(WD_CLEAR_VISIBLE) : val - pl1;
  const T rx = t * ex, ry = t * ey, rz = t * ci;
  const T i1 = rsqrt_(rx * rx + ry * ry + rz * rz);
  const T dxx = rx - T(1);
  const T i2 = rsqrt_(dxx * dxx + ry * ry + rz * rz);
  const T i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
  const T gx = omu * rx * i13 + mu * dxx * i23 - (rx - mu);
  const T gy = ry * (omu * i13 + mu * i23 - T(1));
  const T gz = rz * (omu * i13 + mu * i23);
  const T gdote = gx * ex + gy * ey + gz * ci;
  const T qx = gx - gdote * ex, qy = gy - gdote * ey, qz = gz - gdote * ci;
  const T g_norm = sqrt_(clamp_min(qx * qx + qy * qy + qz * qz, T(1e-24)));
  d = clear / g_norm;
  ex_out = ex;
}

// components._EdgeVisibleFraction.forward: the visible fraction of a
// linearly limb-darkened disc whose centre lies x disc radii inside a
// straight shadow edge
template <typename T> WD_FN T edge_fraction(T x, T u) {
  const T a = clamp_nan(-x, T(-1), T(1));
  const T s2 = clamp_min(T(1) - a * a, T(0));
  const T uni = acos_(a) - a * sqrt_(s2);
  const T third = T(1) / T(3);
  const T sq = T(WD_HALF_PI) * ((T(1) - a) - (T(1) - a * a * a) * third);
  const T total = (T(1) - u) * T(WD_PI) + u * T(2) * T(WD_PI) * third;
  return ((T(1) - u) * uni + u * sq) / total;
}

// components._wd_curve_plain (no precise refinement) at one point
template <typename T>
WD_FN T wd_fraction(T q, T incl, T ph, T x1, T pl1, T rwd, T ulimb,
                    T r_ins) {
  T d, clear, tstar;
  origin_shadow(q, incl, ph, x1, pl1, d, clear, tstar);
  const T miss = sqrt_(clamp_min(T(1) - tstar * tstar, T(0)));
  const bool certain_occ = (tstar > T(0)) & (miss < r_ins - rwd);
  const T x = clear > T(0.25) ? T(1)
              : certain_occ   ? T(-1)
                              : clamp_nan(d / rwd, T(-1), T(1));
  return edge_fraction(x, ulimb);
}

// K10's inputs, in this order, each a pointer and an index map: point i
// reads element ((i / div) % mod) * stride, div 1 dividing nothing and mod
// 0 wrapping nothing (a phase: its own element; a per-row parameter: its
// row's)
enum { WD_PH, WD_Q, WD_INCL, WD_X1, WD_PL1, WD_RWD, WD_ULIMB, WD_RINS,
       WD_INPUTS };

template <typename T> struct WdArgs {
  const T* p[WD_INPUTS];
  unsigned div[WD_INPUTS], mod[WD_INPUTS];
  long long stride[WD_INPUTS];
  T *out, *out2;     // the fraction; the distance mode: d and clear
  long long n;
};

template <typename T>
WD_FN T wd_in(const WdArgs<T>& a, int k, unsigned i) {
  unsigned j = a.div[k] > 1u ? i / a.div[k] : i;
  if (a.mod[k]) j %= a.mod[k];
  return a.p[k][(long long)j * a.stride[k]];
}

// point i of K10: the visible fraction, or (DISTANCE) d and clear
template <bool DISTANCE, typename T>
WD_FN void wd_point_at(const WdArgs<T>& a, unsigned i) {
  const T q = wd_in(a, WD_Q, i), incl = wd_in(a, WD_INCL, i);
  const T ph = wd_in(a, WD_PH, i), x1 = wd_in(a, WD_X1, i);
  const T pl1 = wd_in(a, WD_PL1, i);
  if (DISTANCE) {
    T d, clear, tstar;
    origin_shadow(q, incl, ph, x1, pl1, d, clear, tstar);
    a.out[i] = d;
    a.out2[i] = clear;
  } else {
    a.out[i] = wd_fraction(q, incl, ph, x1, pl1, wd_in(a, WD_RWD, i),
                           wd_in(a, WD_ULIMB, i), wd_in(a, WD_RINS, i));
  }
}

// the launchers' flat arguments, as ops/wd_donor.py hands them: K9 12
// pointers (q, x1, pl1, dx, dy, dz, d_omega, r, slope, pos, nrm, area) and
// 5 integers (the three strides, n_walkers, n_dir);
// K10 10 pointers (the WD_INPUTS inputs, then out and out2) and 3 x
// WD_INPUTS + 1 integers (div, mod, stride of each input, then n)
template <typename T>
static DonorArgs<T> donor_args(const void* const* p, const long long* v) {
  DonorArgs<T> a;
  a.q = (const T*)p[0];
  a.x1 = (const T*)p[1];
  a.pl1 = (const T*)p[2];
  a.dx = (const T*)p[3];
  a.dy = (const T*)p[4];
  a.dz = (const T*)p[5];
  a.d_omega = (const T*)p[6];
  a.r = (T*)p[7];
  a.slope = (T*)p[8];
  a.pos = (T*)p[9];
  a.nrm = (T*)p[10];
  a.area = (T*)p[11];
  a.sq = v[0];
  a.sx1 = v[1];
  a.spl1 = v[2];
  a.n_walkers = v[3];
  a.n_dir = v[4];
  return a;
}

template <typename T>
static WdArgs<T> wd_args(const void* const* p, const long long* v) {
  WdArgs<T> a;
  for (int k = 0; k < WD_INPUTS; ++k) {
    a.p[k] = (const T*)p[k];
    a.div[k] = (unsigned)v[k];
    a.mod[k] = (unsigned)v[WD_INPUTS + k];
    a.stride[k] = v[2 * WD_INPUTS + k];
  }
  a.out = (T*)p[WD_INPUTS];
  a.out2 = (T*)p[WD_INPUTS + 1];
  a.n = v[3 * WD_INPUTS];
  return a;
}

// ---- kernel and launcher ------------------------------------------------

// K9 and K10: one thread a solve or a point, blocks of WD_BLOCK threads
#define WD_BLOCK 128

template <typename T>
__global__ void __launch_bounds__(WD_BLOCK)
donor_grid_kernel(const DonorArgs<T> a) {
  const long long i = (long long)blockIdx.x * WD_BLOCK + threadIdx.x;
  if (i < a.n_walkers * a.n_dir) donor_solve_at(a, i);
}

template <typename T, bool DISTANCE>
__global__ void __launch_bounds__(WD_BLOCK)
wd_curve_kernel(const WdArgs<T> a) {
  const unsigned i = blockIdx.x * WD_BLOCK + threadIdx.x;
  if (i < a.n) wd_point_at<DISTANCE>(a, i);
}

static dim3 wd_grid(long long n) {
  return dim3((unsigned)((n + WD_BLOCK - 1) / WD_BLOCK));
}

// Each launcher runs on ``stream`` and returns the cudaError_t of the
// launch (0 = ok); is_double selects float64 (1) or float32 (0) for every
// array.  The wrappers check the sizes (at most 2**30 solves or points).
extern "C" int donor_grid_launch(int is_double, const void* const* ptrs,
                                 const long long* ints, void* stream) {
  const long long n = ints[3] * ints[4];
  if (n < 1 || n > (1ll << 30) || (ptrs[7] == nullptr && ptrs[9] == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    donor_grid_kernel<double><<<wd_grid(n), WD_BLOCK, 0, s>>>(
        donor_args<double>(ptrs, ints));
  else
    donor_grid_kernel<float><<<wd_grid(n), WD_BLOCK, 0, s>>>(
        donor_args<float>(ptrs, ints));
  return (int)cudaGetLastError();
}

extern "C" int wd_curve_launch(int is_double, int distance,
                               const void* const* ptrs,
                               const long long* ints, void* stream) {
  const long long n = ints[3 * WD_INPUTS];
  if (n < 1 || n > (1ll << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = wd_grid(n);
  if (is_double && distance)
    wd_curve_kernel<double, true><<<grid, WD_BLOCK, 0, s>>>(
        wd_args<double>(ptrs, ints));
  else if (is_double)
    wd_curve_kernel<double, false><<<grid, WD_BLOCK, 0, s>>>(
        wd_args<double>(ptrs, ints));
  else if (distance)
    wd_curve_kernel<float, true><<<grid, WD_BLOCK, 0, s>>>(
        wd_args<float>(ptrs, ints));
  else
    wd_curve_kernel<float, false><<<grid, WD_BLOCK, 0, s>>>(
        wd_args<float>(ptrs, ints));
  return (int)cudaGetLastError();
}
