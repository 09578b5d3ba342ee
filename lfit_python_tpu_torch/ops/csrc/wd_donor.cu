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
// at the card's peak and ~5.6 us at one an FP32 lane and clock (the issue
// floor: --fmad=false fuses none).  K10 is 5120 rows x 128 phases =
// 655,360 points of ~354 operations reading a phase and writing one value
// (5 MB): ~3.5 us at the peak, ~6.9 us at the issue floor.  Neither has a
// dependent chain longer than a few hundred operations, so independent
// solves and points fill the card, and what a kernel issues beyond the
// counted operations is its cost.
//
// What the design does about it.  K10: a group of L lanes serves a row (L =
// 32 from 32 phases on; below, the power of two that holds the row, 32 / L
// rows a warp; where a parameter varies along the last axis, as in the
// distance mode's (2, rows) changepoints, the rows are single points, a
// thread each), lane l phases l, l + L, ...; 1024 walkers' 5120 rows of 128
// phases are 4 phases a lane, one row a warp.  Each lane makes its row's
// prologue once: the row's parameters read through index maps in row units
// (row r reads element ((r / div) % mod) * stride, no parameter expanded to
// (rows, P) and copied, a strided column read in place), the divisions by the
// multiply-high of the divisor's magic number, made on the host; and the
// terms that do not depend on the phase (mu, 1 - mu, -2 (1 - mu), sin and cos
// of the inclination, the squared sphere radius, r_ins - rwd, 1 - u and the
// edge fraction's total).  K9: a block of 384 threads serves a walker (a few,
// blockDim.y, for a grid of fewer directions than half a block), a lane a
// direction; the walker's terms (mu, 1 - mu, pl1, the bracket) are made once
// by its first lane into shared memory, and no index is divided.  Measured on
// the H100 (PERF.md section 6; tools/torch_wd_donor_variants.py): K10 takes
// one phase a lane at a time (four a lane as unrolled chains with 16-byte
// loads and stores, and two in float64, were slower: their registers cost
// more warps than the chains gave back), and K9 writes its grid in place
// (staged in shared memory and written by 16-byte stores it was slower: the
// solve is bound by what it issues, not by its bytes).
//
// Bit-identity with the plain versions: each expression below is one
// PyTorch operation per operator, in the plain version's order; built
// with --fmad=false, so no multiply-add is contracted (PyTorch's eager ops
// round each operation).  A term made once a row or a walker is the value
// the plain chain makes at every point, by the same operations.  Python's
// double constants enter PyTorch's kernels rounded to the tensor's type,
// and so they are written here as T(double); torch.deg2rad multiplies by
// pi / 180 so rounded.  A division by a Python number on a CUDA tensor is
// a product by the reciprocal, rounded in the tensor's type (ATen's
// div_true_kernel_cuda for a CPU scalar): (1 - a ** 3) / 3.0 is a product
// by T(1) / T(3).  a ** 3 is a * a * a (ATen's pow specialises the
// exponent 3), 1.0 / r is r's reciprocal (Tensor.__rtruediv__) times 1.
// sin, cos and acos are sinf, cosf and acosf (sin, cos, acos in float64),
// as PyTorch's; rsqrt is rsqrtf.  torch.minimum / maximum / clamp
// propagate NaN and so do nmin, nmax, clamp_min and clamp_nan; a
// comparison with NaN is false, as in torch.where.  sin / cos carry a
// Payne-Hanek slow path with an array in local memory for |x| > 105615
// (float64; 48039 float32), which no angle here reaches.
//
// Everything above the "kernel and launcher" line is plain arithmetic with
// no CUDA intrinsic: a host loop can run it (tests/test_torch_wd_donor.py),
// the kernels' maps from their threads to solves and points included.

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
// sin and cos of one angle: sinf and cosf in float32; sincos in float64,
// one range reduction for both (the bits of sin and cos)
WD_FN void sincos_(float v, float& s, float& c) {
  s = sinf(v);
  c = cosf(v);
}
WD_FN void sincos_(double v, double& s, double& c) { sincos(v, &s, &c); }
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

// ---- index maps ---------------------------------------------------------

// the high 32 bits of a * b
WD_FN unsigned umulhi_(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}

// n / d for n < 2^31 as (umulhi(n, m) + n) >> s, d's magic number m and
// shift s made on the host (PyTorch's IntDivider's scheme): no integer
// division on the card
struct FastDiv {
  unsigned d, m, s;
};
static inline FastDiv fast_div(unsigned d) {
  FastDiv f;
  f.d = d;
  f.s = 0;
  while ((1ull << f.s) < d) ++f.s;
  f.m = (unsigned)(((1ull << 32) * ((1ull << f.s) - d)) / d + 1);
  return f;
}
WD_FN unsigned div_(const FastDiv& f, unsigned n) {
  return (umulhi_(n, f.m) + n) >> f.s;
}

// an input's index map in row units: row r reads element ((r / div) % mod)
// * stride, div 1 dividing nothing and mod 0 wrapping nothing
struct RowMap {
  FastDiv div, mod;
  long long stride;
};
static inline RowMap row_map(long long div, long long mod, long long stride) {
  RowMap m;
  m.div = fast_div(div > 1 ? (unsigned)div : 1u);
  m.mod = fast_div(mod > 1 ? (unsigned)mod : 1u);
  m.mod.d = (unsigned)mod;
  m.stride = stride;
  return m;
}
WD_FN long long row_at(const RowMap& m, unsigned r) {
  unsigned j = m.div.d > 1u ? div_(m.div, r) : r;
  if (m.mod.d) j -= div_(m.mod, j) * m.mod.d;
  return (long long)j * m.stride;
}

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
// and K9's block in each type: `threads` threads, at least `blocks` of
// them an SM (ptxas keeps the registers within 64K over their threads)
template <typename T> struct DonorSteps;
template <> struct DonorSteps<double> {
  static constexpr int bisections = WD_BISECT_F64, newtons = 0;
  static constexpr int threads = 384, blocks = 3;
};
template <> struct DonorSteps<float> {
  static constexpr int bisections = WD_BISECT_F32, newtons = WD_NEWTON_F32;
  static constexpr int threads = 384, blocks = 5;
};

// components._donor_radius_loop's radius at one (walker, direction):
// DonorSteps<T>::bisections steps over the walker's bracket (1e-6 rmax,
// rmax), rmax = 1 - x1, then DonorSteps<T>::newtons safeguarded Newton
// steps (a proposal outside the bracket, by the strict tests rn < lo or
// rn > hi, takes the bracket's midpoint; a NaN proposal passes them, as
// in torch.where)
template <typename T> WD_FN T lobe_root(const Lobe<T>& s, T lo, T hi) {
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

// K9's block: x lanes across the directions (a multiple of 32) and g
// walkers (blockDim (x, g)), x g <= the type's threads; lane tx solves
// directions tx, tx + x, ... of its walker
struct DonorShape {
  unsigned x, g;
};
static inline DonorShape donor_shape(unsigned n_dir, unsigned threads) {
  DonorShape sh;
  sh.x = (n_dir + 31) / 32 * 32;
  if (sh.x > threads) sh.x = threads;
  sh.g = threads / sh.x;
  return sh;
}
static inline unsigned donor_blocks(unsigned n_walkers, DonorShape sh) {
  return (n_walkers + sh.g - 1) / sh.g;
}

// K9's arrays.  q, x1, pl1 are per walker, walker w at w * stride; dx, dy,
// dz, d_omega per direction (n_dir, contiguous); r, slope (W, N), pos and
// nrm (W, N, 3) and area (W, N), contiguous.  r null: no radius and slope
// (the grid alone, on a forward evaluation); pos null: no grid.  sh: the
// block's shape
template <typename T> struct DonorArgs {
  const T *q, *x1, *pl1, *dx, *dy, *dz, *d_omega;
  T *r, *slope, *pos, *nrm, *area;
  long long sq, sx1, spl1;
  unsigned n_walkers, n_dir;
  DonorShape sh;
};

// a walker's terms, the same along each of its directions: mu, 1 - mu,
// pl1 and the bracket (1e-6 rmax, rmax)
template <typename T> struct Walker {
  T mu, omu, pl1, lo, hi;
};

// the walker of slot ty of block b, and whether it is one
template <typename T>
WD_FN unsigned donor_walker_of(const DonorArgs<T>& a, unsigned b,
                               unsigned ty, bool& real) {
  const unsigned w = b * a.sh.g + ty;
  real = w < a.n_walkers;
  return w;
}

// f(j) for each direction j of lane tx, in its order: tx, tx + x, ...
template <typename T, typename F>
WD_FN void donor_dirs(const DonorArgs<T>& a, unsigned tx, F f) {
  for (unsigned j = tx; j < a.n_dir; j += a.sh.x) f(j);
}

// the first lane of each walker slot makes its walker's terms into wk
template <typename T>
WD_FN void donor_walkers(const DonorArgs<T>& a, unsigned b, unsigned tx,
                         unsigned ty, Walker<T>* wk) {
  bool real;
  const unsigned w = donor_walker_of(a, b, ty, real);
  if (tx != 0 || !real) return;
  Walker<T> k;
  const T q = a.q[w * a.sq];
  k.mu = q / (T(1) + q);
  k.omu = T(1) - k.mu;
  k.pl1 = a.pl1[w * a.spl1];
  k.hi = T(1) - a.x1[w * a.sx1];
  k.lo = T(1e-6) * k.hi;
  wk[ty] = k;
}

// the solve of direction j of walker slot ty of block b: the radius and,
// where r is given, it and its slope; where pos is given,
// components._donor_grid_plain's element (its position, normal and area)
template <typename T>
WD_FN void donor_solve(const DonorArgs<T>& a, unsigned b, unsigned ty,
                       unsigned j, const Walker<T>* wk) {
  bool real;
  const unsigned w = donor_walker_of(a, b, ty, real);
  if (!real) return;
  const Walker<T> k = wk[ty];
  Lobe<T> l;
  l.mu = k.mu;
  l.omu = k.omu;
  l.pl1 = k.pl1;
  l.dx = a.dx[j];
  l.dy = a.dy[j];
  l.dz = a.dz[j];
  const T r = lobe_root(l, k.lo, k.hi);
  const long long i = (long long)w * a.n_dir + j;
  if (a.r != nullptr) {
    a.r[i] = r;
    a.slope[i] = lobe_fp(l, r);
  }
  if (a.pos == nullptr) return;
  const T px = T(1) + r * l.dx;
  const T py = r * l.dy;
  const T pz = r * l.dz;
  const T i1 = rsqrt_(px * px + py * py + pz * pz);
  const T i2 = T(1) / r;
  const T i13 = i1 * i1 * i1;
  const T i23 = i2 * i2 * i2;
  const T gx = k.omu * px * i13 + k.mu * (px - T(1)) * i23 - (px - k.mu);
  const T gy = py * (k.omu * i13 + k.mu * i23 - T(1));
  const T gz = pz * (k.omu * i13 + k.mu * i23);
  const T gn = clamp_min(sqrt_(gx * gx + gy * gy + gz * gz), T(1e-12));
  const T nx = gx / gn, ny = gy / gn, nz = gz / gn;
  const T mu_dn = clamp_min(l.dx * nx + l.dy * ny + l.dz * nz, T(1e-3));
  a.pos[3 * i] = px;
  a.pos[3 * i + 1] = py;
  a.pos[3 * i + 2] = pz;
  a.nrm[3 * i] = nx;
  a.nrm[3 * i + 1] = ny;
  a.nrm[3 * i + 2] = nz;
  a.area[i] = r * r * a.d_omega[j] / mu_dn;
}

// ---- K10: the white dwarf's sweep ---------------------------------------

// a row's terms that do not depend on the phase: the shadow distance's
// (mu, 1 - mu, -2 (1 - mu), sin i, -sin i, cos i, (1 - x1)^2, pl1) and the
// curve's (rwd, r_ins - rwd, u, 1 - u, the edge fraction's total)
template <typename T> struct WdRow {
  T mu, omu, m2omu, si, nsi, ci, rad2, pl1;
  T rwd, gap, u, ou, total;
};

// _origin_clearance's terms of the row's q, inclination (deg), x1, pl1
template <typename T>
WD_FN void wd_row_geometry(WdRow<T>& w, T q, T incl, T x1, T pl1) {
  w.mu = q / (T(1) + q);
  w.omu = T(1) - w.mu;
  w.m2omu = T(-2.0) * w.omu;
  const T i_rad = incl * T(WD_PI_180);
  w.si = sin_(i_rad);
  w.ci = cos_(i_rad);
  w.nsi = -w.si;
  const T rad = T(1) - x1;
  w.rad2 = rad * rad;
  w.pl1 = pl1;
}

// _wd_curve_plain's terms of the row's rwd, ulimb, r_ins
template <typename T>
WD_FN void wd_row_curve(WdRow<T>& w, T rwd, T ulimb, T r_ins) {
  const T third = T(1) / T(3);
  w.rwd = rwd;
  w.gap = r_ins - rwd;
  w.u = ulimb;
  w.ou = T(1) - ulimb;
  w.total = w.ou * T(WD_PI) + ulimb * T(2) * T(WD_PI) * third;
}

// g(t) = Phi(t e) along the ray from the origin (r1 = t)
template <typename T> WD_FN T origin_g(const WdRow<T>& w, T ex, T ey, T t) {
  const T i2 = rsqrt_(t * t - T(2) * ex * t + T(1));
  const T cx = t * ex - w.mu;
  const T cy = t * ey;
  return -w.omu / t - w.mu * i2 - T(0.5) * (cx * cx + cy * cy);
}

// geometry._shadow_distance_plain at one phase ph of the row w (no precise
// refinement): the clearance of the ray from the origin towards the
// observer, from the chord midpoint by 4 clamped Newton steps with the
// chord's end values as insurance; then grad(Phi) at the minimum,
// perpendicular to the line of sight, and the signed sky distance d =
// clear / |grad_perp|.  ex = sin(i) cos(2 pi ph), which wd_flux's guard
// calls tstar, is returned too
template <typename T>
WD_FN void origin_shadow(const WdRow<T>& w, T ph, T& d, T& clear,
                         T& ex_out) {
  const T th = T(WD_TWO_PI) * ph;
  T sth, cth;
  sincos_(th, sth, cth);
  const T ex = w.si * cth;
  const T ey = w.nsi * sth;
  const T tstar = ex;
  const T disc = w.rad2 - (T(1) - tstar * tstar);
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
    const T cx = t * ex - w.mu;
    const T cy = t * ey;
    const T g1 = w.omu / (t * t) + w.mu * u2 * i23 - (cx * ex + cy * ey);
    const T g2 = w.m2omu / (t * t * t)
                 + w.mu * (i23 - T(3) * u2 * u2 * i23 * i2 * i2) - ee2;
    const T step = g2 > T(1e-12) ? g1 / clamp_min(g2, T(1e-12)) : T(0);
    t = nmin(nmax(t - step, t_lo), t_hi);
  }
  T val = origin_g(w, ex, ey, t);
  const T v_lo = origin_g(w, ex, ey, t_lo);
  const T v_hi = origin_g(w, ex, ey, t_hi);
  t = v_lo < val ? t_lo : t;
  val = nmin(val, v_lo);
  t = v_hi < val ? t_hi : t;
  val = nmin(val, v_hi);
  clear = no_occ ? T(WD_CLEAR_VISIBLE) : val - w.pl1;
  const T rx = t * ex, ry = t * ey, rz = t * w.ci;
  const T i1 = rsqrt_(rx * rx + ry * ry + rz * rz);
  const T dxx = rx - T(1);
  const T i2 = rsqrt_(dxx * dxx + ry * ry + rz * rz);
  const T i13 = i1 * i1 * i1, i23 = i2 * i2 * i2;
  const T gx = w.omu * rx * i13 + w.mu * dxx * i23 - (rx - w.mu);
  const T gy = ry * (w.omu * i13 + w.mu * i23 - T(1));
  const T gz = rz * (w.omu * i13 + w.mu * i23);
  const T gdote = gx * ex + gy * ey + gz * w.ci;
  const T qx = gx - gdote * ex, qy = gy - gdote * ey, qz = gz - gdote * w.ci;
  const T g_norm = sqrt_(clamp_min(qx * qx + qy * qy + qz * qz, T(1e-24)));
  d = clear / g_norm;
  ex_out = ex;
}

// components._EdgeVisibleFraction.forward: the visible fraction of a
// linearly limb-darkened disc whose centre lies x disc radii inside a
// straight shadow edge, the row's limb darkening
template <typename T> WD_FN T edge_fraction(const WdRow<T>& w, T x) {
  const T a = clamp_nan(-x, T(-1), T(1));
  const T s2 = clamp_min(T(1) - a * a, T(0));
  const T uni = acos_(a) - a * sqrt_(s2);
  const T third = T(1) / T(3);
  const T sq = T(WD_HALF_PI) * ((T(1) - a) - (T(1) - a * a * a) * third);
  return (w.ou * uni + w.u * sq) / w.total;
}

// components._wd_curve_plain (no precise refinement) at one phase of the
// row w
template <typename T> WD_FN T wd_fraction(const WdRow<T>& w, T ph) {
  T d, clear, tstar;
  origin_shadow(w, ph, d, clear, tstar);
  const T miss = sqrt_(clamp_min(T(1) - tstar * tstar, T(0)));
  const bool certain_occ = (tstar > T(0)) & (miss < w.gap);
  const T x = clear > T(0.25) ? T(1)
              : certain_occ   ? T(-1)
                              : clamp_nan(d / w.rwd, T(-1), T(1));
  return edge_fraction(w, x);
}

// K10's inputs, in this order, each a pointer and an index map in row
// units (a phase: its row's first; a parameter: its row's)
enum { WD_PH, WD_Q, WD_INCL, WD_X1, WD_PL1, WD_RWD, WD_ULIMB, WD_RINS,
       WD_INPUTS };

// K10's block and the most lanes a row
#define WD_BLOCK 128
constexpr unsigned WD_ROW_LANES = 32;

// K10's arrays: rows x P points, row r's phases at p[WD_PH] + its map,
// one apart; out and out2 (the distance mode: d and clear) (rows, P),
// contiguous; lanes a row (a power of two) and its log2
template <typename T> struct WdArgs {
  const T* p[WD_INPUTS];
  RowMap map[WD_INPUTS];
  T *out, *out2;
  unsigned rows, P, lanes, log2_lanes;
};

// the lanes of a row's group: 32 from 32 phases on, else the least power
// of two that holds the row
template <typename T> static inline void wd_layout(WdArgs<T>& a,
                                                   unsigned rows, unsigned P) {
  a.rows = rows;
  a.P = P;
  a.lanes = 1;
  a.log2_lanes = 0;
  while (a.lanes < P && a.lanes < WD_ROW_LANES) {
    a.lanes <<= 1;
    ++a.log2_lanes;
  }
}
template <typename T> static inline unsigned wd_blocks(const WdArgs<T>& a) {
  return (unsigned)(((unsigned long long)a.rows * a.lanes + WD_BLOCK - 1)
                    / WD_BLOCK);
}

// the row and lane of thread t of block b
struct WdLane {
  unsigned row, lane;
};
template <typename T>
WD_FN WdLane wd_lane(const WdArgs<T>& a, unsigned b, unsigned t) {
  const unsigned g = b * WD_BLOCK + t;
  WdLane l;
  l.row = g >> a.log2_lanes;
  l.lane = g & (a.lanes - 1u);
  return l;
}

// f(p) for each phase p that lane `lane` of a row's L lanes serves, in
// its order: lane, lane + L, ...
template <typename F>
WD_FN void wd_visit(unsigned P, unsigned L, unsigned lane, F f) {
  for (unsigned p = lane; p < P; p += L) f(p);
}

template <typename T> WD_FN T wd_in(const WdArgs<T>& a, int k, unsigned r) {
  return a.p[k][row_at(a.map[k], r)];
}

// row r's prologue: its terms, once
template <bool DISTANCE, typename T>
WD_FN WdRow<T> wd_row(const WdArgs<T>& a, unsigned r) {
  WdRow<T> w;
  wd_row_geometry(w, wd_in(a, WD_Q, r), wd_in(a, WD_INCL, r),
                  wd_in(a, WD_X1, r), wd_in(a, WD_PL1, r));
  if (!DISTANCE)
    wd_row_curve(w, wd_in(a, WD_RWD, r), wd_in(a, WD_ULIMB, r),
                 wd_in(a, WD_RINS, r));
  return w;
}

// phase p of the row w: the visible fraction into out[p], or (DISTANCE) d
// into out[p] and clear into out2[p]
template <bool DISTANCE, typename T>
WD_FN void wd_point(const WdRow<T>& w, const T* ph, T* out, T* out2,
                    unsigned p) {
  if (DISTANCE) {
    T d, clear, ex;
    origin_shadow(w, ph[p], d, clear, ex);
    out[p] = d;
    out2[p] = clear;
  } else {
    out[p] = wd_fraction(w, ph[p]);
  }
}

// lane `lane` of row r's group: the row's prologue, then its phases
template <bool DISTANCE, typename T>
WD_FN void wd_row_sweep(const WdArgs<T>& a, unsigned r, unsigned lane) {
  const WdRow<T> w = wd_row<DISTANCE>(a, r);
  const T* ph = a.p[WD_PH] + row_at(a.map[WD_PH], r);
  const long long at = (long long)r * a.P;
  T* out = a.out + at;
  T* out2 = DISTANCE ? a.out2 + at : nullptr;
  wd_visit(a.P, a.lanes, lane,
           [&](unsigned p) { wd_point<DISTANCE>(w, ph, out, out2, p); });
}

// the launchers' flat arguments, as ops/wd_donor.py hands them: K9 12
// pointers (q, x1, pl1, dx, dy, dz, d_omega, r, slope, pos, nrm, area) and
// 5 integers (the three strides, n_walkers, n_dir);
// K10 10 pointers (the WD_INPUTS inputs, then out and out2) and 3 x
// WD_INPUTS + 2 integers (div, mod, stride of each input's row map, then
// rows and P)
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
  a.n_walkers = (unsigned)v[3];
  a.n_dir = (unsigned)v[4];
  a.sh = donor_shape(a.n_dir, DonorSteps<T>::threads);
  return a;
}

template <typename T>
static WdArgs<T> wd_args(const void* const* p, const long long* v) {
  WdArgs<T> a;
  for (int k = 0; k < WD_INPUTS; ++k) {
    a.p[k] = (const T*)p[k];
    a.map[k] = row_map(v[k], v[WD_INPUTS + k], v[2 * WD_INPUTS + k]);
  }
  a.out = (T*)p[WD_INPUTS];
  a.out2 = (T*)p[WD_INPUTS + 1];
  wd_layout(a, (unsigned)v[3 * WD_INPUTS], (unsigned)v[3 * WD_INPUTS + 1]);
  return a;
}

// ---- kernel and launcher ------------------------------------------------

// K9: block (x, g) of donor_shape, one walker a slot: its terms made once
// into shared memory, then its directions, x apart
template <typename T>
__global__ void __launch_bounds__(DonorSteps<T>::threads,
                                  DonorSteps<T>::blocks)
donor_grid_kernel(const DonorArgs<T> a) {
  __shared__ Walker<T> wk[DonorSteps<T>::threads / 32];
  const unsigned b = blockIdx.x, tx = threadIdx.x, ty = threadIdx.y;
  donor_walkers(a, b, tx, ty, wk);
  __syncthreads();
  donor_dirs(a, tx, [&](unsigned j) { donor_solve(a, b, ty, j, wk); });
}

// K10: WD_BLOCK threads, wd_lane's row and lane each
template <typename T, bool DISTANCE>
__global__ void __launch_bounds__(WD_BLOCK)
wd_curve_kernel(const WdArgs<T> a) {
  const WdLane l = wd_lane(a, blockIdx.x, threadIdx.x);
  if (l.row < a.rows) wd_row_sweep<DISTANCE>(a, l.row, l.lane);
}

template <typename T>
static int donor_launch(const void* const* ptrs, const long long* ints,
                        cudaStream_t s) {
  const DonorArgs<T> a = donor_args<T>(ptrs, ints);
  donor_grid_kernel<T><<<donor_blocks(a.n_walkers, a.sh),
                         dim3(a.sh.x, a.sh.g), 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool DISTANCE>
static int wd_launch(const void* const* ptrs, const long long* ints,
                     cudaStream_t s) {
  const WdArgs<T> a = wd_args<T>(ptrs, ints);
  wd_curve_kernel<T, DISTANCE><<<wd_blocks(a), WD_BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
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
  return is_double ? donor_launch<double>(ptrs, ints, s)
                   : donor_launch<float>(ptrs, ints, s);
}

extern "C" int wd_curve_launch(int is_double, int distance,
                               const void* const* ptrs,
                               const long long* ints, void* stream) {
  const long long rows = ints[3 * WD_INPUTS], P = ints[3 * WD_INPUTS + 1];
  if (rows < 1 || P < 1 || rows * P > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double && distance) return wd_launch<double, true>(ptrs, ints, s);
  if (is_double) return wd_launch<double, false>(ptrs, ints, s);
  if (distance) return wd_launch<float, true>(ptrs, ints, s);
  return wd_launch<float, false>(ptrs, ints, s);
}
