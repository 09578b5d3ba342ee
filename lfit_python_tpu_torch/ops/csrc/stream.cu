// K2: the gas-stream scan.  Primal: one thread per walker; with
// sensitivities: two threads per walker, one per tangent column.
//
// Replaces no TPU kernel: on the TPU the scan was an XLA lax.scan
// (lfit_python_tpu/roche/stream.py:278, _stream_impacts_impl) with a
// custom_jvp (:307-325).  Its plain PyTorch version is
// lfit_python_tpu_torch/roche/stream.py (stream_impacts and
// stream_impacts_sens), whose arithmetic this kernel repeats op for op.
//
// What bounds it: the dependent chain of each walker, not operations or
// bytes.  A walker integrates 4352-6144 RK4 steps, each of which needs
// the last (180 operations; 248 more per tangent column, counted by hand
// from this source, each rsqrt and sqrt as one); the inputs
// and outputs are a few bytes per walker, and there are only 256-1024
// walkers, so the card's peak rate cannot be reached.  The floor is the
// latency of one RK4 step's chain: per stage ~15 dependent operations
// and an rsqrt (with rsqrtf's denormal fix-up), ~300-350 cycles a step.
//
// What the design does about it: every instruction the step loop issues
// off that chain is one that a lone warp cannot hide, so the loop keeps
// almost none.
//   * Sorted radii.  Each thread sorts its E <= 16 disc radii once,
//     descending with NaN last, in registers (constant indices only).  A
//     radius is first crossed at the first step with rn <= rd, so the
//     crossed radii are always a prefix of that order (ties included),
//     and each step makes one compare against the next uncrossed radius;
//     a crossing writes its record straight to the output and shifts the
//     registers by one.  The radii never crossed take the closest-
//     approach fallback at the end.  No array is indexed at run time, so
//     nothing lives in local memory (ptxas: 0 bytes stack frame).
//   * The closest-approach update is three selects, not a branch.
//   * Sensitivities: the two tangent columns (d/dq, d/dx0) go to two
//     threads of one warp, each of which also integrates the primal.
//     Both threads run the same instructions (no divergence, no
//     shuffles), so a warp issues primal + one column per step instead
//     of primal + two, and 256 walkers fill 16 warps instead of 8.
// Blocks of 32 threads spread the warps over the SMs.
//
// Bit-identity with the plain version: built with --fmad=false so no
// multiply-add is contracted (PyTorch's eager ops round each operation);
// the clamps propagate NaN as torch.clamp does; the bookkeeping above
// changes which instructions run, never an operation's operands or order.
//
// Outputs, row-major: imp (W, E, 2) = (x, y) of each impact; with
// with_sens != 0 also jq, jx0, jrd (W, E, 2): d(impact)/dq at fixed x0,
// d(impact)/dx0 (x0 = xl1 - 1e-5), d(impact)/d rdisc_e.

#include <cuda_runtime.h>
#include <math.h>

#define STREAM_MAX_E 16
#define STREAM_BLOCK 32

template <typename T> __device__ __forceinline__ T rsqrt_(T v);
template <> __device__ __forceinline__ float rsqrt_<float>(float v) { return rsqrtf(v); }
template <> __device__ __forceinline__ double rsqrt_<double>(double v) { return rsqrt(v); }
template <typename T> __device__ __forceinline__ T sqrt_(T v);
template <> __device__ __forceinline__ float sqrt_<float>(float v) { return sqrtf(v); }
template <> __device__ __forceinline__ double sqrt_<double>(double v) { return sqrt(v); }

// torch.clamp semantics: NaN passes through
template <typename T> __device__ __forceinline__ T clamp_min(T v, T lo) { return v < lo ? lo : v; }
template <typename T> __device__ __forceinline__ T clamp01(T v) {
  return v < (T)0 ? (T)0 : (v > (T)1 ? (T)1 : v);
}

// one RK4 stage's acceleration and, with SENS, one tangent column's
// (dmu: the column's tangent of mu)
template <typename T, bool SENS>
__device__ __forceinline__ void accel(T x, T y, T vx, T vy, T mu, T omu,
                                      T dmu, T tx, T ty, T tvx, T tvy, T& ax,
                                      T& ay, T& tax, T& tay) {
  T yy = y * y;
  T i1 = rsqrt_(x * x + yy);
  T dx2 = x - (T)1;
  T i2 = rsqrt_(dx2 * dx2 + yy);
  T i13 = i1 * i1 * i1;
  T i23 = i2 * i2 * i2;
  T s = omu * i13 + mu * i23 - (T)1;
  T gx = omu * x * i13 + mu * dx2 * i23 - (x - mu);
  T gy = y * s;
  ax = -gx + (T)2 * vy;
  ay = -gy - (T)2 * vx;
  if (SENS) {
    T c13 = i13 * i1 * i1;
    T c23 = i23 * i2 * i2;
    T d13 = (T)-3 * c13 * (x * tx + y * ty);
    T d23 = (T)-3 * c23 * (dx2 * tx + y * ty);
    T dgx = -dmu * x * i13 + omu * (tx * i13 + x * d13) + dmu * dx2 * i23 +
            mu * (tx * i23 + dx2 * d23) - tx + dmu;
    T ds = -dmu * i13 + omu * d13 + dmu * i23 + mu * d23;
    T dgy = ty * s + y * ds;
    tax = -dgx + (T)2 * tvy;
    tay = -dgy - (T)2 * tvx;
  }
}

// u is crossed no later than v: the larger radius first, NaN last
template <typename T> __device__ __forceinline__ bool before(T u, T v) {
  return u > v || (v != v && u == u);
}

// The E radii of a walker, sorted in registers; slots past E hold NaN
// (never crossed) and index -1.
template <typename T>
__device__ __forceinline__ void load_sorted(const T* __restrict__ rd_in,
                                            int E, T (&rd)[STREAM_MAX_E],
                                            int (&id)[STREAM_MAX_E]) {
#pragma unroll
  for (int e = 0; e < STREAM_MAX_E; ++e) {
    rd[e] = (T)NAN;
    id[e] = -1;
    if (e < E) {
      rd[e] = rd_in[e];
      id[e] = e;
    }
  }
#pragma unroll
  for (int i = 0; i < STREAM_MAX_E - 1; ++i) {
#pragma unroll
    for (int j = STREAM_MAX_E - 1; j > i; --j) {
      bool sw = before(rd[j], rd[j - 1]);
      T a = rd[j - 1], b = rd[j];
      int ia = id[j - 1], ib = id[j];
      rd[j - 1] = sw ? b : a;
      rd[j] = sw ? a : b;
      id[j - 1] = sw ? ib : ia;
      id[j] = sw ? ia : ib;
    }
  }
}

// drop the head: the next uncrossed radius moves to slot 0
template <typename T>
__device__ __forceinline__ void pop(T (&rd)[STREAM_MAX_E],
                                    int (&id)[STREAM_MAX_E]) {
#pragma unroll
  for (int i = 0; i < STREAM_MAX_E - 1; ++i) {
    rd[i] = rd[i + 1];
    id[i] = id[i + 1];
  }
  rd[STREAM_MAX_E - 1] = (T)NAN;
  id[STREAM_MAX_E - 1] = -1;
}

// SENS = false: thread = walker.  SENS = true: thread pair = walker,
// col = thread & 1 the tangent column (0: d/dq into jq, 1: d/dx0 into
// jx0); column 0's thread also writes imp and jrd.
template <typename T, bool SENS>
__global__ void __launch_bounds__(STREAM_BLOCK)
stream_kernel(const T* __restrict__ q_in, const T* __restrict__ x1_in,
              const T* __restrict__ rd_in, T* __restrict__ imp,
              T* __restrict__ jq, T* __restrict__ jx0, T* __restrict__ jrd,
              int W, int E, int n_steps, double dt_d) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = SENS ? (t >> 1) : t;
  const int col = SENS ? (t & 1) : 0;
  if (w >= W) return;
  const T dt = (T)dt_d;
  const T h = (T)(0.5 * dt_d);
  const T c6 = (T)(dt_d / 6.0);
  const T tiny = (T)1e-30;
  const T q = q_in[w];
  const T mu = q / ((T)1 + q);
  const T omu = (T)1 - mu;
  const T dmu = col == 0 ? (T)1 / (((T)1 + q) * ((T)1 + q)) : (T)0;
  T* const jc = col == 0 ? jq : jx0;
  const bool writes_imp = col == 0;

  T rd[STREAM_MAX_E];
  int id[STREAM_MAX_E];
  load_sorted(rd_in + (size_t)w * E, E, rd, id);
  const size_t base = (size_t)w * E * 2;

  T x = x1_in[w] - (T)1e-5;
  T y = (T)0, vx = (T)-1e-3, vy = (T)0;
  T r = x < (T)0 ? -x : x;
  // this thread's tangent column: dx/dx0 = 1 at the start
  T tx = col == 0 ? (T)0 : (T)1, ty = (T)0, tvx = (T)0, tvy = (T)0;
  T minr = (T)INFINITY, mx = x, my = y, mtx = tx, mty = ty;

  for (int step = 0; step < n_steps; ++step) {
    T ax1, ay1, ax2, ay2, ax3, ay3, ax4, ay4;
    // tangent temporaries (dead code in the primal instantiation)
    T tax1, tay1, tax2, tay2, tax3, tay3, tax4, tay4;
    T t2x = 0, t2y = 0, t3x = 0, t3y = 0, t4x = 0, t4y = 0;
    accel<T, SENS>(x, y, vx, vy, mu, omu, dmu, tx, ty, tvx, tvy, ax1, ay1,
                   tax1, tay1);
    T v2x = vx + h * ax1, v2y = vy + h * ay1;
    if (SENS) {
      t2x = tvx + h * tax1;
      t2y = tvy + h * tay1;
    }
    accel<T, SENS>(x + h * vx, y + h * vy, v2x, v2y, mu, omu, dmu,
                   tx + h * tvx, ty + h * tvy, t2x, t2y, ax2, ay2, tax2,
                   tay2);
    T v3x = vx + h * ax2, v3y = vy + h * ay2;
    if (SENS) {
      t3x = tvx + h * tax2;
      t3y = tvy + h * tay2;
    }
    accel<T, SENS>(x + h * v2x, y + h * v2y, v3x, v3y, mu, omu, dmu,
                   tx + h * t2x, ty + h * t2y, t3x, t3y, ax3, ay3, tax3,
                   tay3);
    T v4x = vx + dt * ax3, v4y = vy + dt * ay3;
    if (SENS) {
      t4x = tvx + dt * tax3;
      t4y = tvy + dt * tay3;
    }
    accel<T, SENS>(x + dt * v3x, y + dt * v3y, v4x, v4y, mu, omu, dmu,
                   tx + dt * t3x, ty + dt * t3y, t4x, t4y, ax4, ay4, tax4,
                   tay4);
    T xn = x + c6 * (vx + (T)2 * v2x + (T)2 * v3x + v4x);
    T yn = y + c6 * (vy + (T)2 * v2y + (T)2 * v3y + v4y);
    T vxn = vx + c6 * (ax1 + (T)2 * ax2 + (T)2 * ax3 + ax4);
    T vyn = vy + c6 * (ay1 + (T)2 * ay2 + (T)2 * ay3 + ay4);
    T txn = 0, tyn = 0, tvxn = 0, tvyn = 0;
    if (SENS) {
      txn = tx + c6 * (tvx + (T)2 * t2x + (T)2 * t3x + t4x);
      tyn = ty + c6 * (tvy + (T)2 * t2y + (T)2 * t3y + t4y);
      tvxn = tvx + c6 * (tax1 + (T)2 * tax2 + (T)2 * tax3 + tax4);
      tvyn = tvy + c6 * (tay1 + (T)2 * tay2 + (T)2 * tay3 + tay4);
    }
    T rn = sqrt_(xn * xn + yn * yn);
    T den = clamp_min(r - rn, tiny);
    // first crossings at this step: a prefix of the sorted radii
    while (rn <= rd[0]) {
      const size_t o = base + 2 * (size_t)id[0];
      T fr = (r - rd[0]) / den;
      T frac = clamp01(fr);
      T ddx = xn - x, ddy = yn - y;
      if (writes_imp) {
        imp[o] = x + frac * ddx;
        imp[o + 1] = y + frac * ddy;
      }
      if (SENS) {
        bool in_rng = (fr > (T)0) && (fr < (T)1);
        T rc = clamp_min(r, tiny), rnc = clamp_min(rn, tiny);
        T dr = (x * tx + y * ty) / rc;
        T drn = (xn * txn + yn * tyn) / rnc;
        T dfrac = in_rng ? (dr * den - (r - rd[0]) * (dr - drn)) / (den * den)
                         : (T)0;
        jc[o] = tx + dfrac * ddx + frac * (txn - tx);
        jc[o + 1] = ty + dfrac * ddy + frac * (tyn - ty);
        if (writes_imp) {
          T dfr = in_rng ? (T)-1 / den : (T)0;
          jrd[o] = dfr * ddx;
          jrd[o + 1] = dfr * ddy;
        }
      }
      pop(rd, id);
    }
    const bool closer = rn < minr;
    minr = closer ? rn : minr;
    mx = closer ? x : mx;
    my = closer ? y : my;
    x = xn; y = yn; vx = vxn; vy = vyn; r = rn;
    if (SENS) {
      mtx = closer ? tx : mtx;
      mty = closer ? ty : mty;
      tx = txn; ty = tyn; tvx = tvxn; tvy = tvyn;
    }
  }

  // the radii never crossed: closest-approach fallback
#pragma unroll
  for (int i = 0; i < STREAM_MAX_E; ++i) {
    if (id[i] < 0) continue;
    const size_t o = base + 2 * (size_t)id[i];
    if (writes_imp) {
      imp[o] = mx;
      imp[o + 1] = my;
    }
    if (SENS) {
      jc[o] = mtx;
      jc[o + 1] = mty;
      if (writes_imp) {
        jrd[o] = (T)0;
        jrd[o + 1] = (T)0;
      }
    }
  }
}

template <typename T>
static void launch(const void* q, const void* x1, const void* rd, void* imp,
                   void* jq, void* jx0, void* jrd, int W, int E, int n_steps,
                   double dt, int with_sens, cudaStream_t s) {
  const int threads = with_sens ? 2 * W : W;
  dim3 grid((threads + STREAM_BLOCK - 1) / STREAM_BLOCK), block(STREAM_BLOCK);
  if (with_sens)
    stream_kernel<T, true><<<grid, block, 0, s>>>(
        (const T*)q, (const T*)x1, (const T*)rd, (T*)imp, (T*)jq, (T*)jx0,
        (T*)jrd, W, E, n_steps, dt);
  else
    stream_kernel<T, false><<<grid, block, 0, s>>>(
        (const T*)q, (const T*)x1, (const T*)rd, (T*)imp, nullptr, nullptr,
        nullptr, W, E, n_steps, dt);
}

extern "C" int stream_max_e() { return STREAM_MAX_E; }

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
// is_double selects float64 (1) or float32 (0) for every array.
extern "C" int stream_launch(int is_double, const void* q, const void* x1,
                             const void* rd, void* imp, void* jq, void* jx0,
                             void* jrd, int W, int E, int n_steps, double dt,
                             int with_sens, void* stream) {
  if (E < 1 || E > STREAM_MAX_E || W < 1 || n_steps < 0 || W > (1 << 29))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    launch<double>(q, x1, rd, imp, jq, jx0, jrd, W, E, n_steps, dt, with_sens, s);
  else
    launch<float>(q, x1, rd, imp, jq, jx0, jrd, W, E, n_steps, dt, with_sens, s);
  return (int)cudaGetLastError();
}
