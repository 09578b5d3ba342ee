// K2: the gas-stream scan, one thread per walker.
//
// Replaces no TPU kernel: on the TPU the scan was an XLA lax.scan
// (lfit_python_tpu/roche/stream.py:278, _stream_impacts_impl) with a
// custom_jvp (:307-325).  Its plain PyTorch version is
// lfit_python_tpu_torch/roche/stream.py (stream_impacts and
// stream_impacts_sens), whose arithmetic this kernel repeats op for op.
//
// What bounds it: nothing but latency.  Each walker integrates 4352-6144
// dependent RK4 steps of ~60 operations (x 3 with sensitivities); the
// inputs and outputs are a few bytes per walker.  Eager PyTorch spent
// ~200 host launches per step on it; here the whole loop, the first-
// crossing bookkeeping for E disc radii and the closest-approach
// fallback stay in one thread's registers and local memory, and the
// device writes only the results.  Blocks of 32 threads spread the
// walkers over the SMs (1024 walkers: 32 SMs busy, one warp each).
//
// Bit-closeness to the plain version: built with --fmad=false so no
// multiply-add is contracted (PyTorch's eager ops round each operation);
// the clamps propagate NaN as torch.clamp does.
//
// Outputs, row-major: imp (W, E, 2) = (x, y) of each impact; with
// with_sens != 0 also jq, jx0, jrd (W, E, 2): d(impact)/dq at fixed x0,
// d(impact)/dx0 (x0 = xl1 - 1e-5), d(impact)/d rdisc_e.

#include <cuda_runtime.h>

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

// one RK4 stage's acceleration; with tangent columns (K = 2: d/dq, d/dx0)
// when T_ != nullptr
template <typename T, bool SENS>
__device__ __forceinline__ void accel(T x, T y, T vx, T vy, T mu, T omu,
                                      const T dmu[2], const T tx[2],
                                      const T ty[2], const T tvx[2],
                                      const T tvy[2], T& ax, T& ay, T tax[2],
                                      T tay[2]) {
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
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      T d13 = (T)-3 * c13 * (x * tx[k] + y * ty[k]);
      T d23 = (T)-3 * c23 * (dx2 * tx[k] + y * ty[k]);
      T dgx = -dmu[k] * x * i13 + omu * (tx[k] * i13 + x * d13) +
              dmu[k] * dx2 * i23 + mu * (tx[k] * i23 + dx2 * d23) - tx[k] +
              dmu[k];
      T ds = -dmu[k] * i13 + omu * d13 + dmu[k] * i23 + mu * d23;
      T dgy = ty[k] * s + y * ds;
      tax[k] = -dgx + (T)2 * tvy[k];
      tay[k] = -dgy - (T)2 * tvx[k];
    }
  }
}

template <typename T, bool SENS>
__global__ void stream_kernel(const T* __restrict__ q_in,
                              const T* __restrict__ x1_in,
                              const T* __restrict__ rd_in, T* __restrict__ imp,
                              T* __restrict__ jq, T* __restrict__ jx0,
                              T* __restrict__ jrd, int W, int E, int n_steps,
                              double dt_d) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const T dt = (T)dt_d;
  const T h = (T)(0.5 * dt_d);
  const T c6 = (T)(dt_d / 6.0);
  const T tiny = (T)1e-30;
  T q = q_in[w];
  T mu = q / ((T)1 + q);
  T omu = (T)1 - mu;
  T dmu[2] = {(T)1 / (((T)1 + q) * ((T)1 + q)), (T)0};

  T rd[STREAM_MAX_E], hx[STREAM_MAX_E], hy[STREAM_MAX_E];
  bool found[STREAM_MAX_E];
  // sensitivity records per radius: (x, y) for d/dq, d/dx0, d/drd
  T sqx[STREAM_MAX_E], sqy[STREAM_MAX_E], sxx[STREAM_MAX_E],
      sxy[STREAM_MAX_E], srx[STREAM_MAX_E], sry[STREAM_MAX_E];
  for (int e = 0; e < E; ++e) {
    rd[e] = rd_in[(size_t)w * E + e];
    hx[e] = hy[e] = (T)0;
    found[e] = false;
    sqx[e] = sqy[e] = sxx[e] = sxy[e] = srx[e] = sry[e] = (T)0;
  }

  T x = x1_in[w] - (T)1e-5;
  T y = (T)0, vx = (T)-1e-3, vy = (T)0;
  T r = x < (T)0 ? -x : x;
  // tangent columns k = 0 (d/dq), 1 (d/dx0)
  T tx[2] = {(T)0, (T)1}, ty[2] = {(T)0, (T)0};
  T tvx[2] = {(T)0, (T)0}, tvy[2] = {(T)0, (T)0};
  T minr = (T)INFINITY, mx = x, my = y;
  T mtx[2] = {tx[0], tx[1]}, mty[2] = {ty[0], ty[1]};

  for (int step = 0; step < n_steps; ++step) {
    T ax1, ay1, ax2, ay2, ax3, ay3, ax4, ay4;
    T tax1[2], tay1[2], tax2[2], tay2[2], tax3[2], tay3[2], tax4[2], tay4[2];
    T t2x[2], t2y[2], t3x[2], t3y[2], t4x[2], t4y[2], a[2], b[2];
    accel<T, SENS>(x, y, vx, vy, mu, omu, dmu, tx, ty, tvx, tvy, ax1, ay1,
                   tax1, tay1);
    T v2x = vx + h * ax1, v2y = vy + h * ay1;
    if (SENS) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        t2x[k] = tvx[k] + h * tax1[k];
        t2y[k] = tvy[k] + h * tay1[k];
        a[k] = tx[k] + h * tvx[k];
        b[k] = ty[k] + h * tvy[k];
      }
    }
    accel<T, SENS>(x + h * vx, y + h * vy, v2x, v2y, mu, omu, dmu, a, b, t2x,
                   t2y, ax2, ay2, tax2, tay2);
    T v3x = vx + h * ax2, v3y = vy + h * ay2;
    if (SENS) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        t3x[k] = tvx[k] + h * tax2[k];
        t3y[k] = tvy[k] + h * tay2[k];
        a[k] = tx[k] + h * t2x[k];
        b[k] = ty[k] + h * t2y[k];
      }
    }
    accel<T, SENS>(x + h * v2x, y + h * v2y, v3x, v3y, mu, omu, dmu, a, b, t3x,
                   t3y, ax3, ay3, tax3, tay3);
    T v4x = vx + dt * ax3, v4y = vy + dt * ay3;
    if (SENS) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        t4x[k] = tvx[k] + dt * tax3[k];
        t4y[k] = tvy[k] + dt * tay3[k];
        a[k] = tx[k] + dt * t3x[k];
        b[k] = ty[k] + dt * t3y[k];
      }
    }
    accel<T, SENS>(x + dt * v3x, y + dt * v3y, v4x, v4y, mu, omu, dmu, a, b,
                   t4x, t4y, ax4, ay4, tax4, tay4);
    T xn = x + c6 * (vx + (T)2 * v2x + (T)2 * v3x + v4x);
    T yn = y + c6 * (vy + (T)2 * v2y + (T)2 * v3y + v4y);
    T vxn = vx + c6 * (ax1 + (T)2 * ax2 + (T)2 * ax3 + ax4);
    T vyn = vy + c6 * (ay1 + (T)2 * ay2 + (T)2 * ay3 + ay4);
    T txn[2], tyn[2], tvxn[2], tvyn[2];
    if (SENS) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        txn[k] = tx[k] + c6 * (tvx[k] + (T)2 * t2x[k] + (T)2 * t3x[k] + t4x[k]);
        tyn[k] = ty[k] + c6 * (tvy[k] + (T)2 * t2y[k] + (T)2 * t3y[k] + t4y[k]);
        tvxn[k] = tvx[k] + c6 * (tax1[k] + (T)2 * tax2[k] + (T)2 * tax3[k] + tax4[k]);
        tvyn[k] = tvy[k] + c6 * (tay1[k] + (T)2 * tay2[k] + (T)2 * tay3[k] + tay4[k]);
      }
    }
    T rn = sqrt_(xn * xn + yn * yn);
    T den = clamp_min(r - rn, tiny);
    for (int e = 0; e < E; ++e) {
      if (!(rn <= rd[e]) || found[e]) continue;
      T fr = (r - rd[e]) / den;
      T frac = clamp01(fr);
      T ddx = xn - x, ddy = yn - y;
      hx[e] = x + frac * ddx;
      hy[e] = y + frac * ddy;
      found[e] = true;
      if (SENS) {
        bool in_rng = (fr > (T)0) && (fr < (T)1);
        T dr[2], dfrac[2];
        T rc = clamp_min(r, tiny), rnc = clamp_min(rn, tiny);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          dr[k] = (x * tx[k] + y * ty[k]) / rc;
          T drn = (xn * txn[k] + yn * tyn[k]) / rnc;
          dfrac[k] = in_rng ? (dr[k] * den - (r - rd[e]) * (dr[k] - drn)) /
                                  (den * den)
                            : (T)0;
        }
        sqx[e] = tx[0] + dfrac[0] * ddx + frac * (txn[0] - tx[0]);
        sqy[e] = ty[0] + dfrac[0] * ddy + frac * (tyn[0] - ty[0]);
        sxx[e] = tx[1] + dfrac[1] * ddx + frac * (txn[1] - tx[1]);
        sxy[e] = ty[1] + dfrac[1] * ddy + frac * (tyn[1] - ty[1]);
        T dfr = in_rng ? (T)-1 / den : (T)0;
        srx[e] = dfr * ddx;
        sry[e] = dfr * ddy;
      }
    }
    if (rn < minr) {
      minr = rn;
      mx = x;
      my = y;
      if (SENS) {
        mtx[0] = tx[0]; mtx[1] = tx[1];
        mty[0] = ty[0]; mty[1] = ty[1];
      }
    }
    x = xn; y = yn; vx = vxn; vy = vyn; r = rn;
    if (SENS) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        tx[k] = txn[k]; ty[k] = tyn[k]; tvx[k] = tvxn[k]; tvy[k] = tvyn[k];
      }
    }
  }

  for (int e = 0; e < E; ++e) {
    size_t o = ((size_t)w * E + e) * 2;
    imp[o] = found[e] ? hx[e] : mx;
    imp[o + 1] = found[e] ? hy[e] : my;
    if (SENS) {
      jq[o] = found[e] ? sqx[e] : mtx[0];
      jq[o + 1] = found[e] ? sqy[e] : mty[0];
      jx0[o] = found[e] ? sxx[e] : mtx[1];
      jx0[o + 1] = found[e] ? sxy[e] : mty[1];
      jrd[o] = found[e] ? srx[e] : (T)0;
      jrd[o + 1] = found[e] ? sry[e] : (T)0;
    }
  }
}

template <typename T>
static void launch(const void* q, const void* x1, const void* rd, void* imp,
                   void* jq, void* jx0, void* jrd, int W, int E, int n_steps,
                   double dt, int with_sens, cudaStream_t s) {
  dim3 grid((W + STREAM_BLOCK - 1) / STREAM_BLOCK), block(STREAM_BLOCK);
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
  if (E < 1 || E > STREAM_MAX_E || W < 1 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    launch<double>(q, x1, rd, imp, jq, jx0, jrd, W, E, n_steps, dt, with_sens, s);
  else
    launch<float>(q, x1, rd, imp, jq, jx0, jrd, W, E, n_steps, dt, with_sens, s);
  return (int)cudaGetLastError();
}
