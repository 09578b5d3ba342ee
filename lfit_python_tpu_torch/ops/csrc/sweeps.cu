// K7, K8: the flux curves' two (rows, P, N) sweeps and their backward
// kernels.
//
//   K7 element_curve_kernel           out[r, p] = sum_n vis(r, p, n) w[r, n]:
//                                     the disc's and the spot's element
//                                     curves
//   K7 element_curve_backward_kernel  its cotangents: d ph (r, p), a sum over
//                                     n; d pin, d pout, d w (r, n), sums
//                                     over p
//   K8 donor_sum_kernel               out[r, p] = sum_n wgt(mu) a[g, n],
//                                     mu = max(e[r, p] . nrm[g, n], 0), the
//                                     grid g = r / E shared by E rows
//   K8 donor_sum_backward_kernel      its cotangents: d e (r, p, 3), a sum
//                                     over n; d nrm (g, n, 3) and d a (g, n),
//                                     sums over the grid's E rows and P
//
// Replace no TPU kernel: on the TPU each sweep is an XLA fusion feeding a
// reduction.  element_flux_curve (lfit_python_tpu/models/components.py:
// 346-378; visible_fraction_interval, lfit_python_tpu/roche/geometry.py:
// 1119-1137) forms the (P, N) visibility as a fusion into an MXU product;
// donor_flux (components.py:598-626) is input-fused into its jnp.sum.
// Their plain PyTorch versions are lfit_python_tpu_torch/models/
// components.py's _element_curve_plain and _donor_sum_plain, chunked
// (rows, P, N) chains whose arithmetic each kernel repeats operation for
// operation.
//
// What bounds them: operations.  A term is ~8 (K7 without widths) to ~20
// (with widths) operations, or ~12 (K8), on one phase and one element
// staged once; the inputs are O(rows (P + N)) numbers and the terms
// O(rows P N).
//
// The design (a simple one: making them fast is later work).  A block of
// threads runs one row (K8: one row and a grid's elements), its threads
// over the row's phases; the row's elements are staged in shared memory a
// tile of SWEEP_TILE at a time, and every thread sums all of them for its
// phase.  The backward kernels recompute each term's derivative, and
// store no (rows, P, N) tensor: one sweep with the threads over the phases
// sums over the elements, another with the threads over the elements
// (staged phases) sums over the phases.  No atomics: each output is summed
// by one thread in a fixed order, so a row's result does not depend on
// its batch, and two launches give the same bits.
//
// The summation order of the forward sums, which the plain versions write
// out in tensor ops (components.py, _slab_sum): N is padded with elements
// that contribute an exact 0 to a multiple of 32 (at least 32); each of 32
// accumulators sums one lane of the 32-wide slabs in order (acc[j] = t[j],
// then acc[j] + t[32 k + j]: an accumulator starts at -0.0, which adds to
// any value exactly), and the 32 halve pairwise, acc[j] + acc[j + h] for h
// = 16, 8, 4, 2, 1.  The backward sums are not held to bits: each is in
// order (d ph over the slabs as above; the others sequentially).
//
// Bit-identity with the plain version: each expression below is one
// PyTorch operation per operator, in the plain version's order; built
// with --fmad=false, so no multiply-add is contracted.  Python's double
// constants enter PyTorch's kernels rounded to the tensor's type: T(double).
// torch.minimum / clamp(min=) propagate NaN and so do nmin and clamp_min
// (a comparison with NaN is false).  torch.remainder(x, 1.0) is fmod with
// a sign fix-up (m + 1 where m = fmod(x, 1) < 0); the floor form x -
// floor(x) rounds the same real number, so either gives these bits but
// for the sign of an exact zero, which no visibility sees.  The pad
// element (pin = pout = 0, not eclipsed, w = 0; K8: a zero normal and
// area) contributes +0 in both, whatever the phase.  The backward follows
// autograd's rules on the plain chain: clamp(min=) passes the gradient
// where its input is >= the bound (inclusive; NaN: none); minimum gives
// each side the whole gradient where it is the smaller, half at a tie and
// none where it is the larger; where(ecl, overlap / w, 0) routes nothing
// to the false side; remainder passes the gradient to its first argument.
// Without widths the visibility is an indicator, whose derivative is 0:
// only d w is made.
//
// Everything above the "kernel and launcher" line is plain arithmetic on
// staged arrays: a host loop over the rows and phases can stand in for
// the kernels (tests/test_torch_sweeps.py).
//
// Arrays (T float or double): ph, wd (R, P); pin, pout, w (R, N); ecl (R,
// N) bytes 0 / 1; e (R, P, 3); nrm (G, N, 3); a (G, N), R = G E.

#include <cuda_runtime.h>
#include <math.h>

#define SWEEP_FN __device__ __forceinline__

// the slab width of the forward sums and the elements (or phases) staged
// at once: a multiple of it
#define SWEEP_SLAB 32
#define SWEEP_TILE 256

template <typename T> SWEEP_FN T floor_(T v);
template <> SWEEP_FN float floor_<float>(float v) { return floorf(v); }
template <> SWEEP_FN double floor_<double>(double v) { return floor(v); }
template <typename T> SWEEP_FN T fmod_(T a, T b);
template <> SWEEP_FN float fmod_<float>(float a, float b) {
  return fmodf(a, b);
}
template <> SWEEP_FN double fmod_<double>(double a, double b) {
  return fmod(a, b);
}

// torch.minimum / torch.clamp(min=): NaN passes
template <typename T> SWEEP_FN T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> SWEEP_FN T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}

// torch.remainder(x, 1.0)
template <typename T> SWEEP_FN T remainder1(T x) {
  const T m = fmod_(x, T(1.0));
  return (m != T(0.0) && m < T(0.0)) ? m + T(1.0) : m;
}

// autograd's share of g for torch.minimum(a, b)'s first and second
// argument, and for torch.clamp(v, min=0)'s input
template <typename T> SWEEP_FN T min_grad_a(T a, T b, T g) {
  return a == b ? T(0.5) * g : (a > b ? T(0.0) : g);
}
template <typename T> SWEEP_FN T min_grad_b(T a, T b, T g) {
  return a == b ? T(0.5) * g : (a < b ? T(0.0) : g);
}
template <typename T> SWEEP_FN T clamp_grad(T v, T g) {
  return v >= T(0.0) ? g : T(0.0);
}

// 32 running sums in the plain version's order
template <typename T> struct Slabs {
  T acc[SWEEP_SLAB];
  SWEEP_FN void init() {
#pragma unroll
    for (int j = 0; j < SWEEP_SLAB; ++j) acc[j] = T(-0.0);
  }
  // the pairwise halving, written out level by level so that every index
  // is a constant and the 32 sums stay in registers
  template <int H> SWEEP_FN void halve() {
#pragma unroll
    for (int j = 0; j < H; ++j) acc[j] = acc[j] + acc[j + H];
  }
  SWEEP_FN T total() {
    halve<16>();
    halve<8>();
    halve<4>();
    halve<2>();
    halve<1>();
    return acc[0];
  }
};

// the number of slabs a row of n elements is summed in
static __host__ __device__ __forceinline__ int n_slabs(int n) {
  return n > SWEEP_SLAB ? (n + SWEEP_SLAB - 1) / SWEEP_SLAB : 1;
}

// ---- K7: the element curve --------------------------------------------

// staged elements: phi_in, the duration phi_out - phi_in (once per
// element, as the plain version), the weight and the eclipsed flag
template <typename T> struct CurveElems {
  T* pin;
  T* dur;
  T* w;
  unsigned char* ecl;
  // element n of a row of n_el as entry i; past n_el the pad element
  SWEEP_FN void stage(int i, const T* pin_r, const T* pout_r,
                      const unsigned char* ecl_r, const T* w_r, int n,
                      int n_el) const {
    const bool in = n < n_el;
    const T a = in ? pin_r[n] : T(0.0);
    const T b = in ? pout_r[n] : T(0.0);
    pin[i] = a;
    dur[i] = b - a;
    w[i] = in ? w_r[n] : T(0.0);
    ecl[i] = in ? ecl_r[n] : (unsigned char)0;
  }
};

// one phase: without widths the indicator 1 - (d - floor(d) < dur), d =
// ph - pin; with widths visible_fraction_interval's exposure overlap, wc
// = clamp(width, min=1e-12) and hw = ph - 0.5 wc once per phase
template <typename T, bool WIDTHS> struct CurvePhase {
  T ph, wc, hw;
  SWEEP_FN void set(T phase, T width) {
    ph = phase;
    if (WIDTHS) {
      wc = clamp_min(width, T(1e-12));
      hw = ph - T(0.5) * wc;
    }
  }
  SWEEP_FN T vis(T pin, T dur, unsigned char ecl) const {
    if (!WIDTHS) {
      const T d = ph - pin;
      const T rel = d - floor_(d);
      return T(1.0) - (rel < dur ? T(1.0) : T(0.0));
    }
    const T rel = remainder1(hw - pin);
    const T ov_this = nmin(clamp_min(dur - rel, T(0.0)), wc);
    const T ov_next = nmin(clamp_min((rel + wc) - T(1.0), T(0.0)), dur);
    const T overlap = nmin(clamp_min(ov_this + ov_next, T(0.0)), wc);
    const T frac = ecl ? overlap / wc : T(0.0);
    return T(1.0) - frac;
  }
  // (widths) the cotangents of a term's rel (its phase's, and minus its
  // phi_in's) and of its dur for the cotangent gv of its visibility
  SWEEP_FN void vis_grad(T pin, T dur, unsigned char ecl, T gv, T& g_rel,
                         T& g_dur) const {
    const T rel = remainder1(hw - pin);
    const T a1 = dur - rel;
    const T c1 = clamp_min(a1, T(0.0));
    const T ov_this = nmin(c1, wc);
    const T a2 = (rel + wc) - T(1.0);
    const T c2 = clamp_min(a2, T(0.0));
    const T ov_next = nmin(c2, dur);
    const T s = ov_this + ov_next;
    const T c3 = clamp_min(s, T(0.0));
    const T g_overlap = ecl ? (-gv) / wc : T(0.0);
    const T g_s = clamp_grad(s, min_grad_a(c3, wc, g_overlap));
    const T g_a2 = clamp_grad(a2, min_grad_a(c2, dur, g_s));
    const T g_a1 = clamp_grad(a1, min_grad_a(c1, wc, g_s));
    g_rel = g_a2 - g_a1;
    g_dur = min_grad_b(c2, dur, g_s) + g_a1;
  }
};

// K7 forward: the terms of staged slabs [k0, k1) at phase p into acc
template <typename T, bool WIDTHS>
SWEEP_FN void curve_slabs(Slabs<T>& acc, const CurvePhase<T, WIDTHS>& p,
                          const CurveElems<T>& s, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int j = 0; j < SWEEP_SLAB; ++j) {
      const int i = k * SWEEP_SLAB + j;
      acc.acc[j] = acc.acc[j] + p.vis(s.pin[i], s.dur[i], s.ecl[i]) * s.w[i];
    }
  }
}

// K7 backward, threads over phases (widths): d ph of phase p, whose
// cotangent is gp, over staged slabs [k0, k1)
template <typename T>
SWEEP_FN void curve_grad_phase(Slabs<T>& acc, const CurvePhase<T, true>& p,
                               T gp, const CurveElems<T>& s, int k0,
                               int k1) {
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int j = 0; j < SWEEP_SLAB; ++j) {
      const int i = k * SWEEP_SLAB + j;
      T g_rel, g_dur;
      p.vis_grad(s.pin[i], s.dur[i], s.ecl[i], gp * s.w[i], g_rel, g_dur);
      acc.acc[j] = acc.acc[j] + g_rel;
    }
  }
}

// staged phases for the backward's element sweep: each phase's set()
// terms and its cotangent
template <typename T> struct CurvePhases {
  T* ph;
  T* wc;
  T* hw;
  T* g;
  template <bool WIDTHS>
  SWEEP_FN void stage(int i, const T* ph_r, const T* wd_r, const T* g_r,
                      int p) const {
    CurvePhase<T, WIDTHS> q;
    q.set(ph_r[p], WIDTHS ? wd_r[p] : T(0.0));
    ph[i] = q.ph;
    if (WIDTHS) {
      wc[i] = q.wc;
      hw[i] = q.hw;
    }
    g[i] = g_r[p];
  }
  template <bool WIDTHS> SWEEP_FN CurvePhase<T, WIDTHS> at(int i) const {
    CurvePhase<T, WIDTHS> q;
    q.ph = ph[i];
    if (WIDTHS) {
      q.wc = wc[i];
      q.hw = hw[i];
    }
    return q;
  }
};

// K7 backward, threads over elements: one element's d pin, d pout and d w
// over staged phases [i0, i1), in order
template <typename T, bool WIDTHS>
SWEEP_FN void curve_grad_elem(T& g_pin, T& g_pout, T& g_w, T pin, T dur,
                              unsigned char ecl, T w,
                              const CurvePhases<T>& s, int i0, int i1) {
  for (int i = i0; i < i1; ++i) {
    const CurvePhase<T, WIDTHS> p = s.template at<WIDTHS>(i);
    const T gp = s.g[i];
    g_w = g_w + gp * p.vis(pin, dur, ecl);
    if (WIDTHS) {
      T g_rel, g_dur;
      p.vis_grad(pin, dur, ecl, gp * w, g_rel, g_dur);
      g_pin = g_pin - (g_rel + g_dur);
      g_pout = g_pout + g_dur;
    }
  }
}

// ---- K8: the donor sum ------------------------------------------------

// staged grid elements: the normal's components and the area
template <typename T> struct DonorElems {
  T* n0;
  T* n1;
  T* n2;
  T* a;
  // element n of a grid of n_el as entry i; past n_el the pad element
  SWEEP_FN void stage(int i, const T* nrm_g, const T* a_g, int n,
                      int n_el) const {
    const bool in = n < n_el;
    n0[i] = in ? nrm_g[3 * (long long)n] : T(0.0);
    n1[i] = in ? nrm_g[3 * (long long)n + 1] : T(0.0);
    n2[i] = in ? nrm_g[3 * (long long)n + 2] : T(0.0);
    a[i] = in ? a_g[n] : T(0.0);
  }
};

// one term's weight mu (1 - u) + u mu mu, mu = max(e . n, 0); c1 = T(1 -
// u), c2 = T(u)
template <typename T>
SWEEP_FN T donor_weight(T e0, T e1, T e2, T n0, T n1, T n2, T c1, T c2) {
  const T mu = clamp_min((e0 * n0 + e1 * n1) + e2 * n2, T(0.0));
  return mu * c1 + (mu * c2) * mu;
}

// the cotangent of a term's e . n for the cotangent gw of its weight
template <typename T>
SWEEP_FN T donor_dot_grad(T e0, T e1, T e2, T n0, T n1, T n2, T c1, T c2,
                          T gw) {
  const T m = (e0 * n0 + e1 * n1) + e2 * n2;
  const T mu = clamp_min(m, T(0.0));
  return clamp_grad(m, gw * c1 + (gw * mu) * c2 + gw * (mu * c2));
}

// K8 forward: the terms of staged slabs [k0, k1) at direction e into acc
template <typename T>
SWEEP_FN void donor_slabs(Slabs<T>& acc, T e0, T e1, T e2,
                          const DonorElems<T>& s, T c1, T c2, int k0,
                          int k1) {
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int j = 0; j < SWEEP_SLAB; ++j) {
      const int i = k * SWEEP_SLAB + j;
      acc.acc[j] = acc.acc[j]
          + donor_weight(e0, e1, e2, s.n0[i], s.n1[i], s.n2[i], c1, c2)
              * s.a[i];
    }
  }
}

// K8 backward, threads over phases: d e of one direction with cotangent
// gp over staged elements [i0, i1), in order
template <typename T>
SWEEP_FN void donor_grad_phase(T& g0, T& g1, T& g2, T e0, T e1, T e2, T gp,
                               const DonorElems<T>& s, T c1, T c2, int i0,
                               int i1) {
  for (int i = i0; i < i1; ++i) {
    const T gm = donor_dot_grad(e0, e1, e2, s.n0[i], s.n1[i], s.n2[i], c1,
                                c2, gp * s.a[i]);
    g0 = g0 + gm * s.n0[i];
    g1 = g1 + gm * s.n1[i];
    g2 = g2 + gm * s.n2[i];
  }
}

// staged directions (one row's phases) and their cotangents
template <typename T> struct DonorPhases {
  T* e0;
  T* e1;
  T* e2;
  T* g;
  SWEEP_FN void stage(int i, const T* e_r, const T* g_r, int p) const {
    e0[i] = e_r[3 * (long long)p];
    e1[i] = e_r[3 * (long long)p + 1];
    e2[i] = e_r[3 * (long long)p + 2];
    g[i] = g_r[p];
  }
};

// K8 backward, threads over elements: one element's d normal and d area
// over staged phases [i0, i1), in order
template <typename T>
SWEEP_FN void donor_grad_elem(T& g0, T& g1, T& g2, T& ga, T n0, T n1, T n2,
                              T a, const DonorPhases<T>& s, T c1, T c2,
                              int i0, int i1) {
  for (int i = i0; i < i1; ++i) {
    const T gp = s.g[i];
    ga = ga + gp * donor_weight(s.e0[i], s.e1[i], s.e2[i], n0, n1, n2, c1,
                                c2);
    const T gm = donor_dot_grad(s.e0[i], s.e1[i], s.e2[i], n0, n1, n2, c1,
                                c2, gp * a);
    g0 = g0 + gm * s.e0[i];
    g1 = g1 + gm * s.e1[i];
    g2 = g2 + gm * s.e2[i];
  }
}

// ---- kernel and launcher ------------------------------------------------

// blocks of SWEEP_THREADS (the forward kernels: fewer for a short row of
// phases, a multiple of 32)
#define SWEEP_THREADS 128

template <typename T> struct CurveShared {
  T pin[SWEEP_TILE], dur[SWEEP_TILE], w[SWEEP_TILE];
  unsigned char ecl[SWEEP_TILE];
  __device__ CurveElems<T> elems() { return {pin, dur, w, ecl}; }
};

// K7: block (r, c) runs row r's phases c blockDim.x .. (c + 1) blockDim.x
template <typename T, bool WIDTHS>
__global__ void __launch_bounds__(SWEEP_THREADS)
element_curve_kernel(const T* __restrict__ ph, const T* __restrict__ wd,
                     const T* __restrict__ pin, const T* __restrict__ pout,
                     const unsigned char* __restrict__ ecl,
                     const T* __restrict__ w, T* __restrict__ out, int P,
                     int N) {
  __shared__ CurveShared<T> sh;
  const CurveElems<T> s = sh.elems();
  const long long r = blockIdx.x;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < P;
  const long long rp = r * P + (live ? p : P - 1);
  CurvePhase<T, WIDTHS> q;
  q.set(ph[rp], WIDTHS ? wd[rp] : T(0.0));
  const T* pin_r = pin + r * N;
  const T* pout_r = pout + r * N;
  const unsigned char* ecl_r = ecl + r * N;
  const T* w_r = w + r * N;
  Slabs<T> acc;
  acc.init();
  const int k_all = n_slabs(N);
  for (int k0 = 0; k0 < k_all; k0 += SWEEP_TILE / SWEEP_SLAB) {
    __syncthreads();
    for (int i = threadIdx.x; i < SWEEP_TILE; i += blockDim.x)
      s.stage(i, pin_r, pout_r, ecl_r, w_r, k0 * SWEEP_SLAB + i, N);
    __syncthreads();
    const int k1 = min(k_all - k0, SWEEP_TILE / SWEEP_SLAB);
    curve_slabs(acc, q, s, 0, k1);
  }
  const T total = acc.total();
  if (live) out[rp] = total;
}

template <typename T> struct CurveGradShared {
  CurveShared<T> el;
  T ph[SWEEP_TILE], wc[SWEEP_TILE], hw[SWEEP_TILE], g[SWEEP_TILE];
  __device__ CurvePhases<T> phases() { return {ph, wc, hw, g}; }
};

// K7's backward: block (r, 0) runs row r's element sweep (d pin, d pout,
// d w); with widths, block (r, 1) runs its phase sweep (d ph)
template <typename T, bool WIDTHS>
__global__ void __launch_bounds__(SWEEP_THREADS)
element_curve_backward_kernel(
    const T* __restrict__ ph, const T* __restrict__ wd,
    const T* __restrict__ pin, const T* __restrict__ pout,
    const unsigned char* __restrict__ ecl, const T* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ g_ph, T* __restrict__ g_pin,
    T* __restrict__ g_pout, T* __restrict__ g_w, int P, int N) {
  __shared__ CurveGradShared<T> sh;
  const long long r = blockIdx.x;
  const T* ph_r = ph + r * P;
  const T* wd_r = WIDTHS ? wd + r * P : nullptr;
  const T* g_r = g + r * P;
  const T* pin_r = pin + r * N;
  const T* pout_r = pout + r * N;
  const unsigned char* ecl_r = ecl + r * N;
  const T* w_r = w + r * N;
  if (blockIdx.y == 1) {
    if (!WIDTHS) return;
    const CurveElems<T> s = sh.el.elems();
    const int k_all = n_slabs(N);
    for (int p0 = 0; p0 < P; p0 += blockDim.x) {
      const int p = p0 + threadIdx.x;
      const bool live = p < P;
      const int pc = live ? p : P - 1;
      CurvePhase<T, true> q;
      q.set(ph_r[pc], wd_r[pc]);
      const T gp = g_r[pc];
      Slabs<T> acc;
      acc.init();
      for (int k0 = 0; k0 < k_all; k0 += SWEEP_TILE / SWEEP_SLAB) {
        __syncthreads();
        for (int i = threadIdx.x; i < SWEEP_TILE; i += blockDim.x)
          s.stage(i, pin_r, pout_r, ecl_r, w_r, k0 * SWEEP_SLAB + i, N);
        __syncthreads();
        curve_grad_phase(acc, q, gp, s, 0,
                         min(k_all - k0, SWEEP_TILE / SWEEP_SLAB));
      }
      const T total = acc.total();
      if (live) g_ph[r * P + p] = total;
    }
    return;
  }
  const CurvePhases<T> s = sh.phases();
  for (int n0 = 0; n0 < N; n0 += blockDim.x) {
    const int n = n0 + threadIdx.x;
    const bool live = n < N;
    const int nc = live ? n : N - 1;
    const T a = pin_r[nc];
    const T dur = pout_r[nc] - a;
    const unsigned char e = ecl_r[nc];
    const T wn = w_r[nc];
    T gi = T(0.0), go = T(0.0), gw = T(0.0);
    for (int i0 = 0; i0 < P; i0 += SWEEP_TILE) {
      const int m = min(P - i0, SWEEP_TILE);
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        s.template stage<WIDTHS>(i, ph_r, wd_r, g_r, i0 + i);
      __syncthreads();
      curve_grad_elem<T, WIDTHS>(gi, go, gw, a, dur, e, wn, s, 0, m);
    }
    if (live) {
      g_w[r * N + n] = gw;
      if (WIDTHS) {
        g_pin[r * N + n] = gi;
        g_pout[r * N + n] = go;
      }
    }
  }
}

template <typename T> struct DonorShared {
  T n0[SWEEP_TILE], n1[SWEEP_TILE], n2[SWEEP_TILE], a[SWEEP_TILE];
  __device__ DonorElems<T> elems() { return {n0, n1, n2, a}; }
};

// K8: block (r, c) runs row r's phases c blockDim.x .. (c + 1) blockDim.x
// against grid r / E
template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS)
donor_sum_kernel(const T* __restrict__ e, const T* __restrict__ nrm,
                 const T* __restrict__ areas, double c1d, double c2d,
                 T* __restrict__ out, int P, int N, int E) {
  __shared__ DonorShared<T> sh;
  const DonorElems<T> s = sh.elems();
  const long long r = blockIdx.x;
  const long long gr = r / E;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < P;
  const long long rp = r * P + (live ? p : P - 1);
  const T e0 = e[3 * rp], e1 = e[3 * rp + 1], e2 = e[3 * rp + 2];
  const T c1 = T(c1d), c2 = T(c2d);
  const T* nrm_g = nrm + 3 * gr * N;
  const T* a_g = areas + gr * N;
  Slabs<T> acc;
  acc.init();
  const int k_all = n_slabs(N);
  for (int k0 = 0; k0 < k_all; k0 += SWEEP_TILE / SWEEP_SLAB) {
    __syncthreads();
    for (int i = threadIdx.x; i < SWEEP_TILE; i += blockDim.x)
      s.stage(i, nrm_g, a_g, k0 * SWEEP_SLAB + i, N);
    __syncthreads();
    donor_slabs(acc, e0, e1, e2, s, c1, c2, 0,
                min(k_all - k0, SWEEP_TILE / SWEEP_SLAB));
  }
  const T total = acc.total();
  if (live) out[rp] = total;
}

template <typename T> struct DonorGradShared {
  DonorShared<T> el;
  T e0[SWEEP_TILE], e1[SWEEP_TILE], e2[SWEEP_TILE], g[SWEEP_TILE];
  __device__ DonorPhases<T> phases() { return {e0, e1, e2, g}; }
};

// K8's backward: block (g, 0) runs grid g's element sweep (d nrm, d a over
// its E rows' phases, row by row), block (g, 1) its rows' phase sweep (d e)
template <typename T>
__global__ void __launch_bounds__(SWEEP_THREADS)
donor_sum_backward_kernel(const T* __restrict__ e, const T* __restrict__ nrm,
                          const T* __restrict__ areas, double c1d,
                          double c2d, const T* __restrict__ g,
                          T* __restrict__ g_e, T* __restrict__ g_nrm,
                          T* __restrict__ g_a, int P, int N, int E) {
  __shared__ DonorGradShared<T> sh;
  const long long gr = blockIdx.x;
  const T c1 = T(c1d), c2 = T(c2d);
  const T* nrm_g = nrm + 3 * gr * N;
  const T* a_g = areas + gr * N;
  if (blockIdx.y == 1) {
    const DonorElems<T> s = sh.el.elems();
    for (long long r = gr * E; r < (gr + 1) * E; ++r) {
      for (int p0 = 0; p0 < P; p0 += blockDim.x) {
        const int p = p0 + threadIdx.x;
        const bool live = p < P;
        const long long rp = r * P + (live ? p : P - 1);
        const T e0 = e[3 * rp], e1 = e[3 * rp + 1], e2 = e[3 * rp + 2];
        const T gp = g[rp];
        T g0 = T(0.0), g1 = T(0.0), g2 = T(0.0);
        for (int i0 = 0; i0 < N; i0 += SWEEP_TILE) {
          const int m = min(N - i0, SWEEP_TILE);
          __syncthreads();
          for (int i = threadIdx.x; i < m; i += blockDim.x)
            s.stage(i, nrm_g, a_g, i0 + i, N);
          __syncthreads();
          donor_grad_phase(g0, g1, g2, e0, e1, e2, gp, s, c1, c2, 0, m);
        }
        if (live) {
          g_e[3 * rp] = g0;
          g_e[3 * rp + 1] = g1;
          g_e[3 * rp + 2] = g2;
        }
      }
    }
    return;
  }
  const DonorPhases<T> s = sh.phases();
  for (int n0 = 0; n0 < N; n0 += blockDim.x) {
    const int n = n0 + threadIdx.x;
    const bool live = n < N;
    const long long nc = live ? n : N - 1;
    const T n0v = nrm_g[3 * nc], n1v = nrm_g[3 * nc + 1],
            n2v = nrm_g[3 * nc + 2];
    const T a = a_g[nc];
    T g0 = T(0.0), g1 = T(0.0), g2 = T(0.0), ga = T(0.0);
    for (long long r = gr * E; r < (gr + 1) * E; ++r) {
      for (int i0 = 0; i0 < P; i0 += SWEEP_TILE) {
        const int m = min(P - i0, SWEEP_TILE);
        __syncthreads();
        for (int i = threadIdx.x; i < m; i += blockDim.x)
          s.stage(i, e + 3 * r * P, g + r * P, i0 + i);
        __syncthreads();
        donor_grad_elem(g0, g1, g2, ga, n0v, n1v, n2v, a, s, c1, c2, 0, m);
      }
    }
    if (live) {
      const long long gn = gr * N + n;
      g_nrm[3 * gn] = g0;
      g_nrm[3 * gn + 1] = g1;
      g_nrm[3 * gn + 2] = g2;
      g_a[gn] = ga;
    }
  }
}

static bool bad_size(int R, int P, int N, int E) {
  return R < 1 || P < 1 || N < 0 || E < 1 || R % E != 0
         || (long long)R * P > (1LL << 31) - 1
         || (long long)R * N * 3 > (1LL << 31) - 1;
}

// the forward kernels' blocks: a multiple of 32 threads, no more than P
// needs
static unsigned phase_threads(int P) {
  const int t = (P + 31) / 32 * 32;
  return (unsigned)(t < SWEEP_THREADS ? t : SWEEP_THREADS);
}

// Each launcher runs on ``stream`` and returns the cudaError_t of the
// launch (0 = ok); is_double selects float64 (1) or float32 (0) for every
// float array, widths whether wd is given (1) or the indicator runs (0:
// wd may be null, and the backward writes only g_w).
extern "C" int element_curve_launch(int is_double, int widths,
                                    const void* ph, const void* wd,
                                    const void* pin, const void* pout,
                                    const void* ecl, const void* w,
                                    void* out, int R, int P, int N,
                                    void* stream) {
  if (bad_size(R, P, N, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned t = phase_threads(P);
  const dim3 grid((unsigned)R, (P + t - 1) / t);
  const unsigned char* ec = (const unsigned char*)ecl;
#define K7_LAUNCH(TT, WW)                                                   \
  element_curve_kernel<TT, WW><<<grid, t, 0, s>>>(                          \
      (const TT*)ph, (const TT*)wd, (const TT*)pin, (const TT*)pout, ec,    \
      (const TT*)w, (TT*)out, P, N)
  if (is_double) {
    if (widths) K7_LAUNCH(double, true); else K7_LAUNCH(double, false);
  } else {
    if (widths) K7_LAUNCH(float, true); else K7_LAUNCH(float, false);
  }
#undef K7_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int element_curve_backward_launch(
    int is_double, int widths, const void* ph, const void* wd,
    const void* pin, const void* pout, const void* ecl, const void* w,
    const void* g, void* g_ph, void* g_pin, void* g_pout, void* g_w, int R,
    int P, int N, void* stream) {
  if (bad_size(R, P, N, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)R, widths ? 2u : 1u);
  const unsigned char* ec = (const unsigned char*)ecl;
#define K7B_LAUNCH(TT, WW)                                                  \
  element_curve_backward_kernel<TT, WW><<<grid, SWEEP_THREADS, 0, s>>>(     \
      (const TT*)ph, (const TT*)wd, (const TT*)pin, (const TT*)pout, ec,    \
      (const TT*)w, (const TT*)g, (TT*)g_ph, (TT*)g_pin, (TT*)g_pout,       \
      (TT*)g_w, P, N)
  if (is_double) {
    if (widths) K7B_LAUNCH(double, true); else K7B_LAUNCH(double, false);
  } else {
    if (widths) K7B_LAUNCH(float, true); else K7B_LAUNCH(float, false);
  }
#undef K7B_LAUNCH
  return (int)cudaGetLastError();
}

// c1 = 1 - u and c2 = u as Python computes them (doubles); the kernels
// round them to T as PyTorch rounds a Python scalar
extern "C" int donor_sum_launch(int is_double, const void* e,
                                const void* nrm, const void* areas,
                                double c1, double c2, void* out, int R,
                                int P, int N, int E, void* stream) {
  if (bad_size(R, P, N, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned t = phase_threads(P);
  const dim3 grid((unsigned)R, (P + t - 1) / t);
  if (is_double)
    donor_sum_kernel<double><<<grid, t, 0, s>>>(
        (const double*)e, (const double*)nrm, (const double*)areas, c1, c2,
        (double*)out, P, N, E);
  else
    donor_sum_kernel<float><<<grid, t, 0, s>>>(
        (const float*)e, (const float*)nrm, (const float*)areas, c1, c2,
        (float*)out, P, N, E);
  return (int)cudaGetLastError();
}

extern "C" int donor_sum_backward_launch(int is_double, const void* e,
                                         const void* nrm, const void* areas,
                                         double c1, double c2, const void* g,
                                         void* g_e, void* g_nrm, void* g_a,
                                         int R, int P, int N, int E,
                                         void* stream) {
  if (bad_size(R, P, N, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(R / E), 2u);
  if (is_double)
    donor_sum_backward_kernel<double><<<grid, SWEEP_THREADS, 0, s>>>(
        (const double*)e, (const double*)nrm, (const double*)areas, c1, c2,
        (const double*)g, (double*)g_e, (double*)g_nrm, (double*)g_a, P, N,
        E);
  else
    donor_sum_backward_kernel<float><<<grid, SWEEP_THREADS, 0, s>>>(
        (const float*)e, (const float*)nrm, (const float*)areas, c1, c2,
        (const float*)g, (float*)g_e, (float*)g_nrm, (float*)g_a, P, N, E);
  return (int)cudaGetLastError();
}
