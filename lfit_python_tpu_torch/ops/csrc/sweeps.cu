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
// What bounds them: the issue of instructions.  A term is one phase and
// one element; the inputs are O(rows (P + N)) numbers and the terms O(rows
// P N).  Built with --fmad=false, no product and sum fuse.  Issued a term
// (float32, from the SASS: tools/sweeps_sass_counts.py): K7 ~7 without
// widths, ~46 with (its divide); K8 ~14 (7 products, 4 sums, a clamp);
// K7's backward ~56, of which ~28 are compares, selects and min / max on
// the ALU pipe, at half the FP32 rate: that pipe bounds it.
//
// The designs.  K7 (forward) and K8's backward: a block of threads runs
// one row (K8's backward: one grid), its threads over the row's phases;
// the elements are staged in shared memory a tile of SWEEP_TILE at a
// time, and every thread sums all of them for its phase (K8's backward
// also runs a sweep with its threads over the elements); K8 (forward)
// too for rows of at least DONOR_LANES_BELOW phases.  A shorter row (the
// donor curve's normaliser, P = 1) runs a warp a (row, phase) pair, lane j
// the elements j, 32 + j, ... (slab lane j), the lanes' sums halved by
// __shfl_down_sync.  K7's backward: one fused sweep, a block a row; its
// warps split the row's slabs, lane j holding slab lane j of K7B_SLABS
// slabs in registers with their three running cotangents; the block
// walks the row's phases, staged K7B_PHASES at a time, and each term runs
// the overlap chain once for its visibility (d w) and the cotangents of
// its rel and dur (d ph, d pin, d pout), with the fewest ALU instructions
// the rules allow (min.NaN / max.NaN, clamp_min_grad); a warp's d ph
// partials are halved by __shfl_down_sync and the warps' added in warp
// order through shared memory.  No atomics: each output is summed in a
// fixed order, so a row's result does not depend on its batch, and two
// launches give the same bits.
//
// The summation order of the forward sums, which the plain versions write
// out in tensor ops (components.py, _slab_sum): N is padded with elements
// that contribute an exact 0 to a multiple of 32 (at least 32); each of 32
// accumulators sums one lane of the 32-wide slabs in order (acc[j] = t[j],
// then acc[j] + t[32 k + j]: an accumulator starts at -0.0, which adds to
// any value exactly), and the 32 halve pairwise, acc[j] + acc[j + h] for h
// = 16, 8, 4, 2, 1: K7's Slabs, and K8's lanes, whose x + __shfl_down_sync
// (x, h) on lane j is the same add.  The backward sums are not held to
// bits: each is in a fixed order (K7's d ph: a lane's slabs in order, the
// warp's lanes halved as above, the warps in order, the passes in order;
// the others over the phases in order).
//
// Bit-identity with the plain version: each expression below is one
// PyTorch operation per operator, in the plain version's order; built
// with --fmad=false, so no multiply-add is contracted.  Python's double
// constants enter PyTorch's kernels rounded to the tensor's type: T(double).
// torch.minimum / clamp(min=) propagate NaN and so do nmin and clamp_min
// (a comparison with NaN is false).  torch.remainder(x, 1.0) is fmod with
// a sign fix-up (m + 1 where m = fmod(x, 1) < 0); the floor form x -
// floor(x) rounds the same real number once, so it gives the same bits
// but for the sign of an exact zero (torch gives -0 for -0 and for a
// negative integer, the floor form +0), which no visibility sees: rel
// enters only dur - rel, rel + w and comparisons.  The pad element (pin =
// pout = 0, not eclipsed, w = 0; K8: a zero normal and area) contributes
// +0 in both, whatever the phase.  The backward follows autograd's rules
// on the plain chain: clamp(min=) passes the gradient where its input is
// >= the bound (inclusive; NaN: none); minimum gives each side the whole
// gradient where it is the smaller, half at a tie, all at NaN (which the
// chain never shows: a NaN minimum makes the sum s NaN, whose clamp passes
// nothing) and none where it is the larger (K7's backward takes a clamp
// and the minimum it feeds in one step, clamp_min_grad, where the clamp's
// value is its input); where(ecl, overlap / w, 0)
// routes nothing to the false side; remainder passes the gradient to its
// first argument.  The backward is held to a tolerance, not to bits: it
// divides by the clamped width through one reciprocal a phase.  Without
// widths the visibility is an indicator, whose derivative is 0: only d w
// is made.
//
// Everything above the "kernel and launcher" line is plain arithmetic on
// staged arrays and registers: host loops over the rows, the phases and
// 32 lanes can stand in for the kernels (tests/test_torch_sweeps.py).
//
// Arrays (T float or double): ph, wd (R, P); pin, pout, w (R, N); ecl (R,
// N) bytes 0 / 1; e (R, P, 3); nrm (G, N, 3); a (G, N), R = G E.

#include <cuda_runtime.h>
#include <math.h>

#define SWEEP_FN __device__ __forceinline__

// the slab width of the forward sums (a warp's lanes) and the elements (or
// phases) K7 and K8's backward stage at once: a multiple of it
#define SWEEP_SLAB 32
#define SWEEP_TILE 256

// K7's backward: the slabs a lane holds, the warps a block has at most and
// the phases it stages at once
#ifndef K7B_SLABS
#define K7B_SLABS 4
#endif
#ifndef K7B_WARPS
#define K7B_WARPS 8
#endif
#define K7B_PHASES 128

// K8: rows of fewer phases than a warp run a warp a (row, phase) pair
#ifndef DONOR_LANES_BELOW
#define DONOR_LANES_BELOW 32
#endif

template <typename T> SWEEP_FN T floor_(T v);
template <> SWEEP_FN float floor_<float>(float v) { return floorf(v); }
template <> SWEEP_FN double floor_<double>(double v) { return floor(v); }

// torch.minimum / torch.clamp(min=): NaN passes
template <typename T> SWEEP_FN T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> SWEEP_FN T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}

// torch.remainder(x, 1.0) in floor form (its bits but the sign of a zero)
template <typename T> SWEEP_FN T remainder1(T x) { return x - floor_(x); }

// autograd's share of g for torch.clamp(v, min=0)'s input, and for
// torch.minimum(a, b)'s second argument (h = 0.5 g: half at a tie)
template <typename T> SWEEP_FN T clamp_grad(T v, T g) {
  return v >= T(0.0) ? g : T(0.0);
}
template <typename T> SWEEP_FN T min_grad_b(T a, T b, T g, T h) {
  return a == b ? h : (a < b ? T(0.0) : g);
}
// autograd's share of g for v through torch.clamp(min=0) and then
// torch.minimum(., b)'s first argument: the clamp passes g where v >= 0
// (inclusive; NaN: nothing), and there its value is v, which the minimum
// gives the whole where it is the smaller or b is NaN, h = 0.5 g at a tie
// and nothing where it is the larger
template <typename T> SWEEP_FN T clamp_min_grad(T v, T b, T g, T h) {
  const bool on = T(0.0) <= v;
  return on && !(v >= b) ? g : (on && v == b ? h : T(0.0));
}

// the backward's torch.minimum and clamp(min=0): NaN passes; on the card
// in float32 one instruction each (min.NaN / max.NaN), which may give a
// zero the other sign than nmin / clamp_min: the backward's values meet
// only comparisons, sums and products there, which no sign of a zero
// changes
template <typename T> SWEEP_FN T min_nan(T a, T b) { return nmin(a, b); }
template <typename T> SWEEP_FN T max0_nan(T v) {
  return clamp_min(v, T(0.0));
}
SWEEP_FN float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return nmin(a, b);
#endif
}
SWEEP_FN float max0_nan(float v) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
#else
  return clamp_min(v, 0.0f);
#endif
}

// 32 running sums in the plain version's order; total() is also the order
// of a warp's lanes halved by __shfl_down_sync (lane j's value in acc[j])
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

// without widths the indicator 1 - (d - floor(d) < dur), d = ph - pin
template <typename T> SWEEP_FN T indicator_vis(T ph, T pin, T dur) {
  const T d = ph - pin;
  const T rel = d - floor_(d);
  return T(1.0) - (rel < dur ? T(1.0) : T(0.0));
}

// one phase: without widths the indicator; with widths
// visible_fraction_interval's exposure overlap, wc = clamp(width,
// min=1e-12) and hw = ph - 0.5 wc once per phase
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
    if (!WIDTHS) return indicator_vis(ph, pin, dur);
    const T rel = remainder1(hw - pin);
    const T ov_this = nmin(clamp_min(dur - rel, T(0.0)), wc);
    const T ov_next = nmin(clamp_min((rel + wc) - T(1.0), T(0.0)), dur);
    const T overlap = nmin(clamp_min(ov_this + ov_next, T(0.0)), wc);
    const T frac = ecl ? overlap / wc : T(0.0);
    return T(1.0) - frac;
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

// K7's backward: one phase as its terms take it: the phase (without
// widths) or hw = ph - 0.5 wc, the clamped width wc and its reciprocal,
// and the phase's cotangent g
template <typename T> struct alignas(4 * sizeof(T)) CurveGradPhase {
  T hw, wc, iw, g;
  template <bool WIDTHS> SWEEP_FN void set(T phase, T width, T cot) {
    CurvePhase<T, WIDTHS> q;
    q.set(phase, width);
    hw = WIDTHS ? q.hw : phase;
    wc = WIDTHS ? q.wc : T(1.0);
    iw = T(1.0) / wc;
    g = cot;
  }
};

// K7's backward, one term with widths: the overlap chain once; adds g vis
// to g_w, -(d rel + d dur) to g_pin and d dur to g_pout, and returns d rel
// (the phase's share), for the cotangent g w of the visibility; gn = -(g /
// wc), the phase's.  The adjoint by autograd's rules: where(ecl, ., 0)
// routes nothing to the false side; each clamp and the minimum it feeds
// by clamp_min_grad; the sum passes its gradient to both addends; the
// remainder to hw - pin
template <typename T>
SWEEP_FN T curve_grad_term(const CurveGradPhase<T>& q, T gn, T pin, T dur,
                           bool ecl, T w, T& g_pin, T& g_pout, T& g_w) {
  const T rel = remainder1(q.hw - pin);
  const T a1 = dur - rel;
  const T ov_this = min_nan(max0_nan(a1), q.wc);
  const T a2 = (rel + q.wc) - T(1.0);
  const T c2 = max0_nan(a2);
  const T ov_next = min_nan(c2, dur);
  const T s = ov_this + ov_next;
  const T overlap = min_nan(max0_nan(s), q.wc);
  g_w = g_w + q.g * (T(1.0) - (ecl ? overlap * q.iw : T(0.0)));
  const T g_overlap = ecl ? w * gn : T(0.0);
  const T g_s = clamp_min_grad(s, q.wc, g_overlap, T(0.5) * g_overlap);
  const T h = T(0.5) * g_s;
  const T g_a1 = clamp_min_grad(a1, q.wc, g_s, h);
  const T g_a2 = clamp_min_grad(a2, dur, g_s, h);
  const T g_rel = g_a2 - g_a1;
  const T g_dur = min_grad_b(c2, dur, g_s, h) + g_a1;
  g_pin = g_pin - (g_rel + g_dur);
  g_pout = g_pout + g_dur;
  return g_rel;
}

// K7's backward: one lane's elements, slab lane j of the slabs k, k +
// stride, ..., (S of them, ns before the row's last), held with their
// cotangents, which phase() sums over the phases in the order it is
// called
template <typename T, bool WIDTHS, int S> struct CurveGradLane {
  T pin[S], dur[S], w[S], g_pin[S], g_pout[S], g_w[S];
  bool ecl[S];
  int ns;
  SWEEP_FN void load(const T* pin_r, const T* pout_r,
                     const unsigned char* ecl_r, const T* w_r, int k,
                     int stride, int k_all, int j, int n_el) {
    ns = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = (k + s * stride) * SWEEP_SLAB + j;
      const bool in = k + s * stride < k_all && n < n_el;
      const T a = in ? pin_r[n] : T(0.0);
      const T b = in ? pout_r[n] : T(0.0);
      pin[s] = a;
      dur[s] = b - a;
      w[s] = in ? w_r[n] : T(0.0);
      ecl[s] = in && ecl_r[n];
      g_pin[s] = g_pout[s] = g_w[s] = T(0.0);
      if (k + s * stride < k_all) ns = s + 1;
    }
  }
  // the terms of phase q: the lane's share of its d ph, its slabs in order
  SWEEP_FN T phase(const CurveGradPhase<T>& q) {
    T x = T(0.0);
    const T gn = -(q.g * q.iw);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < ns) {
        if (WIDTHS)
          x = x + curve_grad_term(q, gn, pin[s], dur[s], ecl[s], w[s],
                                  g_pin[s], g_pout[s], g_w[s]);
        else
          g_w[s] = g_w[s] + q.g * indicator_vis(q.hw, pin[s], dur[s]);
      }
    }
    return x;
  }
  SWEEP_FN void store(T* g_pin_r, T* g_pout_r, T* g_w_r, int k, int stride,
                      int j, int n_el) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = (k + s * stride) * SWEEP_SLAB + j;
      if (s < ns && n < n_el) {
        g_w_r[n] = g_w[s];
        if (WIDTHS) {
          g_pin_r[n] = g_pin[s];
          g_pout_r[n] = g_pout[s];
        }
      }
    }
  }
};

// K7's backward: the warps of a row's block (enough for its slabs, at
// most K7B_WARPS) and the sum of their d ph totals, in warp order
static __host__ __device__ __forceinline__ int curve_grad_warps(int n) {
  const int w = (n_slabs(n) + K7B_SLABS - 1) / K7B_SLABS;
  return w < K7B_WARPS ? w : K7B_WARPS;
}
template <typename T>
SWEEP_FN T warps_total(const T* part, int warps, int stride) {
  T t = part[0];
  for (int w = 1; w < warps; ++w) t = t + part[w * stride];
  return t;
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

// K8 forward, threads over phases: the terms of staged slabs [k0, k1) at
// direction e into acc
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

// K8 forward, a warp a (row, phase) pair: lane j's running sum at
// direction e over its slab lane of a grid of n_el elements (elements j,
// 32 + j, ... of the k_all slabs, past n_el the pad element), in order
// from -0.0
template <typename T>
SWEEP_FN T donor_lane(T e0, T e1, T e2, const T* nrm_g, const T* a_g, int j,
                      int n_el, int k_all, T c1, T c2) {
  T acc = T(-0.0);
  for (int k = 0; k < k_all; ++k) {
    const long long n = (long long)k * SWEEP_SLAB + j;
    const bool in = n < n_el;
    const T n0 = in ? nrm_g[3 * n] : T(0.0);
    const T n1 = in ? nrm_g[3 * n + 1] : T(0.0);
    const T n2 = in ? nrm_g[3 * n + 2] : T(0.0);
    const T a = in ? a_g[n] : T(0.0);
    acc = acc + donor_weight(e0, e1, e2, n0, n1, n2, c1, c2) * a;
  }
  return acc;
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

// a warp's 32 values halved pairwise: lane j adds lane j + h's for h = 16,
// 8, 4, 2, 1 (Slabs::total's adds); lane 0 holds the total
template <typename T> __device__ __forceinline__ T warp_total(T x) {
#pragma unroll
  for (int h = SWEEP_SLAB / 2; h > 0; h /= 2)
    x = x + __shfl_down_sync(0xffffffffu, x, h);
  return x;
}

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

// K7's backward: block r runs row r, curve_grad_warps(N) warps; a pass
// takes warp w's lane j through slab lane j of the slabs k0 + w + s warps
// (s < K7B_SLABS), over all the row's phases, K7B_PHASES staged at once
template <typename T, bool WIDTHS>
__global__ void __launch_bounds__(K7B_WARPS * SWEEP_SLAB)
element_curve_backward_kernel(
    const T* __restrict__ ph, const T* __restrict__ wd,
    const T* __restrict__ pin, const T* __restrict__ pout,
    const unsigned char* __restrict__ ecl, const T* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ g_ph, T* __restrict__ g_pin,
    T* __restrict__ g_pout, T* __restrict__ g_w, int P, int N) {
  __shared__ CurveGradPhase<T> q_sh[K7B_PHASES];
  __shared__ T part[K7B_WARPS][K7B_PHASES];
  const int warps = blockDim.x / SWEEP_SLAB;
  const int wid = threadIdx.x / SWEEP_SLAB, lane = threadIdx.x % SWEEP_SLAB;
  const long long r = blockIdx.x;
  const T* ph_r = ph + r * P;
  const T* wd_r = WIDTHS ? wd + r * P : nullptr;
  const T* g_r = g + r * P;
  const int k_all = n_slabs(N);
  for (int k0 = 0; k0 < k_all; k0 += warps * K7B_SLABS) {
    CurveGradLane<T, WIDTHS, K7B_SLABS> el;
    el.load(pin + r * N, pout + r * N, ecl + r * N, w + r * N, k0 + wid,
            warps, k_all, lane, N);
    for (int p0 = 0; p0 < P; p0 += K7B_PHASES) {
      const int m = min(P - p0, K7B_PHASES);
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        q_sh[i].template set<WIDTHS>(ph_r[p0 + i],
                                     WIDTHS ? wd_r[p0 + i] : T(0.0),
                                     g_r[p0 + i]);
      __syncthreads();
      for (int i = 0; i < m; ++i) {
        const CurveGradPhase<T> q = q_sh[i];
        const T x = el.phase(q);
        if (WIDTHS) {
          const T t = warp_total(x);
          if (lane == 0) part[wid][i] = t;
        }
      }
      if (WIDTHS) {
        __syncthreads();
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
          const T t = warps_total(&part[0][i], warps, K7B_PHASES);
          T* o = g_ph + r * P + p0 + i;
          *o = k0 == 0 ? t : *o + t;
        }
      }
    }
    el.store(g_pin + r * N, g_pout + r * N, g_w + r * N, k0 + wid, warps,
             lane, N);
  }
}

template <typename T> struct DonorShared {
  T n0[SWEEP_TILE], n1[SWEEP_TILE], n2[SWEEP_TILE], a[SWEEP_TILE];
  __device__ DonorElems<T> elems() { return {n0, n1, n2, a}; }
};

// K8.  LANES (a row of fewer than DONOR_LANES_BELOW phases: the donor
// curve's normaliser, P = 1): warp w of the launch runs (row, phase) pair
// w, lane j its slab lane of the row's grid read straight from memory, the
// lanes halved by warp_total.  Otherwise block (r, c) runs row r's phases
// c blockDim.x .. (c + 1) blockDim.x, a thread a phase, against grid r / E
// staged in shared memory a tile at a time, its 32 running sums halved by
// Slabs::total.  Either gives each sum the plain version's adds.
template <typename T, bool LANES>
__global__ void __launch_bounds__(SWEEP_THREADS)
donor_sum_kernel(const T* __restrict__ e, const T* __restrict__ nrm,
                 const T* __restrict__ areas, double c1d, double c2d,
                 T* __restrict__ out, int R, int P, int N, int E) {
  const T c1 = T(c1d), c2 = T(c2d);
  const int k_all = n_slabs(N);
  if (LANES) {
    const long long rp = (long long)blockIdx.x * (blockDim.x / SWEEP_SLAB)
                         + threadIdx.x / SWEEP_SLAB;
    if (rp >= (long long)R * P) return;          // the whole warp
    const long long gr = rp / P / E;
    const T x = donor_lane(e[3 * rp], e[3 * rp + 1], e[3 * rp + 2],
                           nrm + 3 * gr * N, areas + gr * N,
                           (int)(threadIdx.x % SWEEP_SLAB), N, k_all, c1,
                           c2);
    const T total = warp_total(x);
    if (threadIdx.x % SWEEP_SLAB == 0) out[rp] = total;
    return;
  }
  __shared__ DonorShared<T> sh;
  const DonorElems<T> s = sh.elems();
  const long long r = blockIdx.x;
  const long long gr = r / E;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < P;
  const long long rp = r * P + (live ? p : P - 1);
  const T e0 = e[3 * rp], e1 = e[3 * rp + 1], e2 = e[3 * rp + 2];
  const T* nrm_g = nrm + 3 * gr * N;
  const T* a_g = areas + gr * N;
  Slabs<T> acc;
  acc.init();
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

// the forward kernels' blocks over phases: a multiple of 32 threads, no
// more than P needs
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
  const unsigned t = (unsigned)curve_grad_warps(N) * SWEEP_SLAB;
  const unsigned char* ec = (const unsigned char*)ecl;
#define K7B_LAUNCH(TT, WW)                                                  \
  element_curve_backward_kernel<TT, WW><<<(unsigned)R, t, 0, s>>>(          \
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
  const bool lanes = P < DONOR_LANES_BELOW;
  const unsigned t = lanes ? SWEEP_THREADS : phase_threads(P);
  const dim3 grid = lanes ? dim3((unsigned)(((long long)R * P * SWEEP_SLAB
                                             + t - 1) / t))
                          : dim3((unsigned)R, (P + t - 1) / t);
#define K8_LAUNCH(TT, LL)                                                   \
  donor_sum_kernel<TT, LL><<<grid, t, 0, s>>>(                              \
      (const TT*)e, (const TT*)nrm, (const TT*)areas, c1, c2, (TT*)out, R,  \
      P, N, E)
  if (is_double) {
    if (lanes) K8_LAUNCH(double, true); else K8_LAUNCH(double, false);
  } else {
    if (lanes) K8_LAUNCH(float, true); else K8_LAUNCH(float, false);
  }
#undef K8_LAUNCH
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
