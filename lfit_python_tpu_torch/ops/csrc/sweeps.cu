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
// What bounds them: the issue of instructions, and the pipes some of them
// take.  A term is one phase and one element; the inputs are O(rows (P +
// N)) numbers and the terms O(rows P N).  Built with --fmad=false, no
// product and sum fuse unless the source asks (fma_).  A floor (FRND) and
// a conversion issue at 16 lanes an SM a clock, compares, selects and min
// / max at 64, adds and products at 128 (tools/conv_pipe_rate.py).  Issued
// a term (float32, from the SASS: tools/sweeps_sass_counts.py): see
// chip_smoke.py's SWEEPS_SASS_PER_TERM.
//
// The designs.  K7 (forward) and K8 for rows of at least
// DONOR_LANES_BELOW phases: a block of threads runs one row, its threads
// over the row's phases; the elements are staged in shared memory a tile
// of SWEEP_TILE at a time, and every thread sums all of them for its
// phase.  K7 takes the floor off the term path where it can: without
// widths, where every phase of the block lies within a cycle of each of a
// tile's contacts (the kernel checks each tile against its block's least
// and largest phase: every tile of the north star), d - floor(d) is d + (d
// < 0), a comparison, and acc + vis w one fused rounding (vis is 0 or 1);
// with widths the quotient overlap / wc by the phase's reciprocal and one
// correction (quot_rcp) and the minima and clamps by min.NaN / max.NaN.
// Elsewhere the floor and the divide.  A shorter row of K8 (the donor
// curve's normaliser, P = 1) runs a warp a (row, phase) pair, lane j the
// elements j, 32 + j, ... (slab lane j), the lanes' sums halved by
// __shfl_down_sync.  K7's backward: one fused sweep, a block a row; its
// warps split the row's slabs, lane j holding slab lane j of K7B_SLABS
// slabs in registers with their three running cotangents; the block
// walks the row's phases, staged K7B_PHASES at a time, and each term runs
// the overlap chain once for its visibility (d w) and the cotangents of
// its rel and dur (d ph, d pin, d pout), with the fewest ALU instructions
// the rules allow (min.NaN / max.NaN, clamp_min_grad); a warp's d ph
// partials are halved by __shfl_down_sync and the warps' added in warp
// order through shared memory.  K8's backward: one fused sweep, a block a
// grid; its warps split the grid's slabs (slab groups) and its E rows'
// (row, phase) pairs (phase groups), lane j holding slab lane j of
// K8B_SLABS slabs with their four running cotangents; each term computes
// its dot, clamp and weight once for d a, d n and d e; a pair's d e is
// totalled over a warp's lanes by a packed xor halving (warp_totals3) and
// over the slab groups in order, an element's d n and d a over the phase
// groups in order.  No atomics: each output is summed in a fixed order, so
// a row's result does not depend on its batch, and two launches give the
// same bits.
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
// K8's d e: a lane's slabs in order, warp_totals3, the slab groups in
// order, the passes in order; the others over their phases in order, the
// phase groups in order).
//
// Bit-identity with the plain version: each expression below is one
// PyTorch operation per operator, in the plain version's order, or an
// exact rewrite of it (K7's comparison for the floor, its fused acc + vis
// w, its corrected quotient, each argued where it is defined); built
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
// first argument.  The backward kernels are held to a tolerance, not to
// bits: K7's divides by the clamped width through one reciprocal a phase,
// K8's fuses products and sums and takes each element's area out of its d
// n.  Without widths the visibility is an indicator, whose derivative is
// 0: only d w is made.
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

// the slab width of the forward sums (a warp's lanes) and the elements K7
// and K8 stage at once: a multiple of it
#define SWEEP_SLAB 32
#define SWEEP_TILE 256
// the forward kernels' blocks over phases (fewer for a short row)
#define SWEEP_THREADS 128

// K7's backward: the slabs a lane holds, the warps a block has at most and
// the phases it stages at once
#ifndef K7B_SLABS
#define K7B_SLABS 4
#endif
#ifndef K7B_WARPS
#define K7B_WARPS 8
#endif
#define K7B_PHASES 128

// K7 without widths in float32: the phases a thread sums, each staged
// element read once for all of them (with widths, and float64: one, their
// registers)
#ifndef K7_PHASES
#define K7_PHASES 2
#endif

// K8: rows of fewer phases than a warp run a warp a (row, phase) pair
#ifndef DONOR_LANES_BELOW
#define DONOR_LANES_BELOW 32
#endif

// K8's backward: the slabs a lane holds, the warps a block has at most and
// the (row, phase) pairs it stages at once
#ifndef K8B_SLABS
#define K8B_SLABS 4
#endif
#ifndef K8B_WARPS
#define K8B_WARPS 12
#endif
#define K8B_PAIRS 64

template <typename T> SWEEP_FN T floor_(T v);
template <> SWEEP_FN float floor_<float>(float v) { return floorf(v); }
template <> SWEEP_FN double floor_<double>(double v) { return floor(v); }

// a product and a sum rounded once (the backward kernels, which are held
// to a tolerance, not to bits)
template <typename T> SWEEP_FN T fma_(T a, T b, T c);
template <> SWEEP_FN float fma_<float>(float a, float b, float c) {
  return fmaf(a, b, c);
}
template <> SWEEP_FN double fma_<double>(double a, double b, double c) {
  return fma(a, b, c);
}

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

// the forward kernels' blocks over phases: a multiple of 32 threads, no
// more than P needs
static __host__ __device__ __forceinline__ unsigned phase_threads(int P) {
  const int t = (P + 31) / 32 * 32;
  return (unsigned)(t < SWEEP_THREADS ? t : SWEEP_THREADS);
}

// ---- K7: the element curve --------------------------------------------

// overlap / wc through the phase's reciprocal iw = 1 / wc (rounded once)
// and one correction (Markstein): q = o iw, r = o - q wc (exact in a
// fused product and sum), q + r iw rounded once.  That is the correctly
// rounded quotient wherever nothing underflows: for o = 0 and o >= 2^-100
// (float32; 2^-900 float64) at wc in [1e-12, QUOT_WC_MAX].  Below, both
// quotients are under 2^-60 (wc >= 1e-12), so 1 - frac rounds to 1 for
// either: the visibility keeps its bits for every overlap.  The kernel
// divides at a phase whose width is above QUOT_WC_MAX, infinite or NaN
// (where iw is 0 or subnormal)
template <typename T> SWEEP_FN T quot_rcp(T o, T wc, T iw) {
  const T q = o * iw;
  const T r = fma_(-q, wc, o);
  return fma_(r, iw, q);
}
template <typename T> SWEEP_FN T quot_wc_max();
template <> SWEEP_FN float quot_wc_max<float>() { return 0x1p50f; }
template <> SWEEP_FN double quot_wc_max<double>() { return 0x1p400; }

// staged elements: phi_in, the duration phi_out - phi_in (once per
// element, as the plain version), the weight and the eclipsed flag
template <typename T> struct CurveElems {
  T* pin;
  T* dur;
  T* w;
  unsigned char* ecl;
  // element n of a row of n_el as entry i; past n_el the pad element.
  // Whether the fast path takes it: with widths, always; without, if each
  // phase of the block (in [lo, hi] but NaN) is within [-1, 1) of phi_in
  // (fl(ph - pin) is monotone in ph)
  template <bool WIDTHS>
  SWEEP_FN bool stage(int i, const T* pin_r, const T* pout_r,
                      const unsigned char* ecl_r, const T* w_r, int n,
                      int n_el, T lo, T hi) const {
    const bool in = n < n_el;
    const T a = in ? pin_r[n] : T(0.0);
    const T b = in ? pout_r[n] : T(0.0);
    pin[i] = a;
    dur[i] = b - a;
    w[i] = in ? w_r[n] : T(0.0);
    ecl[i] = in ? ecl_r[n] : (unsigned char)0;
    return WIDTHS || (lo - a >= T(-1.0) && hi - a < T(1.0));
  }
};

// without widths the indicator 1 - (rel < dur), rel = d - floor(d), d = ph
// - pin
template <typename T> SWEEP_FN T indicator(T rel, T dur) {
  return T(1.0) - (rel < dur ? T(1.0) : T(0.0));
}
template <typename T> SWEEP_FN T indicator_vis(T ph, T pin, T dur) {
  const T d = ph - pin;
  return indicator(d - floor_(d), dur);
}

// d - floor(d) for d in [-1, 1) (the kernel checks each tile's range
// against its block's phases): the floor is -1 below 0 and 0 else, so it
// is d + (d < 0), the same rounding, by a comparison where the floor
// costs a conversion (FRND: 16 lanes an SM a clock); at d = -0 it is +0 as
// the floor form's, and NaN stays NaN
template <typename T> SWEEP_FN T rel_near(T d) {
  return d + (d < T(0.0) ? T(1.0) : T(0.0));
}

// one phase: without widths the indicator; with widths
// visible_fraction_interval's exposure overlap, wc = clamp(width,
// min=1e-12), hw = ph - 0.5 wc and iw = 1 / wc once per phase.  Its
// minima and clamps are min_nan / max0_nan: they may give a zero the
// other sign than torch's, which reaches only the quotient's zero, and 1 -
// frac is 1 for either.  FAST: without widths rel_near (the kernel checks
// each tile's range), with widths the quotient by quot_rcp (where the
// phase's width is in its range: fast); else the floor, the divide
template <typename T, bool WIDTHS> struct CurvePhase {
  T ph, wc, hw, iw;
  bool fast;
  SWEEP_FN void set(T phase, T width) {
    ph = phase;
    if (WIDTHS) {
      wc = clamp_min(width, T(1e-12));
      hw = ph - T(0.5) * wc;
      iw = T(1.0) / wc;
      fast = wc <= quot_wc_max<T>();
    }
  }
  template <bool FAST>
  SWEEP_FN T vis(T pin, T dur, unsigned char ecl) const {
    const T rel = remainder1(hw - pin);
    const T ov_this = min_nan(max0_nan(dur - rel), wc);
    const T ov_next = min_nan(max0_nan((rel + wc) - T(1.0)), dur);
    const T overlap = min_nan(max0_nan(ov_this + ov_next), wc);
    const T frac = ecl ? (FAST ? quot_rcp(overlap, wc, iw) : overlap / wc)
                       : T(0.0);
    return T(1.0) - frac;
  }
  // a term into its running sum: acc + vis w.  Without widths vis is 0 or
  // 1, so vis w is exact and one rounding of vis w + acc gives its bits
  template <bool FAST>
  SWEEP_FN T add(T acc, T pin, T dur, unsigned char ecl, T w) const {
    if (WIDTHS) return acc + vis<FAST>(pin, dur, ecl) * w;
    const T d = ph - pin;
    return fma_(indicator(FAST ? rel_near(d) : d - floor_(d), dur), w, acc);
  }
};

// K7: the phases a thread sums
template <typename T, bool WIDTHS> struct CurveThread {
  static constexpr int phases = 1;
};
template <> struct CurveThread<float, false> {
  static constexpr int phases = K7_PHASES;
};

// K7 forward: the terms of staged slabs [k0, k1) at the PH phases p into
// acc, each element read once
template <typename T, bool WIDTHS, bool FAST, int PH>
SWEEP_FN void curve_slabs(Slabs<T> (&acc)[PH],
                          const CurvePhase<T, WIDTHS> (&p)[PH],
                          const CurveElems<T>& s, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
#pragma unroll
    for (int j = 0; j < SWEEP_SLAB; ++j) {
      const int i = k * SWEEP_SLAB + j;
      const T pin = s.pin[i], dur = s.dur[i], w = s.w[i];
      const unsigned char ecl = WIDTHS ? s.ecl[i] : (unsigned char)0;
#pragma unroll
      for (int h = 0; h < PH; ++h)
        acc[h].acc[j] = p[h].template add<FAST>(acc[h].acc[j], pin, dur,
                                                ecl, w);
    }
  }
}

// NaN as x, any other v as itself
template <typename T> SWEEP_FN T nan_as(T v, T x) { return v != v ? x : v; }

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

// K8's backward, one (row, phase) pair as its terms take it: the direction
// e and, of its cotangent g, g c1, g c2 and g 2 c2 (exact)
template <typename T> struct alignas(8 * sizeof(T)) DonorGradPair {
  T e0, e1, e2, gc1, gc2, g2c2;
  SWEEP_FN void set(const T* e_rp, T cot, T c1, T c2) {
    e0 = e_rp[0];
    e1 = e_rp[1];
    e2 = e_rp[2];
    gc1 = cot * c1;
    gc2 = cot * c2;
    g2c2 = gc2 + gc2;
  }
};

// K8's backward: one lane's elements, slab lane j of the slabs k, k +
// stride, ... (S of them, ns before the grid's last; past n_el, and in a
// slab past the grid's last, the pad element), held with their running
// cotangents: each pair's terms add their d n (before the element's area:
// a u e) and d a (g wgt), and give the lane's share of the pair's d e
// (sum of u a n, a n held).  A term computes m = e . n, mu = max(m, 0)
// and the weight's factor once: g wgt = mu g (c1 + c2 mu) for d a, u = g
// (c1 + 2 c2 mu) where m >= 0 (clamp's inclusive bound; NaN: 0) for d e
// and d n.  NaN passes as autograd's: a NaN m gives d a NaN and nothing to
// d e or d n; but a NaN area makes d e NaN for every pair of its grid
// (autograd's: where its m >= 0), and so does a cotangent that is not
// finite where a pad element meets it (autograd's: where some m >= 0).
// A pad element adds 0 to d e otherwise; its d n and d a are not stored
template <typename T, int S> struct DonorGradLane {
  T n0[S], n1[S], n2[S], an0[S], an1[S], an2[S];
  T gn0[S], gn1[S], gn2[S], ga[S];
  int ns;
  SWEEP_FN void load(const T* nrm_g, const T* a_g, int k, int stride,
                     int k_all, int j, int n_el) {
    ns = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long n = (long long)(k + s * stride) * SWEEP_SLAB + j;
      const bool in = k + s * stride < k_all && n < n_el;
      const T a = in ? a_g[n] : T(0.0);
      n0[s] = in ? nrm_g[3 * n] : T(0.0);
      n1[s] = in ? nrm_g[3 * n + 1] : T(0.0);
      n2[s] = in ? nrm_g[3 * n + 2] : T(0.0);
      an0[s] = a * n0[s];
      an1[s] = a * n1[s];
      an2[s] = a * n2[s];
      gn0[s] = gn1[s] = gn2[s] = ga[s] = T(0.0);
      if (k + s * stride < k_all) ns = s + 1;
    }
  }
  // the terms of pair q: the lane's share of its d e in x, its slabs in
  // order
  SWEEP_FN void pair(const DonorGradPair<T>& q, T& x0, T& x1, T& x2) {
    x0 = x1 = x2 = T(0.0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T m = fma_(q.e2, n2[s], fma_(q.e1, n1[s], q.e0 * n0[s]));
      const T mu = max0_nan(m);
      const T h = fma_(mu, q.gc2, q.gc1);
      ga[s] = fma_(mu, h, ga[s]);
      const T u = clamp_grad(m, fma_(mu, q.gc2, h));
      gn0[s] = fma_(u, q.e0, gn0[s]);
      gn1[s] = fma_(u, q.e1, gn1[s]);
      gn2[s] = fma_(u, q.e2, gn2[s]);
      x0 = fma_(u, an0[s], x0);
      x1 = fma_(u, an1[s], x1);
      x2 = fma_(u, an2[s], x2);
    }
  }
};

// K8's backward: the slab groups of a grid's block (warps that split its
// slabs, at most K8B_WARPS) and its phase groups (warps that split its
// pairs, one a pair at most: groups x phase groups <= K8B_WARPS)
static __host__ __device__ __forceinline__ int donor_grad_groups(int n) {
  const int w = (n_slabs(n) + K8B_SLABS - 1) / K8B_SLABS;
  return w < K8B_WARPS ? w : K8B_WARPS;
}
static __host__ __device__ __forceinline__ int donor_grad_phase_groups(
    int n, int pairs) {
  const int p = K8B_WARPS / donor_grad_groups(n);
  return p < pairs ? p : pairs;
}

// ---- kernel and launcher ------------------------------------------------


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

// K7: block (r, c) runs row r's phases c PH blockDim.x .. (c + 1) PH
// blockDim.x, thread t the phases t + h blockDim.x (h < PH)
template <typename T, bool WIDTHS>
__global__ void __launch_bounds__(SWEEP_THREADS)
element_curve_kernel(const T* __restrict__ ph, const T* __restrict__ wd,
                     const T* __restrict__ pin, const T* __restrict__ pout,
                     const unsigned char* __restrict__ ecl,
                     const T* __restrict__ w, T* __restrict__ out, int P,
                     int N) {
  constexpr int PH = CurveThread<T, WIDTHS>::phases;
  __shared__ CurveShared<T> sh;
  const CurveElems<T> s = sh.elems();
  const long long r = blockIdx.x;
  CurvePhase<T, WIDTHS> q[PH];
  long long rp[PH];
  bool live[PH];
  bool fast = true;
  // without widths: the least and the largest of the block's phases that
  // are not NaN
  T lo = T(INFINITY), hi = T(-INFINITY);
#pragma unroll
  for (int h = 0; h < PH; ++h) {
    const int p = (blockIdx.y * PH + h) * blockDim.x + threadIdx.x;
    live[h] = p < P;
    rp[h] = r * P + (live[h] ? p : P - 1);
    q[h].set(ph[rp[h]], WIDTHS ? wd[rp[h]] : T(0.0));
    fast = fast && (!WIDTHS || q[h].fast);
    const T x = live[h] ? q[h].ph : T(NAN);
    lo = nan_as(x, lo) < lo ? x : lo;
    hi = nan_as(x, hi) > hi ? x : hi;
  }
  if (!WIDTHS) {
    __shared__ T range[2][SWEEP_THREADS / SWEEP_SLAB];
#pragma unroll
    for (int h = SWEEP_SLAB / 2; h > 0; h /= 2) {
      const T a = __shfl_xor_sync(0xffffffffu, lo, h);
      const T b = __shfl_xor_sync(0xffffffffu, hi, h);
      lo = a < lo ? a : lo;
      hi = b > hi ? b : hi;
    }
    if (threadIdx.x % SWEEP_SLAB == 0) {
      range[0][threadIdx.x / SWEEP_SLAB] = lo;
      range[1][threadIdx.x / SWEEP_SLAB] = hi;
    }
    __syncthreads();
    for (int v = 0; v < (int)blockDim.x / SWEEP_SLAB; ++v) {
      lo = range[0][v] < lo ? range[0][v] : lo;
      hi = range[1][v] > hi ? range[1][v] : hi;
    }
  }
  const T* pin_r = pin + r * N;
  const T* pout_r = pout + r * N;
  const unsigned char* ecl_r = ecl + r * N;
  const T* w_r = w + r * N;
  Slabs<T> acc[PH];
#pragma unroll
  for (int h = 0; h < PH; ++h) acc[h].init();
  const int k_all = n_slabs(N);
  for (int k0 = 0; k0 < k_all; k0 += SWEEP_TILE / SWEEP_SLAB) {
    __syncthreads();
    bool ok = true;
    for (int i = threadIdx.x; i < SWEEP_TILE; i += blockDim.x)
      ok = s.template stage<WIDTHS>(i, pin_r, pout_r, ecl_r, w_r,
                                    k0 * SWEEP_SLAB + i, N, lo, hi) && ok;
    // whether the whole tile takes the fast path (with widths, if each of
    // this thread's phases does)
    ok = __syncthreads_and(ok);
    const int k1 = min(k_all - k0, SWEEP_TILE / SWEEP_SLAB);
    if (ok && fast)
      curve_slabs<T, WIDTHS, true, PH>(acc, q, s, 0, k1);
    else
      curve_slabs<T, WIDTHS, false, PH>(acc, q, s, 0, k1);
  }
#pragma unroll
  for (int h = 0; h < PH; ++h) {
    const T total = acc[h].total();
    if (live[h]) out[rp[h]] = total;
  }
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

// a warp's lanes' totals of three values: lane l ends with value (l >> 3)
// & 3's (the fourth: 0).  xor 16 trades the slots' halves (the low lanes
// keep values 0, 1 and take the high lanes' of them, the high lanes 2 and
// the fourth), xor 8 the halves again, then xor 4, 2, 1 add; lane 0 holds
// the total of x0, lane 8 of x1, lane 16 of x2
template <typename T>
__device__ __forceinline__ T warp_totals3(T x0, T x1, T x2, int lane) {
  const unsigned full = 0xffffffffu;
  const bool h16 = lane & 16, h8 = lane & 8;
  T k0 = h16 ? x2 : x0, k1 = h16 ? T(0.0) : x1;
  const T s0 = h16 ? x0 : x2, s1 = h16 ? x1 : T(0.0);
  k0 = k0 + __shfl_xor_sync(full, s0, 16);
  k1 = k1 + __shfl_xor_sync(full, s1, 16);
  T k = h8 ? k1 : k0;
  k = k + __shfl_xor_sync(full, h8 ? k0 : k1, 8);
#pragma unroll
  for (int h = 4; h > 0; h /= 2) k = k + __shfl_xor_sync(full, k, h);
  return k;
}

template <typename T> struct DonorGradShared {
  DonorGradPair<T> q[K8B_PAIRS];
  T part[K8B_WARPS][3][K8B_PAIRS];       // a pair's d e by slab group
  T acc[K8B_WARPS][4][SWEEP_SLAB];       // one slab's d n, d a by warp
};

// K8's backward: one fused sweep, block g grid g, donor_grad_groups(N) x
// donor_grad_phase_groups(N, E P) warps: warp w (slab group w % groups,
// phase group w / groups) takes its lane j through slab lane j of the
// slabs k0 + group + s groups (s < K8B_SLABS) and the grid's E rows'
// pairs of its phase group (pair i of each staged tile where i % phase
// groups is its own), K8B_PAIRS staged at once.  A pair's d e: each
// warp's lanes by warp_totals3, the slab groups in order (the passes in
// order); an element's d n and d a: the phase groups in order
template <typename T>
__global__ void __launch_bounds__(K8B_WARPS * SWEEP_SLAB)
donor_sum_backward_kernel(const T* __restrict__ e, const T* __restrict__ nrm,
                          const T* __restrict__ areas, double c1d,
                          double c2d, const T* __restrict__ g,
                          T* __restrict__ g_e, T* __restrict__ g_nrm,
                          T* __restrict__ g_a, int P, int N, int E) {
  __shared__ DonorGradShared<T> sh;
  const int wid = threadIdx.x / SWEEP_SLAB, lane = threadIdx.x % SWEEP_SLAB;
  const int Q = E * P;
  const int groups = donor_grad_groups(N);
  const int phase_groups = blockDim.x / SWEEP_SLAB / groups;
  const int sg = wid % groups, pg = wid / groups;
  const long long gr = blockIdx.x, q0 = gr * Q;
  const T c1 = T(c1d), c2 = T(c2d);
  const T* nrm_g = nrm + 3 * gr * N;
  const T* a_g = areas + gr * N;
  const int k_all = n_slabs(N);
  for (int k0 = 0; k0 < k_all; k0 += groups * K8B_SLABS) {
    DonorGradLane<T, K8B_SLABS> el;
    el.load(nrm_g, a_g, k0 + sg, groups, k_all, lane, N);
    for (int i0 = 0; i0 < Q; i0 += K8B_PAIRS) {
      const int m = min(Q - i0, K8B_PAIRS);
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        sh.q[i].set(e + 3 * (q0 + i0 + i), g[q0 + i0 + i], c1, c2);
      __syncthreads();
      for (int i = pg; i < m; i += phase_groups) {
        const DonorGradPair<T> q = sh.q[i];
        T x0, x1, x2;
        el.pair(q, x0, x1, x2);
        const T t = warp_totals3(x0, x1, x2, lane);
        if (lane % 8 == 0 && lane < 24) sh.part[sg][lane / 8][i] = t;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 3 * m; i += blockDim.x) {
        const int p = i / 3, v = i % 3;
        T t = sh.part[0][v][p];
        for (int s = 1; s < groups; ++s) t = t + sh.part[s][v][p];
        T* o = g_e + 3 * (q0 + i0 + p) + v;
        *o = k0 == 0 ? t : *o + t;
      }
    }
#pragma unroll
    for (int s = 0; s < K8B_SLABS; ++s) {
      __syncthreads();
      sh.acc[wid][0][lane] = el.gn0[s];
      sh.acc[wid][1][lane] = el.gn1[s];
      sh.acc[wid][2][lane] = el.gn2[s];
      sh.acc[wid][3][lane] = el.ga[s];
      __syncthreads();
      const long long n = (long long)(k0 + sg + s * groups) * SWEEP_SLAB
                          + lane;
      if (pg == 0 && s < el.ns && n < N) {
        T t[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          t[v] = sh.acc[sg][v][lane];
          for (int q = 1; q < phase_groups; ++q)
            t[v] = t[v] + sh.acc[q * groups + sg][v][lane];
        }
        const T a = a_g[n];
        const long long gn = gr * N + n;
        g_nrm[3 * gn] = a * t[0];
        g_nrm[3 * gn + 1] = a * t[1];
        g_nrm[3 * gn + 2] = a * t[2];
        g_a[gn] = t[3];
      }
    }
  }
}

static bool bad_size(int R, int P, int N, int E) {
  return R < 1 || P < 1 || N < 0 || E < 1 || R % E != 0
         || (long long)R * P > (1LL << 31) - 1
         || (long long)R * N * 3 > (1LL << 31) - 1;
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
  const int span = is_double || widths ? 1
                                       : CurveThread<float, false>::phases;
  const unsigned t = phase_threads((P + span - 1) / span);
  const dim3 grid((unsigned)R, (P + t * span - 1) / (t * span));
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
  const unsigned t = (unsigned)(donor_grad_groups(N)
                                * donor_grad_phase_groups(N, E * P)
                                * SWEEP_SLAB);
  if (is_double)
    donor_sum_backward_kernel<double><<<(unsigned)(R / E), t, 0, s>>>(
        (const double*)e, (const double*)nrm, (const double*)areas, c1, c2,
        (const double*)g, (double*)g_e, (double*)g_nrm, (double*)g_a, P, N,
        E);
  else
    donor_sum_backward_kernel<float><<<(unsigned)(R / E), t, 0, s>>>(
        (const float*)e, (const float*)nrm, (const float*)areas, c1, c2,
        (const float*)g, (float*)g_e, (float*)g_nrm, (float*)g_a, P, N, E);
  return (int)cudaGetLastError();
}
