"""The flux curves' sweep kernels K7 (the element curve) and K8 (the
donor sum) and their backward kernels (``ops/csrc/sweeps.cu``) on the
CPU, against their plain versions, autograd and the JAX package.

A CUDA kernel cannot run here, so the kernel source's own arithmetic, the
part above its ``// ---- kernel and launcher`` line, is built by g++
behind a small shim header (``-ffp-contract=off``: no product and sum
contracted, as nvcc's ``--fmad=false``), with host loops in the kernels'
place and in their orders: a row's elements staged whole where a kernel
stages them, and a warp's 32 lanes run one after another where a kernel
spreads a sum over them (K8 below 32 phases, K7's fused backward), their
shuffle halving as ``Slabs::total``.  The forward stand-ins give the
plain versions' bits in float32 and float64 on inputs with NaN intervals,
non-eclipsed elements, phases on and across the contacts and the wrap at
1, widths at and below the 1e-12 clamp, mu exactly 0 and negative, at N
= 1-992 and P = 1-257.  The plain versions are held to the JAX package's
``element_flux_curve`` and ``donor_flux`` (vmapped over rows): float64
within 1e-12 and float32 within 1e-6 of the sum of |weights|.  The
backward stand-ins are held to autograd on the plain forward in float64
(1e-9 of the largest |gradient|) and in float32 (PERF.md's gate), with
ties of torch.minimum's arguments among the inputs, also built at another
layout; each autograd rule of K7's fused backward, broken in a copy of
the source, fails a check; the floor-form remainder is held to
torch.remainder.  Then the ``autograd.Function``s with the stand-in in
the launcher's place, through a posterior's value and gradient, against
the CPU path; and the routing: CPU tensors launch nothing, the wrappers
check their inputs, the widths take no gradient.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import components as jcomp
from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models import components as comp
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import sweeps

SOURCE = Path(sweeps.__file__).resolve().parent / "csrc" / "sweeps.cu"
F32, F64 = torch.float32, torch.float64

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __launch_bounds__(...)
"""

_HOST = r"""
#include <algorithm>
#include <vector>

// the least and the largest of n phases that are not NaN (+inf and -inf
// where all are), as the kernel reduces its block's
template <typename T>
static void phase_range(const T* ph, int n, T& lo, T& hi) {
  lo = T(INFINITY);
  hi = T(-INFINITY);
  for (int i = 0; i < n; ++i) {
    lo = nan_as(ph[i], lo) < lo ? ph[i] : lo;
    hi = nan_as(ph[i], hi) > hi ? ph[i] : hi;
  }
}

// K7: each row's phases in the kernel's blocks (phase_threads of the
// row's phases over PH, each thread PH phases a block's width apart),
// each block's elements staged whole with each tile of SWEEP_TILE
// elements' fast-path flag (without widths against the block's phase
// range), then every thread's phases over their slabs a tile at a time,
// as the kernel takes them: the fast path where the tile's flag and (with
// widths) each of the thread's phases allow
template <typename T, bool W>
static void curve_rows(const T* ph, const T* wd, const T* pin,
                       const T* pout, const unsigned char* ecl, const T* w,
                       T* out, int R, int P, int N) {
  constexpr int PH = CurveThread<T, W>::phases;
  const int K = n_slabs(N), M = K * SWEEP_SLAB;
  const int KT = SWEEP_TILE / SWEEP_SLAB;
  const int B = (int)phase_threads((P + PH - 1) / PH);
  std::vector<T> a(M), b(M), c(M);
  std::vector<unsigned char> d(M);
  std::vector<bool> ok((K + KT - 1) / KT);
  const CurveElems<T> s = {a.data(), b.data(), c.data(), d.data()};
  for (long long r = 0; r < R; ++r) {
    for (int p0 = 0; p0 < P; p0 += B * PH) {
      const int m = P - p0 < B * PH ? P - p0 : B * PH;
      T lo, hi;
      phase_range(ph + r * P + p0, m, lo, hi);
      std::fill(ok.begin(), ok.end(), true);
      for (int i = 0; i < M; ++i)
        if (!s.template stage<W>(i, pin + r * N, pout + r * N, ecl + r * N,
                                 w + r * N, i, N, lo, hi))
          ok[i / SWEEP_TILE] = false;
      for (int th = 0; th < B; ++th) {
        CurvePhase<T, W> q[PH];
        Slabs<T> acc[PH];
        bool fast = true;
        for (int h = 0; h < PH; ++h) {
          const int p = p0 + th + h * B < P ? p0 + th + h * B : P - 1;
          q[h].set(ph[r * P + p], W ? wd[r * P + p] : T(0.0));
          fast = fast && (!W || q[h].fast);
          acc[h].init();
        }
        for (int k0 = 0; k0 < K; k0 += KT) {
          const int k1 = k0 + KT < K ? k0 + KT : K;
          if (ok[k0 / KT] && fast)
            curve_slabs<T, W, true, PH>(acc, q, s, k0, k1);
          else
            curve_slabs<T, W, false, PH>(acc, q, s, k0, k1);
        }
        for (int h = 0; h < PH; ++h)
          if (p0 + th + h * B < P) out[r * P + p0 + th + h * B] =
              acc[h].total();
      }
    }
  }
}

// K7's backward: the fused sweep of each row as the kernel runs it, its
// warps' 32 lanes one after another: each pass loads lane j of warp v
// with slab lane j of the slabs k0 + v + s warps (CurveGradLane), every
// phase runs each lane's terms, a warp's d ph partials are halved as
// __shfl_down_sync halves them (Slabs::total) and the warps' totals added
// in warp order, the passes in order
template <typename T, bool W>
static void curve_backward_rows(const T* ph, const T* wd, const T* pin,
                                const T* pout, const unsigned char* ecl,
                                const T* w, const T* g, T* g_ph, T* g_pin,
                                T* g_pout, T* g_w, int R, int P, int N) {
  const int k_all = n_slabs(N), warps = curve_grad_warps(N);
  std::vector<CurveGradLane<T, W, K7B_SLABS>> lanes(warps * SWEEP_SLAB);
  std::vector<T> part(warps);
  for (long long r = 0; r < R; ++r) {
    for (int k0 = 0; k0 < k_all; k0 += warps * K7B_SLABS) {
      for (int i = 0; i < warps * SWEEP_SLAB; ++i)
        lanes[i].load(pin + r * N, pout + r * N, ecl + r * N, w + r * N,
                      k0 + i / SWEEP_SLAB, warps, k_all, i % SWEEP_SLAB, N);
      for (int p = 0; p < P; ++p) {
        CurveGradPhase<T> q;
        q.template set<W>(ph[r * P + p], W ? wd[r * P + p] : T(0.0),
                          g[r * P + p]);
        for (int v = 0; v < warps; ++v) {
          Slabs<T> x;
          for (int j = 0; j < SWEEP_SLAB; ++j)
            x.acc[j] = lanes[v * SWEEP_SLAB + j].phase(q);
          part[v] = x.total();
        }
        if (W) {
          const T t = warps_total(part.data(), warps, 1);
          g_ph[r * P + p] = k0 == 0 ? t : g_ph[r * P + p] + t;
        }
      }
      for (int i = 0; i < warps * SWEEP_SLAB; ++i)
        lanes[i].store(g_pin + r * N, g_pout + r * N, g_w + r * N,
                       k0 + i / SWEEP_SLAB, warps, i % SWEEP_SLAB, N);
    }
  }
}

// K8 as its two layouts run it: a row of fewer than DONOR_LANES_BELOW
// phases a warp a (row, phase) pair, each of its 32 lanes' running sums
// (donor_lane) and then the lanes halved as __shfl_down_sync halves them
// (Slabs::total); a longer row a thread a phase, its grid staged whole
template <typename T>
static void donor_rows(const T* e, const T* nrm, const T* areas, double c1,
                       double c2, T* out, int R, int P, int N, int E) {
  const int K = n_slabs(N), M = K * SWEEP_SLAB;
  if (P < DONOR_LANES_BELOW) {
    for (long long rp = 0; rp < (long long)R * P; ++rp) {
      const long long gr = rp / P / E;
      Slabs<T> x;
      for (int j = 0; j < SWEEP_SLAB; ++j)
        x.acc[j] = donor_lane(e[3 * rp], e[3 * rp + 1], e[3 * rp + 2],
                              nrm + 3 * gr * N, areas + gr * N, j, N, K,
                              T(c1), T(c2));
      out[rp] = x.total();
    }
    return;
  }
  std::vector<T> a(M), b(M), c(M), d(M);
  const DonorElems<T> s = {a.data(), b.data(), c.data(), d.data()};
  for (long long gr = 0; gr < R / E; ++gr) {
    for (int i = 0; i < M; ++i)
      s.stage(i, nrm + 3 * gr * N, areas + gr * N, i, N);
    for (long long r = gr * E; r < (gr + 1) * E; ++r)
      for (int p = 0; p < P; ++p) {
        const T* x = e + 3 * (r * P + p);
        Slabs<T> acc;
        acc.init();
        donor_slabs(acc, x[0], x[1], x[2], s, T(c1), T(c2), 0, K);
        out[r * P + p] = acc.total();
      }
  }
}

// the lanes' totals of three values as the kernel's warp_totals3 makes
// them: xor 16 trades the slots' halves, xor 8 again, xor 4, 2, 1 add;
// value v in lane 8 v
template <typename T>
static void lanes_totals3(const std::vector<T>& x, T* out) {
  T k0[SWEEP_SLAB], k1[SWEEP_SLAB], k[SWEEP_SLAB], t[SWEEP_SLAB];
  for (int l = 0; l < SWEEP_SLAB; ++l) {
    const int p = l ^ 16;
    k0[l] = l & 16 ? x[3 * l + 2] + x[3 * p + 2] : x[3 * l] + x[3 * p];
    k1[l] = l & 16 ? T(0.0) + T(0.0) : x[3 * l + 1] + x[3 * p + 1];
  }
  for (int l = 0; l < SWEEP_SLAB; ++l)
    k[l] = l & 8 ? k1[l] + k1[l ^ 8] : k0[l] + k0[l ^ 8];
  for (int h = 4; h > 0; h /= 2) {
    for (int l = 0; l < SWEEP_SLAB; ++l) t[l] = k[l] + k[l ^ h];
    for (int l = 0; l < SWEEP_SLAB; ++l) k[l] = t[l];
  }
  out[0] = k[0];
  out[1] = k[8];
  out[2] = k[16];
}

// K8's backward: the fused sweep of each grid as the kernel runs it, its
// warps' 32 lanes one after another: each pass loads lane j of warp w
// (slab group w % groups, phase group w / groups) with slab lane j of the
// slabs k0 + group + s groups (DonorGradLane); each staged tile's pair i
// runs the lanes of the warps of phase group i % phase groups, each
// warp's d e totalled as warp_totals3 makes it, the slab groups' in
// order, the passes in order; then each element's d n and d a, the phase
// groups' in order
template <typename T>
static void donor_backward_rows(const T* e, const T* nrm, const T* areas,
                                double c1d, double c2d, const T* g, T* g_e,
                                T* g_nrm, T* g_a, int R, int P, int N,
                                int E) {
  const int Q = E * P, k_all = n_slabs(N), groups = donor_grad_groups(N);
  const int phase_groups = donor_grad_phase_groups(N, Q);
  const int warps = groups * phase_groups;
  const T c1 = T(c1d), c2 = T(c2d);
  std::vector<DonorGradLane<T, K8B_SLABS>> lanes(warps * SWEEP_SLAB);
  std::vector<T> x(3 * SWEEP_SLAB), part(3 * groups);
  for (long long gr = 0; gr < R / E; ++gr) {
    const T* nrm_g = nrm + 3 * gr * N;
    const T* a_g = areas + gr * N;
    for (int k0 = 0; k0 < k_all; k0 += groups * K8B_SLABS) {
      for (int i = 0; i < warps * SWEEP_SLAB; ++i)
        lanes[i].load(nrm_g, a_g, k0 + i / SWEEP_SLAB % groups, groups,
                      k_all, i % SWEEP_SLAB, N);
      for (int i0 = 0; i0 < Q; i0 += K8B_PAIRS) {
        const int m = Q - i0 < K8B_PAIRS ? Q - i0 : K8B_PAIRS;
        for (int i = 0; i < m; ++i) {
          const long long rp = gr * Q + i0 + i;
          DonorGradPair<T> q;
          q.set(e + 3 * rp, g[rp], c1, c2);
          const int pg = i % phase_groups;
          for (int sg = 0; sg < groups; ++sg) {
            for (int j = 0; j < SWEEP_SLAB; ++j)
              lanes[(pg * groups + sg) * SWEEP_SLAB + j].pair(
                  q, x[3 * j], x[3 * j + 1], x[3 * j + 2]);
            lanes_totals3(x, &part[3 * sg]);
          }
          for (int v = 0; v < 3; ++v) {
            T t = part[v];
            for (int sg = 1; sg < groups; ++sg) t = t + part[3 * sg + v];
            g_e[3 * rp + v] = k0 == 0 ? t : g_e[3 * rp + v] + t;
          }
        }
      }
      for (int sg = 0; sg < groups; ++sg)
        for (int j = 0; j < SWEEP_SLAB; ++j) {
          const DonorGradLane<T, K8B_SLABS>& l0 =
              lanes[sg * SWEEP_SLAB + j];
          for (int s = 0; s < l0.ns; ++s) {
            const long long n = (long long)(k0 + sg + s * groups)
                                * SWEEP_SLAB + j;
            if (n >= N) continue;
            T t[4] = {l0.gn0[s], l0.gn1[s], l0.gn2[s], l0.ga[s]};
            for (int pg = 1; pg < phase_groups; ++pg) {
              const DonorGradLane<T, K8B_SLABS>& l =
                  lanes[(pg * groups + sg) * SWEEP_SLAB + j];
              t[0] = t[0] + l.gn0[s];
              t[1] = t[1] + l.gn1[s];
              t[2] = t[2] + l.gn2[s];
              t[3] = t[3] + l.ga[s];
            }
            const long long gn = gr * N + n;
            for (int v = 0; v < 3; ++v) g_nrm[3 * gn + v] = a_g[n] * t[v];
            g_a[gn] = t[3];
          }
        }
    }
  }
}

// the launchers' arguments without the stream
extern "C" int element_curve_host(int is_double, int widths, const void* ph,
                                  const void* wd, const void* pin,
                                  const void* pout, const void* ecl,
                                  const void* w, void* out, int R, int P,
                                  int N) {
  const unsigned char* ec = (const unsigned char*)ecl;
#define K7_HOST(TT, WW)                                                     \
  curve_rows<TT, WW>((const TT*)ph, (const TT*)wd, (const TT*)pin,          \
                     (const TT*)pout, ec, (const TT*)w, (TT*)out, R, P, N)
  if (is_double) {
    if (widths) K7_HOST(double, true); else K7_HOST(double, false);
  } else {
    if (widths) K7_HOST(float, true); else K7_HOST(float, false);
  }
  return 0;
}

extern "C" int element_curve_backward_host(
    int is_double, int widths, const void* ph, const void* wd,
    const void* pin, const void* pout, const void* ecl, const void* w,
    const void* g, void* g_ph, void* g_pin, void* g_pout, void* g_w, int R,
    int P, int N) {
  const unsigned char* ec = (const unsigned char*)ecl;
#define K7B_HOST(TT, WW)                                                    \
  curve_backward_rows<TT, WW>((const TT*)ph, (const TT*)wd,                 \
                              (const TT*)pin, (const TT*)pout, ec,          \
                              (const TT*)w, (const TT*)g, (TT*)g_ph,        \
                              (TT*)g_pin, (TT*)g_pout, (TT*)g_w, R, P, N)
  if (is_double) {
    if (widths) K7B_HOST(double, true); else K7B_HOST(double, false);
  } else {
    if (widths) K7B_HOST(float, true); else K7B_HOST(float, false);
  }
  return 0;
}

extern "C" int donor_sum_host(int is_double, const void* e, const void* nrm,
                              const void* areas, double c1, double c2,
                              void* out, int R, int P, int N, int E) {
  if (is_double)
    donor_rows((const double*)e, (const double*)nrm, (const double*)areas,
               c1, c2, (double*)out, R, P, N, E);
  else
    donor_rows((const float*)e, (const float*)nrm, (const float*)areas, c1,
               c2, (float*)out, R, P, N, E);
  return 0;
}

extern "C" int donor_sum_backward_host(int is_double, const void* e,
                                       const void* nrm, const void* areas,
                                       double c1, double c2, const void* g,
                                       void* g_e, void* g_nrm, void* g_a,
                                       int R, int P, int N, int E) {
  if (is_double)
    donor_backward_rows((const double*)e, (const double*)nrm,
                        (const double*)areas, c1, c2, (const double*)g,
                        (double*)g_e, (double*)g_nrm, (double*)g_a, R, P, N,
                        E);
  else
    donor_backward_rows((const float*)e, (const float*)nrm,
                        (const float*)areas, c1, c2, (const float*)g,
                        (float*)g_e, (float*)g_nrm, (float*)g_a, R, P, N,
                        E);
  return 0;
}

// elementwise, for the tests of the helpers: the floor-form remainder, and
// in rows of out (5, n) autograd's shares of g (clamp_min_grad for a
// through clamp(min=0) into minimum(., b), min_grad_b, clamp_grad of a)
// and the backward's NaN-passing minimum and clamp
template <typename T>
static void helpers(const T* a, const T* b, const T* g, T* out, int n) {
  for (int i = 0; i < n; ++i) {
    const T h = T(0.5) * g[i];
    out[i] = clamp_min_grad(a[i], b[i], g[i], h);
    out[n + i] = min_grad_b(a[i], b[i], g[i], h);
    out[2 * n + i] = clamp_grad(a[i], g[i]);
    out[3 * n + i] = min_nan(a[i], b[i]);
    out[4 * n + i] = max0_nan(a[i]);
  }
}

extern "C" int remainder1_host(int is_double, const void* x, void* out,
                               int n) {
  for (int i = 0; i < n; ++i) {
    if (is_double)
      ((double*)out)[i] = remainder1(((const double*)x)[i]);
    else
      ((float*)out)[i] = remainder1(((const float*)x)[i]);
  }
  return 0;
}

// quot_rcp with the reciprocal rounded once, elementwise
extern "C" int quot_host(int is_double, const void* o, const void* wc,
                         void* out, int n) {
  for (int i = 0; i < n; ++i) {
    if (is_double) {
      const double x = ((const double*)o)[i], y = ((const double*)wc)[i];
      ((double*)out)[i] = quot_rcp(x, y, 1.0 / y);
    } else {
      const float x = ((const float*)o)[i], y = ((const float*)wc)[i];
      ((float*)out)[i] = quot_rcp(x, y, 1.0f / y);
    }
  }
  return 0;
}

extern "C" int rules_host(int is_double, const void* a, const void* b,
                          const void* g, void* out, int n) {
  if (is_double)
    helpers((const double*)a, (const double*)b, (const double*)g,
            (double*)out, n);
  else
    helpers((const float*)a, (const float*)b, (const float*)g, (float*)out,
            n);
  return 0;
}
"""

_HOST_FNS = {"curve": "element_curve_host",
             "curve_backward": "element_curve_backward_host",
             "donor": "donor_sum_host",
             "donor_backward": "donor_sum_backward_host",
             "remainder1": "remainder1_host", "rules": "rules_host",
             "quot": "quot_host"}


def build_source(build, text=None, defines=()):
    """sweeps.cu (or ``text``, an edited copy of it) above its ``// ----
    kernel and launcher`` line, built by g++ in the directory ``build``
    (no contraction, as --fmad=false; ``defines`` as -D flags) with host
    loops in the kernels' place: {launcher name: its host stand-in}, each
    taking the launcher's arguments but the stream."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source's arithmetic")
    (build / "cuda_runtime.h").write_text(_SHIM)
    head, marker, _ = (SOURCE.read_text() if text is None else text
                       ).partition("// ---- kernel and launcher")
    assert marker, "the kernel source lost its marker line"
    (build / "host.cpp").write_text(head + _HOST)
    so = build / "libhost.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                    *(f"-D{d}" for d in defines), "-shared", "-fPIC",
                    f"-I{build}", "-o", str(so), str(build / "host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    types = {"curve": [i, i] + [p] * 7 + [i] * 3,
             "curve_backward": [i, i] + [p] * 11 + [i] * 3,
             "donor": [i] + [p] * 3 + [d, d, p] + [i] * 4,
             "donor_backward": [i] + [p] * 3 + [d, d] + [p] * 4 + [i] * 4,
             "remainder1": [i, p, p, i], "rules": [i] + [p] * 4 + [i],
             "quot": [i] + [p] * 3 + [i]}
    fns = {}
    for name, fn_name in _HOST_FNS.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = types[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture(scope="module")
def source_lib(tmp_path_factory):
    """The source's stand-in as the card builds it."""
    return build_source(tmp_path_factory.mktemp("sweeps_source"))


# the stand-in at another layout: K7 three phases a thread in float32;
# K7's backward one slab a lane and two warps a block (N = 992 in 16
# passes); K8's backward one slab a lane and five warps a block (N = 33: 2
# slab groups x 2 phase groups; N = 384: 5 slab groups in 3 passes)
SMALL_LAYOUT = ("K7_PHASES=3", "K7B_SLABS=1", "K7B_WARPS=2", "K8B_SLABS=1",
                "K8B_WARPS=5")


@pytest.fixture(scope="module")
def small_layout_lib(tmp_path_factory):
    return build_source(tmp_path_factory.mktemp("sweeps_small"),
                        defines=SMALL_LAYOUT)


def host_launch(fns):
    """A stand-in for ``sweeps._launch`` that runs the host loops."""
    def launch(name, ref, *args):
        rc = fns[name](int(ref.dtype == F64), *(
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args))
        assert rc == 0
    return launch


@pytest.fixture
def through_source(source_lib, monkeypatch):
    """The wrappers route CPU tensors as they route CUDA ones, to the
    kernels, whose launcher runs the stand-in; yields the counters'
    starting values."""
    checked = sweeps._checked

    def as_card(*a, **k):
        checked(*a, **k)
        return False

    monkeypatch.setattr(sweeps, "_checked", as_card)
    monkeypatch.setattr(sweeps, "_launch", host_launch(source_lib))
    yield


def _t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def curve_inputs(R, P, N, widths, dtype, seed=0):
    """Rows of contact intervals around the eclipse with the cases the
    kernel must take as the plain version does: non-eclipsed elements (dur
    0), NaN intervals (not eclipsed, and eclipsed), intervals across the
    wrap at 1; phases on each contact, one float either side of them, and
    across the wrap; widths at and below the 1e-12 clamp, and 0."""
    rng = np.random.default_rng(seed)
    pin = rng.uniform(-0.06, 0.04, (R, N))
    pout = pin + rng.uniform(0.0, 0.05, (R, N))
    ecl = rng.uniform(size=(R, N)) < 0.75
    mid = 0.5 * (pin + pout)
    pin = np.where(ecl, pin, mid)
    pout = np.where(ecl, pout, mid)
    if N > 2:
        pin[:, 1], pout[:, 1] = 0.96, 1.02             # across the wrap
        ecl[:, 1] = True
    if N > 3:
        pin[0, 2] = pout[0, 2] = np.nan               # invalid geometry
        ecl[0, 2] = False
    if N > 4 and R > 1:
        pin[1, 3] = np.nan
        ecl[1, 3] = True
    w = rng.uniform(0.0, 1.0, (R, N))
    w /= w.sum(-1, keepdims=True)
    ph = rng.uniform(-0.15, 0.15, (R, P))
    np_dt = np.float64 if dtype == F64 else np.float32
    pin_t, pout_t = pin.astype(np_dt), pout.astype(np_dt)
    # phases exactly on contacts, a float either side, and around the wrap
    k = 0
    for r in range(R):
        for n in range(min(N, 6)):
            for v in (pin_t[r, n], pout_t[r, n]):
                for x in (v, np.nextafter(v, np_dt(-np.inf)),
                          np.nextafter(v, np_dt(np.inf)), v + np_dt(1.0)):
                    if k < P and np.isfinite(x):
                        ph[r, k % P] = x
                        k += 1
        k = 0
    if P > 3:
        ph[:, -1], ph[:, -2] = 0.999, -1.0
    wd = None
    if widths:
        wd = np.full((R, P), 0.3 / 127)
        if P > 4:
            wd[:, 0], wd[:, 1], wd[:, 2] = 1e-12, 1e-13, 0.0
            wd[:, 3] = 0.02
    return (_t(ph, dtype), None if wd is None else _t(wd, dtype),
            _t(pin_t, dtype), _t(pout_t, dtype), torch.tensor(ecl),
            _t(w, dtype))


def donor_inputs(G, E, P, N, dtype, seed=1):
    """Directions to the observer at P phases for E rows of each of G
    grids of N elements: unit normals with some exactly perpendicular to
    a direction (mu exactly 0), some facing away (mu < 0), a zero normal;
    areas of order 1e-3."""
    rng = np.random.default_rng(seed)
    incl = rng.uniform(70.0, 88.0, (G * E, 1))
    ph = rng.uniform(-0.5, 0.5, (G * E, P))
    th = np.deg2rad(incl)
    e = np.stack([np.sin(th) * np.cos(2 * np.pi * ph),
                  -np.sin(th) * np.sin(2 * np.pi * ph),
                  np.cos(th) * np.ones_like(ph)], axis=-1)
    if P > 1:
        e[:, 0] = (0.0, 0.0, 1.0)
    n = rng.standard_normal((G, N, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if N > 3:
        n[:, 0] = (1.0, 0.0, 0.0)          # mu exactly 0 at e = (0, 0, 1)
        n[:, 1] = (0.0, 0.0, -1.0)         # mu < 0 there
        n[:, 2] = 0.0
    a = rng.uniform(1e-4, 3e-3, (G, N))
    return _t(e, dtype), _t(n, dtype), _t(a, dtype)


def same_bits(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


SHAPES = [(1, 1), (31, 128), (32, 257), (33, 128), (992, 128), (992, 1),
          (33, 257)]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
@pytest.mark.parametrize("N,P", SHAPES)
def test_element_curve_source_gives_the_plain_bits(source_lib, dtype,
                                                   widths, N, P):
    R = 3
    args = curve_inputs(R, P, N, widths, dtype)
    want = comp._element_curve_plain(*args)
    got = torch.empty_like(want)
    host_launch(source_lib)("curve", args[0], int(widths), *args, got, R, P,
                            N)
    assert same_bits(got, want)
    if N > 4 and widths:
        assert bool(torch.isnan(want[1]).all())   # the eclipsed NaN row
    assert bool(torch.isfinite(want[2]).all())


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("N,P,E", [(1, 1, 1), (31, 128, 2), (32, 257, 1),
                                   (33, 1, 5), (384, 128, 5), (384, 257, 1),
                                   (384, 1, 5), (33, 31, 2), (384, 32, 1)])
def test_donor_source_gives_the_plain_bits(source_lib, dtype, N, P, E):
    G = 2
    e, n, a = donor_inputs(G, E, P, N, dtype)
    for u in (0.9, 0.37):
        want = comp._donor_sum_plain(e, n, a, u)
        got = torch.empty_like(want)
        host_launch(source_lib)("donor", e, e, n, a,
                                ctypes.c_double(1.0 - u), ctypes.c_double(u),
                                got, G * E, P, N, E)
        assert same_bits(got, want)
        assert bool(torch.isfinite(want).all())


def curve_stress_inputs(P, N, widths, dtype, seed=14):
    """Five rows that the kernel's per-tile paths must take as the plain
    version does, N past one tile of 256 elements (a short last tile):
    row 0 phases several cycles wide, some at integers as are some
    contacts, and intervals across the wrap, some longer than a cycle
    (the floor's path); row 1 phases within a cycle of every contact, d
    exactly -1, -0 and 0 (the comparison's path); row 2 NaN and infinite
    phases, contacts and widths; row 3 contacts and phases below the
    quotient's grain (1e-30, subnormal) and a contact 5 cycles off in the
    second tile only, and widths above the quotient's range at some
    phases, up to where 1 / wc is subnormal, with intervals as long, so
    that one row takes each path in one tile and not in the other; row 4
    row 1 with an infinite weight on an element its phase 0 occults (0 w
    is NaN), and a negative weight in row 3 (0 w is -0)."""
    rng = np.random.default_rng(seed)
    np_dt = np.float64 if dtype == F64 else np.float32
    R = 5
    pin = rng.uniform(-0.5, 0.5, (R, N))
    pout = pin + rng.uniform(0.0, 0.3, (R, N))
    ecl = rng.uniform(size=(R, N)) < 0.8
    ph = np.sort(rng.uniform(-0.2, 0.2, (R, P)), axis=-1)
    ph[0] = np.sort(rng.uniform(-3.5, 3.5, P))
    pout[0, ::7] = pin[0, ::7] + 1.5                  # longer than a cycle
    pin[0, 1::9], pout[0, 1::9] = 0.9, 1.1            # across the wrap
    ints = np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0])
    ph[0, :6] = ints
    pin[0, 2::5] = np.resize(ints, pin[0, 2::5].size)
    near = np.array([-0.5, -0.0, 0.0, 0.25, 0.49])     # d = -1, -0, 0, ...
    ph[1, :P // 2] = np.resize(near, P // 2)
    pin[1, ::3] = np.resize([0.5, 0.0, -0.0, 0.25, -0.25], pin[1, ::3].size)
    pout[1, ::3] = pin[1, ::3] + np.resize([0.0, 0.25, 0.75],
                                           pin[1, ::3].size)
    ph[2, :6] = [np.nan, np.inf, -np.inf, np.nan, 0.5, -0.5]
    pin[2, 3:6] = [np.nan, np.inf, -np.inf]
    pout[2, 3:6] = [0.1, np.inf, 0.2]
    pout[2, 6] = np.nan
    ecl[2, 3:7] = True
    tiny = [1e-30, -1e-30, 1e-44, -1e-44, 3e-39]
    pin[3, 256:256 + 5] = tiny
    pout[3, 256:256 + 5] = np.array(tiny) + np.array([0.0, 1e-30, 0.1,
                                                      1e-44, 0.0])
    ecl[3, 256:256 + 5] = True
    pin[3, 266], pout[3, 266] = 5.0, 5.02           # d < -1 in tile 2
    pin[1, 260], pout[1, 260] = -0.9, -0.6          # d >= 1 in tile 2
    ph[4], pin[4], pout[4], ecl[4] = ph[1], pin[1], pout[1], True
    w = rng.uniform(0.0, 1.0, (R, N))
    w[4, 3], w[3, 290] = np.inf, -0.5               # 0 w is NaN, -0
    big = 3e38 if dtype == F32 else 1e308            # 1 / wc subnormal
    pin[3, 7:9], pout[3, 7:9], ecl[3, 7:9] = 0.0, big, True
    ph[3, :4] = [1e-30, -1e-44, 2.0 ** -60, 0.0]
    wd = None
    if widths:
        wd = rng.uniform(0.0, 0.05, (R, P))
        wd[2, :3] = [np.nan, np.inf, 0.0]
        wd[3, 4:10] = [2.0 ** 60, 3e38, 1e-30, 0.0, np.inf, big]
    return (_t(ph.astype(np_dt), dtype),
            None if wd is None else _t(wd.astype(np_dt), dtype),
            _t(pin.astype(np_dt), dtype), _t(pout.astype(np_dt), dtype),
            torch.tensor(ecl), _t(w, dtype))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
@pytest.mark.parametrize("N,P", [(300, 64), (600, 128)])
def test_element_curve_source_on_the_stress_rows(source_lib, dtype, widths,
                                                 N, P):
    """K7's stand-in on curve_stress_inputs: the plain version's bits
    (signed zeros and infinities included), the same NaN pattern, in both
    dtypes."""
    args = curve_stress_inputs(P, N, widths, dtype)
    want = comp._element_curve_plain(*args)
    got = torch.empty_like(want)
    host_launch(source_lib)("curve", args[0], int(widths), *args, got, 5, P,
                            N)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(_bits(got[ok]), _bits(want[ok]))
    assert bool(torch.isfinite(want[0]).all())
    assert bool(torch.isnan(want[4]).any()) and bool(torch.isinf(want[4]).any())


@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
def test_element_curve_small_layout_gives_the_plain_bits(small_layout_lib,
                                                         widths):
    """K7 built three phases a thread (float32; float64 keeps one): the
    plain version's bits on the stress rows and on rows of 257 phases (a
    short last block)."""
    for dtype in (F32, F64):
        for args, (R, P, N) in (
                (curve_stress_inputs(128, 300, widths, dtype), (5, 128, 300)),
                (curve_inputs(3, 257, 33, widths, dtype), (3, 257, 33))):
            want = comp._element_curve_plain(*args)
            got = torch.empty_like(want)
            host_launch(small_layout_lib)("curve", args[0], int(widths),
                                          *args, got, R, P, N)
            assert same_bits(got, want)


def _quot_pairs(dtype, n, seed=15):
    """(o, wc): n random pairs with wc in [1e-12, its range's top] and o
    in [0, wc] over every exponent down to the subnormals, and edge
    pairs: o = 0, o = wc, mantissas of all ones and of 1, the range's
    ends."""
    rng = np.random.default_rng(seed)
    np_dt, bits = ((np.float64, np.uint64) if dtype == F64
                   else (np.float32, np.uint32))
    fi = np.finfo(np_dt)
    top = 400 if dtype == F64 else 50
    ew = rng.integers(-40, top + 1, n)
    wc = np.ldexp(rng.uniform(1.0, 2.0, n), ew).astype(np_dt)
    eo = ew - rng.integers(0, fi.maxexp - fi.minexp + fi.nmant, n)
    o = np.ldexp(rng.uniform(1.0, 2.0, n), eo).astype(np_dt)
    sub = rng.integers(1, 1 << (fi.nmant - 1), n // 8).astype(bits)
    o[:n // 8] = sub.view(np_dt)                            # subnormal
    ones = (np_dt(2.0) - fi.eps)
    edge_w = np.array([1e-12, np.ldexp(ones, top), np.ldexp(ones, -5),
                       np.ldexp(np_dt(1.0), top), 1.0, 3.0, 0.3 / 127],
                      dtype=np_dt)
    edge_o = np.array([0.0, 1.0, ones, np.ldexp(ones, -20), 2.0 ** -74,
                       np.ldexp(np_dt(1.0), -100), fi.tiny, 1e-13],
                      dtype=np_dt)
    eo_, ew_ = np.meshgrid(edge_o, edge_w)
    o = np.concatenate([o, eo_.ravel(), edge_w])
    wc = np.concatenate([wc, ew_.ravel(), edge_w])
    wc = np.maximum(wc, np_dt(1e-12))
    o = np.minimum(o, wc)
    return torch.tensor(o), torch.tensor(wc)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_the_quotient_by_the_reciprocal_is_the_divide(source_lib, dtype):
    """quot_rcp (the reciprocal of the width and one correction) against
    IEEE division on 10^6 random and edge pairs, subnormal overlaps
    included: the same bits wherever the overlap is 0 or at least 2^-100
    (float32; 2^-900 float64); below, not always, but 1 - the quotient,
    the visibility, has the same bits for every pair."""
    o, wc = _quot_pairs(dtype, 1_000_000)
    got = torch.empty_like(o)
    source_lib["quot"](int(dtype == F64), o.data_ptr(), wc.data_ptr(),
                       got.data_ptr(), o.numel())
    want = o / wc
    low = 2.0 ** (-900 if dtype == F64 else -100)
    in_range = (o == 0) | (o >= low)
    assert int(in_range.sum()) > 600_000 and int((~in_range).sum()) > 100_000
    assert torch.equal(_bits(got[in_range]), _bits(want[in_range]))
    assert not torch.equal(_bits(got[~in_range]), _bits(want[~in_range]))
    assert torch.equal(_bits(1.0 - got), _bits(1.0 - want))


def test_the_slab_sum_is_a_sum():
    """The kernels' order sums what torch.sum sums (float64, to rounding),
    and a slab of zeros changes no bit."""
    rng = np.random.default_rng(2)
    t = torch.tensor(rng.standard_normal((4, 7, 96)))
    np.testing.assert_allclose(comp._slab_sum(t), t.sum(-1), rtol=1e-13)
    padded = torch.cat([t, torch.zeros((4, 7, 32), dtype=F64)], dim=-1)
    assert torch.equal(comp._slab_sum(padded), comp._slab_sum(t))


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
def test_element_curve_plain_matches_jax(dtype, tol, widths):
    """The plain version, row by row, against the JAX package's
    element_flux_curve vmapped over the rows: within tol of the sum of
    |weights| (the eclipsed NaN row apart: NaN in both)."""
    R, P, N = 4, 96, 75
    args = curve_inputs(R, P, N, widths, dtype, seed=3)
    got = comp._element_curve_plain(*args).numpy()
    ph, wd, pin, pout, ecl, w = (None if a is None else jnp.asarray(a.numpy())
                                 for a in args)
    ref = np.asarray(jax.vmap(
        lambda p, d, i, o, c, x: jcomp.element_flux_curve(p, d, (i, o, c), x),
        in_axes=(0, None if wd is None else 0, 0, 0, 0, 0))(
            ph, wd, pin, pout, ecl, w))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    scale = np.abs(args[5].numpy()).sum(-1, keepdims=True)
    err = np.nan_to_num(np.abs(got - ref) / scale)
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-12), (F32, 1e-6)],
                         ids=["f64", "f32"])
def test_donor_sum_plain_matches_jax(dtype, tol):
    """The plain version against the JAX package's donor_flux on each
    row's phases and its grid: within tol of the sum of the areas."""
    G, E, P, N = 3, 2, 40, 96
    rng = np.random.default_rng(4)
    incl = rng.uniform(70.0, 88.0, G * E)
    ph = rng.uniform(-0.5, 0.5, (G * E, P))
    _, n, a = donor_inputs(G, E, P, N, F64, seed=5)
    tincl, tph = torch.tensor(incl, dtype=dtype), torch.tensor(ph, dtype=dtype)
    e = comp.earth_vector(tph, tincl[:, None]).contiguous()
    got = comp._donor_sum_plain(e, n.to(dtype), a.to(dtype), 0.9).numpy()
    ref = np.stack([np.asarray(jcomp.donor_flux(
        jnp.asarray(incl[r]), jnp.asarray(ph[r]),
        jcomp.DonorGrid(jnp.asarray(n[r // E].numpy()),
                        jnp.asarray(n[r // E].numpy()),
                        jnp.asarray(a[r // E].numpy())), 0.9))
        for r in range(G * E)])
    scale = a.numpy().sum(-1).repeat(E)[:, None]
    assert (np.abs(got - ref) / scale).max() <= tol


def _with_ties(args):
    """The widths case's inputs with torch.minimum's arguments tied: dur
    equal to the clamped width (ov_this's tie) and to rel + w - 1's clamp
    at 0 (ov_next's)."""
    ph, wd, pin, pout, ecl, w = (a.clone() if a is not None else None
                                 for a in args)
    wc = torch.clamp(wd[:, 5], min=1e-12)
    pout[:, 5] = pin[:, 5] + wc                       # dur == w
    ecl[:, 5] = True
    pout[:, 6] = pin[:, 6]                            # dur == 0
    ecl[:, 6] = True
    return ph, wd, pin, pout, ecl, w


def _grad_close(got, want, what):
    scale = max(float(torch.nan_to_num(want).abs().max()), 1e-300)
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    err = float(torch.nan_to_num(got - want).abs().max()) / scale
    assert err <= 1e-9, (what, err)


def _curve_backward_host(fns, args, g, widths):
    """The backward stand-in's (d ph, d pin, d pout, d w) on ``args``
    for the cotangent ``g``; without widths the first three None."""
    (R, P), N = args[0].shape, args[2].shape[1]
    got = [None if a is None else torch.empty_like(a)
           for a in (args[0], args[2], args[3], args[5])]
    if not widths:
        got[:3] = [None] * 3
    host_launch(fns)("curve_backward", args[0], int(widths), *args, g, *got,
                     R, P, N)
    return got


def _curve_backward_case(N, P, widths, dtype, seed=6):
    R = 3
    args = curve_inputs(R, P, N, widths, dtype, seed=seed)
    if widths and N > 6:
        args = _with_ties(args)
    g = _t(np.random.default_rng(seed + 1).standard_normal((R, P)), dtype)
    return args, g


@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
@pytest.mark.parametrize("N,P", [(1, 1), (33, 128), (300, 257), (1100, 64)])
def test_element_curve_backward_source_matches_autograd(source_lib, widths,
                                                        N, P):
    """float64: the fused backward stand-in against autograd on the plain
    forward, each cotangent within 1e-9 of its largest |value|; N = 1100
    takes two passes of the card's layout."""
    args, g = _curve_backward_case(N, P, widths, F64)
    want = sweeps._curve_backward_plain(*args, g)
    got = _curve_backward_host(source_lib, args, g, widths)
    for name, a, b in zip(("ph", "pin", "pout", "w"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            _grad_close(a, b, name)


def _f32_gate(k32, p32, p64):
    """PERF.md's float32 gate: each entry within 1e-5 + 2e-3 |g| of plain
    float32, or no farther from plain float64 than plain float32's
    largest distance from it; the same NaN pattern."""
    assert torch.equal(torch.isnan(k32), torch.isnan(p32))
    k32, p32 = torch.nan_to_num(k32), torch.nan_to_num(p32)
    p64 = torch.nan_to_num(p64)
    near = (k32 - p32).abs() <= 1e-5 + 2e-3 * p32.abs()
    lim = float((p32.double() - p64).abs().max())
    return bool((near | ((k32.double() - p64).abs() <= lim)).all())


@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
@pytest.mark.parametrize("N,P", [(33, 128), (300, 257), (992, 128)])
def test_element_curve_backward_source_float32(source_lib, widths, N, P):
    """float32: the fused backward stand-in (one reciprocal of the width a
    phase, its own sum orders) against autograd on the plain forward in
    float32 and float64, at PERF.md's float32 gate."""
    args, g = _curve_backward_case(N, P, widths, F32)
    got = _curve_backward_host(source_lib, args, g, widths)
    p32 = sweeps._curve_backward_plain(*args, g)
    a64 = [a.double() if a is not None and a.is_floating_point() else a
           for a in args]
    p64 = sweeps._curve_backward_plain(*a64, g.double())
    for name, k, a, b in zip(("ph", "pin", "pout", "w"), got, p32, p64):
        assert (k is None) == (a is None), name
        if k is not None:
            assert _f32_gate(k, a, b), name


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_small_layout_gives_the_same_results(small_layout_lib, source_lib,
                                             dtype):
    """The source built at another layout of K7's backward (1 slab a lane,
    2 warps: 16 passes at N = 992): within 1e-9 of autograd in float64
    and at the float32 gate, and the same d pin, d pout, d w bits as the
    card's layout (each element's cotangents sum the same terms in phase
    order; only d ph's order differs)."""
    for widths in (False, True):
        args, g = _curve_backward_case(992, 128, widths, dtype)
        got = _curve_backward_host(small_layout_lib, args, g, widths)
        card = _curve_backward_host(source_lib, args, g, widths)
        want = sweeps._curve_backward_plain(*args, g)
        if dtype == F32:
            a64 = [x.double() if x is not None and x.is_floating_point()
                   else x for x in args]
            want64 = sweeps._curve_backward_plain(*a64, g.double())
        for i, (k, c, p) in enumerate(zip(got, card, want)):
            if k is None:
                continue
            if i > 0:
                assert same_bits(k, c), i
            if dtype == F64:
                _grad_close(k, p, i)
            else:
                assert _f32_gate(k, p, want64[i]), i


def _bits(t):
    return t.view(torch.int64 if t.dtype == F64 else torch.int32)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_the_floor_form_remainder(source_lib, dtype):
    """remainder1 (x - floor(x)) against torch.remainder(x, 1.0): the same
    bits wherever the result is not zero (the same NaN pattern); where it
    is zero, +0, and torch's -0 exactly at -0 and the negative integers."""
    np_dt = np.float64 if dtype == F64 else np.float32
    tiny = np.finfo(np_dt).tiny
    vals = [0.0, -0.0, np.nan, np.inf, -np.inf, tiny, -tiny, tiny / 4,
            -tiny / 4, 1e30, -1e30, 2.0 ** 52, -(2.0 ** 52) - 0.5, 0.5,
            -0.5, 0.999, -0.999]
    for k in range(-4, 5):
        x = np_dt(k)
        vals += [x, np.nextafter(x, np_dt(-np.inf)),
                 np.nextafter(x, np_dt(np.inf))]
    rng = np.random.default_rng(12)
    vals += list(rng.uniform(-5.0, 5.0, 4000)) + list(
        rng.uniform(-1e-6, 1e-6, 1000)) + list(rng.uniform(-1e7, 1e7, 1000))
    x = torch.tensor(np.asarray(vals, dtype=np_dt))
    got = torch.empty_like(x)
    source_lib["remainder1"](int(dtype == F64), x.data_ptr(), got.data_ptr(),
                             x.numel())
    want = torch.remainder(x, 1.0)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    nz = ~torch.isnan(want) & (want != 0)
    assert torch.equal(_bits(got[nz]), _bits(want[nz]))
    zero = want == 0
    assert bool((got[zero] == 0).all()) and not bool(
        torch.signbit(got[zero]).any())
    neg_int = torch.isfinite(x) & (torch.floor(x) == x) & torch.signbit(x)
    assert torch.equal(torch.signbit(want) & zero, neg_int)


def _rules_hold(fns):
    """Whether the stand-in's clamp_min_grad, min_grad_b and clamp_grad
    give autograd's shares for torch.minimum(torch.clamp(a, min=0), b)'s
    a, torch.minimum(a, b)'s b and torch.clamp(a, min=0)'s a, and min_nan
    / max0_nan torch.minimum's / torch.clamp's values, at ties, signed
    zeros, NaN and inf, float64."""
    v = [0.0, -0.0, 1.0, -1.0, 0.25, np.nan, np.inf, -np.inf]
    a, b = (torch.tensor(x, dtype=F64) for x in zip(*[
        (x, y) for x in v for y in v]))
    g = torch.linspace(0.5, 2.0, a.numel(), dtype=F64)
    out = torch.empty((5, a.numel()), dtype=F64)
    fns["rules"](1, a.data_ptr(), b.data_ptr(), g.data_ptr(), out.data_ptr(),
                 a.numel())
    la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
    (gca,) = torch.autograd.grad(
        torch.minimum(torch.clamp(la, min=0.0), b), [la], g)
    (gb,) = torch.autograd.grad(torch.minimum(a, lb), [lb], g)
    lc = a.clone().requires_grad_()
    (gc,) = torch.autograd.grad(torch.clamp(lc, min=0.0), [lc], g)
    return (same_bits(out[0], gca) and same_bits(out[1], gb)
            and same_bits(out[2], gc)
            and same_bits(out[3], torch.minimum(a, b))
            and same_bits(out[4], torch.clamp(a, min=0.0)))


def _rule_inputs():
    """The widths case's inputs (float64) on which each rule of the
    chain's adjoint shows: the ties of _with_ties, NaN intervals, elements
    not eclipsed, and an eclipsed element of zero duration (row 2,
    element 7) at a phase (row 2, phase 3) whose exposure ends just past
    its contact, so that the overlaps' sum is exactly 0 where the clamp's
    inclusive bound passes the gradient on."""
    args, g = _curve_backward_case(33, 128, True, F64)
    ph, wd, pin, pout, ecl, w = args
    pin[2, 7] = pout[2, 7] = 0.1
    ecl[2, 7] = True
    ph[2, 3] = 0.105                         # wd 0.02: rel = 0.995
    return (ph, wd, pin, pout, ecl, w), g


def _chain_holds(fns):
    """Whether the fused backward stand-in is within 1e-9 of autograd on
    the plain forward on _rule_inputs."""
    args, g = _rule_inputs()
    want = sweeps._curve_backward_plain(*args, g)
    got = _curve_backward_host(fns, args, g, True)
    for a, b in zip(got, want):
        scale = max(float(torch.nan_to_num(b).abs().max()), 1e-300)
        if not torch.equal(torch.isnan(a), torch.isnan(b)) or float(
                torch.nan_to_num(a - b).abs().max()) > 1e-9 * scale:
            return False
    return True


def test_the_rules_hold_in_the_source(source_lib):
    assert _rules_hold(source_lib)
    assert _chain_holds(source_lib)


# each autograd rule of the fused chain, broken: (source text, its
# replacement)
MUTATIONS = {
    "clamp_inclusive": ("const bool on = T(0.0) <= v;",
                        "const bool on = T(0.0) < v;"),
    "clamp_nan_passes_nothing": ("const bool on = T(0.0) <= v;",
                                 "const bool on = !(v < T(0.0));"),
    "min_tie_half_a": ("on && v == b ? h : T(0.0)",
                       "on && v == b ? g : T(0.0)"),
    "min_tie_half_b": ("return a == b ? h : (a < b",
                       "return a == b ? g : (a < b"),
    "min_nan_whole_a": ("on && !(v >= b) ? g", "on && v < b ? g"),
    "min_nan_whole_b": ("(a < b ? T(0.0) : g)", "(!(a >= b) ? T(0.0) : g)"),
    "where_false_side": ("const T g_overlap = ecl ? w * gn : T(0.0);",
                         "const T g_overlap = w * gn;"),
    "remainder_passes": ("g_pin = g_pin - (g_rel + g_dur);",
                         "g_pin = g_pin - g_dur;"),
}


@pytest.mark.parametrize("rule", list(MUTATIONS))
def test_a_broken_rule_fails(tmp_path, rule):
    """Each autograd rule that the fused backward keeps (clamp's inclusive
    bound and its NaN, the minimum's halves at a tie and its whole at NaN,
    where's false side, the remainder passing the gradient to phi_in),
    broken in a copy of the source, fails _rules_hold or _chain_holds (the
    minimum's NaN rule only the former: a NaN minimum makes the sum NaN,
    whose clamp passes nothing, so the chain never shows it)."""
    old, new = MUTATIONS[rule]
    text = SOURCE.read_text()
    assert text.count(old) == 1, rule
    fns = build_source(tmp_path, text.replace(old, new))
    assert not (_rules_hold(fns) and _chain_holds(fns))


def test_k7_keeps_its_bits_where_the_remainder_is_a_signed_zero(source_lib):
    """With widths, phases whose hw - phi_in is exactly a negative integer
    (torch.remainder -0, the floor form +0) and 0: K7's stand-in gives
    the plain version's bits, signed zeros included."""
    for dtype in (F32, F64):
        R, P, N = 2, 64, 40
        ph, wd, pin, pout, ecl, w = curve_inputs(R, P, N, True, dtype, seed=13)
        wd[:] = 0.5
        pin[:, :8] = 0.25
        pout[:, :8] = torch.tensor([0.25, 0.3, 0.5, 0.75, 0.25, 0.3, 1.0,
                                    1.5], dtype=dtype)
        ecl[:, :8] = True
        # hw = ph - 0.25: hw - 0.25 = -1, -2, 0, 1, -3
        ph[:, :5] = torch.tensor([-0.5, -1.5, 0.5, 1.5, -2.5], dtype=dtype)
        args = (ph, wd, pin, pout, ecl, w)
        want = comp._element_curve_plain(*args)
        got = torch.empty_like(want)
        host_launch(source_lib)("curve", ph, 1, *args, got, R, P, N)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(_bits(got[ok]), _bits(want[ok]))


def _donor_backward_case(N, P, E, dtype, G=2):
    e, n, a = donor_inputs(G, E, P, N, dtype, seed=8)
    g = _t(np.random.default_rng(9).standard_normal((G * E, P)), dtype)
    return (e, n, a, 0.9, g), G * E


def _donor_backward_host(fns, args, R):
    e, n, a, u, g = args
    (_, P), N = e.shape[:2], a.shape[1]
    got = [torch.empty_like(x) for x in (e, n, a)]
    host_launch(fns)("donor_backward", e, e, n, a,
                     ctypes.c_double(1.0 - u), ctypes.c_double(u), g, *got,
                     R, P, N, R // a.shape[0])
    return got


@pytest.mark.parametrize("N,P,E", [(1, 1, 1), (33, 128, 5), (384, 257, 1),
                                   (384, 1, 5), (992, 128, 5), (96, 257, 5),
                                   (2000, 7, 1), (5, 1, 1)])
def test_donor_backward_source_matches_autograd(source_lib, N, P, E):
    """float64: K8's fused backward stand-in against autograd on the plain
    forward, each cotangent within 1e-9 of its largest |value|; N = 2000
    takes two passes of the card's slab groups, P = 1 is the normaliser."""
    args, R = _donor_backward_case(N, P, E, F64)
    want = sweeps._donor_backward_plain(*args)
    got = _donor_backward_host(source_lib, args, R)
    for name, x, y in zip(("e", "nrm", "areas"), got, want):
        _grad_close(x, y, name)


@pytest.mark.parametrize("N,P,E", [(33, 128, 5), (384, 1, 5), (384, 128, 5),
                                   (992, 257, 1)])
def test_donor_backward_source_float32(source_lib, N, P, E):
    """float32: the fused stand-in (fused products and sums, the area
    taken out of d n, its own sum orders) at PERF.md's float32 gate
    against autograd on the plain forward in float32 and float64."""
    args, R = _donor_backward_case(N, P, E, F32)
    got = _donor_backward_host(source_lib, args, R)
    p32 = sweeps._donor_backward_plain(*args)
    a64 = [x.double() if isinstance(x, torch.Tensor) else x for x in args]
    p64 = sweeps._donor_backward_plain(*a64)
    for name, k, a, b in zip(("e", "nrm", "areas"), got, p32, p64):
        assert _f32_gate(k, a, b), name


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("N,P", [(33, 128), (384, 1), (384, 128)])
def test_donor_backward_small_layout(small_layout_lib, dtype, N, P):
    """K8's backward built at another layout (one slab a lane, five warps:
    phase groups at N = 33, three passes at N = 384): within 1e-9 of
    autograd in float64 and at the float32 gate."""
    args, R = _donor_backward_case(N, P, 5, dtype)
    got = _donor_backward_host(small_layout_lib, args, R)
    want = sweeps._donor_backward_plain(*args)
    if dtype == F64:
        for name, x, y in zip(("e", "nrm", "areas"), got, want):
            _grad_close(x, y, name)
    else:
        a64 = [x.double() if isinstance(x, torch.Tensor) else x
               for x in args]
        want64 = sweeps._donor_backward_plain(*a64)
        for k, a, b in zip(got, want, want64):
            assert _f32_gate(k, a, b)


def _posterior(widths):
    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=24, bands=("g",))
    if widths:
        model = with_calib_widths(model)
    return model.compile()


@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
def test_posterior_through_the_source(through_source, widths):
    """A posterior evaluation and its gradient with the wrappers routed to
    the kernels (the stand-in in the launcher's place): ln p and flux the
    plain path's bits, the gradient within 1e-9 of the largest, in
    float64; K7 and K8 twice an evaluation, their backward kernels twice
    a gradient; and under inference_mode nothing is saved."""
    model = _posterior(widths)
    cfg = CVConfig(n_disc_rad=4, n_disc_az=10, n_spot=8, n_donor_lat=6,
                   n_donor_lon=8)
    start = model.var_start()
    rng = np.random.default_rng(10)
    pos = torch.tensor(start[None] + 1e-3 * np.abs(start)[None]
                       * rng.standard_normal((3, start.size)), dtype=F64)
    lp = make_ln_prob(model, cfg, dtype=F64, device="cpu")
    before = (sweeps.CURVE_LAUNCHES, sweeps.DONOR_LAUNCHES,
              sweeps.CURVE_BACKWARD_LAUNCHES, sweeps.DONOR_BACKWARD_LAUNCHES)
    with torch.inference_mode():
        got = lp(pos), lp.model_flux(pos)
    v, g = lp.value_and_grad(pos)
    after = (sweeps.CURVE_LAUNCHES, sweeps.DONOR_LAUNCHES,
             sweeps.CURVE_BACKWARD_LAUNCHES, sweeps.DONOR_BACKWARD_LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [6, 6, 2, 2]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sweeps, "_checked", lambda *a, **k: True)
        with torch.inference_mode():
            ref = lp(pos), lp.model_flux(pos)
        v_ref, g_ref = lp.value_and_grad(pos)
    assert same_bits(got[0], ref[0]) and same_bits(got[1], ref[1])
    assert same_bits(v, v_ref)
    assert bool(torch.isfinite(g).all())
    scale = float(g_ref.abs().max())
    assert float((g - g_ref).abs().max()) <= 1e-9 * scale


def test_inference_mode_saves_nothing(through_source):
    args = curve_inputs(2, 16, 40, True, F64)
    leaves = [a.clone().requires_grad_() if a is not None and a.is_floating_point()
              and k != 1 else a for k, a in enumerate(args)]
    with torch.inference_mode():
        out = sweeps.element_curve(*leaves)
    assert out.grad_fn is None and not out.requires_grad
    out = sweeps.element_curve(*leaves)
    assert out.grad_fn is not None
    e, n, a = donor_inputs(2, 3, 8, 40, F64)
    with torch.inference_mode():
        d = sweeps.donor_sum(e.requires_grad_(), n, a, 0.9)
    assert d.grad_fn is None


def test_cpu_tensors_launch_nothing():
    before = (sweeps.CURVE_LAUNCHES, sweeps.CURVE_BACKWARD_LAUNCHES,
              sweeps.DONOR_LAUNCHES, sweeps.DONOR_BACKWARD_LAUNCHES)
    args = curve_inputs(2, 16, 40, True, F64)
    g = torch.ones_like(args[0])
    assert same_bits(sweeps.element_curve_kernel(*args),
                     comp._element_curve_plain(*args))
    sweeps.element_curve_backward_kernel(*args, g)
    e, n, a = donor_inputs(2, 3, 8, 40, F64)
    assert same_bits(sweeps.donor_sum_kernel(e, n, a, 0.9),
                     comp._donor_sum_plain(e, n, a, 0.9))
    sweeps.donor_sum_backward_kernel(e, n, a, 0.9, torch.ones((6, 8),
                                                              dtype=F64))
    assert (sweeps.CURVE_LAUNCHES, sweeps.CURVE_BACKWARD_LAUNCHES,
            sweeps.DONOR_LAUNCHES, sweeps.DONOR_BACKWARD_LAUNCHES) == before


def test_wrappers_check_their_inputs():
    ph, wd, pin, pout, ecl, w = curve_inputs(2, 16, 40, True, F64)
    k7 = sweeps.element_curve_kernel
    with pytest.raises(TypeError):
        k7(ph.float(), wd, pin, pout, ecl, w)
    with pytest.raises(TypeError):
        k7(ph, wd, pin, pout, ecl.double(), w)
    with pytest.raises(TypeError):
        k7(ph.half(), wd.half(), pin.half(), pout.half(), ecl, w.half())
    with pytest.raises(ValueError):
        k7(ph, wd, pin[:, :10], pout, ecl, w)
    with pytest.raises(ValueError):
        k7(ph, wd[:1], pin, pout, ecl, w)
    with pytest.raises(ValueError):
        k7(ph.t().contiguous().t(), wd, pin, pout, ecl, w)
    with pytest.raises(ValueError):
        k7(ph[None], wd, pin, pout, ecl, w)
    with pytest.raises(ValueError):
        sweeps.element_curve_backward_kernel(ph, wd, pin, pout, ecl, w,
                                             ph[:, :3].contiguous())
    e, n, a = donor_inputs(2, 3, 8, 40, F64)
    k8 = sweeps.donor_sum_kernel
    with pytest.raises(TypeError):
        k8(e, n, a, torch.tensor(0.9))
    with pytest.raises(ValueError):
        k8(e[:5].contiguous(), n, a, 0.9)       # 5 rows on 2 grids
    with pytest.raises(ValueError):
        k8(e, n[:, :10].contiguous(), a, 0.9)
    with pytest.raises(TypeError):
        k8(e, n.float(), a, 0.9)


def test_the_widths_take_no_gradient():
    args = list(curve_inputs(2, 16, 40, True, F64))
    args[1] = args[1].clone().requires_grad_()
    with pytest.raises(ValueError, match="widths"):
        sweeps.element_curve(*args)
    with torch.no_grad():
        sweeps.element_curve(*args)


def test_donor_flux_takes_a_walkers_grid_once():
    """donor_flux hands K8 a grid a walker once, however many eclipse
    rows share it, and the same curve as the grid copied to every row."""
    rng = np.random.default_rng(11)
    W, E, P, N = 3, 4, 10, 48
    incl = torch.tensor(rng.uniform(70, 88, (W, E)))
    ph = torch.tensor(rng.uniform(-0.5, 0.5, (W, E, P)))
    _, n, a = donor_inputs(W, 1, P, N, F64)
    grid = comp.DonorGrid(n[:, None], n[:, None], a[:, None])
    seen = []

    def spy(e, nrm, areas, u):
        seen.append((tuple(e.shape), tuple(areas.shape)))
        return comp._donor_sum_plain(e, nrm, areas, u)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(sweeps, "donor_sum", spy)
        out = comp.donor_flux(incl, ph, grid)
        full = comp.DonorGrid(*(x.expand(W, E, *x.shape[2:]).contiguous()
                                for x in grid))
        ref = comp.donor_flux(incl, ph, full)
    assert seen[0] == ((W * E, P, 3), (W, N))
    assert seen[1] == ((W * E, P, 3), (W * E, N))
    assert torch.equal(out, ref)
    assert comp._rows_per_grid((W, 1), (W, E)) == E
    assert comp._rows_per_grid((1, E), (W, E)) is None
    assert comp._rows_per_grid((), (W, E)) == W * E
