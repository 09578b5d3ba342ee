"""The flux curves' sweep kernels K7 (the element curve) and K8 (the
donor sum) and their backward kernels (``ops/csrc/sweeps.cu``) on the
CPU, against their plain versions, autograd and the JAX package.

A CUDA kernel cannot run here, so the kernel source's own arithmetic, the
part above its ``// ---- kernel and launcher`` line, is built by g++
behind a small shim header (``-ffp-contract=off``: no product and sum
contracted, as nvcc's ``--fmad=false``), with host loops in the kernels'
place: each row's elements (and, for a backward's element sweep, its
phases) staged whole, the sums in the kernels' order.  The forward
stand-ins give the plain versions' bits in float32 and float64 on inputs
with NaN intervals, non-eclipsed elements, phases on and across the
contacts and the wrap at 1, widths at and below the 1e-12 clamp, mu
exactly 0 and negative, at N = 1, 31, 32, 33, 384, 992 and P = 1, 128,
257.  The plain versions are held to the JAX package's
``element_flux_curve`` and ``donor_flux`` (vmapped over rows): float64
within 1e-12 and float32 within 1e-6 of the sum of |weights|.  The
backward stand-ins are held to autograd on the plain forward in float64
(1e-9 of the largest |gradient|), with ties of torch.minimum's arguments
among the inputs.  Then the ``autograd.Function``s with the stand-in in
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
#include <vector>

// K7: each row's elements staged whole, then every phase over all slabs
template <typename T, bool W>
static void curve_rows(const T* ph, const T* wd, const T* pin,
                       const T* pout, const unsigned char* ecl, const T* w,
                       T* out, int R, int P, int N) {
  const int K = n_slabs(N), M = K * SWEEP_SLAB;
  std::vector<T> a(M), b(M), c(M);
  std::vector<unsigned char> d(M);
  const CurveElems<T> s = {a.data(), b.data(), c.data(), d.data()};
  for (long long r = 0; r < R; ++r) {
    for (int i = 0; i < M; ++i)
      s.stage(i, pin + r * N, pout + r * N, ecl + r * N, w + r * N, i, N);
    for (int p = 0; p < P; ++p) {
      CurvePhase<T, W> q;
      q.set(ph[r * P + p], W ? wd[r * P + p] : T(0.0));
      Slabs<T> acc;
      acc.init();
      curve_slabs(acc, q, s, 0, K);
      out[r * P + p] = acc.total();
    }
  }
}

// K7's backward: the phase sweep (widths) and the element sweep of each
// row, its elements and phases staged whole
template <typename T, bool W>
static void curve_backward_rows(const T* ph, const T* wd, const T* pin,
                                const T* pout, const unsigned char* ecl,
                                const T* w, const T* g, T* g_ph, T* g_pin,
                                T* g_pout, T* g_w, int R, int P, int N) {
  const int K = n_slabs(N), M = K * SWEEP_SLAB;
  std::vector<T> a(M), b(M), c(M), e(P), f(P), h(P), k(P);
  std::vector<unsigned char> d(M);
  const CurveElems<T> s = {a.data(), b.data(), c.data(), d.data()};
  const CurvePhases<T> ps = {e.data(), f.data(), h.data(), k.data()};
  for (long long r = 0; r < R; ++r) {
    for (int i = 0; i < M; ++i)
      s.stage(i, pin + r * N, pout + r * N, ecl + r * N, w + r * N, i, N);
    for (int p = 0; p < P; ++p)
      ps.template stage<W>(p, ph + r * P, W ? wd + r * P : nullptr,
                           g + r * P, p);
    if (W) {
      for (int p = 0; p < P; ++p) {
        CurvePhase<T, true> q;
        q.set(ph[r * P + p], wd[r * P + p]);
        Slabs<T> acc;
        acc.init();
        curve_grad_phase(acc, q, g[r * P + p], s, 0, K);
        g_ph[r * P + p] = acc.total();
      }
    }
    for (int n = 0; n < N; ++n) {
      const long long i = r * N + n;
      T gi = T(0.0), go = T(0.0), gw = T(0.0);
      curve_grad_elem<T, W>(gi, go, gw, pin[i], pout[i] - pin[i], ecl[i],
                            w[i], ps, 0, P);
      g_w[i] = gw;
      if (W) {
        g_pin[i] = gi;
        g_pout[i] = go;
      }
    }
  }
}

// K8: each grid's elements staged whole, then every row that shares it
template <typename T>
static void donor_rows(const T* e, const T* nrm, const T* areas, double c1,
                       double c2, T* out, int R, int P, int N, int E) {
  const int K = n_slabs(N), M = K * SWEEP_SLAB;
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

// K8's backward: each grid's rows' phase sweep, then its element sweep
// over the rows in order
template <typename T>
static void donor_backward_rows(const T* e, const T* nrm, const T* areas,
                                double c1, double c2, const T* g, T* g_e,
                                T* g_nrm, T* g_a, int R, int P, int N,
                                int E) {
  std::vector<T> a(N + 1), b(N + 1), c(N + 1), d(N + 1), u(P), v(P), x(P),
      y(P);
  const DonorElems<T> s = {a.data(), b.data(), c.data(), d.data()};
  const DonorPhases<T> ps = {u.data(), v.data(), x.data(), y.data()};
  for (long long gr = 0; gr < R / E; ++gr) {
    for (int i = 0; i < N; ++i)
      s.stage(i, nrm + 3 * gr * N, areas + gr * N, i, N);
    for (long long r = gr * E; r < (gr + 1) * E; ++r)
      for (int p = 0; p < P; ++p) {
        const long long rp = r * P + p;
        T g0 = T(0.0), g1 = T(0.0), g2 = T(0.0);
        donor_grad_phase(g0, g1, g2, e[3 * rp], e[3 * rp + 1],
                         e[3 * rp + 2], g[rp], s, T(c1), T(c2), 0, N);
        g_e[3 * rp] = g0;
        g_e[3 * rp + 1] = g1;
        g_e[3 * rp + 2] = g2;
      }
    for (int n = 0; n < N; ++n) {
      T g0 = T(0.0), g1 = T(0.0), g2 = T(0.0), ga = T(0.0);
      for (long long r = gr * E; r < (gr + 1) * E; ++r) {
        for (int p = 0; p < P; ++p)
          ps.stage(p, e + 3 * r * P, g + r * P, p);
        donor_grad_elem(g0, g1, g2, ga, s.n0[n], s.n1[n], s.n2[n], s.a[n],
                        ps, T(c1), T(c2), 0, P);
      }
      const long long gn = gr * N + n;
      g_nrm[3 * gn] = g0;
      g_nrm[3 * gn + 1] = g1;
      g_nrm[3 * gn + 2] = g2;
      g_a[gn] = ga;
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
"""

_HOST_FNS = {"curve": "element_curve_host",
             "curve_backward": "element_curve_backward_host",
             "donor": "donor_sum_host",
             "donor_backward": "donor_sum_backward_host"}


@pytest.fixture(scope="module")
def source_lib(tmp_path_factory):
    """sweeps.cu above its ``// ---- kernel and launcher`` line, built by
    g++ (no contraction, as --fmad=false) with host loops in the kernels'
    place: {launcher name: its host stand-in}, each taking the launcher's
    arguments but the stream."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source's arithmetic")
    build = tmp_path_factory.mktemp("sweeps_source")
    (build / "cuda_runtime.h").write_text(_SHIM)
    head, marker, _ = SOURCE.read_text().partition(
        "// ---- kernel and launcher")
    assert marker, "the kernel source lost its marker line"
    (build / "host.cpp").write_text(head + _HOST)
    so = build / "libhost.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{build}", "-o", str(so),
                    str(build / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    types = {"curve": [i, i] + [p] * 7 + [i] * 3,
             "curve_backward": [i, i] + [p] * 11 + [i] * 3,
             "donor": [i] + [p] * 3 + [d, d, p] + [i] * 4,
             "donor_backward": [i] + [p] * 3 + [d, d] + [p] * 4 + [i] * 4}
    fns = {}
    for name, fn_name in _HOST_FNS.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = types[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
                                   (384, 1, 5)])
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


@pytest.mark.parametrize("widths", [False, True], ids=["instant", "widths"])
@pytest.mark.parametrize("N,P", [(1, 1), (33, 128), (300, 257)])
def test_element_curve_backward_source_matches_autograd(source_lib, widths,
                                                        N, P):
    """float64: the backward stand-in against autograd on the plain
    forward, each cotangent within 1e-9 of its largest |value|."""
    R = 3
    args = curve_inputs(R, P, N, widths, F64, seed=6)
    if widths and N > 6:
        args = _with_ties(args)
    g = _t(np.random.default_rng(7).standard_normal((R, P)), F64)
    want = sweeps._curve_backward_plain(*args, g)
    got = [None if a is None else torch.empty_like(a)
           for a in (args[0], args[2], args[3], args[5])]
    if not widths:
        got[:3] = [None] * 3
    host_launch(source_lib)("curve_backward", args[0], int(widths), *args, g,
                            *got, R, P, N)
    for name, a, b in zip(("ph", "pin", "pout", "w"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            _grad_close(a, b, name)


@pytest.mark.parametrize("N,P,E", [(1, 1, 1), (33, 128, 5), (384, 257, 1),
                                   (384, 1, 5)])
def test_donor_backward_source_matches_autograd(source_lib, N, P, E):
    G = 2
    e, n, a = donor_inputs(G, E, P, N, F64, seed=8)
    g = _t(np.random.default_rng(9).standard_normal((G * E, P)), F64)
    want = sweeps._donor_backward_plain(e, n, a, 0.9, g)
    got = [torch.empty_like(x) for x in (e, n, a)]
    host_launch(source_lib)("donor_backward", e, e, n, a,
                            ctypes.c_double(1.0 - 0.9), ctypes.c_double(0.9),
                            g, *got, G * E, P, N, E)
    for name, x, y in zip(("e", "nrm", "areas"), got, want):
        _grad_close(x, y, name)


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
