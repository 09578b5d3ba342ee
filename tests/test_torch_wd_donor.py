"""The donor grid's radius solve K9 and the white dwarf's sweep K10
(``ops/csrc/wd_donor.cu``) on the CPU, against the JAX package and the
port's plain versions.

A CUDA kernel cannot run here, so the kernel source's own arithmetic, the
part above its ``// ---- kernel and launcher`` line, is built by g++
behind a small shim header (``-ffp-contract=off``: no product and sum
contracted, as nvcc's ``--fmad=false``), with host loops in the kernels'
place, and the wrappers of ``ops.wd_donor`` hand it CPU tensors as they
hand the card's (the ``through_source`` fixture).  That stand-in is held
in float64 to the JAX package's ``donor_grid``, ``origin_shadow_distance``
and ``wd_flux`` (1e-12: the two do the same arithmetic, the JAX package
in vmapped scalar form), and in float32 to the port's plain versions
(a few ulps: the CPU's libm and PyTorch's CPU kernels round sin, cos,
acos and rsqrt otherwise than the card, and on the CPU a division by a
Python number is a division, on the card a product by its reciprocal;
equal bits are a card gate, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 24).  K10's index maps (a parameter read in place
per row, per walker, from a strided column, or copied where its layout
cannot be) give the bits of the same inputs broadcast and copied.  The
north-star posterior with the stand-in in the kernels' place is held to
the JAX package's.  Then the routing: CPU tensors run the plain versions
and count no launch; a recorded graph takes the plain chain (and K9
without its grid); the wrappers check their inputs.
"""

import contextlib
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import components as jcomp
from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.convert import from_jax_model
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models import components as comp
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import (make_ln_prob,
                                                     wd_contact_extension)
from lfit_python_tpu_torch.ops import wd_donor
from lfit_python_tpu_torch.roche import geometry as tg

from test_torch_roche_kernels import jax_twin

SOURCE = Path(wd_donor.__file__).resolve().parent / "csrc" / "wd_donor.cu"
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
static inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
static inline double rsqrt(double v) { return 1.0 / std::sqrt(v); }
"""

_HOST = r"""
#include <vector>

// the kernels' blocks one after another, each stretch of a block between
// its barriers over all its threads

template <typename T>
static void donor_blocks_host(const void* const* ptrs,
                              const long long* ints) {
  const DonorArgs<T> a = donor_args<T>(ptrs, ints);
  const DonorShape sh = a.sh;
  Walker<T> wk[DonorSteps<T>::threads / 32];
  for (unsigned b = 0; b < donor_blocks(a.n_walkers, sh); ++b) {
    for (unsigned ty = 0; ty < sh.g; ++ty)
      for (unsigned tx = 0; tx < sh.x; ++tx)
        donor_walkers(a, b, tx, ty, wk);
    for (unsigned ty = 0; ty < sh.g; ++ty)
      for (unsigned tx = 0; tx < sh.x; ++tx)
        donor_dirs(a, tx, [&](unsigned j) { donor_solve(a, b, ty, j, wk); });
  }
}

extern "C" void donor_grid_host(int is_double, const void* const* ptrs,
                                const long long* ints) {
  if (is_double) donor_blocks_host<double>(ptrs, ints);
  else donor_blocks_host<float>(ptrs, ints);
}

template <typename T>
static void wd_blocks_host(int distance, const void* const* ptrs,
                           const long long* ints) {
  const WdArgs<T> a = wd_args<T>(ptrs, ints);
  for (unsigned b = 0; b < wd_blocks(a); ++b)
    for (unsigned t = 0; t < WD_BLOCK; ++t) {
      const WdLane l = wd_lane(a, b, t);
      if (l.row >= a.rows) continue;
      if (distance) wd_row_sweep<true>(a, l.row, l.lane);
      else wd_row_sweep<false>(a, l.row, l.lane);
    }
}

extern "C" void wd_curve_host(int is_double, int distance,
                              const void* const* ptrs,
                              const long long* ints) {
  if (is_double) wd_blocks_host<double>(distance, ptrs, ints);
  else wd_blocks_host<float>(distance, ptrs, ints);
}

// the kernels' maps alone: how often K9's lanes solve and store each
// (walker, direction), and K10's lanes compute each (row, phase)
template <typename T>
static void donor_cover_t(unsigned W, unsigned N, int* counts,
                          unsigned* shape) {
  DonorArgs<T> a;
  a.n_walkers = W;
  a.n_dir = N;
  a.sh = donor_shape(N, DonorSteps<T>::threads);
  shape[0] = a.sh.x;
  shape[1] = a.sh.g;
  shape[2] = donor_blocks(W, a.sh);
  for (unsigned b = 0; b < shape[2]; ++b)
    for (unsigned ty = 0; ty < a.sh.g; ++ty)
      for (unsigned tx = 0; tx < a.sh.x; ++tx) {
        bool real;
        const unsigned w = donor_walker_of(a, b, ty, real);
        donor_dirs(a, tx, [&](unsigned j) {
          if (real) ++counts[(long long)w * N + j];
        });
      }
}

extern "C" void donor_cover(int is_double, long long W, long long N,
                            int* counts, unsigned* shape) {
  if (is_double) donor_cover_t<double>(W, N, counts, shape);
  else donor_cover_t<float>(W, N, counts, shape);
}

template <typename T>
static void wd_cover_t(unsigned rows, unsigned P, int* counts,
                       unsigned* shape) {
  WdArgs<T> a;
  wd_layout(a, rows, P);
  shape[0] = a.lanes;
  shape[1] = wd_blocks(a);
  for (unsigned b = 0; b < wd_blocks(a); ++b)
    for (unsigned t = 0; t < WD_BLOCK; ++t) {
      const WdLane l = wd_lane(a, b, t);
      if (l.row >= a.rows) continue;
      int* c = counts + (long long)l.row * P;
      wd_visit(P, a.lanes, l.lane, [&](unsigned p) { ++c[p]; });
    }
}

extern "C" void wd_cover(int is_double, long long rows, long long P,
                         int* counts, unsigned* shape) {
  if (is_double) wd_cover_t<double>(rows, P, counts, shape);
  else wd_cover_t<float>(rows, P, counts, shape);
}

// n / d by the kernels' multiply-high
extern "C" unsigned fast_div_host(unsigned d, unsigned n) {
  return div_(fast_div(d), n);
}
"""


def build_source(build, defines=()):
    """wd_donor.cu above its ``// ---- kernel and launcher`` line, built by
    g++ in the directory ``build`` (no contraction of products and sums,
    as --fmad=false) with host loops in the kernels' place; ``defines``
    the macros to set (name, value), such as K9's step counts."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source's arithmetic")
    (build / "cuda_runtime.h").write_text(_SHIM)
    head, marker, _ = SOURCE.read_text().partition(
        "// ---- kernel and launcher")
    assert marker, "the kernel source lost its marker line"
    (build / "host.cpp").write_text(head + _HOST)
    so = build / "libhost.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{build}",
                    *(f"-D{k}={v}" for k, v in defines), "-o", str(so),
                    str(build / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    for fn, types in ((lib.donor_grid_host, [i, p, p]),
                      (lib.wd_curve_host, [i, i, p, p]),
                      (lib.donor_cover, [i, ll, ll, p, p]),
                      (lib.wd_cover, [i, ll, ll, p, p])):
        fn.argtypes = types
        fn.restype = None
    lib.fast_div_host.argtypes = [ctypes.c_uint, ctypes.c_uint]
    lib.fast_div_host.restype = ctypes.c_uint
    return lib


@pytest.fixture(scope="module")
def source_lib(tmp_path_factory):
    return build_source(tmp_path_factory.mktemp("wd_donor_source"))


@contextlib.contextmanager
def source_launches(lib):
    """The wrappers of ``ops.wd_donor`` with CPU tensors taken as the
    card's: their checks and index maps, then the arithmetic of ``lib``
    (a :func:`build_source`) by host loops in the launch's place."""
    check = wd_donor._on_cpu

    def host_launch(name, ref, *args):
        getattr(lib, f"{name}_host")(int(ref.dtype == F64), *args)

    with mock.patch.object(wd_donor, "_on_cpu",
                           lambda tag, ts: check(tag, ts) and False), \
            mock.patch.object(wd_donor, "_launch", host_launch):
        yield


@pytest.fixture
def through_source(source_lib):
    """:func:`source_launches` of the source as the card builds it."""
    with source_launches(source_lib):
        yield


@pytest.fixture
def routed(through_source):
    """``through_source``, and the models' CPU tensors routed to the
    kernels as the card's are."""
    with mock.patch.object(tg, "_on_card", lambda t: True):
        yield


def t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


@functools.lru_cache(maxsize=None)
def walkers(n=12, seed=5):
    """q over 0.03-3.5 (and the north star's ~0.1-0.2), x1, pl1, a
    feasible inclination for dphi 0.02-0.09, float64 numpy; the core
    geometry by the port's float64 solves (held to the JAX package's in
    test_torch_geometry.py)."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.uniform(0.03, 3.5, n - 3), [0.03, 0.12, 3.5]])
    dphi = rng.uniform(0.02, 0.09, n)
    tq = t(q)
    x1 = tg.xl1(tq)
    pl1 = tg.l1_potential(tq, x1)
    incl = tg.findi(tq, t(dphi), x1, pl1)
    incl = torch.where(torch.isnan(incl), 89.5, incl)
    return q, x1.numpy(), pl1.numpy(), incl.numpy()


def wd_inputs(dtype, n=12, P=96, seed=5):
    """The white dwarf's per-row parameters (n, 1) and phases (n, P)
    across ingress, egress, mid-eclipse and out of eclipse, with rows at
    inclinations 75-90 deg (some with no occultation at all), a large
    rwd (the inscribed-sphere guard) and a tiny one."""
    q, x1, pl1, incl = (v.copy() for v in walkers(n, seed))
    rng = np.random.default_rng(seed + 1)
    incl[: n // 3] = rng.uniform(75.0, 90.0, n // 3)
    rwd = rng.uniform(0.005, 0.03, n)
    rwd[-1], rwd[-2] = 0.2, 1e-4
    ulimb = rng.uniform(0.1, 0.6, n)
    ph = np.concatenate([np.linspace(-0.12, 0.12, P - 8),
                         [0.0, 0.5, -0.5, 0.25, 1e-7, -1e-7, 0.9, 0.03]])
    ph = ph[None, :] + rng.uniform(-0.002, 0.002, (n, 1))
    r_ins = tg.inscribed_radius(t(q), t(x1), t(pl1)).numpy()
    col = [t(a, dtype)[:, None] for a in (q, incl, rwd, ulimb, x1, pl1,
                                          r_ins)]
    return dict(q=col[0], incl_deg=col[1], phases=t(ph, dtype), rwd=col[2],
                ulimb=col[3], xl1_val=col[4], phi_l1=col[5], r_ins=col[6])


def jax_wd(a, distance=False):
    """The JAX package's wd_flux (or origin_shadow_distance) on
    ``wd_inputs``' rows, float64."""
    rows = [np.asarray(a[k])[:, 0] for k in ("q", "incl_deg", "rwd", "ulimb",
                                              "xl1_val", "phi_l1", "r_ins")]
    ph = np.asarray(a["phases"], dtype=np.float64)
    def one(q, i, r, u, x, p, ri, pp):
        if distance:
            return jg.origin_shadow_distance(q, i, pp, x, p)
        return jcomp.wd_flux(q, i, pp, r, u, x, p, r_ins=ri)

    fn = jax.vmap(one)
    return jax.tree_util.tree_map(np.asarray, fn(*rows, ph))


def same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na], b[~nb]))


def donor_kernel(q, x1, pl1, n_lat, n_lon, grid=True):
    """K9 through its wrapper on (W,) walkers, with the grid's cached
    directions: the grid, or (not ``grid``) the radius and its slope."""
    dirs = comp._directions(n_lat, n_lon, q.dtype, q.device)
    r, slope, out = wd_donor.donor_grid_kernel(q, x1, pl1, *dirs, grid=grid)
    assert (r is None and slope is None) == grid and (out is None) != grid
    return out if grid else (r, slope)


# ---- K9 -----------------------------------------------------------------

class TestDonorGrid:
    def test_against_jax(self, through_source):
        """float64: positions, normals and areas of every walker's grid
        (16 x 24 directions) against the JAX package's donor_grid."""
        q, x1, pl1, _ = walkers()
        grid = donor_kernel(t(q), t(x1), t(pl1), 16, 24)
        r, slope = donor_kernel(t(q), t(x1), t(pl1), 16, 24, grid=False)
        ref = jax.vmap(lambda a, b, c: jcomp.donor_grid(a, b, c, 16, 24))(
            q, x1, pl1)
        for got, want in zip(grid, ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-14)
        assert r.shape == slope.shape == (q.size, 384)
        assert bool((slope > 0).all())

    @pytest.mark.parametrize("dtype,rtol", [(F32, 2e-6), (F64, 1e-13)])
    def test_against_the_plain_loop(self, through_source, dtype, rtol):
        """Against ``_donor_radius_loop`` and ``_donor_grid_plain`` (float32
        at a few ulps: the CPU's rsqrt is not the card's; the radius of a
        bisection step away from the loop's would miss by 2^-8 of rmax).
        The north star's grid at q 0.03-3.5."""
        q, x1, pl1, _ = (t(a, dtype) for a in walkers())
        grid = donor_kernel(q, x1, pl1, 16, 24)
        r, slope = donor_kernel(q, x1, pl1, 16, 24, grid=False)
        dirs = comp._directions(16, 24, dtype, q.device)
        r0, slope0 = comp._donor_radius_loop(q, x1, pl1, *dirs[:3])
        grid0 = comp._donor_grid_plain(r0, (q / (1.0 + q))[:, None], *dirs)
        for got, want in ((r, r0), (slope, slope0), *zip(grid, grid0)):
            assert got.shape == want.shape and got.dtype == dtype
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                       atol=rtol * 1e-3)

    @pytest.mark.parametrize("b32,n32,b64", [(0, 0, 0), (1, 0, 1),
                                             (3, 2, 3), (2, 4, 8)])
    def test_steps_are_the_loops(self, tmp_path, b32, n32, b64):
        """The source built with other step counts (float32 ``b32``
        bisections and ``n32`` Newton steps, float64 ``b64`` bisections)
        against the loop run for as many steps, float32 and float64 (the
        Newton steps' strict bracket test included)."""
        lib = build_source(tmp_path, (("WD_BISECT_F32", b32),
                                      ("WD_NEWTON_F32", n32),
                                      ("WD_BISECT_F64", b64)))
        q, x1, pl1, _ = walkers(6)
        with source_launches(lib), \
                mock.patch.multiple(comp, _DONOR_BISECT_F32=b32,
                                    _DONOR_NEWTON_F32=n32,
                                    _DONOR_BISECT_F64=b64):
            for dtype in (F32, F64):
                a = [t(v, dtype) for v in (q, x1, pl1)]
                dirs = comp._directions(4, 6, dtype, a[0].device)
                got = donor_kernel(*a, 4, 6, grid=False)
                ref = comp._donor_radius_loop(*a, *dirs[:3])
                for g, w in zip(got, ref):
                    np.testing.assert_allclose(g.numpy(), w.numpy(),
                                               rtol=3e-6 if dtype == F32
                                               else 1e-13)

    def test_strided_walkers_are_read_in_place(self, through_source):
        """q, x1, pl1 as columns of a table (stride 7) and as a broadcast
        row (stride 0) give the bits of the same values contiguous."""
        q, x1, pl1, _ = walkers(8)
        table = torch.zeros(8, 7, dtype=F64)
        for k, v in enumerate((q, x1, pl1)):
            table[:, 2 * k] = t(v)
        cols = (table[:, 0], table[:, 2], table[:, 4])
        for grid in (True, False):
            got = donor_kernel(*cols, 4, 6, grid=grid)
            ref = donor_kernel(t(q), t(x1), t(pl1), 4, 6, grid=grid)
            for g, w in zip(got, ref):
                assert same_bits(g, w)
        one = donor_kernel(*(t(v[:1]).expand(8) for v in (q, x1, pl1)), 4, 6,
                           grid=False)
        assert same_bits(one[0], ref[0][:1].expand(8, -1))

    def test_through_donor_grid(self, routed):
        """``components.donor_grid`` on the kernel route: (W, 1) walkers
        as the posterior hands them, the grid the kernel wrote, one launch,
        the same bits as the stand-in called directly."""
        q, x1, pl1, _ = (t(a)[:, None] for a in walkers(6))
        before = wd_donor.DONOR_GRID_LAUNCHES
        grid = comp.donor_grid(q, x1, pl1, 6, 8)
        assert wd_donor.DONOR_GRID_LAUNCHES == before + 1
        ref = donor_kernel(q[:, 0], x1[:, 0], pl1[:, 0], 6, 8)
        assert grid.positions.shape == (6, 1, 48, 3)
        for g, w in zip(grid, ref):
            assert same_bits(g[:, 0], w)

    def test_directions_are_made_once(self):
        """The directions are cached per grid, dtype and device, with the
        bits of the operations that made them a call, usable in a graph
        after an inference-mode call."""
        comp._directions.cache_clear()
        with torch.inference_mode():
            a = comp._directions(6, 8, F32, torch.device("cpu"))
        assert comp._directions(6, 8, F32, torch.device("cpu")) is a
        assert not any(x.is_inference() for x in a)
        th = (torch.arange(6, dtype=F32) + 0.5) / 6 * np.pi
        phl = (torch.arange(8, dtype=F32) + 0.5) / 8 * (2.0 * np.pi)
        TH, PH = torch.meshgrid(th, phl, indexing="ij")
        assert torch.equal(a[0], (torch.sin(TH) * torch.cos(PH)).reshape(-1))
        assert torch.equal(a[2], torch.cos(TH).reshape(-1))
        q = torch.tensor([0.2], dtype=F32, requires_grad=True)
        x1 = tg.xl1(q)
        grid = comp.donor_grid(q, x1, tg.l1_potential(q, x1), 6, 8)
        (g,) = torch.autograd.grad(grid.areas.sum(), q)
        assert torch.isfinite(g).all()


def check_against_plain(a, dtype, atol):
    """K10 (both modes) on the inputs ``a`` against ``_wd_curve_plain``
    and ``_shadow_distance_plain`` at TestWhiteDwarf's
    ``test_against_the_plain_chain`` tolerances."""
    got = wd_donor.wd_curve_kernel(**a)
    ref = comp._wd_curve_plain(**a)
    assert got.dtype == dtype and got.shape == ref.shape
    tol = atol + atol / (2.0 * a["rwd"])
    assert bool(((got - ref).abs() <= tol).all()), float(
        ((got - ref).abs() - tol).max())
    args = (a["q"], a["incl_deg"], a["phases"], a["xl1_val"], a["phi_l1"])
    d, clear = wd_donor.wd_distance_kernel(*args)
    d0, clear0 = tg._shadow_distance_plain(*args)
    rtol = 1e-3 if dtype == F32 else 50 * atol
    np.testing.assert_allclose(clear.numpy(), clear0.numpy(), rtol=rtol,
                               atol=atol)
    # the distance where the curve reads it (test_distance_against_jax)
    used = clear0.numpy() <= 0.25
    np.testing.assert_allclose(d.numpy()[used], d0.numpy()[used],
                               rtol=rtol, atol=atol)


# ---- K10 ----------------------------------------------------------------

class TestWhiteDwarf:
    def test_curve_against_jax(self, through_source):
        """float64: the visible fraction of every row and phase against
        the JAX package's wd_flux (the same -NaN pattern: none)."""
        a = wd_inputs(F64)
        got = wd_donor.wd_curve_kernel(**a).numpy()
        ref = jax_wd(a)
        assert np.isfinite(got).all()
        assert (got < 1e-9).any() and (got == 1.0).any() \
            and ((got > 1e-3) & (got < 0.999)).any()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)

    def test_distance_against_jax(self, through_source):
        a = wd_inputs(F64)
        d, clear = wd_donor.wd_distance_kernel(
            a["q"], a["incl_deg"], a["phases"], a["xl1_val"], a["phi_l1"])
        d_ref, c_ref = jax_wd(a, distance=True)
        # rays that miss the donor: the visible clearance, no NaN
        miss = clear.numpy() == 10.0
        assert miss.any() and np.isfinite(d.numpy()).all()
        np.testing.assert_allclose(clear.numpy(), c_ref, rtol=1e-12,
                                   atol=1e-12)
        # the distance where the curve reads it (clearance <= 0.25): on a
        # ray that misses, the gradient across it may vanish, and the two
        # packages' clamped norms then give different unused quotients
        used = clear.numpy() <= 0.25
        assert used.sum() > 200
        np.testing.assert_allclose(d.numpy()[used], d_ref[used], rtol=1e-11,
                                   atol=1e-11)

    @pytest.mark.parametrize("dtype,atol", [(F32, 2e-6), (F64, 1e-13)])
    def test_against_the_plain_chain(self, through_source, dtype, atol):
        """Against ``_wd_curve_plain`` and ``_shadow_distance_plain`` (the
        CPU's sin, cos, acos and rsqrt are not the card's, and on the CPU
        a division by a Python number is a division): the fraction within
        ``atol`` + ``atol`` / (2 rwd), since near the terminator one
        rounding of the clearance, a difference of two potentials near
        1.5 (a float32 ulp 1.2e-7), moves x = d / rwd by about that over
        |grad| rwd; the clearance and the distance to 50 ``atol``
        relative in float64, 1e-3 in float32: deep in eclipse the ray
        passes near the donor's centre, where the potential dives, and the
        4 clamped Newton steps end at points of another value where an
        early step rounds otherwise (there x is -1 either way); the
        distance where the curve reads it."""
        check_against_plain(wd_inputs(dtype), dtype, atol)

    def test_index_maps_give_the_copies_bits(self, through_source):
        """Each layout of the inputs, read through its index map, gives
        the bits of the same values broadcast and copied: the posterior's
        (W, E, P) phases with (W, E, 1) rows from a strided table and (W,
        1, 1) walkers; (P,) phases shared by every row; a layout that
        cannot be read in place ((W, 1, P) against (1, E, 1)); the
        changepoints' (2, W, E) stack with (W, E) and (W, 1) parameters;
        scalars."""
        W, E, P = 3, 4, 10
        a = wd_inputs(F64, n=W * E, P=P)
        names = ("q", "incl_deg", "rwd", "ulimb", "xl1_val", "phi_l1",
                 "r_ins")
        table = torch.zeros(W, E, 9, dtype=F64)
        for k, n in enumerate(names):
            table[..., k] = a[n][:, 0].reshape(W, E)
        per_row = {n: table[..., k:k + 1] for k, n in enumerate(names)}
        per_walker = {n: per_row[n][:, :1] for n in ("incl_deg", "xl1_val",
                                                     "phi_l1", "r_ins")}
        layouts = [
            {**per_row, **per_walker,
             "phases": a["phases"].reshape(W, E, P)},
            {**per_row, "phases": a["phases"][0]},
            {**{n: v[:, :1] for n, v in per_row.items()},
             "q": per_row["q"][:1, :, 0].reshape(1, E, 1),
             "phases": a["phases"].reshape(W, E, P)[:, :1]},
            {**{n: v[..., 0] for n, v in per_row.items()},
             "incl_deg": per_row["incl_deg"][:, :1, 0],
             "phases": a["phases"][:, :2].T.reshape(2, W, E)},
            {**{n: v[1, 2, 0] for n, v in per_row.items()},
             "phases": a["phases"][0]}]
        for ins in layouts:
            shape = torch.broadcast_shapes(*(v.shape for v in ins.values()))
            copied = {n: v.expand(shape).contiguous() for n, v in ins.items()}
            got = wd_donor.wd_curve_kernel(**ins)
            assert got.shape == shape
            assert same_bits(got, wd_donor.wd_curve_kernel(**copied))
            dist = [n for n in ("q", "incl_deg", "phases", "xl1_val",
                                "phi_l1")]
            d = wd_donor.wd_distance_kernel(*(ins[n] for n in dist))
            d0 = wd_donor.wd_distance_kernel(*(copied[n] for n in dist))
            assert all(same_bits(x, y) for x, y in zip(d, d0))

    def test_index_maps(self):
        """Reading in place: (W, E, 1) rows of a table are (P, 0, 14);
        (W, 1, 1) walkers (E P, 0, stride); (P,) phases (1, P, 1); (2, W, E)
        against (W, E) (1, W E, 1) and (W, 1) (E, W, stride); a scalar
        (1, 0, 0); (W, 1, P) in (W, E, P) is copied."""
        W, E, P = 4, 5, 6
        shape = (W, E, P)
        table = torch.zeros(W, E, 14)
        assert wd_donor._index_map(table[..., 4:5], shape)[1:] == (P, 0, 14)
        w = torch.zeros(W * 3)[::3].reshape(W, 1, 1)
        assert wd_donor._index_map(w, shape)[1:] == (E * P, 0, 3)
        assert wd_donor._index_map(torch.zeros(P), shape)[1:] == (1, P, 1)
        assert wd_donor._index_map(torch.zeros(()), shape)[1:] == (1, 0, 0)
        assert wd_donor._index_map(table[..., 0], (2, W, E))[1:] \
            == (1, W * E, 14)
        assert wd_donor._index_map(table[:, :1, 3], (2, W, E))[1:] \
            == (E, W, 14 * E)
        x = torch.arange(W * P, dtype=F32).reshape(W, 1, P)
        copy, *m = wd_donor._index_map(x, shape)
        assert m == [1, 0, 1] and copy.is_contiguous() \
            and torch.equal(copy, x.expand(shape))

    def test_through_wd_flux_and_the_changepoints(self, routed):
        """``wd_flux`` and ``wd_contact_extension`` on the kernel route:
        one K10 launch for the curve, one a Newton step for the
        changepoints (two), results of the plain chain's tolerance."""
        a = wd_inputs(F64)
        before = wd_donor.WD_LAUNCHES
        got = comp.wd_flux(**a)
        assert wd_donor.WD_LAUNCHES == before + 1
        np.testing.assert_allclose(got.numpy(), comp._wd_curve_plain(
            **a).numpy(), atol=1e-13, rtol=0)
        # (W, E) = (3, 4) rows, the inclination and the L1 terms (W, 1)
        q, x1, pl1, incl = (t(v).reshape(3, 4) for v in walkers())
        dphi = t(np.random.default_rng(3).uniform(0.02, 0.09, 12))
        args = (q, incl[:, :1], dphi.reshape(3, 4),
                t(np.full((3, 4), 0.015)), x1[:, :1], pl1[:, :1])
        ext = wd_contact_extension(*args)
        assert wd_donor.WD_LAUNCHES == before + 3
        with mock.patch.object(tg, "_on_card", lambda t: False):
            ref = wd_contact_extension(*args)
        np.testing.assert_allclose(ext.numpy(), ref.numpy(), atol=1e-12)


# ---- the kernels' maps from their threads to solves and points ---------

# row lengths: fewer phases than a warp, a warp's, between, the north
# star's 128 and around it, and the widths' P * n_sub (128 x 3)
PHASES = (1, 2, 5, 31, 32, 33, 127, 128, 129, 384)
# donor grids (n_lat, n_lon): the north star's 384 directions, fewer than
# a block, a few, more than a block's chunk
GRIDS = ((16, 24), (6, 8), (5, 7), (3, 3), (32, 48))


def cover(lib, fn, is_double, n_outer, n_inner):
    """The counts of the stand-in's map ``fn`` (``donor_cover``,
    ``wd_cover``) over (n_outer, n_inner) solves or points, and the
    launch shape it reports."""
    counts = np.zeros((n_outer, n_inner), dtype=np.int32)
    shape = np.zeros(3, dtype=np.uint32)
    getattr(lib, fn)(int(is_double), n_outer, n_inner,
                     counts.ctypes.data, shape.ctypes.data)
    return counts, shape


class TestLayouts:
    @pytest.mark.parametrize("dtype", [F32, F64])
    @pytest.mark.parametrize("P", PHASES)
    def test_k10_map_covers_each_point_once(self, source_lib, P, dtype):
        """K10's map from (block, thread) to a row and its phases computes
        every point of rows x P exactly once, for row counts that are not
        a multiple of a block's rows; a row's lanes are 32 from 32 phases
        on, else the least power of two that holds it."""
        lanes = 32 if P >= 32 else 1 << (P - 1).bit_length()
        for rows in (1, 7, 130, 1023):
            counts, shape = cover(source_lib, "wd_cover", dtype == F64,
                                  rows, P)
            assert (counts == 1).all(), (rows, np.unique(counts))
            assert shape[0] == lanes
            assert shape[1] == -(-rows * lanes // 128)

    @pytest.mark.parametrize("dtype", [F32, F64])
    @pytest.mark.parametrize("grid", GRIDS)
    def test_k9_map_covers_each_solve_once(self, source_lib, grid, dtype):
        """K9's walker blocks solve and store every (walker, direction)
        exactly once, for walker counts that are not a multiple of a
        block's walkers; at the north star's 384 directions a block is one
        walker of 384 lanes (1024 walkers: 1024 blocks)."""
        N = grid[0] * grid[1]
        threads = 384
        for W in (1, 5, 1023):
            counts, shape = cover(source_lib, "donor_cover", dtype == F64,
                                  W, N)
            assert (counts == 1).all(), (W, np.unique(counts))
            x, g, blocks = (int(v) for v in shape[:3])
            assert x % 32 == 0 and x * g <= threads
            assert blocks == -(-W // g)
            if N == 384:
                assert (x, g, blocks) == (threads, 1, W)

    def test_fast_division(self, source_lib):
        """The index maps' n / d by multiply-high and shift, for divisors
        and numerators up to 2^30."""
        rng = np.random.default_rng(11)
        ds = np.r_[1, 2, 3, 5, 7, 24, 128, 384, 5120, 2 ** 30,
                   rng.integers(1, 2 ** 30, 40)]
        ns = np.r_[0, 1, 2 ** 30, 2 ** 30 - 1, rng.integers(0, 2 ** 30, 40)]
        for d in ds:
            for n in np.r_[ns, d - 1, d, d + 1, 3 * d - 1]:
                if 0 <= n <= 2 ** 30:
                    assert source_lib.fast_div_host(int(d), int(n)) \
                        == int(n) // int(d), (d, n)

    @pytest.mark.parametrize("dtype,atol", [(F32, 2e-6), (F64, 1e-13)])
    @pytest.mark.parametrize("P", PHASES)
    def test_k10_row_lengths_against_the_plain_chain(self, through_source,
                                                     P, dtype, atol):
        """K10's source through its row prologue and point body at each
        row length (5 rows, the first P of wd_inputs' phases), both
        modes, against the plain chains at test_against_the_plain_chain's
        tolerances."""
        a = wd_inputs(dtype, n=5, P=max(P, 8))
        a["phases"] = a["phases"][:, :P].contiguous()
        check_against_plain(a, dtype, atol)

    @pytest.mark.parametrize("dtype,rtol", [(F32, 2e-6), (F64, 1e-13)])
    @pytest.mark.parametrize("grid", GRIDS[1:])
    def test_k9_grids_against_the_plain_loop(self, through_source, grid,
                                             dtype, rtol):
        """K9's source at odd grids (13 walkers) against the plain loop
        and grid at test_against_the_plain_loop's tolerances."""
        q, x1, pl1, _ = (t(a, dtype) for a in walkers(13))
        out = donor_kernel(q, x1, pl1, *grid)
        r, slope = donor_kernel(q, x1, pl1, *grid, grid=False)
        dirs = comp._directions(*grid, dtype, q.device)
        r0, slope0 = comp._donor_radius_loop(q, x1, pl1, *dirs[:3])
        grid0 = comp._donor_grid_plain(r0, (q / (1.0 + q))[:, None], *dirs)
        for got, want in ((r, r0), (slope, slope0), *zip(out, grid0)):
            assert got.shape == want.shape and got.dtype == dtype
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                       atol=rtol * 1e-3)


# ---- the posterior with the stand-in in the kernels' place -------------

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)


def test_posterior_through_the_source_matches_jax(routed):
    """The north-star posterior cut to size (5 eclipses, 2 bands, 16
    points an eclipse, 6 walkers; one walker with an infeasible dphi) in
    float64 with K9 and K10 in their plain versions' place, against the
    JAX package's posterior: the same -inf pattern, ln p within 1e-9
    relative (test_torch_posterior.py's tolerance); each kernel launched
    once; and against the port's own plain chains."""
    spec = build_model(n_eclipses=5, complex_spot=[False] * 5, n_points=16,
                       bands=("g", "r"))
    jm = jax_twin(spec)
    jlp = jax.jit(jax.vmap(jmake(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, **TINY))))
    lp = make_ln_prob(from_jax_model(jm), CVConfig(**TINY), device="cpu")
    start = jm.var_start()
    rng = np.random.default_rng(2)
    pos = start[None] + 0.001 * np.abs(start)[None] * rng.standard_normal(
        (6, start.size))
    names = jm.var_names()
    pos[-1, names.index("q_core")] = 0.04
    pos[-1, names.index("dphi_core")] = 0.19
    p = torch.tensor(pos, dtype=F64)
    before = (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES)
    got = lp(p).numpy()
    assert (wd_donor.DONOR_GRID_LAUNCHES - before[0],
            wd_donor.WD_LAUNCHES - before[1]) == (1, 1)
    ref = np.asarray(jlp(pos))
    with mock.patch.object(tg, "_on_card", lambda t: False):
        plain = lp(p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(got[:-1]).all() and not np.isfinite(got[-1])
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-9)
    np.testing.assert_allclose(got[ok], plain[ok], rtol=1e-12)


# ---- routing ------------------------------------------------------------

class TestRouting:
    def test_cpu_tensors_run_the_plain_versions(self):
        """No launch counted: the models' CPU tensors take the plain
        chains, and the wrappers on CPU tensors run the plain versions."""
        before = (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES)
        a = wd_inputs(F32)
        assert same_bits(comp.wd_flux(**a), comp._wd_curve_plain(**a))
        assert same_bits(wd_donor.wd_curve_kernel(**a),
                         comp._wd_curve_plain(**a))
        args = (a["q"], a["incl_deg"], a["phases"], a["xl1_val"],
                a["phi_l1"])
        for x, y in zip(wd_donor.wd_distance_kernel(*args),
                        tg._shadow_distance_plain(*args)):
            assert same_bits(x, y)
        q, x1, pl1 = (v[:, 0] for v in (a["q"], a["xl1_val"], a["phi_l1"]))
        grid = donor_kernel(q, x1, pl1, 6, 8)
        ref = comp.donor_grid(q, x1, pl1, 6, 8)
        assert all(same_bits(g, w) for g, w in zip(grid, ref))
        dirs = comp._directions(6, 8, q.dtype, q.device)
        for g, w in zip(donor_kernel(q, x1, pl1, 6, 8, grid=False),
                        comp._donor_radius_loop(q, x1, pl1, *dirs[:3])):
            assert same_bits(g, w)
        assert (wd_donor.DONOR_GRID_LAUNCHES,
                wd_donor.WD_LAUNCHES) == before

    def test_a_recorded_graph_takes_the_plain_chain(self, routed):
        """With a gradient recorded, wd_flux and origin_shadow_distance
        launch nothing and autograd runs through the plain chain (the
        gradient of the CPU's); donor_grid launches K9 for the radius and
        its slope alone and attaches the IFT tangent: the gradient of the
        plain loop's."""
        a = wd_inputs(F64)
        before = (wd_donor.DONOR_GRID_LAUNCHES, wd_donor.WD_LAUNCHES)
        leaf = a["q"].clone().requires_grad_()
        y = comp.wd_flux(**{**a, "q": leaf})
        (g,) = torch.autograd.grad(y.sum(), leaf)
        d, _ = tg.origin_shadow_distance(leaf, a["incl_deg"], a["phases"],
                                         a["xl1_val"], a["phi_l1"])
        assert d.requires_grad
        assert wd_donor.WD_LAUNCHES == before[1]
        with mock.patch.object(tg, "_on_card", lambda t: False):
            y0 = comp.wd_flux(**{**a, "q": leaf})
            (g0,) = torch.autograd.grad(y0.sum(), leaf)
        assert same_bits(y, y0) and same_bits(g, g0)
        # (W, 1) walkers, as the posterior hands them
        q = t(walkers(4)[0])[:, None].requires_grad_()

        def areas():
            x1 = tg.xl1(q)
            grid = comp.donor_grid(q, x1, tg.l1_potential(q, x1), 6, 8)
            assert grid.areas.shape == (4, 1, 48)
            return grid.areas, torch.autograd.grad(grid.areas.sum(), q)[0]

        grid_areas, gk = areas()
        assert wd_donor.DONOR_GRID_LAUNCHES == before[0] + 1
        with mock.patch.object(tg, "_on_card", lambda t: False):
            plain_areas, gp = areas()
        np.testing.assert_allclose(grid_areas.detach().numpy(),
                                   plain_areas.detach().numpy(), rtol=1e-13)
        np.testing.assert_allclose(gk.numpy(), gp.numpy(), rtol=1e-10)

    def test_precise_takes_the_plain_chain(self, routed):
        a = wd_inputs(F32)
        before = wd_donor.WD_LAUNCHES
        precise = tuple(a[n].double() for n in ("q", "incl_deg", "xl1_val",
                                                "phi_l1"))
        got = comp.wd_flux(**a, precise=precise)
        assert wd_donor.WD_LAUNCHES == before
        assert same_bits(got, comp._wd_curve_plain(**a, precise=precise))

    def test_a_python_number_off_the_cpu_raises(self, routed):
        """Off the CPU a Python number among wd_flux's or
        origin_shadow_distance's arguments reaches K10's wrapper, which
        raises: no plain chain runs on the card in its place."""
        a = wd_inputs(F32, n=4, P=8)
        before = wd_donor.WD_LAUNCHES
        with pytest.raises(TypeError, match="ulimb is not a tensor"):
            comp.wd_flux(**{**a, "ulimb": 0.3})
        with pytest.raises(TypeError, match="q is not a tensor"):
            tg.origin_shadow_distance(0.2, a["incl_deg"], a["phases"],
                                      a["xl1_val"], a["phi_l1"])
        assert wd_donor.WD_LAUNCHES == before

    def test_wrappers_check_their_inputs(self):
        a = wd_inputs(F64, n=4, P=8)
        with pytest.raises(TypeError):
            wd_donor.wd_curve_kernel(**{**a, "rwd": a["rwd"].float()})
        with pytest.raises(TypeError):
            wd_donor.wd_curve_kernel(**{**a, "ulimb": 0.3})
        with pytest.raises(TypeError):
            wd_donor.wd_distance_kernel(
                a["q"].half(), a["incl_deg"].half(), a["phases"].half(),
                a["xl1_val"].half(), a["phi_l1"].half())
        with pytest.raises(ValueError):
            wd_donor.wd_curve_kernel(**{n: v.to("meta")
                                        for n, v in a.items()})
        q, x1, pl1 = (v[:, 0] for v in (a["q"], a["xl1_val"], a["phi_l1"]))
        dirs = comp._directions(4, 6, F64, q.device)
        with pytest.raises(ValueError):
            wd_donor.donor_grid_kernel(q[:, None], x1, pl1, *dirs)
        with pytest.raises(ValueError):
            wd_donor.donor_grid_kernel(q, x1[:3], pl1, *dirs)
        with pytest.raises(ValueError):
            wd_donor.donor_grid_kernel(q, x1, pl1, dirs[0][::2], *dirs[1:])
        with pytest.raises(TypeError):
            wd_donor.donor_grid_kernel(q.float(), x1, pl1, *dirs)

    def test_other_devices_reach_the_wrappers(self):
        """Off the CPU each model call is one wrapper call (meta tensors
        stand in for the card's here, which the wrappers refuse)."""
        a = wd_inputs(F32, n=4, P=8)
        meta = {n: v.to("meta") for n, v in a.items()}
        with pytest.raises(ValueError, match="runs on CUDA"):
            comp.wd_flux(**meta)
        with pytest.raises(ValueError, match="runs on CUDA"):
            tg.origin_shadow_distance(meta["q"], meta["incl_deg"],
                                      meta["phases"], meta["xl1_val"],
                                      meta["phi_l1"])
        with pytest.raises(ValueError, match="runs on CUDA"):
            comp.donor_grid(meta["q"], meta["xl1_val"], meta["phi_l1"], 4, 6)
