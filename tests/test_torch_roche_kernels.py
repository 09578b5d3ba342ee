"""The core geometry's bisection kernels K4-K6 (``ops/csrc/roche.cu``) on
the CPU, against their plain loops and the JAX package.

A CUDA kernel cannot run here, so the kernel source's own arithmetic, the
part above its ``// ---- kernel and launcher`` line, is built by g++
behind a small shim header (``-ffp-contract=off``: no product and sum
contracted, as nvcc's ``--fmad=false``), with host loops in the kernels'
place.  That stand-in is compared with the JAX package's ``findi``,
``xl1``, ``inscribed_radius`` and ``lobe_radius`` in float64 (the tests of
``test_torch_geometry.py``'s tolerances) and with the port's plain loops
in float32 (1e-5 relative: the CPU's libm and PyTorch's CPU kernels round
sin, cos and rsqrt otherwise than the card, which is why equal bits are a
card gate, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 22).
The whole posterior with the stand-in in the loops' place is held to the
JAX package's.  Then the routing: CPU tensors run the loops and count no
launch; the wrappers check their inputs.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import priors as jpr
from lfit_python_tpu.models import tree as jtree
from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.convert import from_jax_model
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models import components as comp
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import roche
from lfit_python_tpu_torch.roche import geometry as tg

SOURCE = Path(roche.__file__).resolve().parent / "csrc" / "roche.cu"

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline __attribute__((always_inline))
#define __launch_bounds__(...)
static inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
static inline double rsqrt(double v) { return 1.0 / std::sqrt(v); }
"""

_HOST = r"""
// a group of 2^D lanes, one lane after another: ballot(vote) sets bit l of
// the round's mask to lane l's vote, as __ballot_sync does on the card
template <int D> struct HostGroup {
  template <typename Vote> unsigned operator()(Vote vote) const {
    unsigned mask = 0;
    for (unsigned lane = 0; lane < (1u << D); ++lane)
      mask |= unsigned(vote(lane)) << lane;
    return mask;
  }
};

template <int D, typename T>
static void findi_rows(const T* q, const T* hw, const T* x1, const T* pl1,
                       T* out, int n, int iters) {
  for (int i = 0; i < n; ++i)
    out[i] = findi_solve<D>(q[i], hw[i], x1[i], pl1[i], iters,
                            HostGroup<D>());
}

template <int D, typename T>
static void xl1_rows(const T* q, T* out, int n, int iters) {
  for (int i = 0; i < n; ++i)
    out[i] = xl1_solve<D>(q[i], iters, HostGroup<D>());
}

template <int D, typename T>
static void lobe_rows(const T* q, const T* x1, const T* pl1, const T* dx,
                      const T* dy, const T* dz, T* out, int n, int iters) {
  for (int i = 0; i < n; ++i)
    out[i] = lobe_solve<D>(q[i], x1[i], pl1[i], dx[i], dy[i], dz[i], iters,
                           HostGroup<D>());
}

template <int D>
static void findi_typed(int is_double, const void* q, const void* hw,
                        const void* x1, const void* pl1, void* out, int n,
                        int iters) {
  if (is_double)
    findi_rows<D>((const double*)q, (const double*)hw, (const double*)x1,
                  (const double*)pl1, (double*)out, n, iters);
  else
    findi_rows<D>((const float*)q, (const float*)hw, (const float*)x1,
                  (const float*)pl1, (float*)out, n, iters);
}

template <int D>
static void xl1_typed(int is_double, const void* q, void* out, int n,
                      int iters) {
  if (is_double)
    xl1_rows<D>((const double*)q, (double*)out, n, iters);
  else
    xl1_rows<D>((const float*)q, (float*)out, n, iters);
}

template <int D>
static void lobe_typed(int is_double, const void* q, const void* x1,
                       const void* pl1, const void* dx, const void* dy,
                       const void* dz, void* out, int n, int iters) {
  if (is_double)
    lobe_rows<D>((const double*)q, (const double*)x1, (const double*)pl1,
                 (const double*)dx, (const double*)dy, (const double*)dz,
                 (double*)out, n, iters);
  else
    lobe_rows<D>((const float*)q, (const float*)x1, (const float*)pl1,
                 (const float*)dx, (const float*)dy, (const float*)dz,
                 (float*)out, n, iters);
}

// K4-K6 in groups of 2^depth lanes, depth 1 (the loop itself) to 5
extern "C" void findi_host_at(int depth, int is_double, const void* q,
                              const void* hw, const void* x1,
                              const void* pl1, void* out, int n, int iters) {
  switch (depth) {
    case 1: findi_typed<1>(is_double, q, hw, x1, pl1, out, n, iters); break;
    case 2: findi_typed<2>(is_double, q, hw, x1, pl1, out, n, iters); break;
    case 3: findi_typed<3>(is_double, q, hw, x1, pl1, out, n, iters); break;
    case 4: findi_typed<4>(is_double, q, hw, x1, pl1, out, n, iters); break;
    case 5: findi_typed<5>(is_double, q, hw, x1, pl1, out, n, iters); break;
  }
}

extern "C" void xl1_host_at(int depth, int is_double, const void* q,
                            void* out, int n, int iters) {
  switch (depth) {
    case 1: xl1_typed<1>(is_double, q, out, n, iters); break;
    case 2: xl1_typed<2>(is_double, q, out, n, iters); break;
    case 3: xl1_typed<3>(is_double, q, out, n, iters); break;
    case 4: xl1_typed<4>(is_double, q, out, n, iters); break;
    case 5: xl1_typed<5>(is_double, q, out, n, iters); break;
  }
}

extern "C" void lobe_radius_host_at(int depth, int is_double, const void* q,
                                    const void* x1, const void* pl1,
                                    const void* dx, const void* dy,
                                    const void* dz, void* out, int n,
                                    int iters) {
  switch (depth) {
    case 1: lobe_typed<1>(is_double, q, x1, pl1, dx, dy, dz, out, n, iters); break;
    case 2: lobe_typed<2>(is_double, q, x1, pl1, dx, dy, dz, out, n, iters); break;
    case 3: lobe_typed<3>(is_double, q, x1, pl1, dx, dy, dz, out, n, iters); break;
    case 4: lobe_typed<4>(is_double, q, x1, pl1, dx, dy, dz, out, n, iters); break;
    case 5: lobe_typed<5>(is_double, q, x1, pl1, dx, dy, dz, out, n, iters); break;
  }
}

// at the depth the card's launchers take
extern "C" void findi_host(int is_double, const void* q, const void* hw,
                           const void* x1, const void* pl1, void* out, int n,
                           int iters) {
  findi_host_at(FINDI_DEPTH, is_double, q, hw, x1, pl1, out, n, iters);
}

extern "C" void xl1_host(int is_double, const void* q, void* out, int n,
                         int iters) {
  xl1_host_at(XL1_DEPTH, is_double, q, out, n, iters);
}

extern "C" void lobe_radius_host(int is_double, const void* q,
                                 const void* x1, const void* pl1,
                                 const void* dx, const void* dy,
                                 const void* dz, void* out, int n,
                                 int iters) {
  lobe_radius_host_at(LOBE_DEPTH, is_double, q, x1, pl1, dx, dy, dz, out, n,
                      iters);
}

extern "C" int findi_depth_host(void) { return FINDI_DEPTH; }
extern "C" int xl1_depth_host(void) { return XL1_DEPTH; }
extern "C" int lobe_radius_depth_host(void) { return LOBE_DEPTH; }
"""


def build_source(build, defines=()):
    """roche.cu above its ``// ---- kernel and launcher`` line, built by g++
    in the directory ``build`` (no contraction of products and sums, as
    --fmad=false) with host loops in the kernels' place, and the macros
    ``defines`` ("NAME=value") set as nvcc's -D sets them."""
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
                    *(f"-D{d}" for d in defines), "-o", str(so),
                    str(build / "host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn, n_in in ((lib.findi_host, 4), (lib.xl1_host, 1),
                     (lib.lobe_radius_host, 6)):
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (n_in + 1)
                       + [ctypes.c_int] * 2)
        fn.restype = None
    for fn, n_in in ((lib.findi_host_at, 4), (lib.xl1_host_at, 1),
                     (lib.lobe_radius_host_at, 6)):
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * (n_in + 1)
                       + [ctypes.c_int] * 2)
        fn.restype = None
    return lib


@pytest.fixture(scope="module")
def source_lib(tmp_path_factory):
    """roche.cu's arithmetic with host loops, at the card's depths."""
    return build_source(tmp_path_factory.mktemp("roche_source"))


def stand_in(lib, name, iters, depth=None):
    """A function of broadcastable CPU tensors that runs the source's
    solve ``name`` on them, as ``geometry._solve`` hands a kernel its
    arguments: broadcast to one contiguous shape.  K4 and K6 run at the
    card's group depth, or in groups of 2^``depth`` lanes."""
    fn = getattr(lib, f"{name}_host" if depth is None else f"{name}_host_at")
    pre = () if depth is None else (depth,)

    def run(*args):
        shape = torch.broadcast_shapes(*(a.shape for a in args))
        ts = [a.expand(shape).contiguous() for a in args]
        out = torch.empty(shape, dtype=ts[0].dtype)
        fn(*pre, int(out.dtype == torch.float64),
           *(t.data_ptr() for t in ts), out.data_ptr(), out.numel(), iters)
        return out
    return run


@pytest.fixture(scope="module")
def solves(source_lib):
    return {"findi": stand_in(source_lib, "findi", tg._FINDI_ITERS),
            "xl1": stand_in(source_lib, "xl1", tg._XL1_ITERS),
            "lobe": stand_in(source_lib, "lobe_radius", tg._LOBE_ITERS)}


def draws(dtype):
    """test_torch_geometry.py's draws (q 0.05-1.5, dphi 0.02-0.09), then
    infeasible pairs (q 0.05, dphi 0.2) and a NaN q."""
    rng = np.random.default_rng(11)
    q = np.concatenate([rng.uniform(0.05, 1.5, 24), [0.05, 0.05, np.nan]])
    dphi = np.concatenate([rng.uniform(0.02, 0.09, 24), [0.2, 0.25, 0.04]])
    return (torch.tensor(q, dtype=dtype), torch.tensor(dphi, dtype=dtype))


def directions(n, seed=3):
    """Unit directions from the donor's centre, the pole first."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d[0] = (0.0, 0.0, 1.0)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def same_nan_then_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=rtol, atol=0)


def geometry_inputs(q, dphi):
    """(q, dphi / 2, x1, pl1) as findi hands its loop."""
    x1 = tg.xl1(q)
    return q, 0.5 * dphi, x1, tg.l1_potential(q, x1)


class TestAgainstJax:
    """The stand-in in float64 against the JAX package."""

    def test_findi(self, solves):
        q, dphi = draws(torch.float64)
        got = solves["findi"](*geometry_inputs(q, dphi)).numpy()
        ref = np.asarray(jax.vmap(jg.findi)(q.numpy(), dphi.numpy()))
        assert np.isnan(got[-3:]).all() and (~np.isnan(got)).sum() > 12
        same_nan_then_close(got, ref, 1e-10)

    def test_xl1(self, solves):
        q, _ = draws(torch.float64)
        got = solves["xl1"](q).numpy()
        ref = np.asarray(jax.vmap(jg.xl1)(q.numpy()))
        assert not np.isnan(got).any()      # a NaN q ends at the bracket
        same_nan_then_close(got, ref, 1e-12)

    def test_inscribed_radius(self, solves):
        q, _ = draws(torch.float64)
        x1 = tg.xl1(q)
        pl1 = tg.l1_potential(q, x1)
        zero, one = torch.zeros(()), torch.ones(())
        got = 0.995 * solves["lobe"](q, x1, pl1, zero.double(),
                                     zero.double(), one.double())
        ref = np.asarray(jax.vmap(jg.inscribed_radius)(q.numpy()))
        same_nan_then_close(got.numpy(), ref, 1e-12)

    @pytest.mark.parametrize("k", range(4))
    def test_lobe_radius_along_a_direction(self, solves, k):
        q, _ = draws(torch.float64)
        d = directions(4)[k]
        x1 = tg.xl1(q)
        pl1 = tg.l1_potential(q, x1)
        dt = [torch.tensor(c, dtype=torch.float64) for c in d]
        got = solves["lobe"](q, x1, pl1, *dt).numpy()
        ref = np.asarray(jax.vmap(lambda qq: jg.lobe_radius(
            qq, jax.numpy.asarray(d)))(q.numpy()))
        same_nan_then_close(got, ref, 1e-12)


class TestAgainstPlainLoops:
    """The stand-in against the port's plain loops: float32 at 1e-5
    relative, float64 at the JAX tests' tolerances; the same NaN
    pattern in both."""

    @pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                            (torch.float64, 1e-10)])
    def test_findi(self, solves, dtype, rtol):
        args = geometry_inputs(*draws(dtype))
        same_nan_then_close(solves["findi"](*args), tg._findi_loop(*args),
                            rtol)

    @pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                            (torch.float64, 1e-12)])
    def test_xl1(self, solves, dtype, rtol):
        q, _ = draws(dtype)
        same_nan_then_close(solves["xl1"](q), tg._xl1_loop(q), rtol)

    @pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                            (torch.float64, 1e-12)])
    def test_lobe_radius(self, solves, dtype, rtol):
        q, _ = draws(dtype)
        x1 = tg.xl1(q)
        pl1 = tg.l1_potential(q, x1)
        d = torch.tensor(directions(8), dtype=dtype)
        # every walker along every direction: (W, 8)
        args = (q[:, None], x1[:, None], pl1[:, None], d[:, 0], d[:, 1],
                d[:, 2])
        got, ref = solves["lobe"](*args), tg._lobe_loop(*args)
        assert got.shape == ref.shape == (q.numel(), 8)
        same_nan_then_close(got, ref, rtol)

    def test_a_stress_set(self, solves):
        """512 solves over q 0.03-3, dphi 0.005-0.15, float32."""
        rng = np.random.default_rng(5)
        q = torch.tensor(rng.uniform(0.03, 3.0, 512), dtype=torch.float32)
        dphi = torch.tensor(rng.uniform(0.005, 0.15, 512),
                            dtype=torch.float32)
        args = geometry_inputs(q, dphi)
        got, ref = solves["findi"](*args), tg._findi_loop(*args)
        assert 0 < int(torch.isnan(ref).sum()) < 512
        same_nan_then_close(got, ref, 1e-5)


# ---- the k-section schedule: every group depth gives the loop's bits ----

# iteration counts around the depths: none, fewer than a round, whole
# rounds, a short last round, and the solves' own 54 and 64
SCHEDULE_ITERS = (0, 1, 4, 5, 6, 9, 54, 64)
# xl1's q beyond the draws' (which hold a NaN): q <= 0 (mu = -inf at q =
# -1), a large and a tiny q, and inf (mu NaN)
XL1_EXTREMES = (0.0, -0.3, -1.0, -2.5, 1e3, 1e-7, np.inf)


def schedule_inputs(dtype, n=4096):
    """draws() and n random solves (q 0.03-3, dphi 0.005-0.15): {name:
    arguments} of findi, of xl1 (with XL1_EXTREMES) and of lobe_radius
    along random unit directions, half of them the pole."""
    q0, dphi0 = draws(dtype)
    rng = np.random.default_rng(17)
    q = torch.cat([q0, torch.tensor(rng.uniform(0.03, 3.0, n), dtype=dtype)])
    dphi = torch.cat([dphi0, torch.tensor(rng.uniform(0.005, 0.15, n),
                                          dtype=dtype)])
    d = directions(q.numel(), seed=19)
    d[: q.numel() // 2] = (0.0, 0.0, 1.0)
    d = torch.tensor(d, dtype=dtype)
    q_, hw, x1, pl1 = geometry_inputs(q, dphi)
    return {"findi": (q_, hw, x1, pl1),
            "xl1": (torch.cat([q, torch.tensor(XL1_EXTREMES, dtype=dtype)]),),
            "lobe_radius": (q, x1, pl1, d[:, 0], d[:, 1], d[:, 2])}


def same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na], b[~nb]))


class TestSchedule:
    """The source's K4-K6 with a group of 2^d lanes emulated by a host
    loop over its lanes (the mask filled lane by lane, then the walk):
    each depth d = 2 .. 5 against d = 1, the loop itself operation for
    operation, bit for bit, over draws(), 4096 random solves, the
    infeasible pairs and the NaN q, at iteration counts that end on a
    whole round, in a short one and before the first; K5 at every depth
    against the plain loop itself at every step count."""

    @pytest.mark.parametrize("depth", [2, 3, 4, 5])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("name", ["findi", "xl1", "lobe_radius"])
    def test_depth_gives_the_loops_bits(self, source_lib, name, dtype,
                                        depth):
        args = schedule_inputs(dtype)[name]
        for iters in SCHEDULE_ITERS:
            got = stand_in(source_lib, name, iters, depth)(*args)
            ref = stand_in(source_lib, name, iters, 1)(*args)
            assert same_bits(got, ref), (name, depth, iters)
        if name == "findi":
            assert bool(torch.isnan(got[24:27]).all())
            assert int(torch.isnan(got).sum()) < got.numel() // 2

    @pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_xl1_gives_the_plain_loops_bits(self, source_lib, dtype, depth):
        """K5 at each depth against ``_xl1_loop`` itself, bit for bit (its
        test is four operators and a compare, rounded alike by g++ and by
        PyTorch's CPU kernels), at every step count 0-64: in float32 the
        bracket reaches adjacent floats after ~25 steps, and the steps
        after it still move lo and hi by the loop's selects."""
        q, = schedule_inputs(dtype)["xl1"]
        for iters in range(tg._XL1_ITERS + 1):
            with mock.patch.object(tg, "_XL1_ITERS", iters):
                ref = tg._xl1_loop(q)
            got = stand_in(source_lib, "xl1", iters, depth)(q)
            assert same_bits(got, ref), (depth, iters)

    @pytest.mark.parametrize("name", ["findi", "xl1", "lobe_radius"])
    def test_iteration_counts_against_the_plain_loops(self, source_lib,
                                                      name):
        """The card's depth at each iteration count against the plain
        loop run for as many steps (float64, the JAX tests' tolerance):
        the rounds take exactly ``iters`` steps."""
        args = schedule_inputs(torch.float64, n=256)[name]
        loop = {"findi": tg._findi_loop, "xl1": tg._xl1_loop,
                "lobe_radius": tg._lobe_loop}[name]
        attr = {"findi": "_FINDI_ITERS", "xl1": "_XL1_ITERS",
                "lobe_radius": "_LOBE_ITERS"}[name]
        for iters in SCHEDULE_ITERS:
            with mock.patch.object(tg, attr, iters):
                ref = loop(*args)
            same_nan_then_close(stand_in(source_lib, name, iters)(*args),
                                ref, 1e-10)

    @pytest.mark.parametrize("name", ["findi", "xl1", "lobe_radius"])
    def test_depth_is_set_when_the_source_is_built(self, source_lib,
                                                   tmp_path, name):
        """The card's depths are among those held to the loop above, and
        a build that sets them (-D, as tools/torch_roche_depths.py builds
        the depths not kept) runs its kernels at the depth it set, with
        the loop's bits."""
        assert 2 <= source_lib.findi_depth_host() <= 5
        assert 2 <= source_lib.xl1_depth_host() <= 5
        assert 2 <= source_lib.lobe_radius_depth_host() <= 5
        depth = {"findi": 3, "xl1": 3, "lobe_radius": 4}[name]
        lib = build_source(tmp_path, (f"FINDI_DEPTH={depth}",
                                      f"XL1_DEPTH={depth}",
                                      f"LOBE_DEPTH={depth}"))
        assert getattr(lib, f"{name}_depth_host")() == depth
        args = schedule_inputs(torch.float32, n=512)[name]
        for iters in (6, 54):
            assert same_bits(stand_in(lib, name, iters)(*args),
                             stand_in(source_lib, name, iters, 1)(*args))


# ---- the posterior with the stand-in in the loops' place ---------------

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)


def jax_twin(spec):
    """The JAX package's compiled model of the port's model tree."""
    def par(p):
        return jpr.Param(p.name, p.start, jpr.Prior(
            p.prior.type, p.prior.p1, p.prior.p2), p.is_var, p.scatter)

    ecl = [jtree.EclipseSpec(
        e.name, e.band, jtree.Lightcurve(
            e.lightcurve.phase, e.lightcurve.flux, e.lightcurve.err,
            e.lightcurve.width, e.lightcurve.name),
        {k: par(v) for k, v in e.params.items()}, e.complex_spot, e.use_gp)
        for e in spec.eclipses]
    return jtree.HierarchicalModel(
        {k: par(v) for k, v in spec.core.items()},
        {b: {k: par(v) for k, v in d.items()} for b, d in spec.bands.items()},
        ecl).compile()


def test_posterior_through_the_source_matches_jax(solves):
    """The float64 posterior (one simple-spot eclipse, 16 points, 6
    walkers; one walker with an infeasible dphi) with the three loops
    replaced by the stand-in, against the JAX package's posterior: the
    same -inf pattern, ln p within 1e-9 relative (the tolerance of
    test_torch_posterior.py); and against the port's own plain loops."""
    spec = build_model(n_eclipses=1, complex_spot=[False], n_points=16,
                       bands=("g",))
    jm = jax_twin(spec)
    jlp = jax.jit(jax.vmap(jmake(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, **TINY))))
    lp = make_ln_prob(from_jax_model(jm), CVConfig(**TINY), device="cpu")
    start = jm.var_start()
    rng = np.random.default_rng(2)
    pos = start[None] + 0.001 * np.abs(start)[None] * rng.standard_normal(
        (6, start.size))
    names = jm.var_names()
    # inside the prior, but no inclination gives an eclipse that wide
    pos[-1, names.index("q_core")] = 0.04
    pos[-1, names.index("dphi_core")] = 0.19
    p = torch.tensor(pos, dtype=torch.float64)
    calls = {}

    def counted(name):
        def run(*args):
            calls[name] = calls.get(name, 0) + 1
            return solves[name](*args)
        return run

    with mock.patch.object(tg, "_findi_loop", counted("findi")), \
            mock.patch.object(tg, "_xl1_loop", counted("xl1")), \
            mock.patch.object(tg, "_lobe_loop", counted("lobe")):
        got = lp(p).numpy()
    assert calls["findi"] == calls["xl1"] == 1 and calls["lobe"] >= 1
    ref = np.asarray(jlp(pos))
    plain = lp(p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(got[:-1]).all() and not np.isfinite(got[-1])
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-9)
    np.testing.assert_allclose(got[ok], plain[ok], rtol=1e-9)


@pytest.mark.parametrize("mode", ["float64", "float32", "precise"])
def test_the_inscribed_radius_is_solved_once_a_walker(mode):
    """One forward evaluation (ln p, and the model flux) solves the
    inscribed radius (K6 along the pole) once, at one solve a walker, and
    the prior alone never; its ln p and fluxes are the bits of an
    evaluation in which the white dwarf's guard and the contact solve
    each solve their own radius at (walker, eclipse), as they did before
    the posterior shared one (whose solve then goes unused).  Two
    eclipses (one complex spot), 16 points, 5 walkers, one infeasible;
    float64, float32 and float32 in mixed precision."""
    model = build_model(n_eclipses=2, complex_spot=[False, True],
                        n_points=16, bands=("g",)).compile()
    dtype = torch.float64 if mode == "float64" else torch.float32
    post = make_ln_prob(model, CVConfig(mixed_precision=mode == "precise",
                                        **TINY), dtype=dtype, device="cpu")
    start = model.var_start()
    rng = np.random.default_rng(4)
    pos = start[None] + 0.001 * np.abs(start)[None] * rng.standard_normal(
        (5, start.size))
    names = model.var_names()
    pos[-1, names.index("q_core")] = 0.04
    pos[-1, names.index("dphi_core")] = 0.19
    p = torch.tensor(pos, dtype=dtype)
    loop, solves = tg._lobe_loop, []

    def counted(q, x1, pl1, dx, dy, dz):
        if bool((dx == 0).all() & (dy == 0).all() & (dz == 1).all()):
            solves.append(tuple(torch.broadcast_shapes(
                q.shape, x1.shape, pl1.shape, dx.shape, dy.shape,
                dz.shape)))
        return loop(q, x1, pl1, dx, dy, dz)

    def own_radius(fn):
        def run(*args, **kw):
            kw.pop("r_ins", None)
            return fn(*args, **kw)
        return run

    with mock.patch.object(tg, "_lobe_loop", counted):
        post.ln_prior(p)
        assert solves == []
        got = (post(p), post.model_flux(p))
        assert solves == [(5, 1)] * 2
        solves.clear()
        with mock.patch.object(comp, "wd_flux", own_radius(comp.wd_flux)), \
                mock.patch.object(comp, "element_intervals",
                                  own_radius(comp.element_intervals)):
            ref = (post(p), post.model_flux(p))
        assert sorted(solves) == sorted([(5, 1), (5, 2), (5, 2, 1)] * 2)
    assert torch.isfinite(got[0][:-1]).all() and got[0][-1] == -np.inf
    for a, b in zip(got, ref):
        assert a.shape == b.shape and same_bits(a, b)


# ---- routing ---------------------------------------------------------

class TestRouting:
    def test_cpu_tensors_run_the_loops(self):
        q, dphi = draws(torch.float64)
        before = (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES,
                  roche.LOBE_LAUNCHES)
        x1 = tg.xl1(q)
        assert torch.equal(x1, tg._xl1_loop(q))
        pl1 = tg.l1_potential(q, x1)
        i = tg.findi(q, dphi, x1, pl1)
        ref = tg._findi_loop(q, 0.5 * dphi, x1, pl1)
        assert torch.equal(torch.isnan(i), torch.isnan(ref))
        assert torch.equal(i[~torch.isnan(i)], ref[~torch.isnan(ref)])
        pole = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
        r = tg.inscribed_radius(q, x1, pl1)
        rr = 0.995 * tg._lobe_loop(q, x1, pl1, *pole)
        ok = ~torch.isnan(rr)
        assert torch.equal(r[ok], rr[ok])
        assert (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES,
                roche.LOBE_LAUNCHES) == before

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_wrappers_take_the_loops_on_the_cpu(self, dtype):
        q, dphi = draws(dtype)
        args = geometry_inputs(q, dphi)
        before = (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES,
                  roche.LOBE_LAUNCHES)
        got = roche.findi_kernel(*args)
        ref = tg._findi_loop(*args)
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(got.nan_to_num(), ref.nan_to_num())
        assert torch.equal(roche.xl1_kernel(q).nan_to_num(),
                           tg._xl1_loop(q).nan_to_num())
        d = [torch.full_like(q, c) for c in (0.0, 0.6, 0.8)]
        assert torch.equal(
            roche.lobe_radius_kernel(q, args[2], args[3], *d).nan_to_num(),
            tg._lobe_loop(q, args[2], args[3], *d).nan_to_num())
        assert (roche.FINDI_LAUNCHES, roche.XL1_LAUNCHES,
                roche.LOBE_LAUNCHES) == before

    def test_wrappers_check_their_inputs(self):
        q = torch.linspace(0.1, 1.0, 8, dtype=torch.float64)
        with pytest.raises(TypeError):
            roche.xl1_kernel(q.float().to(torch.float16))
        with pytest.raises(TypeError):
            roche.findi_kernel(q, q.float(), q, q)
        with pytest.raises(ValueError):
            roche.findi_kernel(q, q[:4], q, q)
        with pytest.raises(ValueError):
            roche.lobe_radius_kernel(q, q, q, q, q, torch.stack([q, q])[:, 0])
        with pytest.raises(ValueError):
            roche.xl1_kernel(torch.stack([q, q], dim=1)[:, 0])
        with pytest.raises(ValueError):
            roche.xl1_kernel(q.to("meta"))

    def test_other_devices_reach_the_wrapper_broadcast(self):
        """Off the CPU each solve is one wrapper call on its arguments
        broadcast to one contiguous shape (meta tensors stand in for the
        card's here)."""
        seen = {}

        def record(name):
            def run(*args):
                seen[name] = [(tuple(a.shape), a.is_contiguous(), a.device)
                              for a in args]
                return torch.empty_like(args[0])
            return run

        q = torch.empty(6, 1, dtype=torch.float32, device="meta")
        dphi = torch.empty(6, 1, dtype=torch.float32, device="meta")
        x1 = torch.empty(1, 4, dtype=torch.float32, device="meta")
        with mock.patch.object(roche, "findi_kernel", record("findi")), \
                mock.patch.object(roche, "xl1_kernel", record("xl1")), \
                mock.patch.object(roche, "lobe_radius_kernel",
                                  record("lobe")):
            assert tg.xl1(q).shape == (6, 1)
            assert tg.findi(q, dphi, x1, x1).shape == (6, 4)
            assert tg.inscribed_radius(q, x1, x1).shape == (6, 4)
        assert seen["xl1"] == [((6, 1), True, q.device)]
        assert seen["findi"] == [((6, 4), True, q.device)] * 4
        assert seen["lobe"] == [((6, 4), True, q.device)] * 6
