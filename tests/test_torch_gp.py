"""The port's Matern-3/2 GP recursion and changepoints against the JAX
package's (float64, CPU).

The same series, made with numpy from a seed, go through the reference's
per-series ``segmented_matern32_ln_like`` and the port's batched one
(whose CPU route is the plain loop the CUDA kernel K3 repeats), and
through a dense Cholesky of ``matern32_cov``.  Tolerances: rtol 1e-10
against the reference and the dense oracle's own 1e-8 (its Cholesky is
O(n^3) rounding), 1e-9 for ``wd_contact_extension``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models.likelihood import (
    wd_contact_extension as j_extension)
from lfit_python_tpu.ops import gp as jgp
from lfit_python_tpu.roche import geometry as jgeo
from lfit_python_tpu_torch.models.likelihood import wd_contact_extension
from lfit_python_tpu_torch.ops import gp
from lfit_python_tpu_torch.roche import geometry as tgeo

W, E, P = 3, 2, 60


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def batch():
    """(W, E) series of P points: sorted times per eclipse, residuals per
    series, an in-eclipse window per series with its own amplitudes, a
    timescale per series; the last 7 points of eclipse 1 are padding."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(-0.15, 0.15, (E, P)), axis=-1)
    yerr = rng.uniform(1e-3, 3e-3, (E, P))
    y = (0.01 * np.sin(40 * t)[None]
         + 0.002 * rng.standard_normal((W, E, P)))
    half = rng.uniform(0.02, 0.06, (W, E, 1))
    in_ecl = np.abs(t[None]) <= half
    s_in = rng.uniform(5e-4, 2e-3, (W, E, 1))
    s_out = rng.uniform(2e-3, 8e-3, (W, E, 1))
    sigma2 = np.where(in_ecl, s_in ** 2, s_out ** 2)
    reset = np.zeros((W, E, P), bool)
    reset[..., 1:] = in_ecl[..., 1:] != in_ecl[..., :-1]
    c = np.sqrt(3.0) / rng.uniform(0.01, 0.1, (W, E))
    mask = np.ones((E, P), bool)
    mask[1, -7:] = False
    return dict(t=t, y=y, yerr=yerr, sigma2=sigma2, c=c, reset=reset,
                mask=mask)


def reference(b, **over):
    """The JAX package's per-series function on every series."""
    b = {**b, **over}
    out = np.empty((W, E))
    for w in range(W):
        for e in range(E):
            out[w, e] = float(jgp.segmented_matern32_ln_like(
                jnp.asarray(b["t"][e]), jnp.asarray(b["y"][w, e]),
                jnp.asarray(b["yerr"][e]), jnp.asarray(b["sigma2"][w, e]),
                b["c"][w, e], reset=jnp.asarray(b["reset"][w, e]),
                mask=jnp.asarray(b["mask"][e])))
    return out


def port(b, fn=gp.segmented_matern32_ln_like, **over):
    b = {**b, **over}
    return fn(t64(b["t"]), t64(b["y"]), t64(b["yerr"]), t64(b["sigma2"]),
              t64(b["c"]), reset=torch.tensor(b["reset"]),
              mask=torch.tensor(b["mask"])).numpy()


def dense_ln_like(t, y, yerr, sigma, rho):
    K = gp.matern32_cov(t64(t), sigma, rho).numpy() + np.diag(yerr ** 2)
    L = np.linalg.cholesky(K)
    z = np.linalg.solve(L, y)
    return float(-0.5 * z @ z - np.log(np.diag(L)).sum()
                 - 0.5 * len(t) * np.log(2 * np.pi))


class TestRecursionAgainstJax:
    def test_segmented_with_mask_and_reset(self, batch):
        got = port(batch)
        assert got.shape == (W, E) and np.isfinite(got).all()
        np.testing.assert_allclose(got, reference(batch), rtol=1e-10)

    @pytest.mark.parametrize("case", ["no reset", "no mask",
                                      "reset at first and last point",
                                      "no in-eclipse point"])
    def test_cases(self, batch, case):
        over = {}
        if case == "no reset":
            over["reset"] = np.zeros((W, E, P), bool)
        elif case == "no mask":
            over["mask"] = np.ones((E, P), bool)
        elif case == "reset at first and last point":
            r = batch["reset"].copy()
            r[..., 0] = True
            r[:, 0, -1] = True
            over["reset"] = r
        else:
            over["reset"] = np.zeros((W, E, P), bool)
            over["sigma2"] = np.broadcast_to(
                batch["sigma2"].max(axis=-1, keepdims=True), (W, E, P))
        np.testing.assert_allclose(port(batch, **over),
                                   reference(batch, **over), rtol=1e-10)

    def test_kernel_wrapper_on_the_cpu_is_the_plain_loop(self, batch):
        a = port(batch, fn=gp.segmented_matern32_kernel)
        b = port(batch, fn=gp.segmented_matern32_plain)
        np.testing.assert_array_equal(a, b)

    def test_broadcast_arguments(self, batch):
        """A scalar amplitude and no reset or mask, as
        ``matern32_gp_ln_like`` calls it."""
        sigma = np.full((W, E), 3e-3)
        rho = np.sqrt(3.0) / batch["c"]
        got = gp.matern32_gp_ln_like(t64(batch["t"]), t64(batch["y"]),
                                     t64(batch["yerr"]), t64(sigma),
                                     t64(rho)).numpy()
        ref = np.array([[float(jgp.matern32_gp_ln_like(
            jnp.asarray(batch["t"][e]), jnp.asarray(batch["y"][w, e]),
            jnp.asarray(batch["yerr"][e]), sigma[w, e], rho[w, e]))
            for e in range(E)] for w in range(W)])
        np.testing.assert_allclose(got, ref, rtol=1e-10)

    def test_cov_matches_jax(self, batch):
        t = batch["t"][0]
        np.testing.assert_allclose(
            gp.matern32_cov(t64(t), 0.1, 0.2).numpy(),
            np.asarray(jgp.matern32_cov(jnp.asarray(t), 0.1, 0.2)),
            rtol=1e-13, atol=1e-18)


class TestRecursionAgainstDenseCholesky:
    def test_stationary(self, batch):
        t, y, yerr = batch["t"][0], batch["y"][0, 0], batch["yerr"][0]
        for sigma, rho in [(0.01, 0.05), (0.003, 0.02), (0.1, 0.3)]:
            fast = float(gp.matern32_gp_ln_like(
                t64(t)[None], t64(y)[None, None], t64(yerr)[None],
                t64([[sigma]]), t64([[rho]])))
            assert fast == pytest.approx(
                dense_ln_like(t, y, yerr, sigma, rho), rel=1e-8)

    def test_segments_are_independent_gps(self, batch):
        got = port(batch)
        rho = np.sqrt(3.0) / batch["c"]
        for w in range(W):
            for e in range(E):
                n = int(batch["mask"][e].sum())
                bounds = ([0] + list(np.nonzero(batch["reset"][w, e, :n])[0])
                          + [n])
                dense = sum(dense_ln_like(
                    batch["t"][e, a:b], batch["y"][w, e, a:b],
                    batch["yerr"][e, a:b],
                    np.sqrt(batch["sigma2"][w, e, a]), rho[w, e])
                    for a, b in zip(bounds[:-1], bounds[1:]))
                assert len(bounds) == 4
                assert got[w, e] == pytest.approx(dense, rel=1e-8)


class TestGradient:
    def test_autograd_of_the_plain_loop_matches_jax_grad(self, batch):
        """d sum(ll) / d (y, sigma2, c) through the loop as it stands."""
        w, e = 1, 0
        args = [jnp.asarray(batch[k][w, e]) for k in ("y", "sigma2")]

        def f(y, s2, c):
            return jgp.segmented_matern32_ln_like(
                jnp.asarray(batch["t"][e]), y, jnp.asarray(batch["yerr"][e]),
                s2, c, reset=jnp.asarray(batch["reset"][w, e]),
                mask=jnp.asarray(batch["mask"][e]))

        ref = jax.grad(f, argnums=(0, 1, 2))(*args, batch["c"][w, e])
        y, s2, c = (t64(batch[k]).requires_grad_()
                    for k in ("y", "sigma2", "c"))
        ll = gp.segmented_matern32_ln_like(
            t64(batch["t"]), y, t64(batch["yerr"]), s2, c,
            reset=torch.tensor(batch["reset"]),
            mask=torch.tensor(batch["mask"]))
        gy, gs, gc = torch.autograd.grad(ll.sum(), (y, s2, c))
        for got, want in ((gy[w, e], ref[0]), (gs[w, e], ref[1]),
                          (gc[w, e], ref[2])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                       atol=1e-10 * np.abs(want).max())


class TestAnglesFoldedIntoTheReverseKernel:
    """K3's reverse kernel turns the cotangents of cos(eps c t),
    sin(eps c t) and exp(-c dt) into the one gradient of each series' c
    itself: sum_n eps t (gsd cd - gcd sd) - dt phi gphi."""

    @pytest.mark.parametrize("broadcast_c", [False, True])
    def test_closed_form_matches_autograd_through_the_angles(self, batch,
                                                             broadcast_c):
        rng = np.random.default_rng(7)
        t = t64(batch["t"])
        c = t64(batch["c"][:, :1] if broadcast_c else batch["c"])
        c.requires_grad_()
        cd, sd, phi = gp._angles_decay(t, c.expand(W, E))
        gcd, gsd, gphi = t64(rng.standard_normal((3, W, E, P)))
        # a reset or padded point's decay is replaced: no cotangent
        held = torch.tensor(batch["reset"] | ~batch["mask"])
        gphi = torch.where(held, torch.zeros_like(gphi), gphi)
        assert 0 < int(held.sum()) < held.numel()
        ref, = torch.autograd.grad([cd, sd, phi], c, [gcd, gsd, gphi])
        dt = torch.diff(t, dim=-1, prepend=t[..., :1])
        with torch.no_grad():
            gc = (gp._EPS * t * (gsd * cd - gcd * sd)
                  - dt * phi * gphi).sum(-1)
            if broadcast_c:                 # autograd's adjoint of expand
                gc = gc.sum(-1, keepdim=True)
        assert gc.shape == ref.shape
        np.testing.assert_allclose(gc.numpy(), ref.numpy(), rtol=1e-10)


_GP_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
static inline int cudaGetLastError() { return 0; }
static inline void sincospi(double v, double* s, double* c) {
  *s = std::sin(M_PI * v);
  *c = std::cos(M_PI * v);
}
static inline void sincospif(float v, float* s, float* c) {
  *s = (float)std::sin(M_PI * (double)v);
  *c = (float)std::cos(M_PI * (double)v);
}
// the kernel's branch-free quotient is the IEEE one where it is used
static inline float recip_(float d) { return 1.0f / d; }
static inline double recip_(double d) { return 1.0 / d; }
static inline float quot_(float x, float d, float) { return x / d; }
static inline double quot_(double x, double d, double) { return x / d; }
// one thread after another: the kernels' threads share nothing
template <typename F, typename... A>
static void launch_host(dim3 grid, dim3 block, F kernel, A... args) {
  blockDim = block;
  for (unsigned b = 0; b < grid.x; ++b)
    for (unsigned t = 0; t < block.x; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kernel(args...);
    }
}
"""


@pytest.fixture(scope="module")
def compiled_k3(tmp_path_factory):
    """``ops/csrc/gp.cu`` built by g++ behind a shim header, its launches
    rewritten to loops over blocks and threads: a stand-in for
    ``gp._launch`` that runs K3 and its reverse kernel on CPU tensors."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source")
    build = tmp_path_factory.mktemp("gp_host")
    (build / "cuda_runtime.h").write_text(_GP_SHIM)
    src = (Path(gp.__file__).resolve().parent / "csrc" / "gp.cu").read_text()
    src, n = re.subn(
        r"(gp_(?:backward_)?kernel<[\w, ]+>)<<<grid, block, 0, st>>>\(",
        r"launch_host(grid, block, \1, ", src)
    assert n == 6
    (build / "gp_host.cpp").write_text(src)
    so = build / "libgp_host.so"
    # unoptimised: the stand-in makes every load the source makes, also one
    # whose value goes unused (an out-of-bounds read then faults here too)
    subprocess.run(["g++", "-O0", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{build}", "-o", str(so),
                    str(build / "gp_host.cpp")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fns = lib.gp_launch, lib.gp_backward_launch
    for fn, n_ptr in zip(fns, (9, 12)):
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def launch(which, y, pointers):
        n_w, n_e, n_p = y.shape
        assert fns[which](int(y.dtype == torch.float64), *pointers, n_w, n_e,
                          n_p, None) == 0

    return launch


def series(n_w, n_e, n_p, seed):
    """The batch fixture's kind of series at another shape: (t, y, yerr,
    sigma2, c) float64 and (reset, mask)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-0.15, 0.15, (n_e, n_p)), axis=-1)
    yerr = rng.uniform(1e-3, 3e-3, (n_e, n_p))
    y = 0.01 * np.sin(40 * t)[None] + 0.002 * rng.standard_normal(
        (n_w, n_e, n_p))
    in_ecl = np.abs(t[None]) <= rng.uniform(0.02, 0.06, (n_w, n_e, 1))
    sigma2 = np.where(in_ecl, rng.uniform(5e-4, 2e-3, (n_w, n_e, 1)) ** 2,
                      rng.uniform(2e-3, 8e-3, (n_w, n_e, 1)) ** 2)
    reset = np.zeros((n_w, n_e, n_p), bool)
    reset[..., 1:] = in_ecl[..., 1:] != in_ecl[..., :-1]
    mask = np.ones((n_e, n_p), bool)
    mask[-1, -5:] = False
    c = np.sqrt(3.0) / rng.uniform(0.01, 0.1, (n_w, n_e))
    return ([t64(a) for a in (t, y, yerr, sigma2, c)],
            {"reset": torch.tensor(reset), "mask": torch.tensor(mask)})


# (W, E, P): 16-byte loads of 4-point groups in 2 blocks, the second part
# full; and rows loaded point by point, P no multiple of the group, W * E
# no multiple of the 32-series block
SHAPES = {"P 64, 35 series": (7, 5, 64), "P 37, 12 series": (4, 3, 37),
          "P 61, 45 series": (9, 5, 61)}


class TestKernelSourceOnTheCpu:
    """The autograd.Function of K3 with the compiled kernel source in the
    launches' place, against the plain loop and autograd on it."""

    def _args(self, batch, dtype, case):
        def f(k):
            return torch.tensor(batch[k], dtype=dtype)
        reset, mask = torch.tensor(batch["reset"]), torch.tensor(batch["mask"])
        if case == "as matern32_gp_ln_like calls it":
            # one amplitude and timescale per walker, no reset, no mask
            return ([f("t"), f("y"), f("yerr"), f("sigma2")[:, :1, :1],
                     f("c")[:, :1]], {})
        return ([f("t"), f("y"), f("yerr"), f("sigma2"), f("c")],
                {"reset": reset, "mask": mask})

    def _through_the_function(self, args, kw):
        t, y, yerr, sigma2, c = args
        prep = gp._prepare(t, y, yerr, sigma2, c, kw.get("reset"),
                           kw.get("mask"))
        t_, yerr_, sigma2_, c_, reset_, mask_ = prep
        return gp._Recursion.apply(t_, y, yerr_, sigma2_, c_, reset_, mask_)

    @pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                            (torch.float32, 1e-5)])
    def test_forward_matches_the_plain_loop(self, batch, compiled_k3,
                                            monkeypatch, dtype, rtol):
        monkeypatch.setattr(gp, "_launch", compiled_k3)
        args, kw = self._args(batch, dtype, "segments")
        before = gp.LAUNCHES
        got = self._through_the_function(args, kw)
        assert gp.LAUNCHES == before + 1
        ref = gp.segmented_matern32_plain(*args, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol)

    @pytest.mark.parametrize("case", ["segments",
                                      "as matern32_gp_ln_like calls it"])
    @pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                           (torch.float32, 1e-3)])
    def test_reverse_kernel_matches_autograd_of_the_plain_loop(
            self, batch, compiled_k3, monkeypatch, dtype, tol, case):
        """The gradients in y, sigma2 and c, the last two also where they
        came in broadcast, within ``tol`` of each one's largest entry (the
        card's gate); one launch of each kernel."""
        monkeypatch.setattr(gp, "_launch", compiled_k3)
        args, kw = self._args(batch, dtype, case)
        cot = torch.tensor(np.random.default_rng(5).standard_normal((W, E)),
                           dtype=dtype)
        grads = {}
        for name in ("kernel", "plain"):
            leaves = [a.clone().requires_grad_()
                      for a in (args[1], args[3], args[4])]
            call = [args[0], leaves[0], args[2], leaves[1], leaves[2]]
            before = (gp.LAUNCHES, gp.BACKWARD_LAUNCHES)
            ll = (self._through_the_function(call, kw) if name == "kernel"
                  else gp.segmented_matern32_plain(*call, **kw))
            grads[name] = torch.autograd.grad(ll, leaves, cot)
            n = int(name == "kernel")
            assert (gp.LAUNCHES, gp.BACKWARD_LAUNCHES) == (before[0] + n,
                                                           before[1] + n)
        for k, p, leaf in zip(grads["kernel"], grads["plain"],
                              (args[1], args[3], args[4])):
            assert k.shape == p.shape == leaf.shape
            assert bool(torch.isfinite(k).all()) and float(p.abs().max()) > 0
            assert float((k - p).abs().max()) <= tol * float(p.abs().max())

    @pytest.mark.parametrize("shape", list(SHAPES))
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_in_kernel_angles_and_decay_match_the_plain_loop(
            self, compiled_k3, monkeypatch, shape, dtype):
        """The kernel makes cos(eps c t), sin(eps c t) and exp(-c dt)
        itself; against _angles_decay and the plain loop: float64 within
        1e-11 relative; float32 per series within 1e-5 per point of the
        plain float32 loop, or no farther from the float64 plain loop than
        3x the plain float32 loop's largest distance from it (the
        recursion turns a one-ulp difference in an angle into ~1e-3 of ll
        at P = 64: two float32 evaluations that round their angles
        differently differ by about as much as each errs); one launch."""
        monkeypatch.setattr(gp, "_launch", compiled_k3)
        (t, y, yerr, sigma2, c), kw = series(*SHAPES[shape], seed=4)
        args = [a.to(dtype) for a in (t, y, yerr, sigma2, c)]
        before = gp.LAUNCHES
        got = self._through_the_function(args, kw)
        assert gp.LAUNCHES == before + 1
        t_, yerr_, s2_, c_, reset_, mask_ = gp._prepare(*args, **kw)
        ref = gp._recursion_plain(args[1], s2_, *gp._angles_decay(t_, c_),
                                  reset_, yerr_, mask_)
        assert got.shape == ref.shape == y.shape[:2]
        d = (got - ref).abs()
        if dtype == torch.float64:
            assert float((d / ref.abs()).max()) <= 1e-11
        else:
            ref64 = gp.segmented_matern32_plain(t, y, yerr, sigma2, c, **kw)
            far = (got.double() - ref64).abs()
            plain_far = float((ref.double() - ref64).abs().max())
            assert bool(((d <= 1e-5 * y.shape[-1])
                         | (far <= 3 * plain_far)).all())

    @pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                           (torch.float32, 1e-3)])
    def test_reverse_kernel_on_a_staged_forward(self, compiled_k3,
                                                monkeypatch, dtype, tol):
        """The state a forward on 16-byte loads (two blocks) keeps drives
        the reverse kernel to autograd's gradients on the plain loop,
        within ``tol`` of each one's largest entry."""
        monkeypatch.setattr(gp, "_launch", compiled_k3)
        (t, y, yerr, sigma2, c), kw = series(*SHAPES["P 64, 35 series"],
                                             seed=6)
        cot = torch.tensor(np.random.default_rng(2).standard_normal(
            y.shape[:2]), dtype=dtype)
        grads = {}
        for name in ("kernel", "plain"):
            leaves = [a.to(dtype).requires_grad_() for a in (y, sigma2, c)]
            call = [t.to(dtype), leaves[0], yerr.to(dtype), leaves[1],
                    leaves[2]]
            ll = (self._through_the_function(call, kw) if name == "kernel"
                  else gp.segmented_matern32_plain(*call, **kw))
            grads[name] = torch.autograd.grad(ll, leaves, cot)
        for k, p in zip(grads["kernel"], grads["plain"]):
            assert bool(torch.isfinite(k).all()) and float(p.abs().max()) > 0
            assert float((k - p).abs().max()) <= tol * float(p.abs().max())

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_series_without_points(self, compiled_k3, monkeypatch, dtype):
        """P = 0: one launch, whose threads read nothing (the empty rows
        have no storage) and write each series' ln-likelihood 0, as the
        plain loop gives."""
        monkeypatch.setattr(gp, "_launch", compiled_k3)
        (t, y, yerr, sigma2, c), kw = series(4, 3, 1, seed=1)
        args = [a[..., :0].to(dtype) for a in (t, y, yerr, sigma2)]
        kw = {k: v[..., :0] for k, v in kw.items()}
        args.append(c.to(dtype))
        before = gp.LAUNCHES
        got = self._through_the_function(args, kw)
        assert gp.LAUNCHES == before + 1
        ref = gp.segmented_matern32_plain(*args, **kw)
        assert got.shape == ref.shape == (4, 3)
        assert torch.equal(got, ref) and not bool(ref.any())

    def test_no_state_is_kept_without_a_gradient(self, batch, compiled_k3,
                                                 monkeypatch):
        seen = []

        def launch(which, y, pointers):
            seen.append((which, pointers[-1]))
            compiled_k3(which, y, pointers)

        monkeypatch.setattr(gp, "_launch", launch)
        args, kw = self._args(batch, torch.float64, "segments")
        self._through_the_function(args, kw)
        assert seen == [(0, None)]
        with pytest.raises(TypeError):
            self._through_the_function([args[0].float(), *args[1:]], kw)


class TestChangepoints:
    def test_extension_matches_jax(self):
        """Batched over (W, E) against the reference's scalar function,
        with an infeasible walker (no inclination fits: ext = 0)."""
        q = np.array([0.15, 0.35, 0.08, 0.15])
        dphi = np.array([0.04, 0.07, 0.025, 0.19])
        rwd = np.array([[0.01, 0.012], [0.02, 0.018], [0.005, 0.006],
                        [0.01, 0.01]])
        tq, td = t64(q), t64(dphi)
        x1 = tgeo.xl1(tq)
        pl1 = tgeo.l1_potential(tq, x1)
        incl = tgeo.findi(tq, td, x1, pl1)
        got = wd_contact_extension(tq[:, None], incl[:, None], td[:, None],
                                   t64(rwd), x1[:, None],
                                   pl1[:, None]).numpy()
        assert got.shape == (4, 2)
        for w in range(4):
            jx1 = jgeo.xl1(q[w])
            jpl1 = jgeo.l1_potential(q[w], jx1)
            jincl = jgeo.findi(q[w], dphi[w], jx1, jpl1)
            for e in range(2):
                ref = float(j_extension(q[w], jincl, dphi[w], rwd[w, e],
                                        jx1, jpl1, jnp.float64))
                np.testing.assert_allclose(got[w, e], ref, rtol=1e-9,
                                           atol=1e-15)
        assert (got[:3] > 0).all() and (got[3] == 0).all()
        assert not np.isfinite(incl[3].item())
