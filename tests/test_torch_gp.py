"""The port's Matern-3/2 GP recursion and changepoints against the JAX
package's (float64, CPU).

The same series, made with numpy from a seed, go through the reference's
per-series ``segmented_matern32_ln_like`` and the port's batched one
(whose CPU route is the plain loop the CUDA kernel K3 repeats), and
through a dense Cholesky of ``matern32_cov``.  Tolerances: rtol 1e-10
against the reference and the dense oracle's own 1e-8 (its Cholesky is
O(n^3) rounding), 1e-9 for ``wd_contact_extension``.
"""

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
