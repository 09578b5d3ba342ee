"""The port's HMC sampler against the JAX package's, and on its own.

Dual averaging and one trajectory are held to the reference on the same
numbers: ``_trajectory`` is fed the draws JAX makes from its keys
(momenta, step-size jitter, acceptance uniform), so float64 results
agree to rounding.  The analytic-target tests mirror tests/test_hmc.py
with a ``torch.Generator`` in place of the key; the last test steps the
tiny CV posterior with exposure widths through the whole gradient path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.sampling import hmc as jhmc
from lfit_python_tpu_torch.convert import hmc_state_from_numpy
from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import contacts
from lfit_python_tpu_torch.sampling import hmc
from lfit_python_tpu_torch.sampling.hmc import (
    init_hmc, run_hmc, warmup_hmc)

from test_torch_posterior import TINY

COV = np.array([[1.0, 0.8], [0.8, 2.0]])
PREC = np.linalg.inv(COV)


def gauss_torch(x):
    return -0.5 * torch.einsum("ci,ij,cj->c", x, torch.tensor(PREC), x)


def gauss_jax(x):
    return -0.5 * x @ jnp.asarray(PREC) @ x


def box_torch(x):
    inside = ((x > -1.0) & (x < 1.0)).all(dim=-1)
    return torch.where(inside, -0.5 * (x * x).sum(dim=-1),
                       torch.full_like(x[:, 0], -np.inf))


def gen(seed):
    return torch.Generator().manual_seed(seed)


class TestAgainstJax:
    def test_da_update(self):
        eps0 = 0.05
        jda = jhmc._da_init(jnp.asarray(eps0))
        tda = hmc._da_init(torch.tensor(eps0, dtype=torch.float64))
        for a in (0.3, 0.95, 0.7, 0.0, 1.0):
            jda = jhmc._da_update(jda, a)
            tda = hmc._da_update(tda, a)
            for f in ("log_eps", "log_eps_bar", "h_bar", "mu"):
                np.testing.assert_allclose(float(getattr(tda, f)),
                                           float(getattr(jda, f)),
                                           rtol=1e-14, err_msg=f)
            assert tda.m == float(jda.m)

    def test_trajectory_with_jax_draws(self):
        C, D, L = 8, 2, 6
        rng = np.random.default_rng(0)
        x0 = rng.standard_normal((C, D))
        eps, inv_mass = 0.4, np.array([0.9, 1.7])
        keys = jax.random.split(jax.random.PRNGKey(7), C)
        vg = jhmc._value_and_grad(gauss_jax)
        lp0, g0 = jax.vmap(vg)(x0)
        ref = jax.vmap(lambda k, x, l, g: jhmc._trajectory(
            k, x, l, g, eps, inv_mass, vg, L))(keys, x0, lp0, g0)
        # the reference's draws, made as _trajectory makes them
        sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
        noise = jax.vmap(lambda k: jax.random.normal(k, (D,)))(sub[:, 0])
        jitter = jax.vmap(lambda k: jax.random.uniform(k, ()))(sub[:, 1])
        u_acc = jax.vmap(lambda k: jax.random.uniform(k, ()))(sub[:, 2])

        def t(a):
            return torch.tensor(np.asarray(a), dtype=torch.float64)

        got = hmc._trajectory(t(x0), t(lp0), t(g0), t(eps), t(inv_mass),
                              hmc.value_and_grad(gauss_torch), L, t(noise),
                              t(jitter), t(u_acc))
        for a, b, name in zip(got, ref, ("x", "lp", "g", "accept",
                                         "accept_prob", "divergent")):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-12, atol=1e-14, err_msg=name)
        assert 0 < int(got[3].sum()) < C or bool(got[3].all())

    def test_state_from_jax(self):
        state = jhmc.init_hmc(jax.random.PRNGKey(1), jnp.zeros(2),
                              0.5 * jnp.ones(2), gauss_jax, 4)
        port = hmc_state_from_numpy(state, device="cpu")
        np.testing.assert_array_equal(port.positions.numpy(),
                                      np.asarray(state.positions))
        np.testing.assert_array_equal(port.grad.numpy(),
                                      np.asarray(state.grad))
        assert float(port.step_size) == float(state.step_size)
        assert port.inv_mass.shape == (2,) and port.step == 0
        # the carried-over state steps on in the port
        port, *_ = hmc.hmc_step(port, gauss_torch, gen(0), n_leapfrog=3)
        assert port.step == 1 and bool(torch.isfinite(port.log_prob).all())


class TestGaussianTarget:
    def _tuned_state(self, seed=0, n_chains=64, n_warmup=200):
        g = gen(seed)
        state = init_hmc(g, torch.zeros(2, dtype=torch.float64),
                         0.5 * torch.ones(2, dtype=torch.float64),
                         gauss_torch, n_chains)
        return warmup_hmc(state, gauss_torch, n_warmup, g, n_leapfrog=8), g

    def test_moments_and_acceptance(self):
        state, g = self._tuned_state()
        state, chain, chain_lp, acc, div = run_hmc(state, gauss_torch, 300,
                                                   g, n_leapfrog=8)
        assert chain.shape == (300, 64, 2)
        flat = chain[50:].reshape(-1, 2).numpy()
        np.testing.assert_allclose(flat.mean(axis=0), [0.0, 0.0], atol=0.1)
        np.testing.assert_allclose(np.cov(flat.T), COV, rtol=0.25, atol=0.15)
        assert 0.5 < float(acc.mean()) <= 1.0
        assert float(div.mean()) < 0.05
        assert bool(torch.isfinite(chain_lp).all())

    def test_warmup_adapts_metric(self):
        state, _ = self._tuned_state()
        ratio = float(state.inv_mass[1] / state.inv_mass[0])
        assert 1.2 < ratio < 3.5
        assert float(state.step_size) > 1e-3

    def test_deterministic_given_seed(self):
        chains = []
        for _ in range(2):
            state, g = self._tuned_state(seed=3, n_chains=16, n_warmup=50)
            chains.append(run_hmc(state, gauss_torch, 20, g,
                                  n_leapfrog=8)[1])
        assert torch.equal(chains[0], chains[1])

    def test_step_counter_and_thin(self):
        state, g = self._tuned_state(n_chains=16, n_warmup=50)
        assert state.step == 0               # warmup resets the counter
        state, chain, *_ = run_hmc(state, gauss_torch, 25, g, n_leapfrog=4,
                                   thin=10)
        assert chain.shape[0] == 2           # keeps at global steps 10, 20
        assert state.step == 25


class TestConstrainedTarget:
    def test_stays_finite_inside_support(self):
        """Leapfrog steps that leave the box are divergences: rejected,
        never NaN."""
        g = gen(1)
        state = init_hmc(g, torch.zeros(3, dtype=torch.float64),
                         0.1 * torch.ones(3, dtype=torch.float64),
                         box_torch, 32, step_size=0.2)
        state, chain, chain_lp, acc, div = run_hmc(state, box_torch, 100, g,
                                                   n_leapfrog=8)
        assert bool(torch.isfinite(chain).all())
        assert bool(torch.isfinite(chain_lp).all())
        assert bool((chain.abs() < 1.0).all())
        assert float(acc.mean()) > 0.2


def test_hmc_step_on_the_cv_posterior_with_widths():
    """Two leapfrog steps on the tiny CV posterior with exposure widths:
    finite, the chains move, and K1's backward runs once per gradient."""
    m = with_calib_widths(build_model(n_eclipses=2,
                                      complex_spot=[False, True],
                                      n_points=16, bands=("g",))).compile()
    lp = make_ln_prob(m, CVConfig(**TINY), device="cpu")
    start = torch.tensor(m.var_start())
    scatter = 1e-3 * start.abs().clamp(min=1e-2)
    g = gen(0)
    state = init_hmc(g, start, scatter, lp, 3, step_size=1e-4)
    assert bool(torch.isfinite(state.grad).all())
    before = contacts.BACKWARD_CALLS
    new, acc, aprob, div = hmc.hmc_step(state, lp, g, n_leapfrog=2)
    assert contacts.BACKWARD_CALLS == before + 2
    assert bool(torch.isfinite(new.positions).all())
    assert bool(torch.isfinite(new.log_prob).all())
    assert float(acc) > 0.0 and float(div) == 0.0
    assert not torch.equal(new.positions, state.positions)
