"""The port's NUTS sampler against the JAX package's, and on its own.

``_nuts_trajectory`` takes its random numbers from a provider object;
here one replays, per chain, the key splits the reference makes inside
its loops (momentum, jitter and loop keys; direction, subtree and bias
keys per doubling; one uniform per leaf), so the port's lockstep batch
and the reference's vmapped per-chain trajectories can be compared draw
for draw: the same proposal, depth, divergence flag and accept statistic
at rtol 1e-10 in float64.  The analytic-target tests mirror
tests/test_nuts.py with a ``torch.Generator`` in place of the key; the
last test steps the tiny CV posterior with exposure widths.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.sampling import hmc as jhmc
from lfit_python_tpu.sampling import nuts as jnuts
from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.sampling import hmc, nuts
from lfit_python_tpu_torch.sampling.nuts import (
    init_nuts, nuts_step, run_nuts, warmup_nuts)

from test_torch_posterior import TINY

COV = np.array([[1.0, 0.8], [0.8, 2.0]])
PREC = np.linalg.inv(COV)
BOX = 2.5


def gauss_torch(x):
    return -0.5 * torch.einsum("ci,ij,cj->c", x, torch.tensor(PREC), x)


def boxed_torch(x):
    """The correlated Gaussian inside |x| < BOX, -inf outside."""
    inside = (x.abs() < BOX).all(dim=-1)
    lp = gauss_torch(x)
    return torch.where(inside, lp, torch.full_like(lp, -np.inf))


def boxed_jax(x):
    inside = jnp.all(jnp.abs(x) < BOX)
    return jnp.where(inside, -0.5 * x @ jnp.asarray(PREC) @ x, -jnp.inf)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


class ReplayDraws:
    """The reference's draws for C chains, one key each, split as
    ``jnuts._nuts_trajectory`` splits them.  Every chain's keys advance
    at every call; a chain the reference has stopped takes no further
    draw there, and the port discards what it is handed here."""

    def __init__(self, keys, dim):
        self.keys, self.D = keys, dim

    def start(self):
        sub = jax.vmap(lambda k: jax.random.split(k, 3))(self.keys)
        self.loop = sub[:, 2]
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (self.D,), jnp.float64))(sub[:, 0])
        jitter = jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float64))(sub[:, 1])
        return t64(noise), t64(jitter)

    def doubling(self):
        sub = jax.vmap(lambda k: jax.random.split(k, 4))(self.loop)
        self.loop, self.sub = sub[:, 0], sub[:, 2]
        right = jax.vmap(jax.random.bernoulli)(sub[:, 1])
        u_bias = jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float64))(sub[:, 3])
        return torch.tensor(np.asarray(right)), t64(u_bias)

    def leaf(self):
        sub = jax.vmap(jax.random.split)(self.sub)
        self.sub = sub[:, 0]
        return t64(jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float64))(sub[:, 1]))


def _ref_ckpt_idxs(n):
    """The readable oracle of tests/test_nuts.py: popcount of n >> 1 and
    the count of trailing one bits of n."""
    idx_max = bin(n >> 1).count("1")
    trail = len(bin(n)[2:]) - len(bin(n)[2:].rstrip("1"))
    return idx_max - trail + 1, idx_max


class TestCheckpointIndexing:
    def test_leaf_to_ckpt_matches_bit_oracle(self):
        for n in range(256):
            assert nuts._leaf_to_ckpt(n) == _ref_ckpt_idxs(n), f"leaf {n}"

    def test_leaf_to_ckpt_matches_jax(self):
        f = jax.jit(jnuts._leaf_to_ckpt)
        for n in (0, 1, 2, 3, 5, 7, 12, 31, 44, 63):
            lo, hi = f(jnp.int32(n))
            assert nuts._leaf_to_ckpt(n) == (int(lo), int(hi))


# (key, step size, max_depth): small steps reach max_depth, large ones
# leave the box (a divergence) or turn early
TRAJECTORIES = [(7, 0.05, 3), (11, 0.35, 5), (13, 1.2, 4), (17, 0.6, 6)]


class TestTrajectoryAgainstJax:
    def _both(self, key, eps, max_depth, C=12):
        rng = np.random.default_rng(key)
        x0 = rng.uniform(-0.9 * BOX, 0.9 * BOX, (C, 2))
        inv_mass = np.array([0.9, 1.7])
        keys = jax.random.split(jax.random.PRNGKey(key), C)
        jvg = jhmc._value_and_grad(boxed_jax)
        lp0, g0 = jax.vmap(jvg)(x0)
        ref = jax.vmap(lambda k, x, l, g: jnuts._nuts_trajectory(
            k, x, l, g, eps, inv_mass, jvg, max_depth))(keys, x0, lp0, g0)
        calls = []
        tvg = hmc.value_and_grad(boxed_torch)

        def counted(x):
            calls.append(1)
            return tvg(x)

        got = nuts._nuts_trajectory(
            ReplayDraws(keys, 2), t64(x0), t64(lp0), t64(g0), t64(eps),
            t64(inv_mass), counted, max_depth)
        return got, [np.asarray(r) for r in ref], len(calls)

    @pytest.mark.parametrize("key,eps,max_depth", TRAJECTORIES)
    def test_same_draws_same_trajectory(self, key, eps, max_depth):
        got, ref, n_evals = self._both(key, eps, max_depth)
        names = ("x", "lp", "g", "accept_stat", "divergent", "depth")
        for a, b, name in zip(got, ref, names):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-13,
                                       err_msg=name)
        assert bool(torch.isfinite(got[0]).all())
        # lockstep: the batch pays its deepest chain's leaves, no more
        assert 1 <= n_evals <= 2 ** int(ref[5].max()) - 1

    def test_the_cases_cover_max_depth_divergence_and_turning(self):
        hit_max = diverged = turned = 0
        for key, eps, max_depth in TRAJECTORIES:
            _, ref, _ = self._both(key, eps, max_depth)
            div, depth = ref[4].astype(bool), ref[5]
            hit_max += int(((depth == max_depth) & ~div).sum())
            diverged += int(div.sum())
            turned += int(((depth < max_depth) & ~div).sum())
        assert hit_max > 0 and diverged > 0 and turned > 0


class TestGaussianTarget:
    def _tuned_state(self, seed=0, n_chains=64, n_warmup=200):
        g = gen(seed)
        state = init_nuts(g, torch.zeros(2, dtype=torch.float64),
                          0.5 * torch.ones(2, dtype=torch.float64),
                          gauss_torch, n_chains)
        return warmup_nuts(state, gauss_torch, n_warmup, g, max_depth=6), g

    def test_moments_and_depth(self):
        state, g = self._tuned_state()
        state, chain, chain_lp, astat, div, depth = run_nuts(
            state, gauss_torch, 300, g, max_depth=6)
        assert chain.shape == (300, 64, 2)
        flat = chain[50:].reshape(-1, 2).numpy()
        np.testing.assert_allclose(flat.mean(axis=0), [0.0, 0.0], atol=0.1)
        np.testing.assert_allclose(np.cov(flat.T), COV, rtol=0.25, atol=0.15)
        assert 0.6 < float(astat.mean()) <= 1.0
        assert float(div.mean()) < 0.05
        assert 0.5 < float(depth.mean()) < 5.5
        assert bool(torch.isfinite(chain_lp).all())

    def test_warmup_adapts_metric(self):
        state, _ = self._tuned_state()
        ratio = float(state.inv_mass[1] / state.inv_mass[0])
        assert 1.2 < ratio < 3.5
        assert float(state.step_size) > 1e-3
        assert state.step == 0

    def test_deterministic_given_seed_and_thin(self):
        chains = []
        for _ in range(2):
            state, g = self._tuned_state(seed=3, n_chains=16, n_warmup=50)
            state, chain, *_ = run_nuts(state, gauss_torch, 20, g,
                                        max_depth=6, thin=5)
            chains.append(chain)
        assert torch.equal(chains[0], chains[1])
        assert chains[0].shape[0] == 4 and state.step == 20


def test_depth_grows_with_condition_number():
    """With a unit metric on a badly scaled Gaussian the stiff axis forces
    a small step, so the wide axis needs many doublings."""
    scales = torch.tensor([0.01, 1.0], dtype=torch.float64)

    def ln_prob(x):
        return -0.5 * ((x / scales) ** 2).sum(dim=-1)

    g = gen(0)
    state = init_nuts(g, torch.zeros(2, dtype=torch.float64), scales,
                      ln_prob, 32, step_size=5e-3)
    state = state._replace(inv_mass=torch.ones(2, dtype=torch.float64))
    state, chain, _, astat, div, depth = run_nuts(state, ln_prob, 30, g,
                                                  max_depth=8)
    assert float(depth.mean()) > 3.0
    assert bool(torch.isfinite(chain).all())


def test_stays_finite_inside_support():
    """Leapfrog steps that leave the box are divergences: the trajectory
    stops, positions never go NaN."""
    def box(x):
        inside = ((x > -1.0) & (x < 1.0)).all(dim=-1)
        return torch.where(inside, -0.5 * (x * x).sum(dim=-1),
                           torch.full_like(x[:, 0], -np.inf))

    g = gen(1)
    state = init_nuts(g, torch.zeros(3, dtype=torch.float64),
                      0.1 * torch.ones(3, dtype=torch.float64), box, 32,
                      step_size=0.2)
    state, chain, chain_lp, astat, div, depth = run_nuts(state, box, 100, g,
                                                         max_depth=6)
    assert bool(torch.isfinite(chain).all())
    assert bool(torch.isfinite(chain_lp).all())
    assert bool((chain.abs() < 1.0).all())
    assert float(astat.mean()) > 0.2
    assert float(div.mean()) > 0.0


def test_nuts_step_on_the_cv_posterior_with_widths():
    """One NUTS step at max_depth 2 on the tiny CV posterior with
    exposure widths, 4 chains: finite, the chains move, and every leaf
    is one gradient evaluation of the whole batch."""
    m = with_calib_widths(build_model(n_eclipses=2,
                                      complex_spot=[False, True],
                                      n_points=16, bands=("g",))).compile()
    lp = make_ln_prob(m, CVConfig(**TINY), device="cpu")
    start = torch.tensor(m.var_start())
    scatter = 1e-3 * start.abs().clamp(min=1e-2)
    g = gen(0)
    state = init_nuts(g, start, scatter, lp, 4, step_size=1e-4)
    with mock.patch.object(lp, "value_and_grad",
                           wraps=lp.value_and_grad) as rec:
        new, astat, _, div, depth = nuts_step(state, lp, g, max_depth=2)
    assert 1 <= rec.call_count <= 3
    assert all(c.args[0].shape == (4, m.n_var) for c in rec.call_args_list)
    assert new.step == 1
    assert bool(torch.isfinite(new.positions).all())
    assert bool(torch.isfinite(new.log_prob).all())
    assert bool(torch.isfinite(new.grad).all())
    assert 0.0 < float(astat) <= 1.0 and float(div) == 0.0
    assert 1.0 <= float(depth) <= 2.0
    assert not torch.equal(new.positions, state.positions)
