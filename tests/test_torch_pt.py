"""The port's parallel-tempering sampler against the JAX package's, and on
its own.

``_pt_update`` is fed the draws the reference makes from its key
(partners, stretch and acceptance uniforms per half, the swap uniforms),
so float64 results agree to rounding: rtol 1e-12 on an analytic target,
rel 1e-9 through the tiny CV posterior's ``parts``.  ``log_evidence`` is
pure numpy in both packages and must agree exactly.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import (
    make_ln_prob_parts as jmake_parts)
from lfit_python_tpu.sampling import pt as jpt
from lfit_python_tpu_torch.convert import from_jax_model, pt_state_from_numpy
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob_parts
from lfit_python_tpu_torch.sampling import pt

from test_torch_posterior import TINY, jax_twin, walkers


def jprior(x):
    return jnp.where(jnp.all(jnp.abs(x) < 10.0), 0.0, -jnp.inf)


def jlike(x):
    a = -0.5 * jnp.sum((x - 4.0) ** 2) / 0.25
    b = -0.5 * jnp.sum((x + 4.0) ** 2) / 0.25
    return jnp.logaddexp(a, b)


def tprior(x):
    inside = (x.abs() < 10.0).all(dim=-1)
    zero = torch.zeros_like(x[:, 0])
    return torch.where(inside, zero, zero - np.inf)


def tlike(x):
    a = -0.5 * ((x - 4.0) ** 2).sum(dim=-1) / 0.25
    b = -0.5 * ((x + 4.0) ** 2).sum(dim=-1) / 0.25
    return torch.logaddexp(a, b)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def reference_draws(key, T, W):
    """The draws ``jpt.pt_step`` makes from ``key``, as it makes them."""
    half = W // 2
    _, k_a, k_b, k_su = jax.random.split(key, 4)
    out = []
    for k in (k_a, k_b):
        k1, k2, k3 = jax.random.split(k, 3)
        j = jax.random.randint(k1, (T, half), 0, W - half)
        u = jax.random.uniform(k2, (T, half), jnp.float64)
        u_acc = jax.random.uniform(k3, (T, half), jnp.float64)
        out.append((torch.tensor(np.asarray(j), dtype=torch.int64),
                    torch.tensor(np.asarray(u)),
                    torch.tensor(np.asarray(u_acc))))
    u_swap = jax.random.uniform(k_su, (T - 1, W), jnp.float64)
    return out[0], out[1], torch.tensor(np.asarray(u_swap))


def assert_same_state(got, ref, rtol):
    for name in ("positions", "ln_like", "ln_prior", "betas"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, err_msg=name)
    assert got.step == int(ref.step)


class TestAgainstJax:
    def test_ladder(self):
        betas = pt.default_beta_ladder(5)
        np.testing.assert_allclose(betas.numpy(),
                                   np.asarray(jpt.default_beta_ladder(5)),
                                   rtol=1e-15)
        assert float(betas[0]) == 1.0 and bool((betas.diff() < 0).all())

    def test_state_from_jax_steps_on(self):
        state = jpt.init_pt(jax.random.PRNGKey(0), jnp.zeros(2),
                            0.5 * jnp.ones(2), jprior, jlike, n_walkers=8,
                            n_temps=3)
        port = pt_state_from_numpy(state, device="cpu")
        assert_same_state(port, state, 0.0)
        port, (acc, rung) = pt.pt_step(port, tprior, tlike, gen(0))
        assert port.step == 1 and rung.shape == (3,)
        assert 0.0 <= float(acc) <= 1.0
        np.testing.assert_allclose(
            tlike(port.positions.reshape(-1, 2)).reshape(3, 8).numpy(),
            port.ln_like.numpy(), rtol=1e-12)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_step_with_jax_draws(self, seed):
        """Three steps in a row on the bimodal target, each with the
        reference's draws: positions, both ln parts, the accept fraction
        and the per-rung mean ln-likelihood."""
        T, W = 4, 12
        state = jpt.init_pt(jax.random.PRNGKey(seed), jnp.zeros(2),
                            2.0 * jnp.ones(2), jprior, jlike, n_walkers=W,
                            n_temps=T)
        port = pt_state_from_numpy(state, device="cpu")
        parts = pt._default_batch_parts(tprior, tlike)
        swapped = 0
        for _ in range(3):
            draws = reference_draws(state.key, T, W)
            before = port.positions
            state, (jacc, jrung) = jpt.pt_step(state, jprior, jlike)
            port, (acc, rung) = pt._pt_update(port, parts, 2.0, draws)
            assert_same_state(port, state, 1e-12)
            np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-12)
            np.testing.assert_allclose(rung.numpy(), np.asarray(jrung),
                                       rtol=1e-12)
            swapped += int((port.positions[1:] == before[:-1]).all(-1).sum())
        assert swapped > 0              # the swap sweep was exercised

    def test_log_evidence_equals_reference(self):
        rng = np.random.default_rng(0)
        for betas in (np.array([1.0, 0.5, 0.25, 0.125]),
                      np.linspace(0.0, 1.0, 11)[::-1],
                      np.asarray(jpt.default_beta_ladder(6))):
            f = -5.0 / (1.0 + betas) + 0.1 * rng.standard_normal(betas.size)
            assert pt.log_evidence(betas, f) == jpt.log_evidence(betas, f)


class TestOnItsOwn:
    def test_init_redraws_only_bad_walkers(self):
        calls = []

        def prior(x):
            calls.append(x.shape[0])
            return tprior(x * 4.0)           # support |x| < 2.5

        state = pt.init_pt(gen(0), torch.zeros(2, dtype=torch.float64),
                           2.0 * torch.ones(2, dtype=torch.float64), prior,
                           tlike, n_walkers=16, n_temps=3)
        assert state.positions.shape == (3, 16, 2)
        assert bool(torch.isfinite(state.ln_prior).all())
        assert calls[0] == 48 and len(calls) > 1
        assert all(b < a for a, b in zip(calls, calls[1:]))
        assert state.betas.dtype == torch.float64 and state.step == 0

    def test_run_thin_and_shapes(self):
        g = gen(2)
        state = pt.init_pt(g, torch.zeros(2, dtype=torch.float64),
                           torch.ones(2, dtype=torch.float64), tprior, tlike,
                           n_walkers=16, n_temps=2)
        state, chain, lp, acc, rung = pt.run_pt(state, tprior, tlike, 40, g,
                                                thin=4)
        assert chain.shape == (10, 16, 2) and lp.shape == (10, 16)
        assert acc.shape == (40,) and rung.shape == (40, 2)
        assert state.step == 40
        np.testing.assert_allclose(
            lp[-1].numpy(), (state.ln_prior[0] + state.ln_like[0]).numpy())

    def test_cold_chain_visits_both_modes(self):
        """All walkers start in one mode; swaps with the hot rungs carry
        the cold chain across the barrier."""
        g = gen(1)
        state = pt.init_pt(
            g, torch.tensor([4.0], dtype=torch.float64),
            torch.tensor([0.3], dtype=torch.float64), tprior, tlike,
            n_walkers=32, n_temps=5,
            betas=torch.tensor([1.0, 0.3, 0.1, 0.03, 0.01]))
        state, chain, *_ = pt.run_pt(state, tprior, tlike, 600, g)
        frac_neg = float((chain[200:] < 0).double().mean())
        assert 0.15 < frac_neg < 0.85

    def test_sampled_evidence_matches_analytic(self):
        """Conjugate Gaussian: prior N(0, I_2), ln L = -|x|^2 / 2, so
        ln Z = -ln 2."""
        def prior(x):
            return -0.5 * (x * x).sum(-1) - np.log(2.0 * np.pi)

        def like(x):
            return -0.5 * (x * x).sum(-1)

        g = gen(3)
        betas = torch.tensor([1.0, 0.6, 0.35, 0.2, 0.1, 0.05, 0.02])
        state = pt.init_pt(g, torch.zeros(2, dtype=torch.float64),
                           torch.ones(2, dtype=torch.float64), prior, like,
                           n_walkers=64, n_temps=7, betas=betas)
        state, *_ = pt.run_pt(state, prior, like, 200, g)
        state, _, _, _, rung = pt.run_pt(state, prior, like, 400, g)
        ln_z, _ = pt.log_evidence(betas.numpy(), rung.mean(dim=0).numpy())
        assert abs(ln_z + np.log(2.0)) < 0.06


def test_step_on_the_cv_posterior_with_jax_draws():
    """One PT step (2 rungs x 4 walkers) on the tiny CV posterior, the
    reference's draws fed in: rel 1e-9, and each half's proposals are
    one shared ``parts`` pass."""
    spec = build_model(n_eclipses=1, n_points=16)
    jm = jax_twin(spec)
    jprior_fn, jlike_fn, _ = jmake_parts(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, **TINY))
    tm = from_jax_model(jm)
    tprior_fn, tlike_fn, post = make_ln_prob_parts(tm, CVConfig(**TINY),
                                                   device="cpu")
    T, W = 2, 4
    pos = walkers(tm, T * W, 0).reshape(T, W, -1)
    jpos = jnp.asarray(pos)
    both = jax.jit(jax.vmap(jax.vmap(lambda v: (jprior_fn(v), jlike_fn(v)))))
    lp0, ll0 = both(jpos)
    state = jpt.PTState(jax.random.PRNGKey(5), jpos, ll0, lp0,
                        jnp.asarray([1.0, 0.5]), jnp.asarray(0, jnp.int32))
    port = pt_state_from_numpy(state, device="cpu")
    draws = reference_draws(state.key, T, W)
    ref, (jacc, jrung) = jax.jit(
        lambda s: jpt.pt_step(s, jprior_fn, jlike_fn))(state)
    with mock.patch.object(post, "_terms", wraps=post._terms) as rec:
        got, (acc, rung) = pt._pt_update(
            port, pt._default_batch_parts(tprior_fn, tlike_fn), 2.0, draws)
    assert rec.call_count == 2       # one shared pass per half
    assert_same_state(got, ref, 1e-9)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-12)
    np.testing.assert_allclose(rung.numpy(), np.asarray(jrung), rtol=1e-9)
    assert bool(torch.isfinite(got.ln_like).all())
    lp_p, ll_p = post.parts(got.positions[0])
    np.testing.assert_allclose(lp_p.numpy(), got.ln_prior[0].numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(ll_p.numpy(), got.ln_like[0].numpy(),
                               rtol=1e-12)

