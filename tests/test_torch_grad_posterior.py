"""The port's posterior gradient against the JAX package's (float64).

``Posterior.value_and_grad`` on a tiny model with exposure widths (the
width path is where the contact phases carry gradient) against
``jax.value_and_grad`` of the reference posterior at rtol 1e-7, against
central finite differences, and for walker independence and K1's
backward count.  Each CPU evaluation integrates the 4352-step stream
with its sensitivities (about 8 s).
"""

import jax
import numpy as np
import pytest
import torch

from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu_torch.convert import from_jax_model
from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import contacts

from test_torch_posterior import TINY, jax_twin, walkers


@pytest.fixture(scope="module")
def widths_model():
    """2 eclipses (one complex spot), one band, exposure widths as a
    .calib light curve gets them; the port's and the reference's
    posterior of the same compiled model."""
    spec = with_calib_widths(build_model(
        n_eclipses=2, complex_spot=[False, True], n_points=16, bands=("g",)))
    jm = jax_twin(spec)
    jlp = jmake(jm, config=JCfg(n_donor_quad=0, pallas_contacts=False,
                                **TINY))
    tm = from_jax_model(jm)
    tlp = make_ln_prob(tm, CVConfig(**TINY), device="cpu")
    assert tlp.width is not None
    pos = walkers(tm, 3, 0)
    ref = jax.jit(jax.vmap(jax.value_and_grad(jlp)))(pos)
    before = contacts.BACKWARD_CALLS
    got = tlp.value_and_grad(torch.tensor(pos))
    calls = contacts.BACKWARD_CALLS - before
    return tm, tlp, pos, [np.asarray(r) for r in ref], got, calls


class TestPosteriorGradient:
    def test_matches_jax_grad(self, widths_model):
        _, _, _, (lp_ref, g_ref), (lp, g), _ = widths_model
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-7,
                                   atol=1e-9 * np.abs(g_ref).max())

    def test_k1_backward_once_per_evaluation(self, widths_model):
        assert widths_model[-1] == 1

    def test_matches_finite_differences(self, widths_model):
        """Central differences of the port's own posterior, as
        tests/test_e2e.py checks the reference: flux scales, the
        geometry roots (q, dphi, rwd), a disc radius and the smeared
        phase offset — all perturbed walkers in one batched call."""
        tm, tlp, pos, _, (_, g), _ = widths_model
        names = tm.var_names()
        v0 = pos[0]
        idx = [names.index(n) for n in ("wdFlux_g", "q_core", "dphi_core",
                                        "rwd_core", "rdisc_ecl0",
                                        "phi0_ecl0")]
        h = np.array([1e-6 * max(abs(v0[i]), 1e-3) for i in idx])
        batch = np.repeat(v0[None], 2 * len(idx), axis=0)
        for k, i in enumerate(idx):
            batch[2 * k, i] += h[k]
            batch[2 * k + 1, i] -= h[k]
        f = tlp(torch.tensor(batch)).numpy()
        fd = (f[0::2] - f[1::2]) / (2.0 * h)
        got = g.numpy()[0, idx]
        scale = np.maximum(np.maximum(np.abs(fd), np.abs(got)), 1e-6)
        assert np.all(np.abs(got - fd) / scale < 5e-3), (got, fd)

    def test_walkers_are_independent(self, widths_model):
        """A batch with two -inf walkers (outside a prior; no inclination
        fits) gives them zero gradients and the third walker the
        gradient it has in another batch."""
        tm, tlp, pos, _, (lp, g), _ = widths_model
        names = tm.var_names()
        bad = np.repeat(pos[:1], 3, axis=0)
        bad[0, names.index("phi0_ecl0")] = 0.2
        bad[1, names.index("dphi_core")] = 0.19
        bad[2] = pos[2]
        lp2, g2 = tlp.value_and_grad(torch.tensor(bad))
        assert torch.isinf(lp2[:2]).all() and torch.isfinite(lp2[2])
        assert bool((g2[:2] == 0.0).all())
        np.testing.assert_allclose(g2[2].numpy(), g[2].numpy(), rtol=1e-12)

    def test_no_widths_model_never_calls_k1_backward(self):
        """Without widths the flux uses the instantaneous indicator, a
        comparison: the contact phases get no gradient to carry."""
        m = build_model(n_eclipses=1, n_points=8).compile()
        tlp = make_ln_prob(m, CVConfig(**TINY), device="cpu")
        assert tlp.width is None
        before = contacts.BACKWARD_CALLS
        lp, g = tlp.value_and_grad(torch.tensor(walkers(m, 1, 3)))
        assert contacts.BACKWARD_CALLS == before
        assert bool(torch.isfinite(lp).all() & torch.isfinite(g).all())


@pytest.fixture(scope="module")
def gp_widths_model():
    """One GP eclipse with exposure widths: the reference's
    value_and_grad over 2 walkers and the port's."""
    spec = with_calib_widths(build_model(n_eclipses=1, use_gp=True,
                                         n_points=16))
    jm = jax_twin(spec)
    jlp = jmake(jm, config=JCfg(n_donor_quad=0, pallas_contacts=False,
                                **TINY))
    tm = from_jax_model(jm)
    tlp = make_ln_prob(tm, CVConfig(**TINY), device="cpu")
    pos = walkers(tm, 2, 5)
    ref = jax.jit(jax.vmap(jax.value_and_grad(jlp)))(pos)
    return tm, tlp, pos, [np.asarray(r) for r in ref]


class TestGPPosteriorGradient:
    def test_matches_jax_grad(self, gp_widths_model):
        """The GP branch's gradient flows through the residuals, the
        amplitudes and the timescale (the plain recursion under
        autograd), not through the changepoints."""
        tm, tlp, pos, (lp_ref, g_ref) = gp_widths_model
        with torch.enable_grad():
            v = torch.tensor(pos, requires_grad=True)
            total = tlp._ln_prob(v)
            raw, = torch.autograd.grad(total.sum(), v)
        assert bool(torch.isfinite(raw).all())       # nothing to zero
        lp, g = tlp.value_and_grad(torch.tensor(pos))
        np.testing.assert_array_equal(g.numpy(), raw.numpy())
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-7,
                                   atol=1e-9 * np.abs(g_ref).max())
        names = tm.var_names()
        for n in ("ln_ampin_gp_ecl0", "ln_ampout_gp_ecl0", "ln_tau_gp_ecl0"):
            assert np.all(g.numpy()[:, names.index(n)] != 0.0), n

    def test_prior_table_gradient_is_finite_on_gp_priors(self,
                                                         gp_widths_model):
        """uniform(lo, 0) GP priors have p2 = 0, a degenerate sigma for
        the gauss families evaluated beside them: the validity masks keep
        their NaN out of the gradient."""
        from lfit_python_tpu_torch.models.priors import ln_prior_table

        tm, _, pos, _ = gp_widths_model
        assert (tm.prior_table.p2 == 0.0).any()
        full = torch.tensor(tm.full_from_var(pos), requires_grad=True)
        lp = ln_prior_table(full, tm.prior_table)
        g, = torch.autograd.grad(lp.sum(), full)
        assert bool(torch.isfinite(lp).all() & torch.isfinite(g).all())
