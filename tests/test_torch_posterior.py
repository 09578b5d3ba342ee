"""The port's north-star posterior against the JAX package (float64, CPU).

Both packages evaluate the same compiled model: the port builds the model
and its synthetic data, the JAX package compiles the same tree, and
``convert.from_jax_model`` carries the JAX compiled model back to the
port.  CVConfig widths are cut small (the full widths only cost time on
the CPU); every posterior evaluation still runs the full 4352-step gas
stream integration.
"""

import jax
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import priors as jpr
from lfit_python_tpu.models import tree as jtree
from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu.models.likelihood import (
    make_ln_prob_parts as jmake_parts)
from lfit_python_tpu_torch.convert import from_jax_model
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import (make_ln_prob,
                                                     make_ln_prob_parts)

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)


def jax_twin(spec):
    """The JAX package's compiled model of the port's model tree (same
    parameters, priors and light curves)."""
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


def walkers(model, n, seed):
    start = model.var_start()
    rng = np.random.default_rng(seed)
    return start[None] + 0.001 * np.abs(start)[None] * rng.standard_normal(
        (n, start.size))


def both_posteriors(spec):
    jm = jax_twin(spec)
    jlp = jax.jit(jax.vmap(jmake(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, **TINY))))
    tm = from_jax_model(jm)
    return jm, jlp, tm, make_ln_prob(tm, CVConfig(**TINY), device="cpu")


@pytest.fixture(scope="module")
def mixed():
    """2 eclipses (one simple, one complex spot), one band."""
    spec = build_model(n_eclipses=2, complex_spot=[False, True],
                       n_points=16, bands=("g",))
    return both_posteriors(spec)


@pytest.fixture(scope="module")
def north_star_shape():
    """The north-star tree: 5 simple eclipses over 2 bands."""
    spec = build_model(n_eclipses=5, complex_spot=[False] * 5, n_points=16,
                       bands=("g", "r"))
    return both_posteriors(spec)


def assert_same_posterior(jlp, tlp, pos):
    ref = np.asarray(jlp(pos))
    got = tlp(torch.tensor(pos, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_array_equal(got[~np.isfinite(got)],
                                  ref[~np.isfinite(ref)])
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-9)
    return ok


class TestLnProb:
    def test_mixed_model_matches_jax(self, mixed):
        jm, jlp, tm, tlp = mixed
        pos = walkers(tm, 6, 0)
        names = tm.var_names()
        pos[4, names.index("phi0_ecl0")] = 0.2          # outside its prior
        pos[5, names.index("dphi_core")] = 0.19          # no inclination fits
        ok = assert_same_posterior(jlp, tlp, pos)
        assert ok.tolist() == [True] * 4 + [False, False]

    def test_north_star_shape_matches_jax(self, north_star_shape):
        jm, jlp, tm, tlp = north_star_shape
        assert tm.n_eclipses == 5 and tm.n_var == 47
        ok = assert_same_posterior(jlp, tlp, walkers(tm, 4, 1))
        assert ok.all()

    def test_model_flux_shape_and_dtype(self, mixed):
        _, _, tm, tlp = mixed
        pos = torch.tensor(walkers(tm, 2, 2), dtype=torch.float32)
        lp32 = make_ln_prob(tm, CVConfig(**TINY), dtype=torch.float32,
                            device="cpu")
        f = lp32.model_flux(pos)
        assert f.shape == (2, 2, 16) and f.dtype == torch.float32
        f64 = tlp.model_flux(pos.double())
        # float32 against float64 on the same vectors: typical parity
        rel = ((f.double() - f64).abs() / f64.abs().amax()).flatten()
        assert float(rel.median()) < 1e-6

    def test_gp_models_evaluate(self):
        """A GP model builds and evaluates on the CPU, with its GP eclipses
        flagged and a finite ln-probability."""
        m = build_model(n_eclipses=1, use_gp=True, n_points=8).compile()
        assert m.any_gp
        lp = make_ln_prob(m, CVConfig(**TINY), device="cpu")
        assert lp.gp_mask.tolist() == [True]
        assert bool(torch.isfinite(lp(torch.tensor(walkers(m, 1, 0)))).all())


GP_MODELS = {
    "one GP eclipse": dict(n_eclipses=1, use_gp=True),
    "two GP eclipses": dict(n_eclipses=2, complex_spot=[False, True],
                            use_gp=True),
    "GP and chi^2 mixed": dict(n_eclipses=2, use_gp=[True, False]),
}


@pytest.fixture(scope="module")
def mixed_gp_parts():
    """The mixed GP / chi^2 model: the reference's (ln_prior, ln_like,
    ln_prob), jitted over walkers, and the port's three and its
    posterior."""
    spec = build_model(n_points=16, bands=("g",),
                       **GP_MODELS["GP and chi^2 mixed"])
    jm = jax_twin(spec)
    jfns = [jax.jit(jax.vmap(f)) for f in jmake_parts(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, **TINY))]
    tm = from_jax_model(jm)
    pos = walkers(tm, 5, 4)
    names = tm.var_names()
    pos[3, names.index("ln_tau_gp_ecl0")] = 2.5          # outside its prior
    pos[4, names.index("dphi_core")] = 0.19          # no inclination fits
    return jfns, make_ln_prob_parts(tm, CVConfig(**TINY), device="cpu"), pos


class TestGPPosterior:
    @pytest.mark.parametrize("name", ["one GP eclipse", "two GP eclipses"])
    def test_gp_model_matches_jax(self, name):
        jm, jlp, tm, tlp = both_posteriors(build_model(
            n_points=16, bands=("g",), **GP_MODELS[name]))
        assert tm.any_gp and tm.gp_mask.all()
        pos = walkers(tm, 4, 2)
        names = tm.var_names()
        pos[2, names.index("ln_ampin_gp_ecl0")] = 0.5    # outside its prior
        pos[3, names.index("dphi_core")] = 0.19      # no inclination fits
        ok = assert_same_posterior(jlp, tlp, pos)
        assert ok.tolist() == [True, True, False, False]
        # the GP is what was evaluated: the amplitudes move the posterior
        moved = pos[:1].copy()
        moved[0, names.index("ln_ampout_gp_ecl0")] = -6.0
        assert float(tlp(torch.tensor(moved))) < float(
            tlp(torch.tensor(pos[:1])))

    def test_mixed_model_matches_jax(self, mixed_gp_parts):
        (_, _, jprob), (_, _, post), pos = mixed_gp_parts
        assert post.gp_mask.tolist() == [True, False]
        ok = assert_same_posterior(jprob, post, pos)
        assert ok.tolist() == [True, True, True, False, False]

    def test_prior_and_like_match_jax(self, mixed_gp_parts):
        (jprior, jlike, _), (tprior, tlike, _), pos = mixed_gp_parts
        tpos = torch.tensor(pos)
        ref_p, ref_l = np.asarray(jprior(pos)), np.asarray(jlike(pos))
        got_p, got_l = tprior(tpos).numpy(), tlike(tpos).numpy()
        np.testing.assert_array_equal(np.isfinite(got_p), np.isfinite(ref_p))
        assert np.isfinite(ref_p).tolist() == [True] * 3 + [False] * 2
        ok = np.isfinite(ref_p)
        np.testing.assert_allclose(got_p[ok], ref_p[ok], rtol=1e-9)
        np.testing.assert_allclose(got_l[ok], ref_l[ok], rtol=1e-9)
        assert (got_p[~ok] == -np.inf).all()

    def test_parts_is_prior_and_like_in_one_pass(self, mixed_gp_parts):
        _, (tprior, tlike, post), pos = mixed_gp_parts
        tpos = torch.tensor(pos)
        lp, ll = post.parts(tpos)
        np.testing.assert_array_equal(lp.numpy(), tprior(tpos).numpy())
        np.testing.assert_array_equal(ll.numpy(), tlike(tpos).numpy())
        ok = torch.isfinite(lp)
        np.testing.assert_allclose((lp + ll)[ok].numpy(),
                                   post(tpos)[ok].numpy(), rtol=1e-12)

    def test_no_gp_model_runs_nothing_of_the_gp(self, mixed):
        from unittest import mock

        from lfit_python_tpu_torch.models import likelihood

        _, _, tm, tlp = mixed
        assert not tm.any_gp
        with mock.patch.object(likelihood, "gp_flicker_ln_like") as rec:
            tlp(torch.tensor(walkers(tm, 1, 0)))
        assert rec.call_count == 0
