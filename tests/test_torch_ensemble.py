"""The port's stretch-move sampler against a numpy replay that takes its
ln-probabilities from the JAX package (float64, CPU).

jax.random and torch.Generator never give the same numbers, so the draws
(partner indices, the uniforms that give the stretch factors, the
acceptance uniforms) come from numpy or from a replayed generator and go
into both.  Sampler statistics are not tested here.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import priors as jpr
from lfit_python_tpu.models import tree as jtree
from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu_torch.convert import from_jax_model, state_from_numpy
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.sampling import ensemble as ens

TINY = dict(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
            n_donor_lon=8)
A = 2.0


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


@pytest.fixture(scope="module")
def setup():
    spec = build_model(n_eclipses=1, n_points=16)
    jm = jax_twin(spec)
    jlp = jax.jit(jax.vmap(jmake(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, **TINY))))
    tlp = make_ln_prob(from_jax_model(jm), CVConfig(**TINY), device="cpu")
    start = jm.var_start()
    rng = np.random.default_rng(0)
    pos = start[None] + 1e-3 * np.abs(start)[None] * rng.standard_normal(
        (4, start.size))
    return jlp, tlp, pos, np.asarray(jlp(pos))


def replay_half(jlp, movers, movers_lp, others, j, u, u_acc):
    """The stretch move in numpy, scoring proposals with the JAX package."""
    D = movers.shape[1]
    partners = others[j]
    z = ((A - 1.0) * u + 1.0) ** 2 / A
    prop = partners + z[:, None] * (movers - partners)
    lp_prop = np.asarray(jlp(prop))
    accept = np.log(u_acc) < (D - 1.0) * np.log(z) + lp_prop - movers_lp
    return (np.where(accept[:, None], prop, movers),
            np.where(accept, lp_prop, movers_lp), accept)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


class TestAgainstReplay:
    def test_half_update(self, setup):
        jlp, tlp, pos, lp = setup
        j = np.array([1, 0])
        u = np.array([0.3, 0.9])
        u_acc = np.array([1e-9, 0.7])
        new, new_lp, acc = ens._half_update(
            t64(pos[:2]), t64(lp[:2]), t64(pos[2:]), tlp, A, torch.tensor(j),
            t64(u), t64(u_acc))
        r_new, r_lp, r_acc = replay_half(jlp, pos[:2], lp[:2], pos[2:], j, u,
                                         u_acc)
        np.testing.assert_array_equal(acc.numpy(), r_acc)
        np.testing.assert_allclose(new.numpy(), r_new, rtol=1e-15)
        np.testing.assert_allclose(new_lp.numpy(), r_lp, rtol=1e-9)

    def test_ensemble_step(self, setup):
        jlp, tlp, pos, lp = setup
        state = state_from_numpy(pos, lp, step=5, device="cpu")
        gen = torch.Generator().manual_seed(42)
        new, frac = ens.ensemble_step(state, tlp, gen, A)
        # replay: the same generator stream, the same draw order
        gen = torch.Generator().manual_seed(42)
        d1 = [a.numpy() for a in ens.stretch_draws(gen, 2, 2, torch.float64,
                                                   "cpu")]
        d2 = [a.numpy() for a in ens.stretch_draws(gen, 2, 2, torch.float64,
                                                   "cpu")]
        first, first_lp, acc1 = replay_half(jlp, pos[:2], lp[:2], pos[2:],
                                            *d1)
        second, second_lp, acc2 = replay_half(jlp, pos[2:], lp[2:], first,
                                              *d2)
        np.testing.assert_allclose(new.positions.numpy(),
                                   np.concatenate([first, second]),
                                   rtol=1e-15)
        np.testing.assert_allclose(new.log_prob.numpy(),
                                   np.concatenate([first_lp, second_lp]),
                                   rtol=1e-9)
        assert new.step == 6
        assert float(frac) == (acc1.sum() + acc2.sum()) / 4


def box_ln_prob(x):
    """A unit-box uniform density, cheap enough for loop-level tests."""
    inside = ((x > 0.0) & (x < 1.0)).all(dim=-1)
    return torch.where(inside, torch.zeros_like(x[:, 0]),
                       torch.full_like(x[:, 0], -np.inf))


class TestDriver:
    def test_init_redraws_only_invalid_walkers(self):
        start = torch.full((3,), 0.5, dtype=torch.float64)
        scatter = torch.full((3,), 0.4, dtype=torch.float64)
        gen = torch.Generator().manual_seed(1)
        state = ens.init_walkers(gen, start, scatter, box_ln_prob, 64)
        first = start + scatter * torch.randn(
            (64, 3), generator=torch.Generator().manual_seed(1),
            dtype=torch.float64)
        kept = torch.isfinite(box_ln_prob(first))
        assert 0 < int(kept.sum()) < 64
        assert torch.equal(state.positions[kept], first[kept])
        assert bool(torch.isfinite(state.log_prob).all())
        assert state.step == 0

    def test_init_gives_up_after_max_rounds(self):
        start = torch.full((2,), 5.0, dtype=torch.float64)
        scatter = torch.full((2,), 1e-3, dtype=torch.float64)
        calls = []

        def counting(x):
            calls.append(x.shape[0])
            return box_ln_prob(x)

        state = ens.init_walkers(torch.Generator().manual_seed(0), start,
                                 scatter, counting, 8, max_rounds=3)
        assert calls == [8, 8, 8, 8]
        assert not bool(torch.isfinite(state.log_prob).any())

    @pytest.mark.parametrize("thin,kept", [(1, 6), (2, 3), (4, 1)])
    def test_run_sampler_thinning(self, thin, kept):
        gen = torch.Generator().manual_seed(3)
        start = torch.full((2,), 0.5, dtype=torch.float64)
        state = ens.init_walkers(gen, start, torch.full_like(start, 0.1),
                                 box_ln_prob, 16)
        state, chain, chain_lp, acc = ens.run_sampler(state, box_ln_prob, 6,
                                                      gen, thin=thin)
        assert state.step == 6
        assert chain.shape == (kept, 16, 2) and chain_lp.shape == (kept, 16)
        assert acc.shape == (6,) and bool(((acc > 0) & (acc <= 1)).all())
        assert torch.equal(chain[-1], state.positions) == (6 % thin == 0)
        assert bool(((chain > 0) & (chain < 1)).all())


def gauss_ln_prob(x):
    return -0.5 * (x * x).sum(dim=-1)


class _JCounter(NamedTuple):
    positions: jax.Array
    log_prob: jax.Array
    step: jax.Array


_OFFSETS = np.arange(12 * 3, dtype=np.float64).reshape(12, 3) / 100.0


def _accept_of(step):
    return ((step * 7) % 5) / 8.0 + 0.0625


def _jax_counter_step(s):
    """A deterministic step for the JAX driver: the positions and ln-probs
    encode the global step, and so does the accept fraction."""
    step = s.step + 1
    pos = jnp.asarray(_OFFSETS) + step
    return _JCounter(pos, -pos[:, 0], step), _accept_of(step) * 1.0


def _torch_counter_step(s):
    step = s.step + 1
    pos = torch.from_numpy(_OFFSETS) + step
    return (ens.EnsembleState(pos, -pos[:, 0], step),
            torch.tensor(_accept_of(step), dtype=torch.float64))


class TestRunChunked:
    """run_chunked keeps the rows run_sampler keeps (the steps whose
    global number is a multiple of thin), with the same draws, and the
    rows, accept fractions and progress calls of the JAX package's
    run_chunked."""

    @pytest.mark.parametrize("chunk", [4, 64])
    @pytest.mark.parametrize("thin", [1, 3, 4])
    @pytest.mark.parametrize("step0", [0, 2, 5])
    def test_same_as_the_jax_driver(self, step0, thin, chunk):
        from lfit_python_tpu.sampling import ensemble as jens

        n = 13
        pos0 = _OFFSETS + step0
        seen, jseen = [], []
        out = ens.run_chunked(
            ens.EnsembleState(torch.from_numpy(pos0),
                              torch.from_numpy(-pos0[:, 0]), step0),
            _torch_counter_step, n, thin=thin, chunk_size=chunk,
            progress=lambda done, acc: seen.append((done, acc)))
        ref = jens.run_chunked(
            _JCounter(jnp.asarray(pos0), jnp.asarray(-pos0[:, 0]),
                      jnp.asarray(step0, jnp.int32)),
            _jax_counter_step, n, thin=thin, chunk_size=chunk,
            progress=lambda done, acc: jseen.append((done, acc)))
        assert out[0].step == int(ref[0].step) == step0 + n
        kept = [s for s in range(step0 + 1, step0 + n + 1) if s % thin == 0]
        assert out[1].shape == (len(kept), 12, 3)
        np.testing.assert_array_equal(out[1][:, 0, 0], kept)
        assert len(out[3]) == 1
        for got, want in zip((*out[1:3], out[3][0]), ref[1:]):
            assert isinstance(got, np.ndarray) and got.dtype == np.float64
            np.testing.assert_array_equal(got, np.asarray(want))
        assert seen == jseen and seen[-1][0] == n

    @pytest.mark.parametrize("step0", [0, 2])
    def test_same_rows_as_run_sampler(self, step0):
        start = torch.linspace(-1.0, 1.0, 3, dtype=torch.float64)
        gen = torch.Generator().manual_seed(11)
        state = ens.init_walkers(gen, start, torch.full_like(start, 0.3),
                                 gauss_ln_prob, 12)._replace(step=step0)
        twin = torch.Generator()
        twin.set_state(gen.get_state())
        seen = []
        out = ens.run_chunked(
            state, lambda s: ens.ensemble_step(s, gauss_ln_prob, gen), 13,
            thin=3, chunk_size=4,
            progress=lambda done, acc: seen.append((done, acc)))
        ref = ens.run_sampler(state, gauss_ln_prob, 13, twin, thin=3)
        assert out[0].step == ref[0].step == step0 + 13
        assert torch.equal(out[0].positions, ref[0].positions)
        kept = [s for s in range(step0 + 1, step0 + 14) if s % 3 == 0]
        assert out[1].shape == (len(kept), 12, 3)
        assert out[2].shape == (len(kept), 12)
        assert len(out[3]) == 1
        for got, want in zip((*out[1:3], out[3][0]), ref[1:]):
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, want.numpy())
        # one progress call a chunk, with the mean accept of its steps
        ends = [d for d, _ in seen]
        assert ends == sorted(ends) and ends[-1] == 13
        lo = 0
        for done, acc in seen:
            assert acc == float(ref[3][lo:done].numpy().mean())
            lo = done

    def test_a_short_segment_keeps_only_multiples_of_thin(self):
        """A segment that ends before the next multiple of thin keeps
        nothing, and the next segment keeps that multiple."""
        pos0 = _OFFSETS + 1
        state = ens.EnsembleState(torch.from_numpy(pos0),
                                  torch.from_numpy(-pos0[:, 0]), 1)
        seen = []
        state, chain, chain_lp, (acc,) = ens.run_chunked(
            state, _torch_counter_step, 2, thin=5,
            progress=lambda done, a: seen.append(done))
        assert chain.shape == (0, 12, 3) and chain_lp.shape == (0, 12)
        assert acc.tolist() == [_accept_of(2), _accept_of(3)] and seen == [2]
        state, chain, _, _ = ens.run_chunked(state, _torch_counter_step, 4,
                                             thin=5)
        assert state.step == 7 and chain[:, 0, 0].tolist() == [5.0]

    def test_no_steps(self):
        start = torch.zeros(2, dtype=torch.float64)
        state = ens.EnsembleState(start[None].repeat(4, 1),
                                  torch.zeros(4, dtype=torch.float64), 0)
        out = ens.run_chunked(state, None, 0)
        assert out[0] is state
        assert out[1].shape == (0, 4, 2) and len(out[3]) == 1
        assert out[3][0].shape == (0,)
