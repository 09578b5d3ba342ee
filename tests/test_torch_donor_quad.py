"""The port's donor quadrature and the component oracles against the JAX
package (float64, CPU).

``donor_curve_nodes`` / ``donor_curve_eval`` against the JAX functions at
n_quad 32, 256 and 1024 (rtol 1e-12), and against exact per-phase donor
sums under tests/test_components.py's bounds (at most 1.2e-5 of the donor
flux at 256; 1024 below 0.4x that), batched and differentiable; the
oracles ``wd_visible_fraction``, ``disc_flux`` and ``spot_flux`` against
the JAX functions (rtol 1e-12); the TINY posterior at ``n_donor_quad``
0 and 256 against the JAX posterior at the same setting (rtol 1e-9), with
its gradient against ``jax.value_and_grad`` at 256 (rtol 1e-7); and the
north-star tree's flux with the quadrature within 1e-6 of the largest
total of the exact sums'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import components as jcomp
from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.convert import from_jax_model
from lfit_python_tpu_torch.examples import build_model, with_calib_widths
from lfit_python_tpu_torch.models import components as comp
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.roche import geometry as tg

from test_torch_posterior import TINY, jax_twin, walkers

DPHI = 0.04


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def geometry(q, incl_off=0.0):
    """(x1, pl1, incl) of the JAX package at mass ratio ``q``."""
    x1 = jg.xl1(q)
    pl1 = jg.l1_potential(q, x1)
    return x1, pl1, jg.findi(q, DPHI, x1, pl1) + incl_off


def both_grids(q):
    """The donor grid of both packages at ``q`` (default resolution)."""
    x1, pl1, incl = geometry(q)
    tgrid = comp.donor_grid(t64(q), t64(x1), t64(pl1))
    return jcomp.donor_grid(q, x1, pl1), tgrid, incl


PHASES = np.linspace(-0.7, 1.3, 1501)         # wraps and both folds


class TestAgainstJax:
    @pytest.mark.parametrize("n_quad", [32, 256, 1024])
    def test_nodes_and_curve(self, n_quad):
        jgrid, tgrid, incl = both_grids(0.15)
        jn = np.asarray(jcomp.donor_curve_nodes(incl, jgrid, 0.9, n_quad))
        tn = comp.donor_curve_nodes(t64(incl), tgrid, 0.9, n_quad)
        assert tn.shape == (n_quad + 1,)
        np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-12)
        ref = np.asarray(jcomp.donor_curve_eval(jnp.asarray(jn),
                                                jnp.asarray(PHASES)))
        got = comp.donor_curve_eval(t64(jn), t64(PHASES)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12)

    def test_wd_visible_fraction(self):
        q, rwd, ulimb = 0.15, 0.012, 0.35
        x1, pl1, incl = geometry(q)
        ph = np.linspace(-0.06, 0.06, 97)
        ref = np.asarray(jax.vmap(lambda p: jcomp.wd_visible_fraction(
            q, incl, p, rwd, ulimb, x1, pl1))(jnp.asarray(ph)))
        got = comp.wd_visible_fraction(t64(q), t64(incl), t64(ph), t64(rwd),
                                       ulimb, t64(x1), t64(pl1)).numpy()
        assert 0.0 <= got.min() < 1e-6 and got.max() == 1.0
        assert ((got > 1e-6) & (got < 1.0 - 1e-6)).sum() >= 8   # the edges
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)

    def test_disc_and_spot_flux(self):
        q = 0.15
        x1, pl1, incl = geometry(q)
        rdisc = 0.35 * x1
        ph = np.linspace(-0.08, 0.08, 41)
        jpos, jw = jcomp.disc_elements(0.012, rdisc, 1.0, 8, 12)
        args = (q, incl, ph)
        ref = np.asarray(jcomp.disc_flux(*args, jpos, jw, x1, pl1))
        got = comp.disc_flux(*map(t64, args + (jpos, jw, x1, pl1))).numpy()
        assert 0.0 < got.min() < 0.5 and got.max() == pytest.approx(1.0)
        np.testing.assert_allclose(got, ref, rtol=1e-12)
        spos, sw = jcomp.spot_elements(q, rdisc, 0.02, 130.0, 1.0, 1.0, 16)
        normal = jcomp.spot_normal(130.0, 90.0, 0.0)
        ref = np.asarray(jcomp.spot_flux(q, incl, ph, spos, sw, 0.2, normal,
                                         x1, pl1))
        got = comp.spot_flux(*map(t64, (q, incl, ph, spos, sw, 0.2, normal,
                                        x1, pl1))).numpy()
        assert got.min() < 0.5 * got.max()
        np.testing.assert_allclose(got, ref, rtol=1e-12)


class TestQuadratureAgainstExactSums:
    @pytest.mark.parametrize("q,incl_off", [(0.08, 0.0), (0.15, 0.0),
                                            (0.5, -3.0), (1.5, 2.0)])
    def test_interp_matches_exact(self, q, incl_off):
        """tests/test_components.py's cases and bounds: the curve's kinks
        hold interpolation to ~h^1.5, 1.2e-5 of the donor flux at 256."""
        x1, pl1, incl = (t64(a) for a in geometry(q, incl_off))
        grid = comp.donor_grid(t64(q), x1, pl1)
        ph = t64(PHASES)
        exact = comp.donor_flux(incl, ph, grid).numpy()
        errs = []
        for n_quad in (256, 1024):
            nodes = comp.donor_curve_nodes(incl, grid, 0.9, n_quad)
            approx = comp.donor_curve_eval(nodes, ph).numpy()
            errs.append(np.abs(approx - exact).max() / exact.max())
        assert errs[0] < 1.2e-5, f"donor interp error {errs[0]:.2e}"
        assert errs[1] < 0.4 * errs[0]

    def test_batched_shapes_and_gradient(self):
        """Per-walker nodes (W, n + 1) with phases (W, E, P) and (W, P)
        give each walker's own curve; gradients reach the nodes through
        the gather and the phases through the tap weights."""
        q = t64([0.12, 0.15, 0.3])
        x1 = tg.xl1(q)
        pl1 = tg.l1_potential(q, x1)
        incl = tg.findi(q, torch.full_like(q, DPHI), x1, pl1)
        grid = comp.donor_grid(q, x1, pl1)
        nodes = comp.donor_curve_nodes(incl, grid, 0.9, 64)
        assert nodes.shape == (3, 65)
        ph = t64(np.random.default_rng(0).uniform(-0.6, 0.6, (3, 2, 7)))
        batched = comp.donor_curve_eval(nodes, ph)
        flat = comp.donor_curve_eval(nodes, ph.reshape(3, 14))
        for w in range(3):
            one = comp.donor_curve_eval(nodes[w], ph[w].reshape(-1))
            assert torch.equal(batched[w].reshape(-1), one)
            assert torch.equal(flat[w], one)
        with pytest.raises(ValueError, match="leading axes"):
            comp.donor_curve_eval(nodes, ph.reshape(2, 3, 7))
        n = nodes.detach().clone().requires_grad_()
        p = ph.clone().requires_grad_()
        comp.donor_curve_eval(n, p).sum().backward()
        # each of a phase's four taps takes its weight; the weights of a
        # cubic interpolant sum to 1
        np.testing.assert_allclose(n.grad.sum(dim=-1).numpy(), 14.0,
                                   rtol=1e-12)
        h = 1e-7
        fd = (comp.donor_curve_eval(nodes, ph + h)
              - comp.donor_curve_eval(nodes, ph - h)) / (2 * h)
        np.testing.assert_allclose(p.grad.numpy(), fd.numpy(), rtol=1e-5,
                                   atol=1e-9 * nodes.abs().max().item())


@pytest.fixture(scope="module")
def widths_twins():
    """2 eclipses (one complex spot), one band, with the exposure widths
    a .calib light curve gets; the JAX compiled model and the port's."""
    spec = with_calib_widths(build_model(
        n_eclipses=2, complex_spot=[False, True], n_points=16, bands=("g",)))
    jm = jax_twin(spec)
    return jm, from_jax_model(jm)


class TestPosterior:
    @pytest.mark.parametrize("n_quad", [0, 256])
    def test_matches_jax(self, widths_twins, n_quad):
        jm, tm = widths_twins
        jlp = jax.jit(jax.vmap(jmake(jm, config=JCfg(
            n_donor_quad=n_quad, pallas_contacts=False, **TINY))))
        tlp = make_ln_prob(tm, CVConfig(n_donor_quad=n_quad, **TINY),
                           device="cpu")
        pos = walkers(tm, 4, 3)
        ref = np.asarray(jlp(pos))
        got = tlp(torch.tensor(pos)).numpy()
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got, ref, rtol=1e-9)

    def test_quadrature_moves_the_flux_little(self):
        """The north-star tree (5 eclipses of 128 points, 2 bands) at the
        default widths: the quadrature's total flux against the exact
        sums' within 1e-6 of the largest total flux, the parity gate that
        chip_smoke.py's phase 17 holds at 1024 walkers (5.2e-7 here)."""
        model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                            n_points=128, bands=("g", "r")).compile()
        pos = torch.tensor(walkers(model, 4, 4))
        f = [make_ln_prob(model, CVConfig(n_donor_quad=n),
                          device="cpu").model_flux(pos) for n in (0, 256)]
        rel = ((f[1] - f[0]).abs().amax() / f[0].abs().amax()).item()
        assert 0.0 < rel < 1e-6

    def test_value_and_grad_matches_jax_grad(self, widths_twins):
        jm, tm = widths_twins
        jlp = jmake(jm, config=JCfg(n_donor_quad=256, pallas_contacts=False,
                                    **TINY))
        tlp = make_ln_prob(tm, CVConfig(n_donor_quad=256, **TINY),
                           device="cpu")
        pos = walkers(tm, 2, 5)
        lp_ref, g_ref = (np.asarray(a) for a in
                         jax.jit(jax.vmap(jax.value_and_grad(jlp)))(pos))
        lp, g = tlp.value_and_grad(torch.tensor(pos))
        np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-7,
                                   atol=1e-9 * np.abs(g_ref).max())
