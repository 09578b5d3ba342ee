"""The port's Roche geometry against the JAX package and the golden file.

Inputs are drawn from a seeded numpy generator and handed to both
packages; everything runs in float64 on the CPU, where the port's
elementwise tensor code and the JAX reference's vmapped scalar code do the
same arithmetic, so the tolerances are a few ulps above rounding.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.roche import geometry as tg

GOLDEN = Path(__file__).parent / "golden" / "golden_v1.npz"


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(11)
    q = rng.uniform(0.05, 1.5, 24)
    dphi = rng.uniform(0.02, 0.09, 24)
    return q, dphi


class TestScalarSolves:
    def test_xl1_l1_potential(self, draws):
        q, _ = draws
        np.testing.assert_allclose(
            tg.xl1(t64(q)).numpy(), np.asarray(jax.vmap(jg.xl1)(q)),
            rtol=1e-12)
        np.testing.assert_allclose(
            tg.l1_potential(t64(q)).numpy(),
            np.asarray(jax.vmap(jg.l1_potential)(q)), rtol=1e-12)

    def test_findi(self, draws):
        q, dphi = draws
        ref = np.asarray(jax.vmap(jg.findi)(q, dphi))
        got = tg.findi(t64(q), t64(dphi)).numpy()
        # the same NaN (infeasible) pattern, then rel 1e-10 elsewhere
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert ok.sum() > 12
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-10)

    def test_infeasible_is_nan(self):
        # q = 0.05 cannot give an eclipse 0.2 cycles wide at any i <= 90
        assert torch.isnan(tg.findi(t64([0.05]), t64([0.2])))[0]

    @pytest.mark.parametrize("q", [0.08, 0.15, 0.5, 1.5])
    def test_golden(self, q):
        g = np.load(GOLDEN)
        assert tg.xl1(t64([q])).item() == pytest.approx(
            float(g[f"xl1_{q}"]), rel=1e-12)
        assert tg.findi(t64([q]), t64([0.04])).item() == pytest.approx(
            float(g[f"findi_{q}"]), rel=1e-10)

    def test_inscribed_and_lobe_radius(self, draws):
        q, _ = draws
        np.testing.assert_allclose(
            tg.inscribed_radius(t64(q)).numpy(),
            np.asarray(jax.vmap(jg.inscribed_radius)(q)), rtol=1e-12)
        d = np.array([0.6, -0.48, 0.64])
        np.testing.assert_allclose(
            tg.lobe_radius(t64(q), t64(d)).numpy(),
            np.asarray(jax.vmap(lambda qq: jg.lobe_radius(
                qq, jnp.asarray(d)))(q)), rtol=1e-12)

    def test_earth_vector(self):
        ph = np.linspace(-0.3, 0.3, 7)
        np.testing.assert_allclose(
            tg.earth_vector(t64(ph), t64(83.0)).numpy(),
            np.asarray(jg.earth_vector(ph, 83.0)), atol=1e-15)


class TestClearance:
    def test_origin_shadow_distance(self, draws):
        q, dphi = draws
        i = np.asarray(jax.vmap(jg.findi)(q, dphi))
        ok = ~np.isnan(i)
        q, i = q[ok][:6], i[ok][:6]
        x1 = np.asarray(jax.vmap(jg.xl1)(q))
        pl1 = np.asarray(jax.vmap(jg.l1_potential)(q))
        ph = np.linspace(-0.08, 0.08, 33)
        d_ref, c_ref = jax.vmap(
            lambda a, b, c, e: jg.origin_shadow_distance(a, b, ph, c, e))(
                q, i, x1, pl1)
        d, c = tg.origin_shadow_distance(
            t64(q)[:, None], t64(i)[:, None], t64(ph), t64(x1)[:, None],
            t64(pl1)[:, None])
        np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-12)
        np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-12)

    def test_ray_clearance_oracle(self):
        rng = np.random.default_rng(3)
        q = 0.15
        x1 = float(jg.xl1(q))
        pl1 = float(jg.l1_potential(q))
        r = rng.uniform(0.02, 0.45, 64)
        th = rng.uniform(0, 2 * np.pi, 64)
        p = np.stack([r * np.cos(th), r * np.sin(th), np.zeros(64)], -1)
        e = np.asarray(jg.earth_vector(rng.uniform(-0.05, 0.05, 64), 84.0))
        ref = np.asarray(jax.vmap(
            lambda pp, ee: jg.ray_clearance(q, pp, ee, x1, pl1))(p, e))
        got = tg.ray_clearance(t64(q), t64(p), t64(e), t64(x1),
                               t64(pl1)).numpy()
        assert (ref < 0).sum() > 5          # the draw does occult
        np.testing.assert_allclose(got, ref, atol=1e-12)

    def test_visible_fraction_interval(self):
        rng = np.random.default_rng(5)
        ph = rng.uniform(-0.2, 0.2, 50)
        w = rng.uniform(0.0, 0.02, 50)
        pin = rng.uniform(-0.05, 0.0, 50)
        pout = pin + rng.uniform(0.0, 0.05, 50)
        ecl = rng.uniform(size=50) < 0.8
        ref = np.asarray(jg.visible_fraction_interval(ph, w, pin, pout, ecl))
        got = tg.visible_fraction_interval(
            t64(ph), t64(w), t64(pin), t64(pout), torch.tensor(ecl)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-12)
