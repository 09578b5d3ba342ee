"""The port's gradients against the JAX package's (float64 unless stated).

Every root solve of the port carries its implicit-function-theorem (IFT)
tangent; these tests hold each one, the contact phases' backward and the
stream's forward sensitivities to ``jax.grad`` / ``jax.jacfwd`` of the
reference on the same seeded inputs.  Where both sides do the same
float64 arithmetic the tolerance is rtol 1e-8 (rounding, grown through a
4352-step integration at most).  The whole posterior's gradient is in
tests/test_torch_grad_posterior.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import components as jcomp
from lfit_python_tpu.ops.pallas_contacts import contacts_op_diff
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu.roche import stream as js
from lfit_python_tpu_torch.models import components as tcomp
from lfit_python_tpu_torch.ops import contacts
from lfit_python_tpu_torch.ops import stream as tstream
from lfit_python_tpu_torch.roche import geometry as tg
from lfit_python_tpu_torch.roche import stream as ts
from jax_fresh_compiles import fresh_jax_compiles  # noqa: F401


def leaf(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)


def grad_of(out, inputs, cot=None):
    """Gradient of sum(cot * out) in ``inputs`` (a walker-wise vjp)."""
    cot = torch.ones_like(out) if cot is None else cot
    return [g.numpy() for g in torch.autograd.grad((out * cot).sum(),
                                                   inputs)]


@pytest.fixture(scope="module")
def qs():
    rng = np.random.default_rng(21)
    return rng.uniform(0.05, 1.5, 12), rng.uniform(0.02, 0.09, 12)


class TestRootTangents:
    def test_xl1(self, qs):
        q, _ = qs
        tq = leaf(q)
        got, = grad_of(tg.xl1(tq), [tq])
        ref = np.asarray(jax.jit(jax.vmap(jax.grad(jg.xl1)))(q))
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    def test_findi(self, qs):
        q, dphi = qs
        dphi = dphi.copy()
        dphi[0] = 0.19                       # infeasible: NaN inclination
        tq, td = leaf(q), leaf(dphi)
        i = tg.findi(tq, td)
        assert torch.isnan(i[0])
        gq, gd = grad_of(i, [tq, td])
        rq, rd = (np.asarray(a) for a in jax.jit(jax.vmap(
            jax.grad(jg.findi, argnums=(0, 1))))(q, dphi))
        # an infeasible walker gets a zero gradient, as in the reference
        assert gq[0] == 0.0 and gd[0] == 0.0
        np.testing.assert_allclose(gq, rq, rtol=1e-8)
        np.testing.assert_allclose(gd, rd, rtol=1e-8)

    def test_lobe_and_inscribed_radius(self, qs):
        q, _ = qs
        d = np.array([0.6, -0.48, 0.64])
        tq = leaf(q)
        got, = grad_of(tg.lobe_radius(tq, torch.tensor(d)), [tq])
        ref = np.asarray(jax.vmap(jax.grad(
            lambda qq: jg.lobe_radius(qq, jnp.asarray(d))))(q))
        np.testing.assert_allclose(got, ref, rtol=1e-8)
        got, = grad_of(tg.inscribed_radius(tq), [tq])
        ref = np.asarray(jax.vmap(jax.grad(jg.inscribed_radius))(q))
        np.testing.assert_allclose(got, ref, rtol=1e-8)

    @pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-8),
                                            (torch.float32, 2e-3)])
    def test_donor_grid(self, qs, dtype, rtol):
        """Both solver branches: f64 bisection, f32 bisection + Newton;
        d(positions)/dq through x1, pl1 and the lobe radius."""
        q = qs[0][:4]
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        rng = np.random.default_rng(4)
        cot = rng.standard_normal((4, 6 * 8, 3))

        def jpos(qq):
            x1 = jg.xl1(qq)
            return jcomp.donor_grid(qq, x1, jg.l1_potential(qq, x1), 6, 8,
                                    jdt).positions

        ref = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jpos)))(q.astype(jdt)))
        ref = np.einsum("wnk,wnk->w", cot, ref)
        tq = leaf(q, dtype)
        x1 = tg.xl1(tq)
        grid = tcomp.donor_grid(tq, x1, tg.l1_potential(tq, x1), 6, 8)
        got, = grad_of(grid.positions, [tq], torch.tensor(cot, dtype=dtype))
        np.testing.assert_allclose(got, ref, rtol=rtol)


class TestEdgeFraction:
    def test_gradient_finite_at_the_edges(self):
        x = np.array([-1.5, -1.0, -0.4, 0.0, 0.3, 1.0, 1.5])
        tx, tu = leaf(x), leaf(np.full(7, 0.3))
        v = tcomp._edge_visible_fraction(tx, tu)
        gx, gu = grad_of(v, [tx, tu])
        rx, ru = (np.asarray(a) for a in jax.vmap(jax.grad(
            jcomp._edge_visible_fraction, argnums=(0, 1)))(x, np.full(7, 0.3)))
        assert np.isfinite(gx).all() and np.isfinite(gu).all()
        assert gx[1] == 0.0 and gx[5] == 0.0
        np.testing.assert_allclose(gx, rx, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(gu, ru, rtol=1e-12, atol=1e-15)

    def test_broadcast_limb_darkening(self):
        """ulimb (W, 1) against x (W, P): its gradient sums over P."""
        x = leaf(np.linspace(-0.9, 0.9, 8).reshape(2, 4))
        u = leaf([[0.2], [0.4]])
        gx, gu = grad_of(tcomp._edge_visible_fraction(x, u), [x, u])
        assert gu.shape == (2, 1)
        ref = np.asarray(jax.grad(lambda uu: jnp.sum(
            jcomp._edge_visible_fraction(x.detach().numpy(), uu)))(
                np.array([[0.2], [0.4]])))
        np.testing.assert_allclose(gu, ref, rtol=1e-12)


@pytest.fixture(scope="module")
def contact_batch():
    rng = np.random.default_rng(9)
    q, dphi = 0.15, 0.04
    x1 = float(jg.xl1(q))
    pl1 = float(jg.l1_potential(q))
    incl = float(jg.findi(q, dphi))
    n = 160
    r = rng.uniform(0.05, 0.4, n)
    th = rng.uniform(0, 2 * np.pi, n)
    return (q, incl, r * np.cos(th), r * np.sin(th), x1, pl1,
            rng.standard_normal((2, n)))


class TestContactGradient:
    def _port(self, batch, dtype, objective):
        q, incl, px, py, x1, pl1, _ = batch
        leaves = [leaf([q], dtype), leaf([incl], dtype), leaf(px[None], dtype),
                  leaf(py[None], dtype), leaf([x1], dtype), leaf([pl1], dtype)]
        lq, _, _, _, lx1, lpl1 = leaves
        r_ins = tg.inscribed_radius(lq, lx1, lpl1).detach()
        before = contacts.BACKWARD_CALLS
        out = contacts.element_intervals_diff(*leaves, r_ins)
        grads = grad_of(objective(*out), leaves)
        assert contacts.BACKWARD_CALLS == before + 1
        return [g.reshape(-1) for g in grads], out[2]

    def test_f64_matches_contact_interval_jvp(self, contact_batch):
        """Random cotangents on both edges of every element, eclipsed or
        not, against jax.grad of the XLA solver's custom JVP."""
        q, incl, px, py, x1, pl1, cot = contact_batch

        def f(qq, ii, pxx, pyy, xv, pll):
            def one(a, b):
                return jg.contact_interval(qq, ii, jnp.stack(
                    [a, b, jnp.zeros_like(a)]), xv, pll)[:2]
            pin, pout = jax.vmap(one)(pxx, pyy)
            return jnp.sum(cot[0] * pin + cot[1] * pout)

        ref = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
            q, incl, px, py, x1, pl1)
        c = torch.tensor(cot)
        got, ecl = self._port(contact_batch, torch.float64,
                              lambda pin, pout, _: pin * c[0] + pout * c[1])
        assert 20 < int(ecl.sum()) < ecl.numel()       # both branches
        for g, r, name in zip(got, ref, ("q", "incl", "px", "py", "x1",
                                         "pl1")):
            np.testing.assert_allclose(g, np.atleast_1d(np.asarray(r)),
                                       rtol=1e-8, atol=1e-12, err_msg=name)

    def test_f32_matches_contacts_op_diff_interpret(self, contact_batch):
        """float32 against the Pallas kernel's IFT wrapper in interpret
        mode, on tests/test_pallas.py's objective (the summed eclipse
        widths) and at its rtol 1e-4: the float32 roots of two solvers
        agree to ~1e-5 cycles, and the residual's coefficients inherit
        that.  (Random-sign cotangents cancel, and there the reference's
        own XLA and Pallas paths differ by 7e-4.)  x1 enters c only
        through the enclosing sphere's chord ends, so its gradient is
        exactly 0 on both sides."""
        q, incl, px, py, x1, pl1, _ = contact_batch
        f32 = jnp.float32
        pxj, pyj = jnp.asarray(px, f32), jnp.asarray(py, f32)

        def f(qq, ii, xv, pll):
            pin, pout, ecl = jax.vmap(contacts_op_diff,
                                      in_axes=(0, 0, None, None, 0, 0))(
                qq[None], ii[None], pxj, pyj, xv[None], pll[None])
            return jnp.sum(jnp.where(ecl[0], pout[0] - pin[0], 0.0))

        ref = jax.grad(f, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a, f32) for a in (q, incl, x1, pl1)))
        got, _ = self._port(
            contact_batch, torch.float32,
            lambda pin, pout, ecl: torch.where(ecl, pout - pin, 0.0))
        for g, r, name in zip([got[i] for i in (0, 1, 4, 5)], ref,
                              ("q", "incl", "x1", "pl1")):
            np.testing.assert_allclose(g, np.atleast_1d(np.asarray(r)),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


class TestStreamSensitivities:
    @pytest.fixture(scope="class")
    def sens(self):
        """test_torch_stream.py's inputs: three walkers, one radius the
        stream never reaches (closest-approach fallback)."""
        rng = np.random.default_rng(2)
        q = np.array([0.08, 0.15, 0.6])
        x1 = np.asarray(jax.vmap(jg.xl1)(q))
        rd = rng.uniform(0.3, 0.6, (3, 3)) * x1[:, None]
        rd[0, 2] = 0.02
        ref = jax.jit(jax.vmap(lambda a, b, c: js._stream_impacts_impl(
            a, b, c, js._N_STEPS, js._DT, 4, True)))(q, rd, x1)
        got = ts.stream_impacts_sens(*(torch.tensor(a) for a in (q, rd, x1)))
        return q, x1, rd, [np.asarray(r) for r in ref], got

    @pytest.mark.parametrize("k,name", [(0, "impacts"), (1, "jq"),
                                        (2, "jx0"), (3, "jrd")])
    def test_matches_jax(self, sens, k, name):
        *_, ref, got = sens
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-8,
                                   atol=1e-12 * np.abs(ref[k]).max(),
                                   err_msg=name)

    def test_fallback_radius(self, sens):
        *_, ref, got = sens
        # the unreached radius: no rdisc dependence, the closest step's
        # d/dq and d/dx0 columns
        assert np.all(got[3].numpy()[0, 2] == 0.0)
        assert np.abs(got[1].numpy()[0, 2]).max() > 0.0
        np.testing.assert_allclose(got[2].numpy()[0, 2], ref[2][0, 2],
                                   rtol=1e-8)

    def test_backward_applies_the_jacobians(self, sens):
        """autograd through ops.stream.stream_impacts is the transpose of
        the reference's JVP: dq = sum g.jq, dx1 = sum g.jx0, drd = g.jrd."""
        q, x1, rd, _, got = sens
        g = np.random.default_rng(5).standard_normal(got[0].shape)
        g[..., 2] = 0.0
        tq, trd, tx1 = leaf(q), leaf(rd), leaf(x1)
        before = tstream.SENS_LAUNCHES
        out = tstream.stream_impacts(tq, trd, tx1)
        gq, grd, gx1 = grad_of(out, [tq, trd, tx1], torch.tensor(g))
        assert tstream.SENS_LAUNCHES == before       # plain on the CPU
        jq, jx0, jrd = (a.numpy() for a in got[1:])
        np.testing.assert_allclose(gq, np.einsum("wek,wek->w", g, jq),
                                   rtol=1e-12)
        np.testing.assert_allclose(gx1, np.einsum("wek,wek->w", g, jx0),
                                   rtol=1e-12)
        np.testing.assert_allclose(grd, np.einsum("wek,wek->we", g, jrd),
                                   rtol=1e-12)
