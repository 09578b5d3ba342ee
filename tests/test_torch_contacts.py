"""The contact solver K1: its plain version, routing and wrapper checks.

The plain version is held to the JAX package's two contact solvers:
  * float64, against ``components.element_intervals`` (the XLA solver):
    flags equal, phases to 1e-10 cycles;
  * float32, against the Pallas kernel in interpret mode, as
    tests/test_pallas.py runs it: flags equal, phases to 1e-5 cycles (the
    same bound test_pallas.py holds Pallas to XLA by; separately compiled
    float32 programs round differently and a graze element amplifies the
    ulps through the bracket decisions).
The CUDA kernel itself is tested against the plain version on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models import components as jcomp
from lfit_python_tpu.ops.pallas_contacts import element_intervals_pallas
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.ops import contacts
from lfit_python_tpu_torch.roche import geometry as tg


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    W, N = 5, 200
    q = 0.15 + 0.01 * rng.standard_normal(W)
    dphi = np.full(W, 0.04)
    x1 = np.asarray(jax.vmap(jg.xl1)(q))
    pl1 = np.asarray(jax.vmap(jg.l1_potential)(q))
    incl = np.asarray(jax.vmap(jg.findi)(q, dphi))
    r = rng.uniform(0.05, 0.4, (W, N))
    th = rng.uniform(0, 2 * np.pi, (W, N))
    pos = np.stack([r * np.cos(th), r * np.sin(th), np.zeros((W, N))], -1)
    return q, incl, x1, pl1, pos


def _args(batch, dtype):
    q, incl, x1, pl1, pos = batch

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    r_ins = tg.inscribed_radius(t(q), t(x1), t(pl1))
    return (t(q), t(incl), t(pos[..., 0]), t(pos[..., 1]), t(x1), t(pl1),
            r_ins)


class TestPlainVersion:
    def test_f64_matches_xla_solver(self, batch):
        q, incl, x1, pl1, pos = batch
        pin, pout, ecl = contacts.element_intervals_plain(
            *_args(batch, torch.float64))
        for k in range(len(q)):
            ri, ro, re = jcomp.element_intervals(q[k], incl[k],
                                                 jnp.asarray(pos[k]), x1[k],
                                                 pl1[k])
            np.testing.assert_array_equal(ecl[k].numpy(), np.asarray(re))
            np.testing.assert_allclose(pin[k].numpy(), np.asarray(ri),
                                       atol=1e-10)
            np.testing.assert_allclose(pout[k].numpy(), np.asarray(ro),
                                       atol=1e-10)
        assert 50 < int(ecl.sum()) < ecl.numel()

    def test_f32_matches_pallas_interpret(self, batch):
        q, incl, x1, pl1, pos = batch
        ri, ro, re = element_intervals_pallas(
            q, incl, pos[..., 0], pos[..., 1], x1, pl1, interpret=True)
        pin, pout, ecl = contacts.element_intervals_plain(
            *_args(batch, torch.float32))
        assert pin.dtype == torch.float32
        np.testing.assert_array_equal(ecl.numpy(), np.asarray(re))
        m = np.asarray(re)
        np.testing.assert_allclose(pin.numpy()[m], np.asarray(ri)[m],
                                   atol=1e-5)
        np.testing.assert_allclose(pout.numpy()[m], np.asarray(ro)[m],
                                   atol=1e-5)

    def test_empty_interval_where_not_eclipsed(self, batch):
        pin, pout, ecl = contacts.element_intervals_plain(
            *_args(batch, torch.float64))
        assert torch.equal(pin[~ecl], pout[~ecl])
        assert bool((pout[ecl] > pin[ecl]).all())

    def test_mirror_identity(self, batch):
        """(px, -py) has interval (-phi_out, -phi_in): what cv_fluxes's
        halved disc solve relies on."""
        args = list(_args(batch, torch.float64))
        pin, pout, ecl = contacts.element_intervals_plain(*args)
        args[3] = -args[3]
        min_, mout, mecl = contacts.element_intervals_plain(*args)
        assert torch.equal(ecl, mecl)
        np.testing.assert_allclose(min_[ecl].numpy(), -pout[ecl].numpy(),
                                   atol=1e-15)
        np.testing.assert_allclose(mout[ecl].numpy(), -pin[ecl].numpy(),
                                   atol=1e-15)

    def test_nan_row_gives_empty_interval(self, batch):
        args = list(_args(batch, torch.float64))
        args[1] = args[1].clone()
        args[1][0] = float("nan")
        pin, pout, ecl = contacts.element_intervals_plain(*args)
        assert not bool(ecl[0].any())
        assert torch.equal(pin[0], pout[0])


class TestRouting:
    def test_dtype_rule_on_cpu(self, batch):
        before = contacts.LAUNCHES
        for dt in (torch.float32, torch.float64):
            args = _args(batch, dt)
            got = contacts.element_intervals(*args)
            ref = contacts.element_intervals_plain(*args)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
            assert got[0].dtype == dt
        # the kernel wrapper takes the plain version only for CPU tensors,
        # and counts no launch for it
        got = contacts.element_intervals_kernel(*_args(batch, torch.float32))
        assert contacts.LAUNCHES == before
        assert got[2].dtype == torch.bool

    def test_kernel_wrapper_refuses_other_devices(self, batch):
        args = [a.to("meta") for a in _args(batch, torch.float32)]
        with pytest.raises(ValueError):
            contacts.element_intervals_kernel(*args)
