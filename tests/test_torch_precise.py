"""The port's mixed-precision mode (the JAX package's ``--precise``)
against the JAX package, on the CPU.

The mode keeps a float32 posterior but solves the per-walker geometry
again in float64, builds the disc grid in float64, and takes the contact
and white-dwarf decision quantity c = Phi - Phi_L1 in float64 near the
roots.  Each part is held to its JAX counterpart on the same float32
inputs:

- the plain precise contact solver against ``contact_interval(...,
  precise=, p64=)``, on north-star rows and on stress rows (q, incl and
  elements drawn wide): flags equal on all but 1e-4 of the elements,
  phases to a median of 1e-9 and a max of 1e-5 cycles (f32 rounding of
  the final phase is ~1e-8 cycles);
- ``cv_fluxes`` in float32 with ``mixed_precision``: every component
  within 1e-6 of the largest total of the JAX package's, and of
  tests/golden/golden_v1.npz (the JAX package's own gate,
  tests/test_golden.py);
- the float32 posterior with ``mixed_precision`` at 16 walkers: the -inf
  pattern equal, ln p within 1e-5 x max(1, |ln p|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu.models.cv import CVConfig as JCfg
from lfit_python_tpu.models.cv import cv_fluxes as jcv_fluxes
from lfit_python_tpu.models.likelihood import make_ln_prob as jmake
from lfit_python_tpu.roche import geometry as jg
from lfit_python_tpu_torch.convert import from_jax_model
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models import components as comp
from lfit_python_tpu_torch.models.cv import CVConfig, core_precise, cv_fluxes
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.ops import contacts
from lfit_python_tpu_torch.roche import geometry as tg

from test_torch_posterior import TINY, jax_twin, walkers

GOLDEN = np.load(__import__("pathlib").Path(__file__).parent / "golden"
                 / "golden_v1.npz")
CFG = dict(n_disc_rad=8, n_disc_az=12, n_spot=12, n_donor_lat=8,
           n_donor_lon=12)
SIMPLE = np.array([0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01,
                   0.02, 160.0, 0.2, 1.5, 0.0])
COMPLEX = np.concatenate([SIMPLE, [2.0, 1.3, 80.0, 15.0]])
PHASES = np.linspace(-0.15, 0.15, 61)
F32, F64 = torch.float32, torch.float64


def contact_rows(kind, seed=7, rows=12, n=200):
    """float32 rows and their float64 solve, as the mixed mode hands them
    to the contact solver: (q, incl, x1, pl1, r_ins) in float32, (q,
    incl, x1, pl1) in float64 from the float32 q, and element positions
    in float64 with their float32 rounding."""
    rng = np.random.default_rng(seed)
    if kind == "north star":
        q = 0.15 + 0.01 * rng.standard_normal(rows)
        dphi = np.full(rows, 0.04)
        r = rng.uniform(0.02, 0.45, (rows, n))
    else:
        q = rng.uniform(0.05, 1.0, rows)
        dphi = rng.uniform(0.03, 0.12, rows)
        r = rng.uniform(0.0, 0.6, (rows, n))
    th = rng.uniform(0, 2 * np.pi, (rows, n))
    q32 = torch.tensor(q, dtype=F32)
    x1 = tg.xl1(q32)
    pl1 = tg.l1_potential(q32, x1)
    incl = tg.findi(q32, torch.tensor(dphi, dtype=F32), x1, pl1)
    q64 = q32.double()
    x164 = tg.xl1(q64)
    pl164 = tg.l1_potential(q64, x164)
    incl64 = tg.findi(q64, torch.tensor(dphi, dtype=F32).double(), x164,
                      pl164)
    p64 = (torch.tensor(r * np.cos(th)), torch.tensor(r * np.sin(th)))
    r_ins = tg.inscribed_radius(q32, x1, pl1)
    ok = torch.isfinite(incl) & torch.isfinite(incl64)
    return ([a[ok] for a in (q32, incl, x1, pl1, r_ins)],
            tuple(a[ok] for a in (q64, incl64, x164, pl164)),
            tuple(a[ok] for a in p64))


def jax_precise(f32_rows, precise, p64):
    q, incl, x1, pl1, r_ins = (jnp.asarray(a.numpy()) for a in f32_rows)
    pos64 = np.stack([p64[0].numpy(), p64[1].numpy(),
                      np.zeros(p64[0].shape)], -1)
    pos32 = jnp.asarray(pos64, jnp.float32)

    def one(q, incl, p, x1, pl1, r_ins, prec, p_64):
        return jg.contact_interval(q, incl, p, x1, pl1, precise=prec,
                                   p64=p_64, r_ins=r_ins)

    f = jax.jit(jax.vmap(jax.vmap(
        one, in_axes=(None, None, 0, None, None, None, None, 0))))
    out = f(q, incl, pos32, x1, pl1, r_ins,
            tuple(jnp.asarray(a.numpy()) for a in precise),
            jnp.asarray(pos64))
    return [np.asarray(o) for o in out]


class TestPreciseContactSolver:
    @pytest.mark.parametrize("kind", ["north star", "stress"])
    def test_plain_matches_jax(self, kind):
        rows, precise, p64 = contact_rows(kind)
        px, py = (a.to(F32) for a in p64)
        got = contacts.element_intervals_plain(
            rows[0], rows[1], px, py, *rows[2:], precise=precise, p64=p64)
        assert got[0].dtype == F32
        ref = jax_precise(rows, precise, p64)
        ecl, ref_ecl = got[2].numpy(), ref[2]
        assert (ecl != ref_ecl).mean() <= 1e-4
        both = ecl & ref_ecl
        assert 0 < both.sum() < both.size
        err = np.concatenate([np.abs(got[k].numpy() - ref[k])[both]
                              for k in (0, 1)])
        assert np.median(err) <= 1e-9
        assert err.max() <= 1e-5
        # the never-eclipsed get the empty interval at phi_c
        vis = ~ecl
        np.testing.assert_array_equal(got[0].numpy()[vis],
                                      got[1].numpy()[vis])

    def test_routing_on_cpu(self):
        rows, precise, p64 = contact_rows("north star", rows=3, n=40)
        px, py = (a.to(F32) for a in p64)
        before = (contacts.LAUNCHES, contacts.F64_LAUNCHES,
                  contacts.MIXED_LAUNCHES)
        got = contacts.element_intervals(rows[0], rows[1], px, py, *rows[2:],
                                         precise=precise, p64=p64)
        ref = contacts.element_intervals_plain(
            rows[0], rows[1], px, py, *rows[2:], precise=precise, p64=p64)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        # a float32 solve without precise differs: the mode is live
        fast = contacts.element_intervals(rows[0], rows[1], px, py,
                                          *rows[2:])
        assert not torch.equal(fast[0], got[0])
        assert (contacts.LAUNCHES, contacts.F64_LAUNCHES,
                contacts.MIXED_LAUNCHES) == before

    def test_mixed_wrapper_refuses_other_devices(self):
        rows, precise, p64 = contact_rows("north star", rows=3, n=40)
        px, py = (a.to(F32).to("meta") for a in p64)
        with pytest.raises(ValueError):
            contacts.element_intervals_mixed_kernel(
                *[a.to("meta") for a in rows[:2]], px, py,
                *[a.to("meta") for a in rows[2:]], precise, p64)


class TestPreciseFluxes:
    @pytest.mark.parametrize("tag,pars,cplx", [
        ("simple", SIMPLE, False), ("complex", COMPLEX, True)])
    def test_f32_precise_matches_jax_and_golden(self, tag, pars, cplx):
        cfg = CVConfig(complex_spot=cplx, mixed_precision=True, **CFG)
        got = cv_fluxes(torch.tensor(pars, dtype=F32),
                        torch.tensor(PHASES, dtype=F32), config=cfg)
        ref = jcv_fluxes(jnp.asarray(pars, jnp.float32),
                         jnp.asarray(PHASES, jnp.float32),
                         config=JCfg(complex_spot=cplx, mixed_precision=True,
                                     n_donor_quad=0, pallas_contacts=False,
                                     **CFG))
        scale = float(np.max(np.abs(GOLDEN[f"{tag}_total"])))
        for name in ("total", "ywd", "ydisc", "yspot", "ysec"):
            g = getattr(got, name)
            assert g.dtype == F32
            g = g.double().numpy()
            d_jax = np.abs(g - np.asarray(getattr(ref, name), np.float64))
            d_gold = np.abs(g - GOLDEN[f"{tag}_{name}"])
            assert d_jax.max() / scale < 1e-6, (name, d_jax.max() / scale)
            assert d_gold.max() / scale < 1e-6, (name, d_gold.max() / scale)

    def test_the_mode_changes_only_float32(self):
        pars = torch.tensor(SIMPLE)
        ph = torch.tensor(PHASES)
        on = cv_fluxes(pars, ph, config=CVConfig(mixed_precision=True,
                                                  **CFG))
        off = cv_fluxes(pars, ph, config=CVConfig(**CFG))
        assert torch.equal(on.total, off.total)
        q, dphi = torch.tensor(0.15), torch.tensor(0.04)
        assert core_precise(q.double(), dphi.double(),
                            CVConfig(mixed_precision=True), F64) is None
        assert core_precise(q.float(), dphi.float(), CVConfig(), F32) is None
        got = core_precise(q.float(), dphi.float(),
                           CVConfig(mixed_precision=True), F32)
        assert all(a.dtype == F64 for a in got)

    def test_precise_path_is_not_differentiable(self):
        rows, precise, p64 = contact_rows("north star", rows=3, n=40)
        pos = torch.stack([p64[0], p64[1], torch.zeros_like(p64[0])],
                          dim=-1).to(F32).requires_grad_()
        with pytest.raises(ValueError, match="not differentiable"):
            comp.element_intervals(rows[0], rows[1], pos, rows[2], rows[3],
                                   precise=precise,
                                   positions64=pos.detach().double())


@pytest.fixture(scope="module")
def precise_posteriors():
    spec = build_model(n_eclipses=2, complex_spot=[False, True],
                       n_points=16, bands=("g",))
    jm = jax_twin(spec)
    jlp = jax.jit(jax.vmap(jmake(jm, config=JCfg(
        n_donor_quad=0, pallas_contacts=False, mixed_precision=True,
        **TINY), dtype=jnp.float32)))
    tm = from_jax_model(jm)
    tlp = make_ln_prob(tm, CVConfig(mixed_precision=True, **TINY),
                       dtype=F32, device="cpu")
    return jlp, tm, tlp


def test_precise_posterior_matches_jax(precise_posteriors):
    jlp, tm, tlp = precise_posteriors
    pos = walkers(tm, 16, 4).astype(np.float32)
    names = tm.var_names()
    pos[14, names.index("phi0_ecl0")] = 0.2          # outside its prior
    pos[15, names.index("dphi_core")] = 0.19          # no inclination fits
    ref = np.asarray(jlp(jnp.asarray(pos)), np.float64)
    got = tlp(torch.tensor(pos)).double().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    ok = np.isfinite(ref)
    assert ok.sum() == 14
    assert (np.abs(got[ok] - ref[ok])
            <= 1e-5 * np.maximum(1.0, np.abs(ref[ok]))).all()
    # the float32 posterior without the mode is another function
    fast = make_ln_prob(tm, CVConfig(**TINY), dtype=F32, device="cpu")
    assert not torch.equal(fast(torch.tensor(pos)),
                           tlp(torch.tensor(pos)))
