"""The port's priors, parameter tree, CV forward model and example data,
against the JAX package and the golden file (float64, CPU)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfit_python_tpu import examples as jex
from lfit_python_tpu.models import cv as jcv
from lfit_python_tpu.models import priors as jpr
from lfit_python_tpu_torch import convert
from lfit_python_tpu_torch import examples as tex
from lfit_python_tpu_torch.models import cv as tcv
from lfit_python_tpu_torch.models import priors as tpr

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden" / "golden_v1.npz"
CFG = dict(n_disc_rad=8, n_disc_az=12, n_spot=12, n_donor_lat=8,
           n_donor_lon=12)
SIMPLE = [0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01, 0.02, 160.0,
          0.2, 1.5, 0.0]
COMPLEX = SIMPLE + [2.0, 1.3, 80.0, 15.0]
PHASES = np.linspace(-0.15, 0.15, 61)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


class TestGoldenFluxes:
    @pytest.mark.parametrize("tag,pars,cplx", [
        ("simple", SIMPLE, False), ("complex", COMPLEX, True)])
    def test_model_fluxes(self, tag, pars, cplx):
        golden = np.load(GOLDEN)
        with torch.inference_mode():
            f = tcv.cv_fluxes(t64(pars), t64(PHASES), config=tcv.CVConfig(
                complex_spot=cplx, **CFG))
        for name in ("total", "ywd", "ydisc", "yspot", "ysec"):
            np.testing.assert_allclose(
                getattr(f, name).numpy(), golden[f"{tag}_{name}"],
                rtol=1e-9, atol=1e-12, err_msg=f"{tag}.{name}")


def test_batched_fluxes_with_widths_match_jax():
    """Two parameter vectors at once, finite exposures (sub-phase WD
    smearing, interval-overlap visibility) and an odd azimuth count (no
    mirror halving), against the JAX package vmapped."""
    rng = np.random.default_rng(4)
    pars = np.array([COMPLEX, COMPLEX])
    pars[1, 4] = 0.2                     # q
    pars[1, 6] = 0.5                     # rdisc
    pars[1, 10] = 140.0                  # az
    ph = np.sort(rng.uniform(-0.1, 0.1, (2, 40)), axis=-1)
    wd = rng.uniform(0.001, 0.004, (2, 40))
    cfg = dict(CFG, n_disc_az=11, complex_spot=True)
    ref = jax.vmap(lambda p, a, b: jcv.cv_fluxes(
        p, a, b, config=jcv.CVConfig(**cfg)))(pars, ph, wd)
    with torch.inference_mode():
        got = tcv.cv_fluxes(t64(pars), t64(ph), t64(wd),
                            config=tcv.CVConfig(**cfg))
    for name in ("total", "ywd", "ydisc", "yspot", "ysec"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-9, atol=1e-12, err_msg=name)


def test_spot_elements_match_jax():
    """The strip from its own stream integration (impact not given)."""
    from lfit_python_tpu.models import components as jcomp
    from lfit_python_tpu_torch.models import components as tcomp

    q, rdisc, scale, az, e1, e2 = 0.15, 0.3, 0.02, 150.0, 1.5, 1.2
    ref_pos, ref_w = jcomp.spot_elements(q, rdisc, scale, az, e1, e2, 12)
    with torch.inference_mode():
        pos, w = tcomp.spot_elements(*(t64(v) for v in (
            q, rdisc, scale, az, e1, e2)), 12)
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref_pos), atol=1e-10)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=1e-12)


class TestPriors:
    @pytest.mark.parametrize("kind,p1,p2", [
        ("uniform", -1.0, 2.0), ("log_uniform", 0.01, 3.0),
        ("gauss", 0.3, 0.05), ("gaussPos", 0.1, 0.2),
        ("mod_jeff", 0.05, 2.0), ("uniform", -25.0, 0.0)])
    def test_families_match_jax(self, kind, p1, p2):
        vals = np.linspace(-1.5, 3.5, 41)
        params_t = [tpr.Param("x", 0.0, tpr.Prior(kind, p1, p2))]
        params_j = [jpr.Param("x", 0.0, jpr.Prior(kind, p1, p2))]
        table_t = tpr.make_prior_table(params_t)
        table_j = jpr.make_prior_table(params_j)
        got = tpr.ln_prior_table(t64(vals[:, None]), table_t).numpy()
        ref = np.asarray(jax.vmap(lambda v: jpr.ln_prior_table(
            v[None], table_j))(vals))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        ok = np.isfinite(ref)
        # every family but gauss has a bounded support inside the sweep
        assert ok.any() and ok.all() == (kind == "gauss")
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-12)

    def test_unknown_family_raises(self):
        with pytest.raises(ValueError):
            tpr.Prior("cauchy", 0, 1)


@pytest.fixture(scope="module")
def models():
    """The same 2-eclipse mixed-spot model built by both packages."""
    kw = dict(n_eclipses=2, complex_spot=[False, True], n_points=16,
              bands=("g",))
    return jex.build_model(**kw).compile(), tex.build_model(**kw).compile()


class TestTreeAndData:
    def test_build_model_data_matches_jax(self, models):
        jm, tm = models
        for name in ("data_phase", "data_flux", "data_err", "data_width"):
            np.testing.assert_allclose(getattr(tm, name),
                                       getattr(jm, name), rtol=0, atol=1e-9,
                                       err_msg=name)
        np.testing.assert_array_equal(tm.data_mask, jm.data_mask)

    def test_index_maps_match_jax(self, models):
        jm, tm = models
        assert tm.param_names == jm.param_names
        for name in ("full_start", "var_idx", "var_pos", "scatter", "cv_idx",
                     "cv_const", "gp_idx", "gp_mask"):
            np.testing.assert_array_equal(getattr(tm, name),
                                          getattr(jm, name), err_msg=name)
        for name in ("codes", "p1", "p2"):
            np.testing.assert_array_equal(getattr(tm.prior_table, name),
                                          getattr(jm.prior_table, name))
        assert (tm.any_complex, tm.any_gp) == (jm.any_complex, jm.any_gp)
        assert tm.n_eclipses == 2 and tm.n_var == jm.n_var

    def test_gathers_match_jax(self, models):
        jm, tm = models
        rng = np.random.default_rng(1)
        var = jm.var_start()[None] + 0.01 * rng.standard_normal(
            (3, jm.n_var))
        full_j = np.stack([np.asarray(jm.full_from_var(jnp.asarray(v)))
                           for v in var])
        full_t = tm.full_from_var(t64(var))
        np.testing.assert_array_equal(full_t.numpy(), full_j)
        np.testing.assert_array_equal(tm.full_from_var(var), full_j)
        cvp_j = np.stack([np.asarray(jm.cv_params(jnp.asarray(f)))
                          for f in full_j])
        np.testing.assert_array_equal(tm.cv_params(full_t).numpy(), cvp_j)

    def test_from_jax_model_and_dict(self, models):
        jm, tm = models
        for src in (jm, {k: getattr(jm, k) for k in (
                "param_names", "prior_table", "any_complex", "any_gp",
                *convert._ARRAYS)}):
            cm = convert.from_jax_model(src)
            for name in convert._ARRAYS:
                np.testing.assert_array_equal(getattr(cm, name),
                                              getattr(jm, name))
            assert cm.param_names == tm.param_names

    def test_state_from_numpy(self):
        st = convert.state_from_numpy(np.ones((4, 3)), np.zeros(4), 7,
                                      device="cpu")
        assert st.positions.shape == (4, 3) and st.step == 7
        assert st.log_prob.dtype == torch.float64


def test_port_never_imports_jax():
    """Every module of the package and every tools/torch_*.py imports
    without jax or the JAX package; none pulls in matplotlib or arviz
    (the card's machine has neither: they are imported where a plot or
    an ArviZ file is made)."""
    code = (
        "import importlib, importlib.util, pathlib, pkgutil, sys\n"
        "import lfit_python_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 21, names\n"
        "tools = sorted(pathlib.Path('tools').glob('torch_*.py'))\n"
        "for path in tools:\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert len(tools) >= 10, tools\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith(('jax.', 'jaxlib', 'lfit_python_tpu.',\n"
        "                     'matplotlib', 'arviz'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(names), len(tools))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
