"""The frozen reference against the port's plain CPU path, and the
configuration files against the models they stand for."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lfit_bench.reference import spec
from lfit_bench.reference.posterior import Posterior as RefPosterior

HERE = Path(__file__).resolve().parents[1]
CONFIGS = ("hier5_calib", "prod10_gp")


def _config(name, **cut):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(cut)
    return cfg


def _port_classes():
    from lfit_python_tpu_torch.models import priors, tree
    return dict(Param=priors.Param, Prior=priors.Prior,
                Lightcurve=tree.Lightcurve, EclipseSpec=tree.EclipseSpec,
                HierarchicalModel=tree.HierarchicalModel)


def test_reference_imports_nothing_of_the_port():
    """No module of the reference imports the port, the JAX package or
    JAX (top-level names compared whole)."""
    banned = {"lfit_python_tpu_torch", "lfit_python_tpu", "jax", "jaxlib",
              "flax"}
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (path.name, n)


@pytest.mark.parametrize("name", CONFIGS)
def test_template_flux_is_the_reference_model(name):
    cfg = _config(name)
    for flavour, flux in cfg["template_flux"].items():
        made = spec.template_flux(cfg, flavour == "complex")
        np.testing.assert_allclose(flux, made, rtol=0, atol=1e-13)


@pytest.mark.parametrize("name, kw", [
    ("hier5_calib", dict(n_eclipses=5, complex_spot=[False] * 5)),
    ("prod10_gp", dict(n_eclipses=10, complex_spot=True, use_gp=True)),
])
def test_configuration_is_the_packages_model(name, kw):
    """The configuration's tree is the port's example model of the same
    shape (bench.py's), parameter for parameter and slot for slot."""
    from lfit_python_tpu_torch.examples import build_model, with_calib_widths

    cfg = _config(name)
    ours = spec.build_spec(cfg, spec.light_curves(cfg, 3),
                           _port_classes()).compile()
    theirs = build_model(n_points=128, bands=("g", "r"), **kw)
    if cfg["widths"] == "median_spacing":
        theirs = with_calib_widths(theirs)
    theirs = theirs.compile()
    assert ours.param_names == theirs.param_names
    for f in ("full_start", "var_idx", "scatter", "cv_idx", "cv_const",
              "gp_idx", "gp_mask", "data_phase", "data_err", "data_width",
              "data_mask"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    for f in ("codes", "p1", "p2"):
        np.testing.assert_array_equal(getattr(ours.prior_table, f),
                                      getattr(theirs.prior_table, f))


def test_light_curves_follow_the_seed():
    cfg = _config("hier5_calib")
    a, b = spec.light_curves(cfg, 2 ** 31 + 5), spec.light_curves(cfg, 2 ** 31 + 5)
    c = spec.light_curves(cfg, 2 ** 31 + 6)
    for k in a:
        np.testing.assert_array_equal(a[k][1], b[k][1])
        assert not np.array_equal(a[k][1], c[k][1])


@pytest.mark.parametrize("name, grad", [("hier5_calib", True),
                                        ("prod10_gp", False)])
def test_reference_is_the_ports_plain_path(name, grad):
    """float64 on the CPU, a few walkers of a two-eclipse cut: the
    reference's ln p (and gradient) are the port's plain path's."""
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    cfg = _config(name, n_eclipses=2)
    curves = spec.light_curves(cfg, 11)
    port = make_ln_prob(spec.build_spec(cfg, curves,
                                        _port_classes()).compile(),
                        dtype=torch.float64, device="cpu")
    ref = RefPosterior(spec.build_spec(cfg, curves,
                                       spec.REFERENCE_CLASSES).compile())
    start = ref.model.var_start()
    scatter = 1e-3 * np.maximum(np.abs(start), 1e-2)
    x = torch.tensor(start + scatter * np.random.default_rng(4)
                     .standard_normal((3, start.size)))
    lp, g, share = ref.evaluate(x, grad=grad)
    assert 0.5 < share < 1.0
    if grad:
        lp_p, g_p = port.value_and_grad(x)
        np.testing.assert_allclose(g.numpy(), g_p.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(g_p.abs().max()))
    else:
        lp_p = port(x)
    assert torch.isfinite(lp).all()
    np.testing.assert_allclose(lp.numpy(), lp_p.numpy(), rtol=1e-12)
