"""The port's reference-API ``CV`` and the eclipse plot against the JAX
package, on the CPU in float64.

``compat.CV.calcFlux`` (simple and complex spot, with and without
exposure widths): the total and all four component curves within 1e-9
relative of ``lfit_python_tpu.compat.CV``'s on the same parameters and
phases (tests/test_compat.py's checks too).  ``utils.plotting.
plot_eclipse``: every line of the figure (data, total, the four
components, residuals) within 1e-9 of the JAX ``plot_eclipse`` figure's
on the same full parameter vector of the demo fit, and
``eclipse_fluxes`` is what it draws.  Both evaluate on the low-resolution
element grids, to keep the JAX package's compile short.
"""

import numpy as np
import pytest
import torch

from lfit_python_tpu import compat as jcompat
from lfit_python_tpu.models.cv import CVConfig as JCVConfig
from lfit_python_tpu_torch import compat
from lfit_python_tpu_torch.models.cv import CVConfig

LOW = dict(n_disc_rad=6, n_disc_az=8, n_spot=8, n_donor_lat=6,
           n_donor_lon=8)
PARS = np.array([0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01,
                 0.02, 160.0, 0.2, 1.5, 0.0])
COMPLEX = np.concatenate([PARS, [2.0, 1.0, 90.0, 0.0]])
COMPONENTS = ("ywd", "ydisc", "yspot", "ysec")


def _curves(cv, total):
    return {"total": total, **{c: getattr(cv, c) for c in COMPONENTS}}


@pytest.mark.parametrize("pars,widths", [(PARS, False), (COMPLEX, False),
                                         (COMPLEX, True)],
                         ids=["simple", "complex", "complex_widths"])
def test_calcflux_matches_the_jax_cv(pars, widths):
    complex_spot = pars.size >= 18
    phase = np.linspace(-0.1, 0.1, 41)
    width = np.full_like(phase, 0.003) if widths else None
    ours = compat.CV(pars, CVConfig(complex_spot=complex_spot, **LOW),
                     device="cpu")
    theirs = jcompat.CV(pars, JCVConfig(complex_spot=complex_spot, **LOW))
    got = _curves(ours, ours.calcFlux(pars, phase, width))
    want = _curves(theirs, theirs.calcFlux(pars, phase, width))
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].shape == (41,)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                   atol=1e-9 * np.abs(want["total"]).max(),
                                   err_msg=k)
    np.testing.assert_allclose(got["total"], sum(got[c] for c in COMPONENTS),
                               rtol=1e-12)
    # out of eclipse the WD curve sits at wdFlux
    assert got["ywd"][0] == pytest.approx(0.1, rel=1e-5)


def test_complex_pars_autodetect_and_default_device():
    assert compat.CV(COMPLEX, device="cpu").config.complex_spot
    assert not compat.CV(PARS, device="cpu").config.complex_spot
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compat.CV(PARS)


@pytest.fixture(scope="module")
def demo():
    from pathlib import Path

    from lfit_python_tpu.utils.config import (
        build_model_from_config as jbuild, parse_input_dat as jparse)
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)

    path = Path(__file__).resolve().parent.parent / "examples" / \
        "demo_input.dat"
    ours = build_model_from_config(parse_input_dat(path)).compile()
    theirs = jbuild(jparse(path)).compile()
    rng = np.random.default_rng(7)
    start = ours.var_start()
    var = start * (1 + 1e-3 * rng.standard_normal(start.size))
    return ours, theirs, ours.full_from_var(var)


def _lines(fig):
    """(x, y) of every line and every errorbar's points in the figure."""
    import matplotlib.pyplot as plt

    out = [(np.asarray(ln.get_xdata(), float), np.asarray(ln.get_ydata(),
                                                          float))
           for ax in fig.axes for ln in ax.get_lines()]
    plt.close(fig)
    return out


def test_plot_eclipse_draws_the_jax_figure(demo):
    from lfit_python_tpu.utils.plotting import plot_eclipse as jplot
    from lfit_python_tpu_torch.utils.plotting import (eclipse_fluxes,
                                                      plot_eclipse)

    ours, theirs, full = demo
    got = _lines(plot_eclipse(ours, full, 0, CVConfig(**LOW),
                              device="cpu"))
    want = _lines(jplot(theirs, full, 0, JCVConfig(**LOW)))
    assert len(got) == len(want) >= 7
    scale = np.abs(want[1][1]).max()           # the total
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_allclose(gy, wy, rtol=1e-9, atol=1e-9 * scale)
    fl = eclipse_fluxes(ours, full, 0, CVConfig(**LOW), device="cpu")
    np.testing.assert_array_equal(got[1][1], fl.total)


def test_plot_eclipse_writes_a_png(demo, tmp_path):
    from lfit_python_tpu_torch.utils.plotting import plot_eclipse

    ours, _, full = demo
    path = tmp_path / "e.png"
    assert plot_eclipse(ours, full, 0, CVConfig(**LOW), path=path,
                        device="cpu") == path
    assert path.stat().st_size > 1000
