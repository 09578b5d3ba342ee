"""Result plots: one eclipse's data against the model and its four
components, and corner plots.

Port of ``lfit_python_tpu/utils/plotting.py``.  matplotlib is imported
only inside the functions that draw, so the package imports without it;
:func:`eclipse_fluxes`, the evaluation behind :func:`plot_eclipse`, needs
none.  The ``corner`` package is not assumed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.cv import CVConfig, CVFluxes, cv_fluxes

__all__ = ["have_matplotlib", "eclipse_fluxes", "plot_eclipse",
           "corner_plot"]


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported here (it is not imported)."""
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def eclipse_fluxes(model, full_vec, eclipse_index=0, config=None,
                   device=None) -> CVFluxes:
    """The model's total and component fluxes of one full parameter
    vector (n_full,) on eclipse ``eclipse_index``'s data phases (with its
    exposure widths, where it has them), evaluated in float64 on
    ``device`` (the CUDA card unless given) and returned as numpy
    arrays.  ``config`` defaults to the full-resolution grids."""
    if model.spec is None:
        raise ValueError("the model carries no tree (spec): compile it "
                         "from a HierarchicalModel to plot its eclipses")
    config = (CVConfig() if config is None else config)._replace(
        complex_spot=True)
    device = resolve_device(device)
    lc = model.spec.eclipses[eclipse_index].lightcurve

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    with torch.inference_mode():
        cvp = model.cv_params(tensor(full_vec))[eclipse_index]
        widths = None if lc.width is None else tensor(lc.width)
        out = cv_fluxes(cvp, tensor(lc.phase), widths, config)
        return CVFluxes(*(o.cpu().numpy() for o in out))


def plot_eclipse(model, full_vec, eclipse_index=0, config=None, path=None,
                 device=None):
    """Data, total model and the four component curves, and the
    residuals, of one eclipse (:func:`eclipse_fluxes` gives the curves).
    Saves to ``path`` and returns it, or returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = eclipse_index
    out = eclipse_fluxes(model, full_vec, k, config, device)
    ecl = model.spec.eclipses[k]
    lc = ecl.lightcurve

    fig, (ax, axr) = plt.subplots(
        2, 1, figsize=(8, 6), sharex=True,
        gridspec_kw={"height_ratios": [3, 1]})
    ax.errorbar(lc.phase, lc.flux, lc.err, fmt=".", ms=3, alpha=0.5,
                color="k", label="data")
    ax.plot(lc.phase, out.total, "r-", lw=1.2, label="total")
    for y, lab, c in [(out.ywd, "WD", "C0"), (out.ydisc, "disc", "C1"),
                      (out.yspot, "spot", "C2"), (out.ysec, "donor", "C3")]:
        ax.plot(lc.phase, y, c, lw=0.8, label=lab)
    ax.set_ylabel("flux")
    ax.legend(fontsize=8, ncol=3)
    ax.set_title(f"eclipse {ecl.name} ({ecl.band})")
    resid = lc.flux - out.total
    axr.errorbar(lc.phase, resid, lc.err, fmt=".", ms=3, color="k")
    axr.axhline(0, color="r", lw=0.8)
    axr.set_xlabel("orbital phase")
    axr.set_ylabel("residual")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def corner_plot(flat, names, path=None, max_params=12):
    """Corner plot (pairwise scatter and histograms) of samples ``flat``
    (n, D).  At most ``max_params`` dimensions are drawn, and never
    silently: a truncation warns and says "showing d/D parameters" on the
    figure.  The command line raises the cap for the per-node corners
    (every tree node fits in 19), so every sampled parameter appears in
    some corner plot."""
    import warnings

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    flat = np.asarray(flat)
    d = min(flat.shape[1], max_params)
    truncated = flat.shape[1] > d
    if truncated:
        warnings.warn(
            f"corner_plot: showing {d}/{flat.shape[1]} parameters "
            f"({path or 'figure'}); the per-node corner_<label>.png "
            "plots cover the rest", stacklevel=2)
    fig, axes = plt.subplots(d, d, figsize=(2.0 * d, 2.0 * d))
    if truncated:
        fig.suptitle(f"showing {d}/{flat.shape[1]} parameters "
                     "(see per-node corners)", fontsize=10, color="crimson")
    if d == 1:
        axes = np.array([[axes]])
    for i in range(d):
        for j in range(d):
            ax = axes[i, j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(flat[:, i], bins=40, color="C0",
                        histtype="stepfilled", alpha=0.7)
            else:
                ax.plot(flat[:, j], flat[:, i], ",", color="k", alpha=0.3)
            if i == d - 1:
                ax.set_xlabel(names[j], fontsize=7)
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(names[i], fontsize=7)
            else:
                ax.set_yticklabels([])
            ax.tick_params(labelsize=6)
    fig.tight_layout(pad=0.3)
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
    return fig
