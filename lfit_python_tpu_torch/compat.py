"""Reference-API compatibility layer.

Port of ``lfit_python_tpu/compat.py``: drop-in equivalents of the
surfaces a ``lfit_python`` user touches directly, mapped onto the port:

  * ``CV`` / ``cv.calcFlux(pars, phase, width)`` with the component
    curves ``cv.ywd / cv.ydisc / cv.yspot / cv.ysec`` (numpy arrays);
  * ``mcmc_utils``-style helpers: ``readchain``, ``readflatchain``,
    ``flatchain``, ``thumbPlot``, ``rebin``, ``Param``, ``Prior``;
  * ``dynasty_par_vals`` / ``dynasty_par_names`` flat-vector access on a
    compiled model tree.

Thin wrappers: new code should call the port's own functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.cv import CVConfig, cv_fluxes
from .models.priors import Param, Prior  # noqa: F401  (re-exports)
from .utils import chains as _chains

__all__ = [
    "CV", "Param", "Prior",
    "readchain", "readflatchain", "flatchain", "thumbPlot", "rebin",
    "dynasty_par_vals", "dynasty_par_names",
]


class CV:
    """Reference-compatible CV model object.

    >>> cv = CV(pars)                     # 14 or 18 parameters
    >>> total = cv.calcFlux(pars, phase)  # or (pars, phase, width)
    >>> cv.ywd, cv.ydisc, cv.yspot, cv.ysec   # component curves

    Each ``calcFlux`` is one evaluation of ``models.cv.cv_fluxes`` in
    ``dtype`` on ``device`` (the CUDA card unless given; it raises where
    there is none): the geometry is solved again on every call, and the
    object keeps only the latest component curves, as numpy arrays.
    """

    def __init__(self, pars, config: CVConfig | None = None, device=None,
                 dtype=torch.float64):
        pars = np.asarray(pars, float)
        if config is None:
            config = CVConfig(complex_spot=pars.size >= 18)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        self.ywd = self.ydisc = self.yspot = self.ysec = None

    def calcFlux(self, pars, phase, width=None):
        def tensor(a):
            return torch.as_tensor(np.asarray(a, float), dtype=self.dtype,
                                   device=self.device)

        with torch.inference_mode():
            out = cv_fluxes(tensor(pars), tensor(phase),
                            None if width is None else tensor(width),
                            self.config)
            total, self.ywd, self.ydisc, self.yspot, self.ysec = (
                o.cpu().numpy() for o in out)
        return total


def readchain(path):
    """(chain (n_steps, W, D), lnp (n_steps, W), names) of a chain file."""
    return _chains.read_chain(path)


def readflatchain(path, discard=0, thin=1):
    chain, _, names = _chains.read_chain(path)
    return _chains.flatchain(chain, discard, thin), names


flatchain = _chains.flatchain
rebin = _chains.rebin


def thumbPlot(flat, names, path=None, **kw):
    """Corner plot (``utils.plotting.corner_plot``)."""
    from .utils.plotting import corner_plot

    return corner_plot(np.asarray(flat), list(names), path, **kw)


def dynasty_par_vals(model):
    """Flat parameter vector of a compiled model (its sampled subset), in
    depth-first tree order."""
    return model.var_start()


def dynasty_par_names(model):
    """Label-suffixed names matching :func:`dynasty_par_vals`."""
    return model.var_names()
