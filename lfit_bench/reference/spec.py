"""A configuration file's model tree and its synthetic light curves.

A configuration (``lfit_bench/configs/<name>.json``) states the
hierarchical model: the eclipses, their bands and flavours, every
parameter's start value and prior, the phases and the noise of the light
curves, and the noise-free template flux each flavour's curves are made
from.  :func:`light_curves` adds the noise of ``seed``;
:func:`build_spec` builds the tree from a package's own classes, so the
port and this reference each compile the same configuration themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from .cv import CVConfig, cv_fluxes
from .priors import Param, Prior
from .tree import EclipseSpec, HierarchicalModel, Lightcurve

__all__ = ["phases_widths", "eclipses", "template_flux", "light_curves",
           "build_spec", "REFERENCE_CLASSES"]

REFERENCE_CLASSES = dict(Param=Param, Prior=Prior, Lightcurve=Lightcurve,
                         EclipseSpec=EclipseSpec,
                         HierarchicalModel=HierarchicalModel)

_SIMPLE_ORDER = ("wdFlux", "dFlux", "sFlux", "rsFlux", "q", "dphi", "rdisc",
                 "ulimb", "rwd", "scale", "az", "fis", "dexp", "phi0")
_COMPLEX_ORDER = _SIMPLE_ORDER + ("exp1", "exp2", "tilt", "yaw")


def phases_widths(cfg):
    """(phases (P,), exposure widths (P,) or None) of every eclipse: P
    uniform phases over ``phase_range``; with ``widths`` =
    ``"median_spacing"`` each exposure as wide as the median spacing, as
    a ``.calib`` light curve gets on loading."""
    lo, hi = cfg["phase_range"]
    ph = np.linspace(lo, hi, cfg["n_points"])
    if cfg["widths"] == "median_spacing":
        return ph, np.full_like(ph, np.median(np.abs(np.diff(ph))))
    if cfg["widths"] is None:
        return ph, None
    raise ValueError(f"unknown widths rule {cfg['widths']!r}")


def eclipses(cfg):
    """[(name, band, complex spot, GP)] of the configuration's eclipses,
    round-robin over its bands."""
    bands = cfg["bands"]
    return [(f"ecl{k}", bands[k % len(bands)], bool(cfg["complex_spot"]),
             bool(cfg["use_gp"])) for k in range(cfg["n_eclipses"])]


def template_flux(cfg, complex_spot):
    """The noise-free model flux (P,) at the configuration's true
    parameters, in float64 on the CPU (with the exposure widths where the
    configuration has them): what ``template_flux`` in its file holds."""
    t = cfg["true_params"]
    order = _COMPLEX_ORDER if complex_spot else _SIMPLE_ORDER
    ph, wd = phases_widths(cfg)
    pars = torch.tensor([t[k] for k in order], dtype=torch.float64)
    with torch.inference_mode():
        flux = cv_fluxes(pars, torch.from_numpy(ph),
                         None if wd is None else torch.from_numpy(wd),
                         config=CVConfig(complex_spot=complex_spot)).total
    return flux.numpy()


def light_curves(cfg, seed):
    """{eclipse name: (phase, flux, err, width or None)}: each eclipse's
    template flux plus white noise of the configuration's ``noise``, from
    ``numpy.random.default_rng((seed, k))`` for eclipse k."""
    ph, wd = phases_widths(cfg)
    noise = cfg["noise"]
    out = {}
    for k, (name, _, cs, _) in enumerate(eclipses(cfg)):
        flux = np.asarray(cfg["template_flux"]["complex" if cs
                                               else "simple"], np.float64)
        rng = np.random.default_rng((int(seed) & (2 ** 64 - 1), k))
        out[name] = (ph.copy(), flux + noise * rng.standard_normal(ph.size),
                     np.full(ph.size, noise), None if wd is None
                     else wd.copy())
    return out


def build_spec(cfg, curves, classes):
    """The configuration's model tree, made of ``classes`` (a dict of the
    package's ``Param``, ``Prior``, ``Lightcurve``, ``EclipseSpec`` and
    ``HierarchicalModel``), with the light curves ``curves``."""
    Param, Prior = classes["Param"], classes["Prior"]

    def params(group):
        return {n: Param(n, p["start"], Prior(*p["prior"]),
                         p.get("is_var", True))
                for n, p in cfg["params"][group].items()}

    ecl_specs = []
    for name, band, cs, gp in eclipses(cfg):
        ps = params("eclipse")
        if cs:
            ps.update(params("eclipse_complex"))
        if gp:
            ps.update(params("eclipse_gp"))
        ph, flux, err, wd = curves[name]
        ecl_specs.append(classes["EclipseSpec"](
            name, band, classes["Lightcurve"](ph, flux, err, wd, name=name),
            ps, complex_spot=cs, use_gp=gp))
    return classes["HierarchicalModel"](
        params("core"), {b: params("band") for b in cfg["bands"]}, ecl_specs)
