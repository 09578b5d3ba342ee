"""Canonical example models with synthetic data.

Port of ``lfit_python_tpu/examples.py``.  The synthetic light curves are
made by the port's own forward model in float64 on the CPU, at known
parameters, so a fit has a known ground truth; the noise comes from
numpy's ``default_rng(seed)``, as in the JAX package, so both packages
build the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.cv import CVConfig, cv_fluxes
from .models.priors import Param, Prior
from .models.tree import EclipseSpec, HierarchicalModel, Lightcurve

__all__ = ["TRUE_PARAMS", "make_synthetic_lightcurve",
           "default_eclipse_params", "build_model", "with_calib_widths"]

TRUE_PARAMS = {
    "wdFlux": 0.1, "dFlux": 0.05, "sFlux": 0.08, "rsFlux": 0.03,
    "q": 0.15, "dphi": 0.04, "rdisc": 0.44, "ulimb": 0.3, "rwd": 0.01,
    "scale": 0.02, "az": 160.0, "fis": 0.2, "dexp": 1.5, "phi0": 0.0,
    "exp1": 2.0, "exp2": 1.0, "tilt": 90.0, "yaw": 0.0,
}

_SIMPLE_ORDER = ["wdFlux", "dFlux", "sFlux", "rsFlux", "q", "dphi", "rdisc",
                 "ulimb", "rwd", "scale", "az", "fis", "dexp", "phi0"]


def _p(name, start, prior, is_var=True):
    return Param(name, start, prior, is_var)


def _model_flux(n_points, complex_spot, jitter=None):
    """Noise-free float64 CPU model flux at TRUE_PARAMS (+ jitter)."""
    t = dict(TRUE_PARAMS)
    if jitter:
        t.update(jitter)
    order = _SIMPLE_ORDER + (["exp1", "exp2", "tilt", "yaw"]
                             if complex_spot else [])
    ph = np.linspace(-0.15, 0.15, n_points)
    pars = torch.tensor([t[k] for k in order], dtype=torch.float64)
    with torch.inference_mode():
        flux = cv_fluxes(pars, torch.from_numpy(ph),
                         config=CVConfig(complex_spot=complex_spot)).total
    return ph, flux.numpy()


def _noisy(curve, noise, seed, name):
    ph, flux = curve
    rng = np.random.default_rng(seed)
    return Lightcurve(ph, flux + noise * rng.standard_normal(len(ph)),
                      np.full(len(ph), noise), name=name)


def make_synthetic_lightcurve(n_points=100, noise=0.002, seed=0,
                              complex_spot=False, name="synth",
                              jitter=None):
    """A light curve from TRUE_PARAMS (+ optional per-eclipse parameter
    ``jitter`` dict) with white noise of standard deviation ``noise``."""
    return _noisy(_model_flux(n_points, complex_spot, jitter), noise, seed,
                  name)


def default_eclipse_params(complex_spot=False, use_gp=False):
    t = TRUE_PARAMS
    params = {
        "dFlux": _p("dFlux", t["dFlux"], Prior("uniform", 0, 1)),
        "sFlux": _p("sFlux", t["sFlux"], Prior("uniform", 0, 1)),
        "rdisc": _p("rdisc", t["rdisc"], Prior("uniform", 0.2, 0.9)),
        "scale": _p("scale", t["scale"], Prior("log_uniform", 1e-4, 0.5)),
        "az": _p("az", t["az"], Prior("uniform", 50, 175)),
        "fis": _p("fis", t["fis"], Prior("uniform", 0, 1)),
        "dexp": _p("dexp", t["dexp"], Prior("uniform", 0, 3)),
        "phi0": _p("phi0", t["phi0"], Prior("uniform", -0.05, 0.05)),
    }
    if complex_spot:
        params.update({
            "exp1": _p("exp1", t["exp1"], Prior("uniform", 0.01, 5)),
            "exp2": _p("exp2", t["exp2"], Prior("uniform", 0.01, 5)),
            "tilt": _p("tilt", t["tilt"], Prior("uniform", 0, 180)),
            "yaw": _p("yaw", t["yaw"], Prior("uniform", -90, 90)),
        })
    if use_gp:
        params.update({
            "ln_ampin_gp": _p("ln_ampin_gp", -9.0, Prior("uniform", -25, 0)),
            "ln_ampout_gp": _p("ln_ampout_gp", -10.0,
                               Prior("uniform", -25, 0)),
            "ln_tau_gp": _p("ln_tau_gp", -4.0, Prior("uniform", -12, 2)),
        })
    return params


def build_model(n_eclipses=1, complex_spot=False, use_gp=False,
                n_points=100, bands=("g",), noise=0.002):
    """A hierarchical model with synthetic data.

    ``complex_spot`` / ``use_gp`` may be bools or per-eclipse sequences.
    Eclipses are assigned round-robin to ``bands``; eclipse k's noise uses
    seed k.  The noise-free curve is the same for every eclipse of one
    spot flavour, so it is computed once per flavour."""
    t = TRUE_PARAMS
    if isinstance(complex_spot, bool):
        complex_spot = [complex_spot] * n_eclipses
    if isinstance(use_gp, bool):
        use_gp = [use_gp] * n_eclipses

    core = {
        "q": _p("q", t["q"], Prior("uniform", 0.03, 3.0)),
        "dphi": _p("dphi", t["dphi"], Prior("uniform", 0.01, 0.2)),
        "rwd": _p("rwd", t["rwd"], Prior("uniform", 0.0005, 0.1)),
    }
    band_params = {
        b: {
            "wdFlux": _p("wdFlux", t["wdFlux"], Prior("uniform", 0, 1)),
            "rsFlux": _p("rsFlux", t["rsFlux"], Prior("uniform", 0, 1)),
            "ulimb": _p("ulimb", t["ulimb"], Prior("gauss", 0.3, 0.05),
                        is_var=False),
        }
        for b in bands
    }
    curves = {}
    eclipses = []
    for k in range(n_eclipses):
        cs = bool(complex_spot[k])
        if cs not in curves:
            curves[cs] = _model_flux(n_points, cs)
        lc = _noisy(curves[cs], noise, k, f"ecl{k}")
        eclipses.append(EclipseSpec(
            f"ecl{k}", bands[k % len(bands)], lc,
            default_eclipse_params(cs, use_gp[k]),
            complex_spot=cs, use_gp=use_gp[k]))
    return HierarchicalModel(core, band_params, eclipses)


def with_calib_widths(spec: HierarchicalModel) -> HierarchicalModel:
    """``spec`` with every light curve given the exposure widths a
    ``.calib`` file gets on loading (the reference's
    ``Lightcurve.from_calib``): the median sample spacing, in cycles.
    The flux then goes through the exact finite-exposure smearing, which
    is continuous in the contact phases.  Changes ``spec`` in place."""
    for ecl in spec.eclipses:
        lc = ecl.lightcurve
        lc.width = np.full_like(lc.phase,
                                np.median(np.abs(np.diff(lc.phase))))
    return spec
