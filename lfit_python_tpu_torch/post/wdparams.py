"""White-dwarf atmosphere fitting: (T_eff, log g, parallax) from the
white dwarf's fluxes in several bands.

Port of ``lfit_python_tpu/post/wdparams.py``.  A DA model grid (T_eff x
log g -> absolute AB magnitude per band) is interpolated bilinearly, and
the fluxes measured by an eclipse fit are fitted with the port's
stretch-move ensemble on the card.  The grid is a user's table
(``--grid``: a whitespace table ``Teff logg <band>...`` under a header
line) or, by default, the built-in synthetic grid: blackbody photospheres
with the Nauenberg (1972) mass-radius relation, labelled as such in the
output.  Nothing is downloaded.

Input file format (Param lines as in a fit's input, and flux lines):

    teff = 15000 uniform 6000 90000 1
    logg = 8.0 uniform 6.5 9.5 1
    plax = 5.0 gauss 5.0 0.5 1          # parallax, mas
    ebv = 0.05 uniform 0.0 0.5 1        # optional E(B-V)
    flux_g = 0.12 0.01 4770             # mJy, err, lambda_eff [Angstrom]

The host-side parts (the mass-radius relation, the synthetic grid, the
extinction law, the grid reader) are numpy; the interpolation and the
posterior are batched torch functions of (W, D) tensors.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.priors import Param, Prior, ln_prior_table, make_prior_table
from ..utils.config import _PARAM_RE

__all__ = ["nauenberg_radius", "mass_radius_from_logg", "synthetic_da_grid",
           "extinction_coefficients", "GridInterpolator", "WDInput",
           "read_wd_input", "make_wd_ln_prob", "run_wdparams"]

# physical constants (SI)
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23
_G = 6.674e-11
_MSUN = 1.98892e30
_RSUN = 6.957e8
_PC = 3.0856775814913673e16
_MCH = 1.44


def nauenberg_radius(mass_msun):
    """Nauenberg (1972) zero-temperature WD mass-radius relation (R_sun)."""
    x = (mass_msun / _MCH)
    return 0.0112 * np.sqrt(x ** (-2.0 / 3.0) - x ** (2.0 / 3.0))


def mass_radius_from_logg(logg):
    """Solve (M, R) from log g [cgs] under the Nauenberg relation."""
    g_si = 10.0 ** np.asarray(logg) * 1e-2  # cgs -> m/s^2

    def g_of_m(m):
        r = nauenberg_radius(m) * _RSUN
        return _G * m * _MSUN / r**2

    lo = np.full_like(g_si, 0.15)
    hi = np.full_like(g_si, 1.42)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        too_light = g_of_m(mid) < g_si
        lo = np.where(too_light, mid, lo)
        hi = np.where(too_light, hi, mid)
    m = 0.5 * (lo + hi)
    return m, nauenberg_radius(m)


def synthetic_da_grid(bands_angstrom, teffs=None, loggs=None):
    """Blackbody + Nauenberg synthetic DA grid: absolute AB magnitudes.

    Returns (teffs (NT,), loggs (NG,), mags (NT, NG, NB)): a stand-in for
    the Bergeron tables with the same interface; pass real tables with
    ``--grid`` for publication-grade results."""
    if teffs is None:
        teffs = np.linspace(6000.0, 90000.0, 85)
    if loggs is None:
        loggs = np.linspace(6.5, 9.5, 31)
    lam = np.asarray(bands_angstrom, float) * 1e-10
    nu = _C / lam
    _, r_sun = mass_radius_from_logg(loggs)
    r = r_sun * _RSUN                                     # (NG,)
    T = np.asarray(teffs)[:, None, None]                  # (NT,1,1)
    nu_ = nu[None, None, :]
    b_nu = (2.0 * _H * nu_**3 / _C**2
            / np.expm1(_H * nu_ / (_KB * T)))             # (NT,1,NB)
    # observed flux at 10 pc from a disc of radius R: pi B_nu (R/d)^2
    fnu = np.pi * b_nu * (r[None, :, None] / (10.0 * _PC)) ** 2
    fnu_jy = fnu / 1e-26
    return np.asarray(teffs), np.asarray(loggs), \
        -2.5 * np.log10(fnu_jy / 3631.0)


def extinction_coefficients(lams_angstrom, r_v=3.1):
    """Per-band A_lambda / E(B-V) from the Cardelli, Clayton & Mathis
    (1989) mean extinction law, its optical and near-infrared branches."""
    lam_um = np.asarray(lams_angstrom, float) * 1e-4
    x = 1.0 / lam_um
    # optical branch (1.1 <= x <= 3.3), CCM89 eq. (3a, 3b)
    y = x - 1.82
    a_opt = (1.0 + 0.17699 * y - 0.50447 * y**2 - 0.02427 * y**3
             + 0.72085 * y**4 + 0.01979 * y**5 - 0.77530 * y**6
             + 0.32999 * y**7)
    b_opt = (1.41338 * y + 2.28305 * y**2 + 1.07233 * y**3
             - 5.38434 * y**4 - 0.62251 * y**5 + 5.30260 * y**6
             - 2.09002 * y**7)
    # infrared branch (0.3 <= x < 1.1), CCM89 eq. (2a, 2b)
    a_ir = 0.574 * x**1.61
    b_ir = -0.527 * x**1.61
    a = np.where(x < 1.1, a_ir, a_opt)
    b = np.where(x < 1.1, b_ir, b_opt)
    # A_lambda = A_V (a + b/R_V), A_V = R_V E(B-V)
    return r_v * a + b


class GridInterpolator:
    """Bilinear (Teff, logg) -> absolute magnitude per band over a
    rectangular grid; ``__call__`` is batched over torch tensors."""

    def __init__(self, teffs, loggs, mags, source="synthetic-blackbody"):
        self.teffs = np.asarray(teffs)
        self.loggs = np.asarray(loggs)
        self.mags = np.asarray(mags)
        self.source = source

    @classmethod
    def from_file(cls, path, band_names):
        """Load a ``Teff logg <band>...`` whitespace table.

        The first line is the column header, with or without a leading
        ``#`` (the published Bergeron DA tables have a bare one); the
        rows must form a complete rectangular (Teff, logg) grid.  Band
        columns are matched by name, so other columns are ignored."""
        path = Path(path)
        first = path.read_text().splitlines()[0]
        header = first.lstrip("#").split()
        cols = {n: i for i, n in enumerate(header)}
        for required in ("Teff", "logg", *band_names):
            if required not in cols:
                raise ValueError(
                    f"{path}: header is missing column {required!r} "
                    f"(found: {header})")
        raw = np.loadtxt(
            path, skiprows=0 if first.lstrip().startswith("#") else 1)
        if raw.ndim == 1:
            raw = raw[None]
        teffs = np.unique(raw[:, cols["Teff"]])
        loggs = np.unique(raw[:, cols["logg"]])
        mags = np.full((len(teffs), len(loggs), len(band_names)), np.nan)
        ti = np.searchsorted(teffs, raw[:, cols["Teff"]])
        gi = np.searchsorted(loggs, raw[:, cols["logg"]])
        for b, name in enumerate(band_names):
            mags[ti, gi, b] = raw[:, cols[name]]
        if np.isnan(mags).any():
            raise ValueError(f"{path}: grid is not complete/rectangular")
        return cls(teffs, loggs, mags, source=str(path))

    def __call__(self, teff, logg):
        """Magnitudes (..., NB) at ``teff`` and ``logg`` (...), in their
        dtype and on their device; clamped to the grid's edges."""
        def tensor(a):
            return torch.as_tensor(a, dtype=teff.dtype, device=teff.device)

        ts, gs, mg = tensor(self.teffs), tensor(self.loggs), tensor(
            self.mags)
        t = torch.clamp(teff, float(self.teffs[0]), float(self.teffs[-1]))
        g = torch.clamp(logg, float(self.loggs[0]), float(self.loggs[-1]))
        i = torch.clamp(torch.searchsorted(ts, t.contiguous()) - 1, 0,
                        len(self.teffs) - 2)
        j = torch.clamp(torch.searchsorted(gs, g.contiguous()) - 1, 0,
                        len(self.loggs) - 2)
        ft = ((t - ts[i]) / (ts[i + 1] - ts[i]))[..., None]
        fg = ((g - gs[j]) / (gs[j + 1] - gs[j]))[..., None]
        return ((1 - ft) * (1 - fg) * mg[i, j]
                + ft * (1 - fg) * mg[i + 1, j]
                + (1 - ft) * fg * mg[i, j + 1]
                + ft * fg * mg[i + 1, j + 1])


_FLUX_RE = re.compile(
    r"^\s*flux_(\w+)\s*=\s*([\d.eE+\-]+)\s+([\d.eE+\-]+)\s+([\d.eE+\-]+)\s*$")


class WDInput(NamedTuple):
    """A wdparams input file: its parameters and its measured fluxes."""
    params: Dict[str, Param]
    bands: List[str]
    fluxes: List[float]     # mJy
    errs: List[float]
    lams: List[float]       # effective wavelengths, Angstrom

    @property
    def fit_params(self) -> List[Param]:
        """teff, logg, plax and, where the file has it, ebv."""
        names = ["teff", "logg", "plax"] + (
            ["ebv"] if "ebv" in self.params else [])
        return [self.params[n] for n in names]


def read_wd_input(path) -> WDInput:
    """Parse a wdparams input file (format in the module docstring)."""
    bands, fluxes, errs, lams = [], [], [], []
    params = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        fm = _FLUX_RE.match(line)
        if fm:
            bands.append(fm.group(1))
            fluxes.append(float(fm.group(2)))
            errs.append(float(fm.group(3)))
            lams.append(float(fm.group(4)))
            continue
        pm = _PARAM_RE.match(line)
        if pm:
            name, start, ptype, p1, p2, isvar = pm.groups()
            params[name] = Param(name, float(start),
                                 Prior(ptype, float(p1), float(p2)),
                                 bool(int(isvar)))
    for required in ("teff", "logg", "plax"):
        if required not in params:
            raise KeyError(f"{path}: missing parameter line {required}")
    if not bands:
        raise ValueError(f"{path}: no flux_<band> lines")
    return WDInput(params, bands, fluxes, errs, lams)


def make_wd_ln_prob(inp: WDInput, interp: GridInterpolator,
                    dtype=torch.float64, device=None):
    """The batched ln posterior ``(W, D) -> (W,)`` of (teff, logg, plax
    [, ebv]) given the input's fluxes, in ``dtype`` on ``device`` (the
    CUDA card unless given): the prior table, and a chi^2 of the apparent
    fluxes in mJy at distance 1000 / plax pc, reddened by ebv with the
    CCM89 coefficients; -inf where it is not finite."""
    device = resolve_device(device)
    plist = inp.fit_params
    table = make_prior_table(plist)
    fit_ebv = len(plist) == 4

    def tensor(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    fx, fe = tensor(inp.fluxes), tensor(inp.errs)
    ext_coeff = tensor(extinction_coefficients(inp.lams))

    def ln_prob(v):
        teff, logg, plax = v[:, 0], v[:, 1], v[:, 2]
        ebv = v[:, 3] if fit_ebv else torch.zeros_like(teff)
        lp = ln_prior_table(v, table)
        mags = interp(teff, logg)                  # absolute AB mags
        dist_pc = 1000.0 / torch.clamp(plax, min=1e-3)
        m_app = (mags + (5.0 * torch.log10(dist_pc / 10.0))[:, None]
                 + ext_coeff * ebv[:, None])
        f_mjy = 3631e3 * torch.pow(10.0, -0.4 * m_app)
        chi2 = (((fx - f_mjy) / fe) ** 2).sum(dim=-1)
        val = lp - 0.5 * chi2
        return torch.where(torch.isfinite(val), val,
                           torch.full_like(val, -math.inf))

    return ln_prob


def run_wdparams(args):
    """The ``wdparams`` command: fit (Teff, logg, parallax [, E(B-V)]) to
    the input's fluxes with ``args.nwalkers`` walkers (``args.nburn``
    burn-in and ``args.nprod`` production steps, seeded by ``args.seed``)
    in float64 on ``args.device``; write ``wdparams.json`` (grid, params,
    best, derived, mean_acceptance) and, where matplotlib is installed,
    ``wd_corner.png`` to ``args.outdir``.

    Float64, not float32: absolute magnitudes of 10-15 carry ~1e-6 mag of
    float32 rounding, 1e-6 of the flux, which is 1e-4 of a 1% error bar:
    around a 15000 K, log g 8 white dwarf with 1% errors in 5 bands a
    float32 ln p sits up to 3.5e-5-6.6e-5 x |ln p| from the float64 one.
    The posterior is a few bands a walker: float64 costs nothing here."""
    from ..sampling.ensemble import init_walkers, run_sampler
    from ..utils.chains import summarize

    device = resolve_device(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    inp = read_wd_input(args.input)
    if args.grid:
        interp = GridInterpolator.from_file(args.grid, inp.bands)
    else:
        interp = GridInterpolator(*synthetic_da_grid(inp.lams))
        print("NOTE: using the built-in synthetic (blackbody+Nauenberg) DA "
              "grid; supply --grid for Bergeron-table results")
    dtype = torch.float64
    ln_prob = make_wd_ln_prob(inp, interp, dtype, device)
    plist = inp.fit_params
    names = [p.name for p in plist]
    ndim = len(names)

    start = torch.tensor([p.start for p in plist], dtype=dtype, device=device)
    scatter = torch.tensor([abs(p.start) * 0.01 + 1e-3 for p in plist],
                           dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = init_walkers(generator, start, scatter, ln_prob, args.nwalkers)
    state = run_sampler(state, ln_prob, args.nburn, generator)[0]
    state, chain, lp, acc = run_sampler(state, ln_prob, args.nprod,
                                        generator)
    chain = chain.double().cpu().numpy()
    lp = lp.double().cpu().numpy()

    tab = summarize(chain, names, discard=len(chain) // 4)
    best = chain.reshape(-1, ndim)[np.argmax(lp.reshape(-1))]
    m, r = mass_radius_from_logg(best[1])
    report = {
        "grid": interp.source,
        "params": tab,
        "best": dict(zip(names, map(float, best))),
        "derived": {"mass_msun": float(m), "radius_rsun": float(r),
                    "distance_pc": float(1000.0 / best[2])},
        "mean_acceptance": float(acc.double().mean()),
    }
    with (outdir / "wdparams.json").open("w") as fh:
        json.dump(report, fh, indent=1)
    from ..utils.plotting import corner_plot, have_matplotlib

    if have_matplotlib():
        corner_plot(chain[len(chain) // 4:].reshape(-1, ndim), names,
                    outdir / "wd_corner.png")
    else:
        print("wd_corner.png: not made (matplotlib is not installed)")
    print(json.dumps(report["params"], indent=1))
    print("derived:", report["derived"])
    return 0
