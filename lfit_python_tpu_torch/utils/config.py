"""Reader of the reference-format fit input file (``mcmc_input.dat``).

Port of ``lfit_python_tpu/utils/config.py``.  The file is flat
``key = value`` lines: meta keys (nwalkers, nburn, nprod, neclipses,
complex, useGP, scatter_1/2, double_burnin, file_<k>, band_<k>, ...) and
parameter lines

    <name>_<label> = <start> <prior_type> <p1> <p2> <isVar>

with labels ``core``, a band name, or an eclipse index.  It is read into a
:class:`FitConfig`, from which :func:`build_model_from_config` builds the
port's hierarchical model.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from ..models.priors import Param, Prior
from ..models.tree import (
    BAND_NAMES,
    CORE_NAMES,
    ECLIPSE_COMPLEX_NAMES,
    ECLIPSE_NAMES,
    GP_NAMES,
    EclipseSpec,
    HierarchicalModel,
    Lightcurve,
)

__all__ = ["FitConfig", "parse_input_dat", "build_model_from_config",
           "COMP_SCAT_FRACTIONS"]

# Per-parameter walker-ball scatter fractions, applied when the input file
# sets ``comp_scat``: geometry parameters that the eclipse shape pins
# tightly get small balls, flux scales wide ones.
COMP_SCAT_FRACTIONS = {
    "q": 0.3, "dphi": 0.05, "rwd": 0.3,
    "wdFlux": 2.0, "dFlux": 2.0, "sFlux": 2.0, "rsFlux": 2.0,
    "ulimb": 0.1,
    "rdisc": 1.0, "scale": 2.0, "az": 0.5, "fis": 1.0, "dexp": 1.0,
    "phi0": 0.05,
    "exp1": 1.0, "exp2": 1.0, "tilt": 0.5, "yaw": 0.5,
    "ln_ampin_gp": 1.0, "ln_ampout_gp": 1.0, "ln_tau_gp": 1.0,
}

_META_INT = {"nwalkers", "nburn", "nprod", "nthreads", "neclipses", "ntemps",
             "nsub", "thin"}
_META_FLOAT = {"scatter_1", "scatter_2", "t0", "period"}
_META_BOOL = {"complex", "useGP", "usePT", "double_burnin", "comp_scat",
              "notify", "useGP_default"}

_PARAM_RE = re.compile(
    r"^\s*(\S+)\s*=\s*([\-\d.eE+]+)\s+(\w+)\s+([\-\d.eE+]+)\s+"
    r"([\-\d.eE+]+)\s+(\d)\s*$")
_META_RE = re.compile(r"^\s*(\S+)\s*=\s*(.+?)\s*$")
_INDEXED_RE = re.compile(
    r"^(file|band|plot|complex|useGP|calib|trim)_(\d+)$")


@dataclass
class FitConfig:
    """Parsed fit configuration (meta + raw parameter table)."""
    meta: Dict[str, object] = field(default_factory=dict)
    params: Dict[str, Param] = field(default_factory=dict)
    files: Dict[int, str] = field(default_factory=dict)
    bands: Dict[int, str] = field(default_factory=dict)
    complex_flags: Dict[int, bool] = field(default_factory=dict)
    gp_flags: Dict[int, bool] = field(default_factory=dict)
    plot_flags: Dict[int, bool] = field(default_factory=dict)
    calib_flags: Dict[int, bool] = field(default_factory=dict)
    trims: Dict[int, tuple] = field(default_factory=dict)
    source: Optional[Path] = None

    @property
    def n_eclipses(self) -> int:
        return int(self.meta.get("neclipses", len(self.files) or 1))

    def get(self, key, default=None):
        return self.meta.get(key, default)


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("1", "true", "yes", "y")


def parse_input_dat(path) -> FitConfig:
    """Parse a reference-format input file (``mcmc_input.dat``)."""
    path = Path(path)
    cfg = FitConfig(source=path)
    for raw in path.read_text().splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        m = _PARAM_RE.match(line)
        if m:
            name, start, ptype, p1, p2, isvar = m.groups()
            base = name.rsplit("_", 1)[0]
            cfg.params[name] = Param(
                name=base,
                start=float(start),
                prior=Prior(ptype, float(p1), float(p2)),
                is_var=bool(int(isvar)),
                scatter=COMP_SCAT_FRACTIONS.get(base, 1.0),
            )
            continue
        m = _META_RE.match(line)
        if not m:
            raise ValueError(f"{path}: cannot parse line: {raw!r}")
        key, val = m.groups()
        fm = _INDEXED_RE.match(key)
        if fm:
            kind, idx = fm.group(1), int(fm.group(2))
            if kind == "file":
                cfg.files[idx] = val
            elif kind == "band":
                cfg.bands[idx] = val
            elif kind == "complex":
                cfg.complex_flags[idx] = _parse_bool(val)
            elif kind == "useGP":
                cfg.gp_flags[idx] = _parse_bool(val)
            elif kind == "plot":
                cfg.plot_flags[idx] = _parse_bool(val)
            elif kind == "calib":
                cfg.calib_flags[idx] = _parse_bool(val)
            elif kind == "trim":
                lo, hi = val.split()
                cfg.trims[idx] = (float(lo), float(hi))
            continue
        if key in _META_INT:
            cfg.meta[key] = int(float(val))
        elif key in _META_FLOAT:
            cfg.meta[key] = float(val)
        elif key in _META_BOOL:
            cfg.meta[key] = _parse_bool(val)
        else:
            cfg.meta[key] = val
    return cfg


def _lookup(cfg: FitConfig, base: str, label: str) -> Param:
    key = f"{base}_{label}"
    if key not in cfg.params:
        raise KeyError(
            f"{cfg.source}: missing parameter line for {key!r}")
    return cfg.params[key]


def build_model_from_config(cfg: FitConfig, data_dir=None) -> HierarchicalModel:
    """Assemble the hierarchical model tree from a parsed config.

    Light-curve files are resolved relative to ``data_dir`` (default: the
    input file's directory).  Eclipse ``k`` becomes the tree node
    ``ecl<k>``, so its parameters are named ``<name>_ecl<k>``; the input
    file's own keys stay ``<name>_<k>``.
    """
    if data_dir is None:
        data_dir = cfg.source.parent if cfg.source else Path(".")
    data_dir = Path(data_dir)

    n_ecl = cfg.n_eclipses
    default_complex = bool(cfg.meta.get("complex", False))
    default_gp = bool(cfg.meta.get("useGP", False))

    core = {n: _lookup(cfg, n, "core") for n in CORE_NAMES}

    bands: Dict[str, Dict[str, Param]] = {}
    eclipses: List[EclipseSpec] = []
    for k in range(n_ecl):
        band = cfg.bands.get(k, cfg.bands.get(0, "g"))
        if band not in bands:
            bands[band] = {n: _lookup(cfg, n, band) for n in BAND_NAMES}
        cplx = cfg.complex_flags.get(k, default_complex)
        gp = cfg.gp_flags.get(k, default_gp)
        names = ECLIPSE_NAMES + (ECLIPSE_COMPLEX_NAMES if cplx else ()) \
            + (GP_NAMES if gp else ())
        params = {n: _lookup(cfg, n, str(k)) for n in names}
        fname = cfg.files.get(k)
        if fname is None:
            raise KeyError(f"{cfg.source}: missing file_{k} entry")
        # calibrated photometry: calib_<k> = 1 or a .calib file; an
        # optional global ephemeris (t0, period) folds time to phase
        if cfg.calib_flags.get(k, fname.endswith(".calib")):
            lc = Lightcurve.from_calib(
                data_dir / fname, name=f"ecl{k}", trim=cfg.trims.get(k),
                t0=cfg.meta.get("t0"), period=cfg.meta.get("period"))
        else:
            lc = Lightcurve.from_file(data_dir / fname, name=f"ecl{k}",
                                      trim=cfg.trims.get(k))
        eclipses.append(EclipseSpec(
            f"ecl{k}", band, lc, params, complex_spot=cplx, use_gp=gp,
            plot=cfg.plot_flags.get(k, True)))
    return HierarchicalModel(core, bands, eclipses)
