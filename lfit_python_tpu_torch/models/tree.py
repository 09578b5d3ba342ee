"""Hierarchical (tree-structured) parameter model.

Port of ``lfit_python_tpu/models/tree.py``.  The tree is declarative: it
compiles once, in numpy, into index maps (sampled vector -> full parameter
vector -> per-eclipse 18-slot CV vectors) and stacked, padded data arrays.
Every posterior evaluation then only indexes tensors: the maps and the
prior table are kept on the evaluation's device
(:meth:`CompiledModel.tensors`), so that it copies nothing from the host.

Core params (shared by every eclipse):  q, dphi, rwd.
Band params (shared per filter):        wdFlux, rsFlux, ulimb.
Eclipse params:                         dFlux, sFlux, rdisc, scale, az,
                                        fis, dexp, phi0
                                        [+ exp1, exp2, tilt, yaw if complex]
                                        [+ ln_ampin_gp, ln_ampout_gp,
                                           ln_tau_gp if GP].

Simple eclipses use the same 18-slot CV vector with the neutral complex
values (exp1 = 1, exp2 = 1, tilt = 90, yaw = 0) pinned as constants.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .priors import (Param, PriorTable, PriorTensors, make_prior_table,
                     prior_tensors)

__all__ = [
    "Lightcurve",
    "EclipseSpec",
    "HierarchicalModel",
    "CompiledModel",
    "ModelTensors",
    "CORE_NAMES",
    "BAND_NAMES",
    "ECLIPSE_NAMES",
    "ECLIPSE_COMPLEX_NAMES",
    "GP_NAMES",
]

CORE_NAMES = ("q", "dphi", "rwd")
BAND_NAMES = ("wdFlux", "rsFlux", "ulimb")
ECLIPSE_NAMES = ("dFlux", "sFlux", "rdisc", "scale", "az", "fis", "dexp", "phi0")
ECLIPSE_COMPLEX_NAMES = ("exp1", "exp2", "tilt", "yaw")
GP_NAMES = ("ln_ampin_gp", "ln_ampout_gp", "ln_tau_gp")

# canonical CV 18-vector slot order (models/cv.py docstring)
_CV_SLOTS = (
    "wdFlux", "dFlux", "sFlux", "rsFlux", "q", "dphi", "rdisc", "ulimb",
    "rwd", "scale", "az", "fis", "dexp", "phi0", "exp1", "exp2", "tilt", "yaw",
)
_NEUTRAL_COMPLEX = {"exp1": 1.0, "exp2": 1.0, "tilt": 90.0, "yaw": 0.0}


@dataclass
class Lightcurve:
    """Observed eclipse light curve: phase, flux, flux error, and
    optionally the exposure phase width."""
    phase: np.ndarray
    flux: np.ndarray
    err: np.ndarray
    width: Optional[np.ndarray] = None
    name: str = ""

    @classmethod
    def from_file(cls, path, name=None, trim=None):
        """Load a 3- or 4-column whitespace text file (phase flux err
        [width]); ``trim=(lo, hi)`` masks to a phase range."""
        arr = np.loadtxt(path, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] < 3:
            raise ValueError(f"{path}: expected >=3 columns (phase flux err)")
        width = arr[:, 3] if arr.shape[1] > 3 else None
        lc = cls(arr[:, 0], arr[:, 1], arr[:, 2], width,
                 name or str(path))
        return lc.trimmed(trim)

    @classmethod
    def from_calib(cls, path, name=None, trim=None, t0=None, period=None):
        """Load calibrated photometry: 3 columns (phase-or-time, flux,
        err) and no exposure-width column.  The width is the median sample
        spacing (contiguous exposures: the cadence is the exposure time).
        With an ephemeris ``(t0, period)``, column 0 is absolute time and
        is folded to orbital phase in [-0.5, 0.5) and sorted."""
        arr = np.loadtxt(path, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.shape[1] < 3:
            raise ValueError(
                f"{path}: expected >=3 columns (phase-or-time flux err)")
        x, flux, err = arr[:, 0], arr[:, 1], arr[:, 2]
        if (t0 is None) != (period is None):
            raise ValueError("from_calib: give both t0 and period or neither")
        if t0 is not None:
            x = ((x - t0) / period + 0.5) % 1.0 - 0.5
            order = np.argsort(x)
            x, flux, err = x[order], flux[order], err[order]
        if len(x) > 1:
            width = np.full_like(x, np.median(np.abs(np.diff(x))))
        else:
            width = None
        lc = cls(x, flux, err, width, name or str(path))
        return lc.trimmed(trim)

    def trimmed(self, trim):
        """Mask to the phase range ``trim=(lo, hi)``; ``None`` returns
        self unchanged."""
        if trim is None:
            return self
        m = (self.phase >= trim[0]) & (self.phase <= trim[1])
        return type(self)(
            self.phase[m], self.flux[m], self.err[m],
            None if self.width is None else self.width[m], self.name)

    def __len__(self):
        return len(self.phase)


@dataclass
class EclipseSpec:
    """One eclipse leaf: its data, band, model flavour, and parameters."""
    name: str
    band: str
    lightcurve: Lightcurve
    params: Dict[str, Param]
    complex_spot: bool = False
    use_gp: bool = False
    plot: bool = True   # the input file's plot_<k> flag


@dataclass
class HierarchicalModel:
    """Declarative model tree; ``compile()`` produces the index maps."""
    core: Dict[str, Param]
    bands: Dict[str, Dict[str, Param]]
    eclipses: List[EclipseSpec]

    def compile(self) -> "CompiledModel":
        return _compile(self)


class ModelTensors(NamedTuple):
    """A :class:`CompiledModel`'s index maps, constants and prior table as
    tensors on one device, in one dtype."""
    full_start: torch.Tensor   # (n_full,)
    var_idx: torch.Tensor      # (n_var,) int64
    cv_idx: torch.Tensor       # (E, 18) int64
    cv_const: torch.Tensor     # (E, 18)
    prior: PriorTensors


@dataclass
class CompiledModel:
    """Flat-vector layout, index maps and stacked data of one model.

    Layout of the *full* vector (depth-first): core, then each band, then
    each eclipse (base + complex + gp params as applicable).  The
    *sampled* vector covers only the variable parameters; ``var_pos[i]``
    is the sampled position of full slot ``i``, or -1 for a fixed one.
    """
    param_names: List[str]
    full_start: np.ndarray    # (n_full,) f64
    var_idx: np.ndarray       # (n_var,) int32 full slots that are sampled
    var_pos: np.ndarray       # (n_full,) int32
    scatter: np.ndarray       # (n_full,) f64
    prior_table: PriorTable
    cv_idx: np.ndarray        # (E, 18) int32, -1 = pinned constant
    cv_const: np.ndarray      # (E, 18) f64
    gp_idx: np.ndarray        # (E, 3) int32
    gp_mask: np.ndarray       # (E,) bool
    data_phase: np.ndarray    # (E, P) f64, pads at phase 0.25
    data_flux: np.ndarray     # (E, P)
    data_err: np.ndarray      # (E, P), pads at 1
    data_width: np.ndarray    # (E, P), zero = no exposure width
    data_mask: np.ndarray     # (E, P) bool
    any_complex: bool
    any_gp: bool
    # the tree node (core, band, eclipse) of each full slot, and which
    # eclipses to plot; None where the model was carried across without them
    param_labels: Optional[List[str]] = None
    plot_mask: Optional[np.ndarray] = None   # (E,) bool
    # the tree it was compiled from (each eclipse's name, band and light
    # curve, for the plots); None where the model was carried across
    spec: Optional[HierarchicalModel] = field(default=None, repr=False)
    # ModelTensors by (dtype, device), made on first use (tensors())
    _tensors: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    @property
    def n_eclipses(self) -> int:
        return self.cv_idx.shape[0]

    @property
    def n_var(self) -> int:
        return len(self.var_idx)

    @property
    def n_full(self) -> int:
        return len(self.full_start)

    def var_start(self):
        return self.full_start[self.var_idx].copy()

    def var_scatter(self):
        return self.scatter[self.var_idx].copy()

    def var_names(self):
        return [self.param_names[i] for i in self.var_idx]

    def var_groups(self):
        """Sampled-parameter positions grouped by tree node, in tree
        order: ``[(label, [positions])]``."""
        groups: Dict[str, List[int]] = {}
        for pos, i in enumerate(self.var_idx):
            groups.setdefault(self.param_labels[i], []).append(pos)
        return list(groups.items())

    def tensors(self, dtype, device) -> ModelTensors:
        """The index maps, constants and prior table as tensors in
        ``dtype`` on ``device``: made on the first call for that pair (outside
        any inference mode, so that a gradient may use them) and kept."""
        device = torch.device(device)
        key = (dtype, device)
        t = self._tensors.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = ModelTensors(
                    torch.as_tensor(self.full_start, dtype=dtype,
                                    device=device),
                    torch.as_tensor(self.var_idx, dtype=torch.int64,
                                    device=device),
                    torch.as_tensor(self.cv_idx, dtype=torch.int64,
                                    device=device),
                    torch.as_tensor(self.cv_const, dtype=dtype,
                                    device=device),
                    prior_tensors(self.prior_table, dtype, device))
            self._tensors[key] = t
        return t

    def full_from_var(self, var_vec):
        """Place a sampled ``(..., n_var)`` vector into the full template
        ``(..., n_full)``.  Works on numpy arrays or tensors."""
        if isinstance(var_vec, np.ndarray):
            full = np.broadcast_to(
                self.full_start, var_vec.shape[:-1] + (self.n_full,)).copy()
            full[..., self.var_idx] = var_vec
            return full
        t = self.tensors(var_vec.dtype, var_vec.device)
        full = t.full_start.expand(
            var_vec.shape[:-1] + (self.n_full,)).clone()
        full[..., t.var_idx] = var_vec
        return full

    def cv_params(self, full_vec: torch.Tensor) -> torch.Tensor:
        """Per-eclipse 18-slot CV parameters ``(..., E, 18)`` from a full
        vector ``(..., n_full)``: indexed slots, with the pinned neutral
        constants where ``cv_idx < 0``."""
        t = self.tensors(full_vec.dtype, full_vec.device)
        gathered = full_vec[..., t.cv_idx.clamp(min=0)]
        return torch.where(t.cv_idx >= 0, gathered, t.cv_const)


def _compile(spec: HierarchicalModel) -> CompiledModel:
    """The numpy index maps and stacked data of ``spec``."""
    names: List[str] = []
    params: List[Param] = []
    labels: List[str] = []

    def add(p: Param, label: str):
        names.append(f"{p.name}_{label}")
        params.append(p)
        labels.append(label)

    for n in CORE_NAMES:
        add(spec.core[n], "core")
    for bname, bp in spec.bands.items():
        for n in BAND_NAMES:
            add(bp[n], bname)
    for ecl in spec.eclipses:
        enames = ECLIPSE_NAMES + (
            ECLIPSE_COMPLEX_NAMES if ecl.complex_spot else ()
        ) + (GP_NAMES if ecl.use_gp else ())
        for n in enames:
            add(ecl.params[n], ecl.name)

    var_mask = np.asarray([p.is_var for p in params], bool)
    var_idx = np.nonzero(var_mask)[0].astype(np.int32)
    var_pos = np.full(len(params), -1, np.int32)
    var_pos[var_idx] = np.arange(len(var_idx), dtype=np.int32)
    index = {n: i for i, n in enumerate(names)}

    n_ecl = len(spec.eclipses)
    cv_idx = np.zeros((n_ecl, 18), np.int32)
    cv_const = np.zeros((n_ecl, 18), np.float64)
    gp_idx = np.zeros((n_ecl, 3), np.int32)
    gp_mask = np.zeros(n_ecl, bool)
    for k, ecl in enumerate(spec.eclipses):
        for s, slot in enumerate(_CV_SLOTS):
            if slot in CORE_NAMES:
                cv_idx[k, s] = index[f"{slot}_core"]
            elif slot in BAND_NAMES:
                cv_idx[k, s] = index[f"{slot}_{ecl.band}"]
            elif slot in _NEUTRAL_COMPLEX and not ecl.complex_spot:
                cv_idx[k, s] = -1
                cv_const[k, s] = _NEUTRAL_COMPLEX[slot]
            else:
                cv_idx[k, s] = index[f"{slot}_{ecl.name}"]
        if ecl.use_gp:
            gp_mask[k] = True
            for s, n in enumerate(GP_NAMES):
                gp_idx[k, s] = index[f"{n}_{ecl.name}"]

    pmax = max((len(e.lightcurve) for e in spec.eclipses), default=0)
    data_phase = np.zeros((n_ecl, pmax))
    data_flux = np.zeros((n_ecl, pmax))
    data_err = np.ones((n_ecl, pmax))
    data_width = np.zeros((n_ecl, pmax))
    data_mask = np.zeros((n_ecl, pmax), bool)
    for k, ecl in enumerate(spec.eclipses):
        lc = ecl.lightcurve
        n = len(lc)
        data_phase[k, :n] = lc.phase
        data_phase[k, n:] = 0.25      # pad slots: harmless out-of-eclipse
        data_flux[k, :n] = lc.flux
        data_err[k, :n] = lc.err
        if lc.width is not None:
            data_width[k, :n] = lc.width
        data_mask[k, :n] = True

    return CompiledModel(
        param_names=names,
        full_start=np.asarray([p.start for p in params], np.float64),
        var_idx=var_idx,
        var_pos=var_pos,
        scatter=np.asarray([p.scatter for p in params], np.float64),
        prior_table=make_prior_table(params),
        cv_idx=cv_idx, cv_const=cv_const, gp_idx=gp_idx, gp_mask=gp_mask,
        data_phase=data_phase, data_flux=data_flux, data_err=data_err,
        data_width=data_width, data_mask=data_mask,
        any_complex=any(e.complex_spot for e in spec.eclipses),
        any_gp=any(e.use_gp for e in spec.eclipses),
        param_labels=labels,
        plot_mask=np.asarray([e.plot for e in spec.eclipses], bool),
        spec=spec,
    )
