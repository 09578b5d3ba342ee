"""Chain files and convergence diagnostics.

Port of ``lfit_python_tpu/utils/chains.py``: the same text format, one row
per (step, walker),

    walker_index  par_0 ... par_{D-1}  ln_prob

under the header ``# walker <names> ln_prob``, so chain files of either
package are read by the other.  Rows are written with numpy, or with the
native C++ writer (``lfit_python_tpu_torch.native``) where a
:class:`ChainWriter` is given ``use_native=True``: the same bytes.
:func:`save_arviz` writes the chain as named per-parameter arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = [
    "ChainWriter",
    "read_chain",
    "flatchain",
    "gelman_rubin",
    "autocorr_time",
    "rebin",
    "save_arviz",
    "to_arviz",
    "summarize",
]


class ChainWriter:
    """Incremental chain writer: rows are appended as steps arrive, so a
    killed run keeps every row written so far."""

    def __init__(self, path, param_names: Sequence[str], append=False,
                 use_native=False):
        """``append=True`` keeps an existing file's rows (resume): the
        header is written only to a new or empty file, and a file with
        another header is refused.  ``use_native=True`` formats the rows
        in C++ (built on first use; a failed build raises)."""
        self.path = Path(path)
        self.param_names = list(param_names)
        header = "# walker " + " ".join(self.param_names) + " ln_prob\n"
        if append and self.path.exists() and self.path.stat().st_size:
            with self.path.open() as fh:
                existing = fh.readline()
            if existing != header:
                raise ValueError(
                    f"{self.path} exists with a different parameter header; "
                    "refusing to append a mismatched chain")
        else:
            self.path.write_text(header)
        self._fh = self.path.open("a")
        self._use_native = use_native

    def append(self, positions: np.ndarray, log_probs: np.ndarray):
        """positions (n_steps, W, D) or (W, D); log_probs matching."""
        positions = np.asarray(positions)
        log_probs = np.asarray(log_probs)
        if positions.ndim == 2:
            positions = positions[None]
        if log_probs.ndim == 1:
            log_probs = log_probs[None]
        n_steps, W, D = positions.shape
        rows = np.empty((n_steps * W, D + 2))
        rows[:, 0] = np.tile(np.arange(W), n_steps)
        rows[:, 1:-1] = positions.reshape(-1, D)
        rows[:, -1] = log_probs.reshape(-1)
        if self._use_native:
            from ..native import chain_write

            self._fh.flush()
            chain_write(self.path, rows)
            return
        np.savetxt(self._fh, rows, fmt=["%d"] + ["%.10e"] * (D + 1))
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_chain(path):
    """Read a chain file -> (chain (n_steps, W, D), lnp (n_steps, W),
    param_names)."""
    path = Path(path)
    with path.open() as fh:
        header = fh.readline()
    names = header.lstrip("#").split()
    if not names or names[0] != "walker" or names[-1] != "ln_prob":
        raise ValueError(f"{path}: not a chain file (header {header!r})")
    names = names[1:-1]
    raw = np.loadtxt(path, ndmin=2)
    W = int(raw[:, 0].max()) + 1
    n_steps = raw.shape[0] // W
    raw = raw[: n_steps * W]
    chain = raw[:, 1:-1].reshape(n_steps, W, -1)
    lnp = raw[:, -1].reshape(n_steps, W)
    return chain, lnp, names


def flatchain(chain, discard=0, thin=1):
    """(n_steps, W, D) -> (n_samples, D)."""
    return np.asarray(chain)[discard::thin].reshape(-1, chain.shape[-1])


def gelman_rubin(chain, discard=0):
    """Split-R-hat per parameter of ``chain`` (n_steps, W, D), each walker
    a chain split in half (Gelman et al. 2013).

    A heuristic: stretch-move walkers are correlated by construction (each
    proposal uses another walker), so treating them as independent chains
    understates R-hat.  For a convergence claim compare independent runs.
    """
    x = np.asarray(chain)[discard:]
    n, w, d = x.shape
    half = n // 2
    x = np.concatenate([x[:half], x[half: 2 * half]], axis=1)  # (half, 2w, d)
    n, m, _ = x.shape
    means = x.mean(axis=0)                      # (m, d)
    W = x.var(axis=0, ddof=1).mean(axis=0)      # within-chain
    B = n * means.var(axis=0, ddof=1)           # between-chain
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / np.maximum(W, 1e-300))


def autocorr_time(chain, c=5.0, walker_block=256):
    """Integrated autocorrelation time per parameter (emcee's
    self-consistent window), for the effective sample size.

    FFT-based, over blocks of ``walker_block`` walkers whose normalised
    autocorrelations are summed: the transient memory is ~26x one block's
    rows, not the whole chain's.
    """
    x = np.asarray(chain)
    n, w, d = x.shape
    # next power of two >= 2n for linear (non-circular) autocorrelation
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.zeros((n, d))
    for b0 in range(0, w, walker_block):
        y = np.asarray(x[:, b0:b0 + walker_block], np.float64)
        y = y - y.mean(axis=0, keepdims=True)       # (n, wb, d)
        fy = np.fft.rfft(y, n=nfft, axis=0)
        fy *= np.conj(fy)
        acf = np.fft.irfft(fy, n=nfft, axis=0)[:n]  # (n, wb, d)
        del fy
        acf /= np.maximum(acf[0], 1e-300)
        f += acf.sum(axis=1)
    f /= w                                          # (n, d) walker-averaged
    taus = np.empty(d)
    for j in range(d):
        taus_cum = 2.0 * np.cumsum(f[:, j]) - 1.0
        window = np.arange(n) < c * taus_cum
        idx = np.argmin(window) if not window.all() else n - 1
        taus[j] = taus_cum[max(idx, 1)]
    return taus


def rebin(phase, flux, err, factor):
    """Rebin a light curve by an integer factor with inverse-variance
    weighting; trailing remainder points are dropped."""
    n = (len(phase) // factor) * factor
    ph = np.asarray(phase)[:n].reshape(-1, factor)
    fl = np.asarray(flux)[:n].reshape(-1, factor)
    er = np.asarray(err)[:n].reshape(-1, factor)
    w = 1.0 / np.maximum(er, 1e-300) ** 2
    wsum = w.sum(axis=1)
    return (ph.mean(axis=1),
            (fl * w).sum(axis=1) / wsum,
            1.0 / np.sqrt(wsum))


def to_arviz(chain, param_names, log_prob=None):
    """Chain (n_steps, W, D) -> ``arviz.InferenceData`` where arviz is
    importable, else a dict {name: (walker, draw) array}, with ``ln_prob``
    (walker, draw) where ``log_prob`` (n_steps, W) is given."""
    x = np.asarray(chain)          # (draw, walker, dim) -> (walker, draw)
    data = {n: x[:, :, i].T for i, n in enumerate(param_names)}
    if log_prob is not None:
        data["ln_prob"] = np.asarray(log_prob).T
    try:
        import arviz

        return arviz.from_dict(posterior=data)
    except Exception:
        return data


def save_arviz(chain, param_names, path, log_prob=None):
    """Write the chain in ArviZ form: ``<path>.nc`` (netCDF) where arviz
    is importable, else ``<path>.npz`` holding the same named (walker,
    draw) arrays.  Returns the written path."""
    out = to_arviz(chain, param_names, log_prob)
    path = Path(path)
    if isinstance(out, dict):               # arviz absent: npz
        path = path.with_suffix(".npz")
        np.savez_compressed(path, **out)
    else:
        path = path.with_suffix(".nc")
        out.to_netcdf(str(path))
    return path


def summarize(chain, param_names, discard=0, percentiles=(16, 50, 84)):
    """Percentile table: a list of dicts with name, median, upper (+err)
    and lower (-err)."""
    flat = flatchain(chain, discard)
    lo, med, hi = np.percentile(flat, percentiles, axis=0)
    return [
        {
            "name": nm,
            "median": float(m),
            "upper": float(h - m),
            "lower": float(m - l),
        }
        for nm, l, m, h in zip(param_names, lo, med, hi)
    ]
