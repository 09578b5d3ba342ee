"""Hand-written CUDA kernels, their wrappers and their plain versions.

Each wrapper module counts its kernels' launches in module integers
(``contacts.LAUNCHES``, ``sweeps.CURVE_LAUNCHES``, ...: the integers of
its ``__all__``).  :func:`launch_counts` reads them all and
:func:`add_launch_counts` advances them: a CUDA graph's replay launches
its kernels without calling a wrapper, so its replay adds what its
capture counted.
"""

from __future__ import annotations

import importlib

__all__ = ["launch_counts", "add_launch_counts"]

_WRAPPERS = ("contacts", "gp", "roche", "stream", "sweeps", "wd_donor")
_counters = None


def _all_counters():
    """[(module, name)] of every wrapper module's launch counter."""
    global _counters
    if _counters is None:
        found = []
        for name in _WRAPPERS:
            mod = importlib.import_module(f"{__name__}.{name}")
            found += [(mod, n) for n in mod.__all__
                      if type(getattr(mod, n)) is int]
        _counters = found
    return _counters


def launch_counts():
    """Every launch counter's value, in a fixed order."""
    return tuple(getattr(mod, n) for mod, n in _all_counters())


def add_launch_counts(deltas):
    """Advance each launch counter by its entry of ``deltas`` (in
    :func:`launch_counts`' order)."""
    for (mod, n), d in zip(_all_counters(), deltas):
        if d:
            setattr(mod, n, getattr(mod, n) + d)
