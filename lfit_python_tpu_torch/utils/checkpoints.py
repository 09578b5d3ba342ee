"""Checkpoints of the port's samplers.

Port of ``lfit_python_tpu/utils/checkpoints.py`` for the three sampler
states: :class:`~..sampling.ensemble.EnsembleState` (kind ``ensemble``),
:class:`~..sampling.pt.PTState` (kind ``pt``) and
:class:`~..sampling.hmc.HMCState` (kind ``hmc``, for HMC and NUTS alike;
the command line keeps which of the two in ``meta``).  A checkpoint holds
the state's arrays, the global step counter and the state of the
``torch.Generator`` the sampler draws from, so a resumed run is
bit-identical to an uninterrupted one on the same device.

The fields ``version``, ``kind``, ``meta``, ``positions``, ``log_prob``
and ``step`` have the JAX package's names and meaning, and so do the
other kinds' own: ``ln_prior`` and ``betas`` for ``pt`` (whose
``log_prob`` holds the ln-likelihood), ``grad``, ``step_size`` and
``inv_mass`` for ``hmc``.  In place of its PRNG key the file holds
``generator_state`` (``Generator.get_state()``, uint8) and
``generator_device`` (the generator's device type), under a format
version of its own.  A file without a generator state, such as any
checkpoint of the JAX package, cannot be resumed and is refused.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..sampling.ensemble import EnsembleState
from ..sampling.hmc import HMCState
from ..sampling.pt import PTState

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_FMT_VERSION = 101
# kind: (state type, the fields beside positions and step, in the state's
# field order; "log_prob" is the file's name of the first)
_KINDS = {
    "ensemble": (EnsembleState, ("log_prob",)),
    "pt": (PTState, ("log_prob", "ln_prior", "betas")),
    "hmc": (HMCState, ("log_prob", "grad", "step_size", "inv_mass")),
}


def _kind_of(state):
    for kind, (cls, _) in _KINDS.items():
        if isinstance(state, cls):
            return kind
    raise TypeError(f"no checkpoint kind for a {type(state).__name__}")


def save_checkpoint(path, state, generator: torch.Generator,
                    meta: dict | None = None):
    """Write ``state`` (an ensemble, PT or HMC state) and ``generator``'s
    state to ``path`` atomically (a temporary file, then a rename).
    Returns ``path``."""
    path = Path(path)
    kind = _kind_of(state)
    values = state[1:-1]           # the fields between positions and step
    fields = {name: v.detach().cpu().numpy()
              for name, v in zip(_KINDS[kind][1], values)}
    # a hidden name, which latest_checkpoint's pattern never matches
    tmp = path.with_name(f".{path.name}.tmp")
    with tmp.open("wb") as fh:
        np.savez(
            fh,
            version=_FMT_VERSION,
            kind=kind,
            meta=json.dumps(meta or {}),
            positions=state.positions.detach().cpu().numpy(),
            step=np.asarray(state.step, np.int64),
            generator_state=generator.get_state().numpy(),
            generator_device=generator.device.type,
            **fields,
        )
    tmp.replace(path)
    return path


def load_checkpoint(path, device, kind="ensemble"):
    """Read a checkpoint written by :func:`save_checkpoint` -> (state of
    ``kind``'s type on ``device``, a ``torch.Generator`` on ``device`` in
    the saved state, meta dict).  Raises ``ValueError`` for a file that
    holds no generator state (a JAX-package checkpoint), for a checkpoint
    of another kind than ``kind``, or for a generator saved on another
    device type."""
    device = torch.device(device)
    with np.load(Path(path), allow_pickle=False) as z:
        if "generator_state" not in z:
            raise ValueError(
                f"{path} holds no torch.Generator state (a JAX-package "
                "checkpoint stores a JAX PRNG key, which the port cannot "
                "continue); it cannot be resumed here")
        version = int(z["version"])
        if version != _FMT_VERSION:
            raise ValueError(f"{path}: unsupported checkpoint version "
                             f"{version}")
        found = str(z["kind"])
        if found != kind:
            raise ValueError(f"{path} is a {found!r} checkpoint, not a "
                             f"{kind!r} one; refusing to resume across "
                             "sampler kinds")
        gen_device = str(z["generator_device"])
        if gen_device != device.type:
            raise ValueError(
                f"{path} holds a {gen_device} generator; a resume on "
                f"{device.type} would not continue its random stream")
        cls, names = _KINDS[kind]
        state = cls(torch.from_numpy(z["positions"]).to(device),
                    *(torch.from_numpy(z[n]).to(device) for n in names),
                    int(z["step"]))
        generator = torch.Generator(device=device)
        generator.set_state(torch.from_numpy(z["generator_state"]))
        meta = json.loads(str(z["meta"]))
    return state, generator, meta


def latest_checkpoint(directory, pattern="checkpoint_*.npz"):
    """Most recent checkpoint file in a directory, or None."""
    files = sorted(Path(directory).glob(pattern))
    return files[-1] if files else None
