"""Checkpoints of the port's ensemble sampler.

Port of ``lfit_python_tpu/utils/checkpoints.py`` for
:class:`~..sampling.ensemble.EnsembleState`.  A checkpoint holds the
walker positions, their ln-probabilities, the global step counter and the
state of the ``torch.Generator`` the sampler draws from, so a resumed run
is bit-identical to an uninterrupted one on the same device.

The fields ``version``, ``kind``, ``meta``, ``positions``, ``log_prob``
and ``step`` have the JAX package's names and meaning.  In place of its
PRNG key the file holds ``generator_state`` (``Generator.get_state()``,
uint8) and ``generator_device`` (the generator's device type), under a
format version of its own.  A file without a generator state, such as
any checkpoint of the JAX package, cannot be resumed and is refused.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..sampling.ensemble import EnsembleState

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

_FMT_VERSION = 101


def save_checkpoint(path, state: EnsembleState, generator: torch.Generator,
                    meta: dict | None = None):
    """Write ``state`` and ``generator``'s state to ``path`` atomically
    (a temporary file, then a rename).  Returns ``path``."""
    path = Path(path)
    # a hidden name, which latest_checkpoint's pattern never matches
    tmp = path.with_name(f".{path.name}.tmp")
    with tmp.open("wb") as fh:
        np.savez(
            fh,
            version=_FMT_VERSION,
            kind="ensemble",
            meta=json.dumps(meta or {}),
            positions=state.positions.detach().cpu().numpy(),
            log_prob=state.log_prob.detach().cpu().numpy(),
            step=np.asarray(state.step, np.int64),
            generator_state=generator.get_state().numpy(),
            generator_device=generator.device.type,
        )
    tmp.replace(path)
    return path


def load_checkpoint(path, device):
    """Read a checkpoint written by :func:`save_checkpoint` -> (state on
    ``device``, a ``torch.Generator`` on ``device`` in the saved state,
    meta dict).  Raises ``ValueError`` for a file that holds no generator
    state (a JAX-package checkpoint), for another sampler kind, or for a
    generator saved on another device type."""
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
        kind = str(z["kind"])
        if kind != "ensemble":
            raise ValueError(f"{path} is a {kind!r} checkpoint; only "
                             "ensemble checkpoints are read here")
        gen_device = str(z["generator_device"])
        if gen_device != device.type:
            raise ValueError(
                f"{path} holds a {gen_device} generator; a resume on "
                f"{device.type} would not continue its random stream")
        state = EnsembleState(
            torch.from_numpy(z["positions"]).to(device),
            torch.from_numpy(z["log_prob"]).to(device),
            int(z["step"]))
        generator = torch.Generator(device=device)
        generator.set_state(torch.from_numpy(z["generator_state"]))
        meta = json.loads(str(z["meta"]))
    return state, generator, meta


def latest_checkpoint(directory, pattern="checkpoint_*.npz"):
    """Most recent checkpoint file in a directory, or None."""
    files = sorted(Path(directory).glob(pattern))
    return files[-1] if files else None
