"""Where the port's entry points put their tensors.

The port is written for the card: ``make_ln_prob``, ``make_ln_prob_parts``,
``Posterior``, ``convert.state_from_numpy``, ``convert.hmc_state_from_numpy``
and ``convert.pt_state_from_numpy`` put their tensors on the CUDA device
unless the caller names another one.
Without a card they raise rather than carry on on the CPU; a caller who
wants the CPU (the CPU tests, a machine without a card) passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.  A
    CUDA device raises ``RuntimeError`` where there is no card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device='cpu' to run on the CPU")
    return device
