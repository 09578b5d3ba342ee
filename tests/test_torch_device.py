"""The port's entry points put their tensors on the CUDA card unless the
caller names a device, and raise where there is no card.

The tests decide inside each test whether this machine has a card: here,
on a CPU-only machine, the default raises; with a card it is the card.
"""

import numpy as np
import pytest
import torch

from lfit_python_tpu_torch import convert
from lfit_python_tpu_torch.device import resolve_device
from lfit_python_tpu_torch.examples import build_model
from lfit_python_tpu_torch.models.likelihood import (Posterior, make_ln_prob,
                                                     make_ln_prob_parts)


@pytest.fixture(scope="module")
def model():
    return build_model(n_eclipses=1, n_points=8).compile()


HMC_FIELDS = dict(positions=np.zeros((2, 3)), log_prob=np.zeros(2),
                  grad=np.zeros((2, 3)), step_size=0.1,
                  inv_mass=np.ones(3), step=4)

PT_FIELDS = dict(positions=np.zeros((2, 4, 3)), ln_like=np.zeros((2, 4)),
                 ln_prior=np.zeros((2, 4)), betas=np.array([1.0, 0.5]),
                 step=3)

ENTRY_POINTS = {
    "make_ln_prob": lambda m, **kw: make_ln_prob(m, **kw).phase,
    "Posterior": lambda m, **kw: Posterior(m, **kw).flux,
    "state_from_numpy": lambda m, **kw: convert.state_from_numpy(
        np.ones((4, 3)), np.zeros(4), 0, **kw).positions,
    "hmc_state_from_numpy": lambda m, **kw: convert.hmc_state_from_numpy(
        HMC_FIELDS, **kw).grad,
    "make_ln_prob_parts": lambda m, **kw: make_ln_prob_parts(
        m, **kw)[2].gp_mask,
    "pt_state_from_numpy": lambda m, **kw: convert.pt_state_from_numpy(
        PT_FIELDS, **kw).betas,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(model, entry):
    """No device given: the card, or a clear error without one."""
    fn = ENTRY_POINTS[entry]
    if torch.cuda.is_available():
        assert fn(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(model)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_explicit_cpu(model, entry):
    assert ENTRY_POINTS[entry](model, device="cpu").device.type == "cpu"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
