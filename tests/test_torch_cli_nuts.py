"""The port's ``fit`` command with ``--sampler nuts``: the tests of
tests/test_torch_cli_hmc.py (a fit at 8 chains, 2 warmup and 2
production steps, at depth 1, and its resume), for NUTS."""

import pytest

from test_torch_cli_hmc import (gradient_fit,  # noqa: F401
                                test_fit_writes_its_files,
                                test_resume_gives_the_same_chain)

__all__ = ["test_fit_writes_its_files", "test_resume_gives_the_same_chain"]


@pytest.fixture(scope="module")
def sampler():
    return "nuts"
