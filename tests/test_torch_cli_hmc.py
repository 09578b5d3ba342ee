"""The port's ``fit`` command with ``--sampler hmc`` (and, through
tests/test_torch_cli_nuts.py, which runs these tests for ``--sampler
nuts``), on the CPU at a size the CPU can run: the demo input with 8
chains, float64, the low-resolution element grids, 2 warmup steps and 2
production steps (HMC with 2 leapfrog steps, NUTS at depth 1: every
evaluation on the CPU pays the eager stream scan with its
sensitivities, ~12 s).

After tests/test_cli.py's HMC and NUTS tests: the fit exits 0 and writes
its chain (2 x 8 x 13, finite) and checkpoints of kind ``hmc`` that carry
the adapted step size and metric and name the sampler in their meta; the
chain's ln_prob column equals the posterior on the last checkpoint's
chains (relative 1e-9: 11 significant digits in the file); and a resume
from what a fit stopped after its first production checkpoint leaves
(that checkpoint, and the chain file's header and first step: a run with
``--nprod 1`` runs exactly the whole run's first segment) writes the same
chain file as the whole run.  The HMC fit with ``--shard`` under
``torchrun`` at 2 ranks (gloo; after tests/test_cli.py's sharded HMC fit)
writes the unsharded fit's chain file byte for byte.
"""

import shutil

import numpy as np
import pytest
import torch

from lfit_python_tpu.utils import chains as jchains
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.sampling.hmc import HMCState
from lfit_python_tpu_torch.utils import checkpoints
from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                parse_input_dat)

from test_torch_cli import CPU, LOW, REPORT, W, demo_copy, run, torchrun

SAMPLERS = {"hmc": ["--sampler", "hmc", "--hmc-leapfrog", 2],
            "nuts": ["--sampler", "nuts", "--nuts-max-depth", 1]}
COMMON = ["--nburn", 2, "--checkpoint-every", 1, *CPU]


@pytest.fixture(scope="module")
def sampler():
    return "hmc"


@pytest.fixture(scope="module")
def gradient_fit(sampler, tmp_path_factory):
    kind = sampler
    d = tmp_path_factory.mktemp(f"{kind}_fit")
    inp = demo_copy(d)
    rc, out = run("fit", inp, "--outdir", d / "out", "--nprod", 2,
                  *SAMPLERS[kind], *COMMON)
    return kind, d, inp, rc, out


def test_fit_writes_its_files(gradient_fit):
    kind, d, inp, rc, out = gradient_fit
    assert rc == 0, out
    assert sorted(p.name for p in (d / "out").iterdir()) == sorted([
        "chain_prod.txt", "checkpoint_0000001.npz", "checkpoint_0000002.npz",
        "metrics.jsonl", *REPORT])
    chain, lp, _ = jchains.read_chain(d / "out" / "chain_prod.txt")
    assert chain.shape == (2, W, 13) and np.isfinite(lp).all()
    if kind == "hmc":
        assert "HMC total" in out and "gradient evals/s" in out
    else:
        assert "NUTS total" in out and "mean depth 1.0" in out
        assert "trajectories/s" in out
    state, _, meta = checkpoints.load_checkpoint(
        d / "out" / "checkpoint_0000002.npz", "cpu", "hmc")
    assert isinstance(state, HMCState) and state.step == 2
    assert meta["kind"] == kind
    assert float(state.step_size) > 0.0
    assert state.inv_mass.shape == (13,) and bool((state.inv_mass > 0).all())
    # the chain's ln_prob column is the posterior
    np.testing.assert_allclose(chain[-1], state.positions.numpy(),
                               rtol=1e-10, atol=0)
    model = build_model_from_config(parse_input_dat(inp)).compile()
    post = make_ln_prob(model, LOW, dtype=torch.float64, device="cpu")
    fresh = post(state.positions).numpy()
    np.testing.assert_allclose(state.log_prob.numpy(), fresh, rtol=1e-12)
    np.testing.assert_allclose(lp[-1], fresh, rtol=1e-9, atol=0)


def test_resume_gives_the_same_chain(gradient_fit, tmp_path):
    kind, d, _, _, _ = gradient_fit
    inp = demo_copy(tmp_path)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    lines = (d / "out" / "chain_prod.txt").read_text().splitlines(
        keepends=True)
    (out_dir / "chain_prod.txt").write_text("".join(lines[:1 + W]))
    shutil.copy(d / "out" / "checkpoint_0000001.npz", out_dir)
    rc, out = run("fit", inp, "--outdir", out_dir, "--nprod", 2, "--resume",
                  *SAMPLERS[kind], *COMMON)
    assert rc == 0, out
    assert "resumed from" in out and "at step 1" in out
    assert (out_dir / "chain_prod.txt").read_text() == \
        (d / "out" / "chain_prod.txt").read_text()


def test_sharded_fit_writes_the_same_chain(gradient_fit, tmp_path):
    kind, d, _, _, _ = gradient_fit
    inp = demo_copy(tmp_path)
    rc, out = torchrun(2, "fit", inp, "--outdir", tmp_path / "out",
                       "--nprod", 2, "--shard", *SAMPLERS[kind], *COMMON)
    assert rc == 0, out[-4000:]
    assert "--shard: 2 rank(s), gloo, ranks started by torchrun" in out
    assert (tmp_path / "out" / "chain_prod.txt").read_text() == \
        (d / "out" / "chain_prod.txt").read_text()
