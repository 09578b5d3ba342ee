"""The port's ``fit`` command with ``usePT = 1`` and with ``--precise``, on
the CPU at a size the CPU can run: the demo input with 8 walkers, the
low-resolution element grids.

The tempered fit (2 rungs, float64, 1 burn-in and 2 production steps):
its cold chain's ln_prob column must equal the port's posterior on the
last checkpoint's cold walkers (relative 1e-9: the file keeps 11
significant digits), ``evidence.json`` must equal the JAX package's
``log_evidence`` on its betas and mean ln-likelihoods to 1e-12, its
checkpoints must be of kind ``pt``, and a fit stopped at step 1 and
resumed must write the same chain file.  The ``--precise`` fit (float32
in the mixed-precision mode, 1 + 2 steps) must exit 0 and its chain's
ln_prob column must equal the precise posterior on its walkers (relative
1e-5: float32 batches of another size round otherwise).
"""

import json

import numpy as np
import pytest
import torch

from lfit_python_tpu.sampling.pt import log_evidence as jlog_evidence
from lfit_python_tpu.utils import chains as jchains
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.sampling.pt import PTState
from lfit_python_tpu_torch.utils import checkpoints
from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                parse_input_dat)

from test_torch_cli import CPU, LOW, REPORT, W, demo_copy, run

PT_INPUT = "usePT = 1\nntemps = 2\n"
COMMON = ["--nburn", 1, "--checkpoint-every", 1, *CPU]


@pytest.fixture(scope="module")
def pt_fit(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt_fit")
    inp = demo_copy(d, PT_INPUT)
    rc, out = run("fit", inp, "--outdir", d / "out", "--nprod", 2, *COMMON)
    return d, inp, rc, out


def test_pt_fit_writes_its_files(pt_fit):
    d, _, rc, out = pt_fit
    assert rc == 0, out
    assert sorted(p.name for p in (d / "out").iterdir()) == sorted([
        "chain_prod.txt", "checkpoint_0000001.npz", "checkpoint_0000002.npz",
        "evidence.json", "metrics.jsonl", *REPORT])
    chain, lp, names = jchains.read_chain(d / "out" / "chain_prod.txt")
    assert chain.shape == (2, W, 13) and np.isfinite(lp).all()
    assert "PT (2 rungs) total" in out and "ln-prob evals/s" in out
    assert "ln evidence (thermodynamic integration)" in out
    with np.load(d / "out" / "checkpoint_0000002.npz") as z:
        assert str(z["kind"]) == "pt"
        assert z["positions"].shape == (2, W, 13)


def test_pt_chain_is_the_cold_posterior(pt_fit):
    d, inp, _, _ = pt_fit
    state, _, meta = checkpoints.load_checkpoint(
        d / "out" / "checkpoint_0000002.npz", "cpu", "pt")
    assert isinstance(state, PTState) and state.step == 2
    assert meta["kind"] == "pt"
    chain, lp, _ = jchains.read_chain(d / "out" / "chain_prod.txt")
    np.testing.assert_allclose(chain[-1], state.positions[0].numpy(),
                               rtol=1e-10, atol=0)
    model = build_model_from_config(parse_input_dat(inp)).compile()
    post = make_ln_prob(model, LOW, dtype=torch.float64, device="cpu")
    fresh = post(state.positions[0]).numpy()
    np.testing.assert_allclose(
        (state.ln_prior[0] + state.ln_like[0]).numpy(), fresh, rtol=1e-12)
    np.testing.assert_allclose(lp[-1], fresh, rtol=1e-9, atol=0)


def test_evidence_is_the_jax_log_evidence(pt_fit):
    d, _, _, _ = pt_fit
    ev = json.loads((d / "out" / "evidence.json").read_text())
    assert set(ev) == {"ln_evidence", "dln_evidence", "betas",
                       "mean_ln_like_per_rung", "note"}
    assert ev["betas"] == pytest.approx([1.0, 2 ** -0.5], rel=1e-15)
    ln_z, dln_z = jlog_evidence(np.asarray(ev["betas"]),
                                np.asarray(ev["mean_ln_like_per_rung"]))
    assert ev["ln_evidence"] == pytest.approx(float(ln_z), rel=1e-12)
    assert ev["dln_evidence"] == pytest.approx(float(dln_z), rel=1e-12,
                                               abs=1e-12)
    assert np.isfinite(ev["mean_ln_like_per_rung"]).all()


def test_pt_resume_gives_the_same_chain(pt_fit, tmp_path):
    d, _, _, _ = pt_fit
    inp = demo_copy(tmp_path, PT_INPUT)
    out_dir = tmp_path / "out"
    assert run("fit", inp, "--outdir", out_dir, "--nprod", 1,
               *COMMON)[0] == 0
    rc, out = run("fit", inp, "--outdir", out_dir, "--nprod", 2, "--resume",
                  *COMMON)
    assert rc == 0, out
    assert "resumed from" in out and "at step 1" in out
    assert (out_dir / "chain_prod.txt").read_text() == \
        (d / "out" / "chain_prod.txt").read_text()


def test_precise_fit(tmp_path):
    inp = demo_copy(tmp_path)
    out_dir = tmp_path / "out"
    rc, out = run("fit", inp, "--outdir", out_dir, "--precise", "--nburn", 1,
                  "--nprod", 2, "--checkpoint-every", 2, "--device", "cpu",
                  "--resolution", "low", "--quiet")
    assert rc == 0, out
    state, _, _ = checkpoints.load_checkpoint(
        out_dir / "checkpoint_0000002.npz", "cpu")
    assert state.positions.dtype == torch.float32
    chain, lp, _ = jchains.read_chain(out_dir / "chain_prod.txt")
    assert chain.shape == (2, W, 13) and np.isfinite(lp).all()
    model = build_model_from_config(parse_input_dat(inp)).compile()
    post = make_ln_prob(model, LOW._replace(mixed_precision=True),
                        dtype=torch.float32, device="cpu")
    fresh = post(state.positions).double().numpy()
    np.testing.assert_allclose(lp[-1], fresh, rtol=1e-5, atol=0)
    # the chain is not the float32 posterior without the mode
    fast = make_ln_prob(model, CVConfig(**LOW._asdict()),
                        dtype=torch.float32, device="cpu")
    assert not np.array_equal(fast(state.positions).double().numpy(), fresh)
