"""The port's ``fit`` command on the CPU, at a size the CPU can run: the
demo input with 8 walkers, 2 burn-in and 4 production steps, float64, the
low-resolution element grids.

One fit is shared by the tests that read its files.  Its chain file's
ln_prob column must equal the port's posterior re-evaluated on the last
checkpoint's walkers (relative 1e-9: the file keeps 11 significant
digits), the checkpoint's walkers must be the chain's last rows, and a
fit stopped at step 2 and resumed must write the same chain file.  The
same fit with ``--shard`` under ``torchrun`` at 2 ranks (gloo), stopped
at step 2 and resumed, writes that chain file byte for byte; ``--shard``
without torchrun is a one-rank group and says so, and refuses a walker
count that twice the world size does not divide.  Every
option or input key the port does not run yet exits with code 2 and a
message naming what it waits for, and so does each combination the JAX
package's command line refuses (``--precise`` or ``usePT`` with HMC /
NUTS, a resume from another sampler kind's checkpoint); without a card
and without ``--device cpu`` the command exits non-zero.  The tempered,
HMC, NUTS and ``--precise`` fits have their own files
(tests/test_torch_cli_*.py).
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lfit_python_tpu.utils import chains as jchains
from lfit_python_tpu_torch import cli
from lfit_python_tpu_torch.models.cv import CVConfig
from lfit_python_tpu_torch.models.likelihood import make_ln_prob
from lfit_python_tpu_torch.utils import checkpoints
from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                parse_input_dat)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
W, N_BURN, N_PROD = 8, 2, 4
CPU = ["--device", "cpu", "--x64", "--resolution", "low", "--quiet"]
LOW = CVConfig(n_disc_rad=5, n_disc_az=8, n_spot=8, n_donor_lat=6,
               n_donor_lon=8)


def demo_copy(d, extra=""):
    """The demo input at 8 walkers (plus ``extra`` lines) in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    text = (EXAMPLES / "demo_input.dat").read_text().replace(
        "nwalkers = 1024", f"nwalkers = {W}")
    path = d / "input.dat"
    path.write_text(text + extra)
    shutil.copy(EXAMPLES / "demo_ecl0.txt", d)
    return path


def run(*argv):
    """``cli.main(argv)`` -> (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    inp = demo_copy(d)
    rc, out = run("fit", inp, "--outdir", d / "out", "--nburn", N_BURN,
                  "--nprod", N_PROD, "--checkpoint-every", 2, *CPU)
    return d, inp, rc, out


def test_fit_writes_its_files(fit):
    d, _, rc, out = fit
    assert rc == 0, out
    out_dir = d / "out"
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "chain_prod.txt", "checkpoint_0000002.npz", "checkpoint_0000004.npz",
        "metrics.jsonl", "params.json"]
    chain, lp, names = jchains.read_chain(out_dir / "chain_prod.txt")
    assert chain.shape == (N_PROD, W, 13) and lp.shape == (N_PROD, W)
    assert names[0] == "q_core" and names[-1] == "phi0_ecl0"
    assert np.isfinite(lp).all()
    table = json.loads((out_dir / "params.json").read_text())
    assert [r["name"] for r in table] == names
    assert all(set(r) == {"name", "median", "upper", "lower"} for r in table)
    recs = [json.loads(ln) for ln in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(r["stage"], r["step"]) for r in recs] == [
        ("burn", 2), ("prod", 2), ("prod", 4)]
    assert all(0.0 <= r["accept"] <= 1.0 for r in recs)
    assert "ln-prob evals/s" in out and out.startswith("total ")
    assert "max split-R-hat" in out and "plots: not made" in out


def test_chain_ln_prob_is_the_posterior(fit):
    d, inp, _, _ = fit
    state, _, meta = checkpoints.load_checkpoint(
        d / "out" / "checkpoint_0000004.npz", "cpu")
    assert state.step == N_PROD and meta["stage"] == "prod"
    chain, lp, _ = jchains.read_chain(d / "out" / "chain_prod.txt")
    pos = state.positions.numpy()
    np.testing.assert_allclose(chain[-1], pos, rtol=1e-10, atol=0)
    model = build_model_from_config(parse_input_dat(inp)).compile()
    ln_prob = make_ln_prob(model, LOW, dtype=torch.float64, device="cpu")
    with torch.inference_mode():
        fresh = ln_prob(state.positions).numpy()
    np.testing.assert_allclose(state.log_prob.numpy(), fresh, rtol=1e-12)
    np.testing.assert_allclose(lp[-1], fresh, rtol=1e-9, atol=0)


def test_resume_gives_the_same_chain(fit, tmp_path):
    d, _, _, _ = fit
    inp = demo_copy(tmp_path)
    common = ["--outdir", tmp_path / "out", "--nburn", N_BURN,
              "--checkpoint-every", 2, *CPU]
    assert run("fit", inp, "--nprod", 2, *common)[0] == 0
    rc, out = run("fit", inp, "--nprod", N_PROD, "--resume", *common)
    assert rc == 0
    assert "resumed from" in out and "at step 2" in out
    assert (tmp_path / "out" / "chain_prod.txt").read_text() == \
        (d / "out" / "chain_prod.txt").read_text()
    assert sorted(p.name for p in (tmp_path / "out").glob("checkpoint_*")) \
        == ["checkpoint_0000002.npz", "checkpoint_0000004.npz"]


def torchrun(n_ranks, *argv):
    """The command line under ``torchrun --standalone`` (a free localhost
    port) at ``n_ranks`` ranks -> (exit code, its output)."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n_ranks}", "-m", "lfit_python_tpu_torch.cli",
         *(str(a) for a in argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    return proc.returncode, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def sharded_fit(tmp_path_factory):
    """The shared fit with ``--shard`` at 2 ranks, stopped after its
    first checkpoint segment (its chain file then), and resumed."""
    d = tmp_path_factory.mktemp("sharded_fit")
    inp = demo_copy(d)
    common = ["--outdir", d / "out", "--nburn", N_BURN, "--checkpoint-every",
              2, "--shard", *CPU]
    first = torchrun(2, "fit", inp, "--nprod", 2, *common)
    stopped = (d / "out" / "chain_prod.txt").read_text()
    resumed = torchrun(2, "fit", inp, "--nprod", N_PROD, "--resume", *common)
    return d, first, stopped, resumed


def test_sharded_fit_writes_the_same_chain(fit, sharded_fit):
    _, (rc, out), stopped, _ = sharded_fit
    assert rc == 0, out[-4000:]
    assert "--shard: 2 rank(s), gloo, ranks started by torchrun" in out
    lines = (fit[0] / "out" / "chain_prod.txt").read_text().splitlines(
        keepends=True)
    assert stopped == "".join(lines[:1 + 2 * W])


def test_sharded_fit_resumes(fit, sharded_fit):
    d, _, _, (rc, out) = sharded_fit
    assert rc == 0, out[-4000:]
    assert "resumed from" in out and "at step 2" in out
    assert (d / "out" / "chain_prod.txt").read_text() == \
        (fit[0] / "out" / "chain_prod.txt").read_text()
    assert sorted(p.name for p in (d / "out").iterdir()) == [
        "chain_prod.txt", "checkpoint_0000002.npz", "checkpoint_0000004.npz",
        "metrics.jsonl", "params.json"]


def test_shard_without_torchrun_is_a_one_rank_group(tmp_path):
    import torch.distributed as dist

    inp = demo_copy(tmp_path)
    rc, out = run("fit", inp, "--outdir", tmp_path / "out", "--nburn", 0,
                  "--nprod", 0, "--shard", *CPU)
    assert rc == 0
    assert "--shard: 1 rank(s), gloo, a one-rank group: not started by " \
        "torchrun" in out
    assert not dist.is_initialized()


def test_shard_refuses_an_indivisible_walker_count(tmp_path, capsys):
    inp = demo_copy(tmp_path)
    inp.write_text(inp.read_text().replace(f"nwalkers = {W}",
                                           "nwalkers = 7"))
    rc = cli.main(["fit", str(inp), "--outdir", str(tmp_path / "out"),
                   "--nburn", "0", "--nprod", "2", "--shard", *CPU])
    assert rc == 2
    assert "n_walkers=7 must be divisible by 2*world_size=2" in \
        capsys.readouterr().err


ITEM6 = "ROADMAP queue 1 item 6"
BY_DTYPE = "routes the contact solve by dtype"
REFUSED = {
    "pallas": (["--pallas"], "", BY_DTYPE),
    "no_pallas": (["--no-pallas"], "", BY_DTYPE),
    "profile": (["--profile", "trace"], "", ITEM6),
    "notify_cmd": (["--notify-cmd", "true"], "", ITEM6),
    "notify_file": (["--notify-file", "n.jsonl"], "", ITEM6),
    "notify_key": ([], "notify = 1\n", ITEM6),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_options_exit_2(case, tmp_path, capsys):
    flags, extra, why = REFUSED[case]
    inp = demo_copy(tmp_path, extra)
    rc = cli.main(["fit", str(inp), "--outdir", str(tmp_path / "out"),
                   *flags, *CPU])
    err = capsys.readouterr().err
    assert rc == 2
    assert why in err
    assert not (tmp_path / "out").exists()


PT_INPUT = "usePT = 1\nntemps = 2\n"
NOT_DIFFERENTIABLE = "not differentiable"
NO_LADDER = "ignores usePT"
ACROSS = "refusing to resume across sampler kinds"
# the JAX command line's refusals (lfit_python_tpu/cli.py): flags that do
# not go together, and a resume from another sampler kind's checkpoint
# (flags, input lines, the kind of checkpoint in outdir, message)
JAX_REFUSALS = {
    "hmc_precise": (["--sampler", "hmc", "--precise"], "", None,
                    NOT_DIFFERENTIABLE),
    "nuts_precise": (["--sampler", "nuts", "--precise"], "", None,
                     NOT_DIFFERENTIABLE),
    "hmc_usePT": (["--sampler", "hmc"], PT_INPUT, None, NO_LADDER),
    "nuts_usePT": (["--sampler", "nuts"], PT_INPUT, None, NO_LADDER),
    "pt_to_ensemble": ([], "", "pt", ACROSS),
    "ensemble_to_pt": ([], PT_INPUT, "ensemble", ACROSS),
    "hmc_to_nuts": (["--sampler", "nuts"], "", "hmc", ACROSS),
    "ensemble_to_hmc": (["--sampler", "hmc"], "", "ensemble", ACROSS),
    "nuts_to_ensemble": ([], "", "nuts", ACROSS),
    "hmc_to_pt": ([], PT_INPUT, "hmc", ACROSS),
}


def kind_checkpoint(out_dir, kind):
    """A checkpoint of sampler ``kind`` at step 2 in ``out_dir``, of a
    state of the demo's width (no posterior evaluated)."""
    from lfit_python_tpu_torch.sampling.ensemble import EnsembleState
    from lfit_python_tpu_torch.sampling.hmc import HMCState
    from lfit_python_tpu_torch.sampling.pt import PTState

    out_dir.mkdir(parents=True)
    z = torch.zeros
    f64 = dict(dtype=torch.float64)
    state = {"ensemble": EnsembleState(z(W, 13, **f64), z(W, **f64), 2),
             "pt": PTState(z(2, W, 13, **f64), z(2, W, **f64),
                           z(2, W, **f64), z(2, **f64), 2)}.get(kind)
    if state is None:
        state = HMCState(z(W, 13, **f64), z(W, **f64), z(W, 13, **f64),
                         z((), **f64), z(13, **f64), 2)
    checkpoints.save_checkpoint(out_dir / "checkpoint_0000002.npz", state,
                                torch.Generator(), {"kind": kind})


@pytest.mark.parametrize("case", sorted(JAX_REFUSALS))
def test_jax_command_line_refusals_exit_2(case, tmp_path, capsys):
    flags, extra, saved, why = JAX_REFUSALS[case]
    inp = demo_copy(tmp_path, extra)
    out_dir = tmp_path / "out"
    if saved is not None:
        kind_checkpoint(out_dir, saved)
        flags = [*flags, "--resume"]
    before = sorted(p.name for p in out_dir.iterdir()) \
        if out_dir.exists() else None
    rc = cli.main(["fit", str(inp), "--outdir", str(out_dir), *flags, *CPU])
    err = capsys.readouterr().err
    assert rc == 2
    assert why in err
    if before is None:
        assert not out_dir.exists()
    else:        # nothing written but the metrics file the run opened
        assert sorted(p.name for p in out_dir.iterdir()
                      if p.name != "metrics.jsonl") == before


def test_wdparams_is_refused(capsys):
    assert cli.main(["wdparams", "wd_input.dat", "--nburn", "5"]) == 2
    assert ITEM6 in capsys.readouterr().err


def test_resuming_a_jax_checkpoint_is_refused(tmp_path, capsys):
    import jax
    import jax.numpy as jnp

    from lfit_python_tpu.sampling.ensemble import EnsembleState
    from lfit_python_tpu.utils import checkpoints as jck

    inp = demo_copy(tmp_path)
    (tmp_path / "out").mkdir()
    jck.save_checkpoint(tmp_path / "out" / "checkpoint_0000002.npz",
                        EnsembleState(jax.random.PRNGKey(0),
                                      jnp.zeros((W, 13)), jnp.zeros(W),
                                      jnp.asarray(2, jnp.int32)))
    rc = cli.main(["fit", str(inp), "--outdir", str(tmp_path / "out"),
                   "--resume", *CPU])
    assert rc == 2
    assert "no torch.Generator state" in capsys.readouterr().err


def test_without_a_card_the_default_device_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    inp = demo_copy(tmp_path)
    for device in ([], ["--device", "cuda"]):
        rc = cli.main(["fit", str(inp), "--outdir", str(tmp_path / "out"),
                       "--resolution", "low", *device])
        assert rc != 0
        assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
