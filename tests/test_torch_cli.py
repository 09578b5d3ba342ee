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
count that twice the world size does not divide.  The fit writes the
chain in ArviZ form (``chains.npz``) and the plots; ``--profile`` writes
a trace (of an empty burn-in and production here: a CPU evaluation's
eager stream scan makes a trace of gigabytes), and says on the tempered
branch that it takes none; ``--notify-cmd``, ``--notify-file`` and
``notify = 1`` deliver their notification; ``wdparams`` runs.
``--pallas`` / ``--no-pallas`` exit with code 2 and a message, and so
does each combination the JAX package's command line refuses
(``--precise`` or ``usePT`` with HMC / NUTS, a resume from another
sampler kind's checkpoint); without a card and without ``--device cpu``
``fit`` and ``wdparams`` exit non-zero.  The tempered, HMC, NUTS and
``--precise`` fits have their own files (tests/test_torch_cli_*.py).
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
# what the fit's report writes beside the chain: the chain in ArviZ form,
# the percentile table, the corner plots (global and per tree node) and
# the eclipse's plot
REPORT = ["chains.npz", "corner.png", "corner_core.png", "corner_ecl0.png",
          "corner_g.png", "eclipse_0.png", "params.json"]
REPORT_FILES = sorted(["chain_prod.txt", "checkpoint_0000002.npz",
                       "checkpoint_0000004.npz", "metrics.jsonl", *REPORT])


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
    assert sorted(p.name for p in out_dir.iterdir()) == REPORT_FILES
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
    assert "max split-R-hat" in out and "plots: written to" in out
    # the chain in ArviZ form: (walker, draw) arrays of the chain file's
    # columns (which keep 11 significant digits)
    with np.load(out_dir / "chains.npz") as z:
        assert set(z.files) == {*names, "ln_prob"}
        for i, name in enumerate(names):
            np.testing.assert_allclose(z[name], chain[:, :, i].T, rtol=1e-10)
        np.testing.assert_allclose(z["ln_prob"], lp.T, rtol=1e-10)


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
    assert sorted(p.name for p in (d / "out").iterdir()) == REPORT_FILES


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


BY_DTYPE = "routes the contact solve by dtype"
REFUSED = {
    "pallas": (["--pallas"], "", BY_DTYPE),
    "no_pallas": (["--no-pallas"], "", BY_DTYPE),
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


def empty_fit(tmp_path, *flags, extra=""):
    """A fit with no burn-in and no production (one evaluation of the
    walker ball) -> (exit code, stdout, its output directory)."""
    inp = demo_copy(tmp_path, extra)
    rc, out = run("fit", inp, "--outdir", tmp_path / "out", "--nburn", 0,
                  "--nprod", 0, *flags, *CPU)
    return rc, out, tmp_path / "out"


def test_profile_writes_a_trace(tmp_path):
    rc, out, _ = empty_fit(tmp_path, "--profile", tmp_path / "trace")
    assert rc == 0
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1 and f"trace written to {traces[0]}" in out
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_profile_takes_no_trace_on_the_tempered_branch(tmp_path):
    rc, out, _ = empty_fit(tmp_path, "--profile", tmp_path / "trace",
                           extra=PT_INPUT)
    assert rc == 0
    assert "--profile: no trace taken on the tempered branch" in out
    assert not (tmp_path / "trace").exists()


def test_notify_cmd_delivers_the_message(tmp_path):
    got = tmp_path / "message.txt"
    rc, _, out_dir = empty_fit(tmp_path, "--notify-cmd", f"cat > {got}")
    assert rc == 0
    assert got.read_text() == (f"lfit_python_tpu_torch fit finished: "
                               f"{tmp_path / 'input.dat'}\nresults in "
                               f"{out_dir}")


def test_notify_file_gets_one_json_line(tmp_path):
    note = tmp_path / "n.jsonl"
    rc, _, out_dir = empty_fit(tmp_path, "--notify-file", note)
    assert rc == 0
    rec, = [json.loads(ln) for ln in note.read_text().splitlines()]
    assert rec["subject"].startswith("lfit_python_tpu_torch fit finished")
    assert rec["body"] == f"results in {out_dir}"
    assert not (out_dir / "notifications.jsonl").exists()


def test_notify_key_writes_notifications_jsonl(tmp_path):
    rc, _, out_dir = empty_fit(tmp_path, extra="notify = 1\n")
    assert rc == 0
    rec, = [json.loads(ln) for ln in
            (out_dir / "notifications.jsonl").read_text().splitlines()]
    assert rec["body"] == f"results in {out_dir}"


def test_wdparams_runs(tmp_path, capsys):
    inp = tmp_path / "wd_input.dat"
    inp.write_text("teff = 15000 uniform 6000 90000 1\n"
                   "logg = 8.0 uniform 6.5 9.5 1\n"
                   "plax = 5.0 gauss 5.0 0.5 1\n"
                   "flux_g = 0.362 0.0036 4770\n"
                   "flux_r = 0.287 0.0029 6230\n")
    rc = cli.main(["wdparams", str(inp), "--outdir", str(tmp_path / "out"),
                   "--device", "cpu", "--nwalkers", "16", "--nburn", "5",
                   "--nprod", "10"])
    assert rc == 0
    report = json.loads((tmp_path / "out" / "wdparams.json").read_text())
    assert [r["name"] for r in report["params"]] == ["teff", "logg", "plax"]
    assert "derived:" in capsys.readouterr().out
    if not torch.cuda.is_available():      # the card is the default device
        rc = cli.main(["wdparams", str(inp), "--outdir",
                       str(tmp_path / "out2")])
        assert rc == 1 and "no CUDA device" in capsys.readouterr().err


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
