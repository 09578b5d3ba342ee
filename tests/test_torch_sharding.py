"""Walker sharding (``parallel.mesh``) on the CPU with gloo.

Mirrors tests/test_sharding.py, which holds the JAX package's sharded
samplers to its unsharded ones on a virtual 8-device CPU mesh.  Here the
ranks are processes: ``torchrun --standalone`` (a free localhost port, so
concurrent test workers do not collide) starts tests/torch_shard_worker.py
at world size 2 for every case, and at 4 for one.  Each case runs an init
and a step of one sampler (stretch move, PT, HMC, NUTS) on a posterior (a
Gaussian with a hard support bound, or the port's posterior of a TINY
2-eclipse model) in float64 or float32 (``CASES``), sharded, and rank 0
runs the same unsharded: the walkers, their ln p (its parts, its
gradient), the step's outputs and the generator state must be the same
bits.  The Gaussian's
inits redraw batches that the world size does not divide, so the
evaluator pads them.  The ``shard_*`` functions refuse, with "divisible",
the walker and chain counts the JAX package refuses; a one-rank group made
in process goes through the same collectives; and sharding on a CUDA
device raises where there is no card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lfit_python_tpu_torch.parallel import mesh as pm
from lfit_python_tpu_torch.sampling.ensemble import EnsembleState
from lfit_python_tpu_torch.sampling.hmc import HMCState
from lfit_python_tpu_torch.sampling.pt import PTState

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_shard_worker.py")
# every sampler on the Gaussian in both dtypes; on the CV posterior the
# stretch move and PT in both, HMC in float64 and NUTS in float32 (each CPU
# gradient evaluation integrates the 4352-step stream with sensitivities)
CASES = ([f"{s}:gauss:{d}" for s in ("ensemble", "pt", "hmc", "nuts")
          for d in ("f64", "f32")]
         + [f"{s}:cv:{d}" for s in ("ensemble", "pt") for d in ("f64", "f32")]
         + ["hmc:cv:f64", "nuts:cv:f32"])
AT_FOUR = ["ensemble:cv:f64"]


def torchrun(n_ranks, out, cases):
    """The worker at ``n_ranks`` ranks: its results (rank 0's JSON)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n_ranks}", str(WORKER), str(out), *cases],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    return {2: torchrun(2, d / "two.json", CASES),
            4: torchrun(4, d / "four.json", AT_FOUR)}


@pytest.mark.parametrize("world_size,case",
                         [(2, c) for c in CASES] + [(4, c) for c in AT_FOUR])
def test_sharded_step_is_the_unsharded_step(results, world_size, case):
    assert results[world_size]["world_size"] == world_size
    r = results[world_size][case]
    assert r["finite"]
    assert r["fields_equal"], r["max_abs"]
    assert r["outputs_equal"] and r["generator_equal"]
    assert r["batch_sizes"], "the sharded evaluator was never called"


def test_inits_pad_batches_the_ranks_do_not_divide(results):
    """The Gaussian's walker and chain balls redraw the draws outside its
    support: batches of sizes 2 ranks do not divide reach the sharded
    evaluator (padded, gathered, the padding dropped), and the cases
    above found the same bits."""
    sizes = [b for case in CASES if ":gauss:" in case
             for b in results[2][case]["batch_sizes"]]
    assert any(b % 2 for b in sizes), sizes


def fake_mesh(world_size):
    return pm.WalkerMesh(0, world_size, torch.device("cpu"), False)


def test_shard_state_rejects_an_indivisible_walker_count():
    pos = torch.zeros(36, 2)
    state = EnsembleState(pos, torch.zeros(36), 0)
    with pytest.raises(ValueError, match="divisible"):
        pm.shard_state(state, fake_mesh(8))


def test_shard_pt_state_rejects_an_indivisible_walker_count():
    state = PTState(torch.zeros(3, 6, 2), torch.zeros(3, 6),
                    torch.zeros(3, 6), torch.ones(3), 0)
    with pytest.raises(ValueError, match="divisible"):
        pm.shard_pt_state(state, fake_mesh(2))


def test_shard_hmc_state_rejects_an_indivisible_chain_count():
    """Chains never interact: only the world size must divide them."""
    state = HMCState(torch.zeros(6, 2), torch.zeros(6), torch.zeros(6, 2),
                     torch.tensor(0.1), torch.ones(2), 0)
    with pytest.raises(ValueError, match="divisible"):
        pm.shard_hmc_state(state, fake_mesh(4))


def test_walker_sharding_blocks():
    blocks = [pm.walker_sharding(pm.WalkerMesh(r, 4, None, True), 10)
              for r in range(4)]
    assert [(b.start, b.stop) for b in blocks] == [(0, 3), (3, 6), (6, 9),
                                                   (9, 12)]


def test_one_rank_group_in_process():
    """Without torchrun, a one-rank gloo group: the same collective calls,
    and the generator state and the walkers pass through unchanged."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = pm.walker_mesh("cpu")
        assert (mesh.rank, mesh.world_size, mesh.launched) == (0, 1, False)
        assert dist.get_backend() == "gloo"
        batch = pm.sharded_batch_ln_prob(lambda x: -(x * x).sum(-1), mesh)
        x = torch.randn(5, 3, dtype=torch.float64)
        assert torch.equal(batch(x), -(x * x).sum(-1))
        gen = torch.Generator().manual_seed(3)
        before = gen.get_state()
        state = pm.shard_state(EnsembleState(x[:4], x[:4, 0], 7), mesh, gen)
        assert torch.equal(state.positions, x[:4]) and state.step == 7
        assert torch.equal(gen.get_state(), before)
    finally:
        dist.destroy_process_group()


def test_cuda_sharding_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.walker_mesh("cuda")
