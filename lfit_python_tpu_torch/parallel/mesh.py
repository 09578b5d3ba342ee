"""Walker sharding over the ranks of a ``torch.distributed`` process group.

Port of ``lfit_python_tpu/parallel/mesh.py``, under the same names.  The
JAX package places the walker axis on a 1-D device mesh that one process
drives (single controller).  The port runs one process per card instead
(``torchrun --nproc-per-node N``; NCCL between cards, gloo between CPU
processes): an evaluation of the port is host-bound, a north-star
posterior being ~21.8k kernel launches for ~53 ms of device time, so one
Python thread driving N cards would issue N times the launches and gain
nothing, while a process per card gives each card its own host thread.

The design is a replicated sampler and a sharded evaluator:

- every rank holds the whole ensemble (a few MB at most) and its own
  ``torch.Generator``, seeded alike, so every rank draws the same random
  numbers for the whole ensemble and makes the same proposals;
- each batch of proposals (a half-ensemble, a tempered ladder's half, a
  leapfrog step's chains, a NUTS leaf's chains) is split into one block
  of rows per rank, padded with copies of its last row to a multiple of
  the world size; each rank evaluates its block and the blocks are
  all-gathered, the padding dropped;
- so with a posterior whose value for a walker does not depend on the
  batch it comes in (the port's, see ``models.components.sum_last``),
  every rank holds the unsharded sampler's state bit for bit after every
  step.  The gradient samplers integrate their trajectories on every
  rank (a few elementwise operations on the chains) and shard each
  gradient evaluation, so NUTS's per-leaf stopping test sees the same
  chains on every rank and costs no collective of its own.

The ``shard_*`` functions check the JAX package's divisibility conditions
(``ValueError``) and make every rank start from rank 0's state and
generator state.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..sampling.ensemble import EnsembleState
from ..sampling.hmc import HMCState, value_and_grad
from ..sampling.pt import PTState, parts_fn

__all__ = ["WalkerMesh", "walker_mesh", "walker_sharding", "shard_state",
           "shard_pt_state", "shard_hmc_state", "sharded_batch_ln_prob",
           "sharded_pt_batch_parts", "sharded_value_and_grad"]


class WalkerMesh(NamedTuple):
    """This process's place in the walker sharding."""
    rank: int
    world_size: int
    device: torch.device   # the rank's device: cuda:LOCAL_RANK, or the CPU
    launched: bool         # the group comes from torchrun's environment


def walker_mesh(device="cuda") -> WalkerMesh:
    """Join the process group of the ranks ``torchrun`` started (its
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_*`` environment), or, run without
    torchrun, create a one-rank group; reuse a group that already exists.
    The backend is NCCL for a CUDA ``device`` (each rank on
    ``cuda:LOCAL_RANK``, which becomes its current device) and gloo for
    the CPU.  Raises ``RuntimeError`` where the card or NCCL is
    missing."""
    import torch.distributed as dist

    device = torch.device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("walker sharding on cuda needs a CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("walker sharding on cuda needs NCCL, which "
                               "this PyTorch lacks")
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        if launched:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"but {device} needs {backend}")
    return WalkerMesh(dist.get_rank(), dist.get_world_size(), device,
                      launched)


def walker_sharding(mesh: WalkerMesh, n_rows: int) -> slice:
    """The rows of a batch of ``n_rows`` that this rank evaluates: its
    block of ceil(n_rows / world_size), in the batch padded to a multiple
    of the world size."""
    block = -(-n_rows // mesh.world_size)
    return slice(mesh.rank * block, (mesh.rank + 1) * block)


def _sharded_rows(fn, x, mesh: WalkerMesh):
    """``fn(x)`` for ``x`` (N, ...) whose outputs are tensors of N leading
    rows, each rank evaluating its block (:func:`walker_sharding`) and the
    blocks all-gathered (the list form, which gloo and NCCL both have):
    a list of the outputs, every rank with all N rows."""
    import torch.distributed as dist

    n = x.shape[0]
    rows = walker_sharding(mesh, n)
    pad = (rows.stop - rows.start) * mesh.world_size - n
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    out = []
    for part in fn(x[rows]):
        part = part.contiguous()
        blocks = [torch.empty_like(part) for _ in range(mesh.world_size)]
        dist.all_gather(blocks, part)
        out.append(torch.cat(blocks)[:n])
    return out


def sharded_batch_ln_prob(ln_prob_fn, mesh: WalkerMesh):
    """``ln_prob_fn`` sharded: ``pos (N, D) -> (N,)``, any N, the
    ``ln_prob_fn`` that ``init_walkers``, ``ensemble_step`` and
    ``run_sampler`` take."""
    def batch(pos):
        return _sharded_rows(lambda rows: (ln_prob_fn(rows),), pos, mesh)[0]

    return batch


def sharded_pt_batch_parts(ln_prior_fn, ln_like_fn, mesh: WalkerMesh):
    """The sharded ``batch_parts_fn`` of ``init_pt``, ``pt_step`` and
    ``run_pt``: ``pos (T, H, D) -> (ln_prior (T, H), ln_like (T, H))``,
    the ``T * H`` rows split over the ranks."""
    parts = parts_fn(ln_prior_fn, ln_like_fn)

    def batch(pos):
        lp, ll = _sharded_rows(parts, pos.reshape(-1, pos.shape[-1]), mesh)
        return lp.reshape(pos.shape[:2]), ll.reshape(pos.shape[:2])

    return batch


def sharded_value_and_grad(ln_prob_fn, mesh: WalkerMesh):
    """The sharded ``vg_fn`` of the gradient samplers: ``x (C, D) ->
    (ln p (C,), grad (C, D))``, any C.  ``init_hmc`` / ``init_nuts``,
    ``hmc.batch_trajectories`` (whose evaluator is the ``traj_batch_fn``
    of ``hmc_step``, ``warmup_hmc`` and ``run_hmc``) and ``nuts_step`` /
    ``warmup_nuts`` / ``run_nuts`` take it."""
    vg = value_and_grad(ln_prob_fn)

    def batch(x):
        return tuple(_sharded_rows(vg, x, mesh))

    return batch


def _divisible(n, k, what, by):
    if n % k:
        raise ValueError(f"{what}={n} must be divisible by {by}={k}")


@torch.no_grad()
def _from_rank0(mesh: WalkerMesh, *tensors):
    """Rank 0's values of ``tensors`` on every rank (copies)."""
    import torch.distributed as dist

    out = []
    for t in tensors:
        t = t.to(mesh.device, copy=True)
        dist.broadcast(t, 0)
        out.append(t)
    return out


def _replicate(mesh: WalkerMesh, step, generator):
    """Rank 0's step counter, and its generator state into ``generator``
    on every rank."""
    step_t, = _from_rank0(mesh, torch.tensor([step], dtype=torch.int64))
    if generator is not None:
        state, = _from_rank0(mesh, generator.get_state())
        generator.set_state(state.cpu())
    return int(step_t.item())


def shard_state(state: EnsembleState, mesh: WalkerMesh,
                generator=None) -> EnsembleState:
    """The ensemble every rank runs: rank 0's walkers, step and (into
    ``generator``) generator state.  The walker count must be divisible
    by twice the world size (two half-ensembles, each split over the
    ranks)."""
    _divisible(state.positions.shape[0], 2 * mesh.world_size, "n_walkers",
               "2*world_size")
    pos, lp = _from_rank0(mesh, state.positions, state.log_prob)
    return EnsembleState(pos, lp, _replicate(mesh, state.step, generator))


def shard_pt_state(state: PTState, mesh: WalkerMesh,
                   generator=None) -> PTState:
    """:func:`shard_state` for a tempered ladder (T, W, D): the walker
    count of a rung must be divisible by twice the world size."""
    _divisible(state.positions.shape[1], 2 * mesh.world_size, "n_walkers",
               "2*world_size")
    pos, ll, lp, betas = _from_rank0(mesh, state.positions, state.ln_like,
                                     state.ln_prior, state.betas)
    return PTState(pos, ll, lp, betas, _replicate(mesh, state.step,
                                                  generator))


def shard_hmc_state(state: HMCState, mesh: WalkerMesh,
                    generator=None) -> HMCState:
    """:func:`shard_state` for HMC / NUTS chains: chains never interact,
    so the chain count need only be divisible by the world size."""
    _divisible(state.positions.shape[0], mesh.world_size, "n_chains",
               "world_size")
    pos, lp, g, eps, inv_mass = _from_rank0(
        mesh, state.positions, state.log_prob, state.grad, state.step_size,
        state.inv_mass)
    return HMCState(pos, lp, g, eps, inv_mass,
                    _replicate(mesh, state.step, generator))
