#!/usr/bin/env python3
"""Time the fit's HMC posterior unsharded and sharded over a one-rank
NCCL group, in turns in one process, on one CUDA card, and trace one
gradient evaluation of each.

    python3 tools/torch_shard_turns.py [OUT_DIR]

The posterior is the one ``fit --sampler hmc`` builds from
examples/demo_input.dat with exposure widths (the median sample spacing)
at full resolution, float32, at 256 chains.  In the order a, b, b, a,
three times:

- ms per gradient evaluation (``value_and_grad`` of the posterior, and
  ``parallel.mesh.sharded_value_and_grad`` of it), 2 calls a turn;
- s per ``hmc_step`` of 16 leapfrog steps from one state and one
  generator state, unsharded and with the sharded gradient (the two
  steps' outputs compared bit for bit);
- ms per sharded gradient evaluation with its all-gathers replaced by
  a copy (the evaluator's slicing, padding and concatenation alone).

Then one gradient evaluation of each, traced by ``torch.profiler``: host
wall, device kernel time, and the count of each CUDA runtime call that
can stop the host (synchronize, memcpy, malloc, free), with the caching
allocator's counters (``num_alloc_retries``: a free of the cache and a
device synchronize) over the turns.  Prints one JSON line; writes each
trace's ``key_averages`` table to OUT_DIR (default
``chiprun_out/shard_turns``).
"""

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lfit_python_tpu_torch.models.cv import CVConfig  # noqa: E402
from lfit_python_tpu_torch.models.likelihood import make_ln_prob  # noqa: E402
from lfit_python_tpu_torch.parallel.mesh import (  # noqa: E402
    sharded_value_and_grad, walker_mesh)
from lfit_python_tpu_torch.sampling import hmc  # noqa: E402
from lfit_python_tpu_torch.utils.config import (  # noqa: E402
    build_model_from_config, parse_input_dat)

DEV = torch.device("cuda", 0)
CONFIG = CVConfig()       # full resolution, as the fit runs it
N_CHAINS = 256
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync",
              "cudaMalloc", "cudaFree", "cudaStreamWaitEvent",
              "cudaEventRecord", "cudaLaunchKernel")


def hmc_posterior(work):
    """The fit's float32 posterior on the demo light curve with exposure
    widths, and its start (D,)."""
    work.mkdir(parents=True, exist_ok=True)
    lc = np.loadtxt(ROOT / "examples" / "demo_ecl0.txt")
    width = np.median(np.abs(np.diff(lc[:, 0])))
    np.savetxt(work / "demo_ecl0_widths.txt",
               np.column_stack([lc, np.full(len(lc), width)]), fmt="%.17e")
    text = (ROOT / "examples" / "demo_input.dat").read_text().replace(
        "file_0 = demo_ecl0.txt", "file_0 = demo_ecl0_widths.txt")
    (work / "hmc.dat").write_text(text)
    model = build_model_from_config(
        parse_input_dat(work / "hmc.dat")).compile()
    post = make_ln_prob(model, config=CONFIG, dtype=torch.float32,
                        device=DEV)
    start = torch.as_tensor(model.var_start(), dtype=torch.float32,
                            device=DEV)
    return post, start


def sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def memory_stats():
    return torch.cuda.memory_stats() if DEV.type == "cuda" else {}


def wall(fn, reps):
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def in_turns(fns, n_turns=3, reps=2):
    """{name: [seconds per call, a turn each]} over a, b, ..., ..., b, a
    orders, ``n_turns`` times."""
    out = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(n_turns):
        for k in order:
            out[k].append(wall(fns[k], reps))
    return out


def traced(fn, out_dir, name):
    """One call of ``fn`` under the profiler: host wall (ms), device
    kernel time (ms), kernels, and the count of each of SYNC_CALLS."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    calls = {c: sum(1 for e in events if e.device_type == DeviceType.CPU
                    and re.fullmatch(c + r"(_v2)?", e.name))
             for c in SYNC_CALLS}
    (out_dir / f"{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=60))
    return {"host_ms": host_ms, "kernels": len(kern),
            "device_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3,
            "calls": calls}


def main():
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        ROOT / "chiprun_out" / "shard_turns")
    out_dir.mkdir(parents=True, exist_ok=True)
    work = ROOT / "build" / "shard_turns"
    shutil.rmtree(work, ignore_errors=True)
    post, start = hmc_posterior(work)
    mesh = walker_mesh(DEV.type)
    assert mesh.world_size == 1, mesh

    gen = torch.Generator(device=start.device).manual_seed(7)
    state = hmc.init_hmc(gen, start, 1e-3 * start.abs().clamp(min=1e-2),
                         post, N_CHAINS)
    x = state.positions
    vg = hmc.value_and_grad(post)
    vg_shard = sharded_value_and_grad(post, mesh)

    def gather_copy(blocks, part, *a, **kw):
        blocks[0].copy_(part)

    def vg_shard_no_collective():
        with mock.patch.object(dist, "all_gather", gather_copy):
            return vg_shard(x)

    g_state = gen.get_state()
    trajs = {"unsharded": hmc.batch_trajectories(post, 16),
             "sharded": hmc.batch_trajectories(post, 16, vg_fn=vg_shard)}
    steps = {}

    def step(k):
        def run():
            gen.set_state(g_state)
            steps[k] = hmc.hmc_step(state, post, gen, 16, trajs[k])
        return run

    alloc0 = memory_stats()
    vg(x), vg_shard(x), vg_shard_no_collective()
    sync()
    grad_s = in_turns({"unsharded": lambda: vg(x),
                       "sharded": lambda: vg_shard(x),
                       "sharded_no_collective": vg_shard_no_collective})
    step_s = in_turns({k: step(k) for k in trajs}, reps=1)
    alloc1 = memory_stats()
    a, b = steps["unsharded"][0], steps["sharded"][0]
    same = all(torch.equal(u, v) for u, v in zip(a[:3], b[:3]))

    part = torch.randn(N_CHAINS, device=start.device)
    blocks = [torch.empty_like(part)]
    gather_ms = wall(lambda: dist.all_gather(blocks, part), 50) * 1e3
    traces = {"unsharded": traced(lambda: vg(x), out_dir, "vg_unsharded"),
              "sharded": traced(lambda: vg_shard(x), out_dir, "vg_sharded")}
    backend = dist.get_backend()
    dist.destroy_process_group()

    smi = shutil.which("nvidia-smi") and subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "card": (smi or str(DEV)).strip(), "torch": torch.__version__,
        "backend": backend,
        "chains": N_CHAINS, "dims": int(start.numel()),
        "grad_ms": {k: [round(v * 1e3, 2) for v in t]
                    for k, t in grad_s.items()},
        "grad_ms_median": {k: round(statistics.median(t) * 1e3, 2)
                           for k, t in grad_s.items()},
        "hmc_step_s": {k: [round(v, 4) for v in t]
                       for k, t in step_s.items()},
        "hmc_step_s_median": {k: round(statistics.median(t), 4)
                              for k, t in step_s.items()},
        "hmc_steps_equal": same,
        "all_gather_256_ms": round(gather_ms, 4),
        "alloc": {k: alloc1.get(k, 0) - alloc0.get(k, 0)
                  for k in ("num_alloc_retries", "num_device_alloc",
                            "num_device_free", "num_sync_all_streams")},
        "traces": traces}))


if __name__ == "__main__":
    main()
