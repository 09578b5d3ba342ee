"""One run of one benchmark cell of lfit_python_tpu_torch.

    python3 -m lfit_bench.run --workload NAME --seed N --seconds S --trace 0|1

The cell is found by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration, traffic mix and settings are data files
found by name (``configs/<config>.json``, with the port's dtype and
``CVConfig`` keywords, ``traffic/<traffic>.json``,
``cells/<workload>.json``); the sampler the traffic names is a module of
its own (``samplers/<sampler>.py``), and so is each per-layer metric's
reader (``metrics/<metric>.py``).  A cell is added by adding files and
entries.

A run builds the port's kernels (``build/kernels/`` in the checkout), the
model, the seed's light curves, the Posterior and the sampler's start
ball, and takes one warm-up step: that is ``setup_s``.  Then the fit's
production loop, ``sampling.ensemble.run_chunked`` with the sampler's
``step_fn`` and ``thin`` = 1 (each step's kept row copied to the host, as
the command line's fit copies it), runs in segments until ``--seconds``
have passed; the window ends at a step's copy.  With ``--trace 1`` the
window runs with the benchmark's spans around each step and each
posterior call, and then a short window under the profiler gives the
device's numbers.  After the windows, the sampler's final state and its
last step are held to the plain float64 reference (``check.py`` and the
sampler's module), and the result's line is
printed last on standard output, the numbers compared last on standard
error.  The run exits 2 without a card, and 1 if a module of JAX or of
the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "lfit_python_tpu")
# the port's CUDA sources (lfit_python_tpu_torch/ops/csrc/<name>.cu)
KERNEL_SOURCES = ("contacts", "contacts_backward", "stream", "gp", "roche",
                  "sweeps", "wd_donor")

__all__ = ["load_cell", "forbidden_modules", "program", "run", "main"]


def _merge(base, extra):
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def load_cell(workload, root=ROOT):
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files:
    {"workload", "config", "traffic", "settings", "end_to_end",
    "per_layer"}, the metrics being those the cell reports."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    here = root / "lfit_bench"
    return {
        "workload": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (here / "traffic" / f"{cell['traffic']}.json").read_text()),
        "settings": json.loads(
            (here / "cells" / f"{workload}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "metrics_dir": here / "metrics",
    }


def forbidden_modules():
    """The loaded modules' top-level names that are JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _load(path):
    """The module of the file ``path`` (a metric's reader or a sampler),
    loaded by its path."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        f"lfit_bench_{path.parent.name}_{len(path.stem)}_"
        f"{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dtype_of(cfg):
    """The torch dtype the configuration states (``"dtype"``)."""
    import torch

    dt = getattr(torch, cfg["dtype"], None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown dtype {cfg['dtype']!r}")
    return dt


def program(cfg, curves, device):
    """(compiled model, Posterior) of the port for the configuration
    ``cfg`` and the light curves ``curves``: ``make_ln_prob`` in the
    configuration's dtype, with its ``cv_config`` keywords, on
    ``device``."""
    from lfit_python_tpu_torch.models import priors, tree
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    from .reference import spec

    classes = dict(Param=priors.Param, Prior=priors.Prior,
                   Lightcurve=tree.Lightcurve, EclipseSpec=tree.EclipseSpec,
                   HierarchicalModel=tree.HierarchicalModel)
    model = spec.build_spec(cfg, curves, classes).compile()
    return model, make_ln_prob(model, CVConfig(**cfg.get("cv_config", {})),
                               dtype=dtype_of(cfg), device=device)


def _build_kernels():
    """Every CUDA source of the port built (or found built) at once, so a
    first run's nvcc calls overlap."""
    from lfit_python_tpu_torch.ops import _build

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for f in [pool.submit(_build.load_library, n)
                  for n in KERNEL_SOURCES]:
            f.result()


class _Spans:
    """The posterior as the sampler sees it, with the benchmark's host
    clock around each call (and, under the profiler, a range): each
    call's seconds and walkers."""

    def __init__(self, post, ranges=False):
        self.post = post
        self.ranges = ranges
        self.calls, self.rows = [], []

    def __call__(self, var):
        t = time.perf_counter()
        if self.ranges:
            from torch.profiler import record_function

            from .trace import POSTERIOR
            with record_function(POSTERIOR):
                out = self.post(var)
        else:
            out = self.post(var)
        self.calls.append(time.perf_counter() - t)
        self.rows.append(int(var.shape[0]))
        return out


class _Sampler:
    """The cell's sampler on the port (``samplers/<sampler>.py``): its
    start ball from the seed, its ``step_fn`` for ``run_chunked`` and,
    for the check, the generator's state before the latest step."""

    def __init__(self, root, traffic, model, post, seed, dtype, device):
        import torch

        self.mod = _load(Path(root) / "lfit_bench" / "samplers"
                         / f"{traffic['sampler']}.py")
        self.traffic = traffic
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) & (2 ** 63 - 1))
        start = torch.tensor(model.var_start(), dtype=dtype, device=device)
        ball = traffic["ball"]
        scatter = ball["rel"] * torch.clamp(start.abs(), min=ball["floor"])
        self.state = self.mod.start(traffic, post, start, scatter, self.gen)
        self.gen_state = None

    def evals_per_step(self):
        return self.mod.evals_per_step(self.traffic)

    def step_fn(self, post, marks=None):
        """``state -> (state, aux)`` on ``post``; each call's start time
        appended to ``marks``."""
        inner = self.mod.step_fn(self.traffic, post, self.gen)

        def step(state):
            if marks is not None:
                marks.append(time.perf_counter())
            self.gen_state = self.gen.get_state()
            return inner(state)

        return step


def _window(sampler, step, seconds, segment, run_chunked, rows):
    """run_chunked in segments of ``segment`` steps until ``seconds`` have
    passed: (steps, its start and end on the host clock, the last two kept
    rows and their ln p, after ``rows``: the state's before the window)."""
    state = sampler.state
    t0 = time.perf_counter()
    steps = 0
    while True:
        state, chain, chain_lp, _ = run_chunked(state, step, segment,
                                                thin=1)
        steps += segment
        rows = (rows + list(zip(chain, chain_lp)))[-2:]
        if time.perf_counter() - t0 >= seconds:
            break
    sampler.state = state
    return steps, t0, time.perf_counter(), rows


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def run(workload, seed, seconds, trace, device="cuda", root=ROOT,
        overrides=None, log=sys.stderr, controls=()):
    """One run of ``workload``: (result dict, [(name, value, limit)]).
    ``device`` "cpu" and ``overrides`` ({"config"|"traffic"|"settings":
    {key: value}}) are for the tests' small runs.  ``controls``: torch
    dtypes in which the reference is also put in the program's place at
    the checked walkers, its readings under ``result["controls"]``
    (``lfit_bench/control.py``; a benchmark run makes none)."""
    cell = load_cell(workload, root)
    for part in ("config", "traffic", "settings"):
        cell[part] = _merge(cell[part], (overrides or {}).get(part))
    chips = cell["workload"]["chips"]
    import torch

    # the window's load comes from this one thread; the reference, after
    # it, takes every core
    threads = torch.get_num_threads()
    if device == "cuda":
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"this cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=log)
            raise SystemExit(2)
        _build_kernels()
    from lfit_python_tpu_torch.sampling.ensemble import run_chunked

    from . import check, layers
    from .reference import spec
    from .reference.cv import CVConfig as RefCVConfig
    from .reference.posterior import Posterior as RefPosterior

    cfg, traffic, settings = cell["config"], cell["traffic"], cell["settings"]
    dtype = dtype_of(cfg)
    curves = spec.light_curves(cfg, seed)
    model, post = program(cfg, curves, device)
    spans = _Spans(post) if trace else None
    sampler = _Sampler(root, traffic, model, post, seed, dtype, device)
    segment = traffic["segment_steps"]
    step_post = spans if trace else post
    marks = []
    step = sampler.step_fn(step_post, marks)
    sampler.state, *_ = run_chunked(sampler.state, step, 1, thin=1)
    if device == "cuda":
        torch.cuda.synchronize()
    start_pos = sampler.state.positions.cpu().numpy()
    start_lp = sampler.state.log_prob.cpu().numpy()
    del marks[:]
    if spans is not None:
        spans.calls.clear()
        spans.rows.clear()
    # what set-up made lives on: later collections need not walk it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - _T0

    steps, t0, t1, last_rows = _window(sampler, step, seconds, segment,
                                       run_chunked, [(start_pos, start_lp)])
    window_s = t1 - t0
    step_s = np.diff(np.asarray(marks + [t1]))
    evals = steps * sampler.evals_per_step()
    values = {"setup_s": setup_s, "evals_per_s": evals / window_s,
              "step_ms_p95": 1e3 * float(np.percentile(step_s, 95))}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell["end_to_end"]} if not trace else {}

    tr = None
    ctx = layers.Context(cfg, traffic)
    if trace:
        ctx.spans = {"step": list(step_s), "posterior": list(spans.calls)}
        tr, ctx.trace_rows, rows = _traced_window(
            sampler, post, window_s / steps, traffic, run_chunked, device)
        ctx.trace = tr
        last_rows = (last_rows + rows)[-2:]
    peak = (torch.cuda.max_memory_allocated() if device == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=log)
        raise SystemExit(1)
    final = sampler.state
    fin_pos = final.positions.cpu().numpy()
    fin_lp = final.log_prob.cpu().numpy()
    record = {"gen_state": sampler.gen_state, "before": last_rows[0],
              "after": last_rows[1], "dtype": dtype, "device": device}
    mod, kind = sampler.mod, (torch.cuda.get_device_name(0)
                              if device == "cuda" else "cpu")
    del sampler, post, step, step_post, spans, final, model
    gc.unfreeze()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the reference: its own model from the configuration and the same
    # light curves, in float64 on the CPU, at the checked walkers' final
    # positions and at the points the sampler's check asks for
    torch.set_num_threads(threads)
    t_ref = time.perf_counter()
    ref_cfg = RefCVConfig(**cfg.get("cv_config", {}))
    ref_model = spec.build_spec(cfg, curves,
                                spec.REFERENCE_CLASSES).compile()

    def evaluate(points, dt=torch.float64):
        return check.reference_eval(
            RefPosterior(ref_model, ref_cfg, dtype=dt, device="cpu"), points)

    idx = check.sample(seed, fin_pos.shape[0], settings["check"]["sample"])
    extra, memo = mod.check_points(traffic, record, idx)
    lp_all, ctx.eclipsed_share = evaluate(
        np.concatenate([fin_pos[idx], extra]))
    lp_ref, lp_extra = lp_all[:len(idx)], lp_all[len(idx):]
    gaps = np.sort(np.abs(fin_lp[idx].astype(np.float64) - lp_ref))[::-1]
    print(f"walkers' ln p gaps, widest first: {gaps[:6].tolist()}; median "
          f"{float(np.median(gaps))!r}", file=log)
    print(f"steps: median {1e3 * float(np.median(step_s))!r} ms, p10 "
          f"{1e3 * float(np.percentile(step_s, 10))!r}, p95 "
          f"{1e3 * float(np.percentile(step_s, 95))!r}; first 50 "
          f"{1e3 * float(np.median(step_s[:50]))!r}, last 50 "
          f"{1e3 * float(np.median(step_s[-50:]))!r}", file=log)
    print(f"window: {steps} steps in {window_s!r} s; setup {setup_s!r} s; "
          f"reference: {len(idx) + len(extra)} points in "
          f"{time.perf_counter() - t_ref!r} s, eclipsed share "
          f"{ctx.eclipsed_share!r}", file=log)
    numbers = {"lnp_gap": check.lnp_gap(fin_lp[idx], lp_ref),
               "unmoved_pct": check.unmoved_pct(start_pos, fin_pos),
               **mod.check(traffic, record, idx, memo, lp_extra)}
    correct, rows = check.judge(numbers, settings["limits"])
    read = {}
    for dt in controls:
        read[str(dt)] = {
            "lnp_gap": check.lnp_gap(evaluate(fin_pos[idx], dt)[0], lp_ref),
            **mod.control(traffic, record, idx, memo, lp_extra, dt,
                          evaluate)}

    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": chips, "memory_peak_bytes": int(peak)}
    if device == "cuda":
        dev["power_limit_w"] = _power_limit()
    result = {"correct": bool(correct), "attempted": len(rows),
              "failed": sum(not v <= lim for _, v, lim in rows),
              "metrics": metrics, "device": dev}
    if trace:
        for m in cell["per_layer"]:
            v = _load(cell["metrics_dir"] / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_by_host()}
        print(f"step_ms_p95 (host clock, spans on) "
              f"{values['step_ms_p95']!r}; evals/s {values['evals_per_s']!r}",
              file=log)
    if controls:
        result["controls"] = read
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                            "limit": lim} for k, v, lim in rows}
    return result, rows


def _traced_window(sampler, post, step_s, traffic, run_chunked, device):
    """A short window under the profiler (about the traffic's
    ``trace_seconds``, at least one step): its :class:`Trace`, the
    walkers of each posterior call in it and its last two kept rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import STEP, WINDOW, read_trace

    n = max(1, int(round(traffic["trace_seconds"] / step_s)))
    spans = _Spans(post, ranges=True)
    inner = sampler.step_fn(spans)

    def step(state):
        with record_function(STEP):
            return inner(state)

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            sampler.state, chain, chain_lp, _ = run_chunked(
                sampler.state, step, n, thin=1)
            if device == "cuda":
                torch.cuda.synchronize()
    return read_trace(prof), spans.rows, list(zip(chain, chain_lp))[-2:]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    result, rows = run(a.workload, a.seed, a.seconds, bool(a.trace))
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
