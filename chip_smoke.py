#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one NVIDIA Hopper card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; imports nothing of JAX.  The
north-star model (5 eclipses, 2 bands, 128 points per eclipse, default
CVConfig widths) is built with synthetic data, and the port's posterior
and ensemble sampler run at 1024 walkers in float32.  Phases:

  1. device: the card, its power limit, the K1 build from
     lfit_python_tpu_torch/ops/csrc/;
  2. K1 against its plain version on the contact rows one posterior
     evaluation hands it (5120 rows x 512 elements);
  3. the posterior with K1 against the same posterior with the plain
     contact solver, at the same 1024 walkers; ms per evaluation, the
     stream scan's share, peak device memory, the other stages' time
     (the stream cut to 64 steps) and the stream's device-busy share;
  4. float32 flux parity against the port's own float64 plain path
     (64 walkers), and float64 fluxes against tests/golden/golden_v1.npz;
  5. the sampler: init_walkers and 3 run_sampler steps at 1024 walkers,
     with K1's launch count read around the run.

Every failed check raises, so the exit code is non-zero.  The last lines
are a JSON object describing each kernel, the card's name and power limit
as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
N_WALKERS = 1024
KERNEL_SOURCE = "lfit_python_tpu_torch/ops/csrc/contacts.cu"
KERNEL_REPLACES = "lfit_python_tpu/ops/pallas_contacts.py:352"


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync_time(fn, reps):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _event_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_busy_us(fn):
    """Microseconds of device kernels in one profiled call of ``fn``, and
    how many kernels ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels), len(kernels)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    import lfit_python_tpu_torch

    pkg_root = Path(lfit_python_tpu_torch.__file__).resolve().parent.parent
    _check(pkg_root == ROOT,
           f"the port was imported from {pkg_root}, not this checkout")
    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.models.cv import CVConfig, cv_fluxes
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import _build, contacts
    from lfit_python_tpu_torch.roche.geometry import xl1
    from lfit_python_tpu_torch.roche.stream import stream_impacts
    from lfit_python_tpu_torch.sampling.ensemble import (init_walkers,
                                                         run_sampler)

    _check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    f32, f64 = torch.float32, torch.float64
    smi = _smi()

    # ---- 1. device and build ------------------------------------------
    print(f"[1 device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    contacts._kernel_fn()
    build_s = time.perf_counter() - t0
    nvcc_s = _build.BUILD_SECONDS.get("contacts")
    print(f"[1 device] K1 built and loaded in {build_s:.2f} s (nvcc "
          f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'})")
    for path in _build._BUILD_ROOT.glob("*/contacts.ptxas.txt"):
        for ln in path.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[1 device] ptxas: {ln.strip()}")

    # ---- the north-star model and 1024 walkers around its start -------
    t0 = time.perf_counter()
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    start = model.var_start()
    rng = np.random.default_rng(0)
    pos_host = (start[None, :] + 0.001 * np.abs(start)[None, :]
                * rng.standard_normal((N_WALKERS, start.size)))
    pos = torch.tensor(pos_host, dtype=f32, device=dev)
    lp32 = make_ln_prob(model, dtype=f32, device=dev)
    print(f"[model] 5 eclipses x 128 points, 2 bands, D = {start.size}; "
          f"built on the host in {time.perf_counter() - t0:.1f} s")

    # ---- 2. K1 vs plain on the main path's own contact rows -----------
    with mock.patch.object(contacts, "element_intervals_kernel",
                           wraps=contacts.element_intervals_kernel) as rec:
        lp_kernel = lp32(pos)
    _check(rec.call_count == 1, f"K1 called {rec.call_count} times per eval")
    args = rec.call_args.args
    rows, n = args[2].shape
    _check((rows, n) == (N_WALKERS * 5, 512),
           f"contact rows {rows} x {n}, expected 5120 x 512")
    k_out = contacts.element_intervals_kernel(*args)
    p_out = contacts.element_intervals_plain(*args)
    torch.cuda.synchronize()
    flag_diff = (k_out[2] != p_out[2]).float().mean().item()
    both = k_out[2] & p_out[2]
    err_in = (k_out[0] - p_out[0]).abs()[both].max().item()
    err_out = (k_out[1] - p_out[1]).abs()[both].max().item()
    max_abs_err = max(err_in, err_out)
    n_ecl = int(both.sum().item())
    print(f"[2 K1] {rows} x {n} contacts, {n_ecl} eclipsed in both; flag "
          f"disagreement {flag_diff:.3e} (limit 1e-4); max |dphi| "
          f"{max_abs_err:.3e} cycles (limit 1e-5)")
    _check(flag_diff <= 1e-4, "K1 eclipsed flags disagree with plain")
    _check(max_abs_err <= 1e-5, "K1 contact phases disagree with plain")
    k_ms = _event_ms(lambda: contacts.element_intervals_kernel(*args), 20)
    p_ms = _event_ms(lambda: contacts.element_intervals_plain(*args), 5)
    print(f"[2 K1] time per call: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms ({p_ms / k_ms:.1f}x)")

    # ---- 3. posterior: kernel path vs plain path ----------------------
    def plain_path(fn):
        with mock.patch.object(contacts, "element_intervals_kernel",
                               contacts.element_intervals_plain):
            return fn()

    lp_plain = plain_path(lambda: lp32(pos))
    fin_k, fin_p = torch.isfinite(lp_kernel), torch.isfinite(lp_plain)
    _check(bool((fin_k == fin_p).all()), "finite/-inf pattern differs")
    _check(int(fin_k.sum()) > N_WALKERS // 2, "most walkers are -inf")
    fk = lp32.model_flux(pos)
    fp = plain_path(lambda: lp32.model_flux(pos))
    good = fin_k
    dflux = (fk - fp).abs()[good]
    f_max, f_med = dflux.max().item(), dflux.median().item()
    print(f"[3 posterior] {int(fin_k.sum())}/{N_WALKERS} walkers finite "
          f"in both paths; model flux |kernel - plain| max {f_max:.3e} "
          f"(limit 2e-4), median {f_med:.3e} (limit 1e-6)")
    _check(f_max <= 2e-4 and f_med <= 1e-6, "posterior fluxes disagree")
    with torch.inference_mode():
        cvp = model.cv_params(model.full_from_var(pos))
        q = cvp[:, 0, 4]
        x1 = xl1(q)
        rd = cvp[..., 6] * x1[:, None]

    def stream_alone(n_steps):
        with torch.inference_mode():
            stream_impacts(q, rd, x1, n_steps=n_steps)

    # both are bound by host dispatch, whose speed drifts within a run:
    # the eval and the stream alone are timed in turns, the least of each
    torch.cuda.reset_peak_memory_stats()
    turns = {"kernel": [], "stream": []}
    for _ in range(2):
        turns["kernel"].append(_sync_time(lambda: lp32(pos), 1))
        turns["stream"].append(
            _sync_time(lambda: stream_alone(lp32.stream_steps), 1))
    peak = torch.cuda.max_memory_allocated()
    ms_kernel, ms_stream = min(turns["kernel"]), min(turns["stream"])
    ms_plain = plain_path(lambda: _sync_time(lambda: lp32(pos), 2))
    print(f"[3 posterior] ms per eval at {N_WALKERS} walkers: kernel path "
          f"{ms_kernel:.1f} (turns {turns['kernel'][0]:.1f}, "
          f"{turns['kernel'][1]:.1f}), plain path {ms_plain:.1f}; stream "
          f"scan alone {ms_stream:.1f} ms (turns {turns['stream'][0]:.1f}, "
          f"{turns['stream'][1]:.1f}) = {ms_stream / ms_kernel:.1%} of the "
          f"kernel path; peak device memory {peak / 2**30:.2f} GiB")
    # the posterior's other stages: the same evaluation with the stream
    # cut to 64 steps (its values unused), in turns plain, kernel, kernel,
    # plain; and the stream scan's device-busy share under the profiler
    steps, lp32.stream_steps = lp32.stream_steps, 64
    rest = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        def run():
            return _sync_time(lambda: lp32(pos), 3)
        rest[path].append(plain_path(run) if path == "plain" else run())
    lp32.stream_steps = steps
    ms64 = _sync_time(lambda: stream_alone(64), 3)
    busy_us, n_kern = _device_busy_us(lambda: stream_alone(64))
    busy = (f"{busy_us / (ms64 * 1e3):.1%} ({n_kern} kernels, "
            f"{busy_us:.0f} us on the device in {ms64 * 1e3:.0f} us)"
            if n_kern else "not measured (no device events traced)")
    print(f"[3 stages] posterior with the stream cut to 64 steps: kernel "
          f"path {min(rest['kernel']):.1f} ms, plain path "
          f"{min(rest['plain']):.1f} ms; 64 stream steps {ms64:.2f} ms, "
          f"device-busy share {busy}")

    # ---- 4. f32 parity vs the f64 plain path; f64 vs golden ------------
    # identical f32-representable parameter vectors in both precisions
    sub32 = pos[:64]
    sub64 = sub32.to(f64)
    lp64 = make_ln_prob(model, dtype=f64, device=dev)
    f_64 = lp64.model_flux(sub64)
    f_32 = lp32.model_flux(sub32).to(f64)
    ok = torch.isfinite(lp64(sub64))
    scale = f_64.abs().amax(dim=-1, keepdim=True)
    rel = ((f_32 - f_64).abs() / scale)[ok].flatten().cpu().numpy()
    print(f"[4 parity] f32 kernel path vs f64 plain path, {int(ok.sum())} "
          f"walkers x 5 eclipses x 128 phases, relative flux error: median "
          f"{np.median(rel):.2e}, p99 {np.percentile(rel, 99):.2e}, max "
          f"{rel.max():.2e}")
    # median and p99 against the 1e-6 gate's scale; the max is a graze
    # flip: one element's contact phase within f32 error of a data phase
    # moves that element's whole weight at that phase (a bright-spot
    # element carries up to ~2e-2 of the peak flux)
    _check(np.median(rel) < 1e-6 and np.percentile(rel, 99) < 1e-4
           and rel.max() < 5e-2, "f32 parity")
    golden = np.load(ROOT / "tests" / "golden" / "golden_v1.npz")
    cfg = CVConfig(n_disc_rad=8, n_disc_az=12, n_spot=12, n_donor_lat=8,
                   n_donor_lon=12)
    simple = [0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01, 0.02,
              160.0, 0.2, 1.5, 0.0]
    phases = torch.linspace(-0.15, 0.15, 61, dtype=f64, device=dev)
    worst = 0.0
    for tag, pars, cplx in (("simple", simple, False),
                            ("complex", simple + [2.0, 1.3, 80.0, 15.0],
                             True)):
        with torch.inference_mode():
            out = cv_fluxes(torch.tensor(pars, dtype=f64, device=dev),
                            phases, config=cfg._replace(complex_spot=cplx))
        for name in ("total", "ywd", "ydisc", "yspot", "ysec"):
            ref = golden[f"{tag}_{name}"]
            got = getattr(out, name).cpu().numpy()
            worst = max(worst, float(np.max(
                np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12))))
    print(f"[4 golden] f64 cv_fluxes on the card vs golden_v1.npz: max "
          f"relative error {worst:.2e} (limit 1e-9)")
    _check(worst <= 1e-9, "f64 fluxes drifted from golden")

    # ---- 5. sampler: the main path ------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    start_t = torch.tensor(start, dtype=f32, device=dev)
    scatter = 1e-3 * torch.clamp(start_t.abs(), min=1e-2)
    contacts.LAUNCHES = 0
    t0 = time.perf_counter()
    state = init_walkers(gen, start_t, scatter, lp32, N_WALKERS)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    launches_init = contacts.LAUNCHES
    n_steps = 3
    t0 = time.perf_counter()
    state, chain, chain_lp, acc = run_sampler(state, lp32, n_steps, gen)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_steps
    launches = contacts.LAUNCHES
    acc_mean = acc.mean().item()
    print(f"[5 sampler] init_walkers {t_init:.1f} s ({launches_init} K1 "
          f"launches); {n_steps} steps at {s_step:.2f} s/step; acceptance "
          f"{acc_mean:.3f}; K1 launches in the steps "
          f"{launches - launches_init} (2 per step expected)")
    _check(bool(torch.isfinite(state.log_prob).all()), "non-finite log_prob")
    _check(0.0 < acc_mean < 1.0, "acceptance fraction outside (0, 1)")
    _check(launches - launches_init == 2 * n_steps,
           "K1 did not launch once per half-step")
    _check(tuple(chain.shape) == (n_steps, N_WALKERS, start.size),
           "chain shape")

    print(json.dumps({"kernels": [{
        "name": "contacts", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
