#!/usr/bin/env python3
"""Effective samples per second of the port's samplers on the north-star
posterior, on the card.

    python3 tools/torch_ess_study.py [--steps-scale S] [--skip ...]
        [--leapfrogs 16 ...] [--nuts-max-depth 8] [--target-accept A]
        [--config5] [--device cuda]

Port of ``tools/ess_study.py``.  Each sampler runs its warmup or burn-in,
then a timed production; the effective sample size of each parameter
comes from its integrated autocorrelation time
(``utils.chains.autocorr_time``, what ``params.json`` reports), and the
metric is the smallest ESS over the parameters per second of production
wall clock.  Chain counts follow each sampler's operating point: the
stretch move at 1024 walkers (4096 with ``--config5``: 10 complex-spot GP
eclipses), HMC and NUTS at 256 chains.  Step counts are the JAX tool's
times ``--steps-scale`` (ensemble 400 burn-in + 2000 production, 4000
with ``--config5``; HMC 300 + 400; NUTS 200 + 250, 150 + 150 with
``--config5``).  Prints one JSON line per sampler and a markdown table.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ess_per_sec(chain, seconds):
    from lfit_python_tpu_torch.utils.chains import autocorr_time

    tau = autocorr_time(chain)
    ess = chain.shape[0] * chain.shape[1] / np.maximum(tau, 1.0)
    return {"production_s": round(seconds, 2),
            "ess_min": round(float(ess.min()), 1),
            "ess_median": round(float(np.median(ess)), 1),
            "ess_min_per_sec": round(float(ess.min() / seconds), 2),
            "tau_max": round(float(tau.max()), 1)}


def _host(t):
    return t.double().cpu().numpy()


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run_ensemble(model, ln_prob, n_burn, n_prod, n_walkers, device):
    import torch

    from lfit_python_tpu_torch.sampling.ensemble import (init_walkers,
                                                         run_sampler)

    start = torch.tensor(model.var_start(), dtype=torch.float32,
                         device=device)
    scatter = 0.001 * start.abs().clamp(min=1e-2)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_walkers(gen, start, scatter, ln_prob, n_walkers)
    t0 = time.perf_counter()
    state = run_sampler(state, ln_prob, n_burn, gen)[0]
    _sync()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, chain, _, acc = run_sampler(state, ln_prob, n_prod, gen)
    _sync()
    dt = time.perf_counter() - t0
    out = {"sampler": "ensemble", "chains": n_walkers, "steps": n_prod,
           "warmup_s": round(warm_s, 2),
           "accept": round(float(acc.mean()), 3)}
    out.update(_ess_per_sec(_host(chain), dt))
    return out


def run_gradient(kind, model, ln_prob, n_warm, n_prod, device, n_chains=256,
                 n_leapfrog=16, max_depth=8, target_accept=None):
    import torch

    from lfit_python_tpu_torch.sampling import hmc, nuts

    start = torch.tensor(model.var_start(), dtype=torch.float32,
                         device=device)
    scatter = 0.001 * start.abs().clamp(min=1e-2)
    gen = torch.Generator(device=device).manual_seed(0)
    state = hmc.init_hmc(gen, start, scatter, ln_prob, n_chains,
                         step_size=1e-3)
    t0 = time.perf_counter()
    if kind == "hmc":
        ta = hmc._TARGET_ACCEPT if target_accept is None else target_accept
        state = hmc.warmup_hmc(state, ln_prob, n_warm, gen, n_leapfrog,
                               target_accept=ta)
        _sync()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, chain, _, acc, div = hmc.run_hmc(state, ln_prob, n_prod, gen,
                                                n_leapfrog)
        _sync()
        dt = time.perf_counter() - t0
        extra = {"n_leapfrog": n_leapfrog,
                 "accept": round(float(acc.mean()), 3),
                 "divergence_frac": round(float(div.mean()), 4),
                 "step_size": float(state.step_size)}
    else:
        state = nuts.warmup_nuts(state, ln_prob, n_warm, gen, max_depth)
        _sync()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, chain, _, astat, div, depth = nuts.run_nuts(
            state, ln_prob, n_prod, gen, max_depth)
        _sync()
        dt = time.perf_counter() - t0
        extra = {"max_depth": max_depth,
                 "mean_depth": round(float(depth.mean()), 2),
                 "accept_stat": round(float(astat.mean()), 3),
                 "divergence_frac": round(float(div.mean()), 4),
                 "step_size": float(state.step_size)}
    out = {"sampler": kind, "chains": n_chains, "steps": n_prod,
           "warmup_s": round(warm_s, 2), **extra}
    out.update(_ess_per_sec(_host(chain), dt))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="scale every step count (a quick look: 0.05)")
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=["ensemble", "hmc", "nuts"])
    ap.add_argument("--config5", action="store_true",
                    help="the config-5 posterior (10 complex-spot GP "
                         "eclipses) instead of the north star")
    ap.add_argument("--leapfrogs", type=int, nargs="*", default=None,
                    help="HMC trajectory lengths to try (default [16]; "
                         "[4, 8, 16, 32] with --config5)")
    ap.add_argument("--nuts-max-depth", type=int, default=None,
                    help="NUTS tree depth (default 8; 7 with --config5)")
    ap.add_argument("--target-accept", type=float, default=None,
                    help="HMC dual-averaging acceptance target (0.8)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    s = args.steps_scale
    leapfrogs = args.leapfrogs or ([4, 8, 16, 32] if args.config5 else [16])
    depth = args.nuts_max_depth or (7 if args.config5 else 8)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.config5:
        model = build_model(n_eclipses=10, complex_spot=True, use_gp=True,
                            n_points=128, bands=("g", "r")).compile()
    else:
        model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                            n_points=128, bands=("g", "r")).compile()
    ln_prob = make_ln_prob(model, dtype=torch.float32, device=device)
    print(json.dumps({"posterior": "config5" if args.config5 else
                      "north star", "n_var": model.n_var,
                      "device": str(device)}), flush=True)
    rows = []
    if "ensemble" not in args.skip:
        rows.append(run_ensemble(
            model, ln_prob, int(400 * s), int((4000 if args.config5
                                               else 2000) * s),
            4096 if args.config5 else 1024, device))
        print(json.dumps(rows[-1]), flush=True)
    if "hmc" not in args.skip:
        for n_leap in leapfrogs:
            rows.append(run_gradient("hmc", model, ln_prob, int(300 * s),
                                     int(400 * s), device,
                                     n_leapfrog=n_leap,
                                     target_accept=args.target_accept))
            print(json.dumps(rows[-1]), flush=True)
    if "nuts" not in args.skip:
        rows.append(run_gradient(
            "nuts", model, ln_prob,
            int((150 if args.config5 else 200) * s),
            int((150 if args.config5 else 250) * s), device,
            max_depth=depth))
        print(json.dumps(rows[-1]), flush=True)

    print("\n| sampler | chains | prod steps | prod wall | min ESS | "
          "min ESS/s | notes |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        notes = [f"{k}={r[k]}" for k in ("n_leapfrog", "max_depth",
                                         "accept", "accept_stat",
                                         "mean_depth", "divergence_frac")
                 if k in r]
        print(f"| {r['sampler']} | {r['chains']} | {r['steps']} | "
              f"{r['production_s']}s | {r['ess_min']} | "
              f"**{r['ess_min_per_sec']}** | {', '.join(notes)} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
