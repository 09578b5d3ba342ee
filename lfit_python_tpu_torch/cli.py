"""Command line of the port: an MCMC fit from an input file.

    python -m lfit_python_tpu_torch.cli fit mcmc_input.dat [--outdir out]
        [--device cuda|cpu] [--seed N] [--nburn N] [--nprod N] [--x64]
        [--resume] [--checkpoint-every N] [--resolution full|low]
        [--no-plots] [--quiet]

Port of the stretch-move ensemble branch of ``lfit_python_tpu/cli.py``:
parse the input, build the model tree, scatter the walker ball, burn in
(twice with ``double_burnin``), then run production in segments of
``--checkpoint-every`` steps, each appended to ``chain_prod.txt`` and
checkpointed, and end with the percentile table (``params.json``) and the
convergence diagnostics.  ``metrics.jsonl`` gets one line a chunk.

The fit runs on the CUDA card unless ``--device`` names another device,
and stops with an error where there is no card.  What the JAX package's
command line offers beyond this (tempering, HMC / NUTS, ``--precise``,
sharding, profiling, notifications, plots, ``wdparams``) is refused with
exit code 2 and the roadmap item it waits for.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["main"]

_ITEM3 = "ROADMAP queue 1 item 3 (the CLI's PT, HMC and NUTS branches)"
_ITEM6 = "ROADMAP queue 1 item 6 (the rest of the host surface)"


def _refusal(args, cfg):
    """Why the port cannot run this fit as asked, or None."""
    if cfg.get("usePT", False):
        return f"usePT = 1: parallel tempering waits for {_ITEM3}"
    if args.sampler != "ensemble":
        return f"--sampler {args.sampler} waits for {_ITEM3}"
    if args.hmc_leapfrog is not None or args.nuts_max_depth is not None:
        return f"--hmc-leapfrog / --nuts-max-depth belong to the HMC and " \
               f"NUTS branches, which wait for {_ITEM3}"
    if args.precise:
        return ("--precise waits for ROADMAP queue 1 item 4 (the "
                "mixed-precision mode)")
    if args.pallas or args.no_pallas:
        return ("--pallas / --no-pallas do not apply to the port: it routes "
                "the contact solve by dtype (float32 on the card: the CUDA "
                "kernel K1; --x64: the plain solver)")
    if args.shard:
        return ("--shard waits for ROADMAP queue 1 item 7 (multi-GPU walker "
                "sharding)")
    if args.profile is not None:
        return f"--profile waits for {_ITEM6}"
    if args.notify_cmd or args.notify_file or cfg.get("notify", False):
        return ("--notify-cmd / --notify-file / notify = 1: notifications "
                f"wait for {_ITEM6}")
    return None


def _fit(args):
    import torch

    from .device import resolve_device
    from .models.cv import CVConfig
    from .models.likelihood import make_ln_prob
    from .sampling.ensemble import ensemble_step, init_walkers, run_chunked
    from .utils.chains import ChainWriter, read_chain
    from .utils.checkpoints import (latest_checkpoint, load_checkpoint,
                                    save_checkpoint)
    from .utils.config import build_model_from_config, parse_input_dat

    cfg = parse_input_dat(args.input)
    why = _refusal(args, cfg)
    if why is not None:
        print(f"lfit_python_tpu_torch fit: {why}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"lfit_python_tpu_torch fit: {exc} (here: --device cpu)",
              file=sys.stderr)
        return 1

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    model = build_model_from_config(cfg).compile()
    dtype = torch.float64 if args.x64 else torch.float32
    # element-grid fidelity: 'low' is for quick looks and tests
    cvcfg = (CVConfig() if args.resolution == "full"
             else CVConfig(n_disc_rad=5, n_disc_az=8, n_spot=8,
                           n_donor_lat=6, n_donor_lon=8))
    ln_prob = make_ln_prob(model, config=cvcfg, dtype=dtype, device=device)

    n_walkers = int(cfg.get("nwalkers", 64))
    n_burn = args.nburn if args.nburn is not None else int(cfg.get("nburn", 100))
    n_prod = args.nprod if args.nprod is not None else int(cfg.get("nprod", 100))
    ckpt_every = max(args.checkpoint_every, 1)
    # the JAX command line's chunk length, so that metrics.jsonl gets its
    # lines on the same steps as there
    chunk = math.gcd(math.gcd(n_burn or ckpt_every, n_prod or ckpt_every),
                     ckpt_every)
    if chunk < 8:
        chunk = 64
    scatter_1 = float(cfg.get("scatter_1", 1e-3))
    scatter_2 = float(cfg.get("scatter_2", scatter_1))
    thin = int(cfg.get("thin", 1))

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    start = tensor(model.var_start())
    # per-parameter scatter fractions with comp_scat, else the plain
    # scatter_1 ball
    comp_mult = (tensor(model.var_scatter())
                 if cfg.get("comp_scat", False) else torch.ones_like(start))

    def ball(centre, frac):
        return frac * comp_mult * centre.abs().clamp(min=1e-2)

    def step_fn(state):
        return ensemble_step(state, ln_prob, generator)

    with (outdir / "metrics.jsonl").open("a") as metrics:
        def log(stage, step, acc):
            rec = {"t": time.time(), "stage": stage, "step": step,
                   "accept": round(float(acc), 4)}
            metrics.write(json.dumps(rec) + "\n")
            metrics.flush()
            if not args.quiet:
                print(f"[{stage}] step {step} accept={acc:.3f}", flush=True)

        resume_from = latest_checkpoint(outdir) if args.resume else None
        if resume_from is not None:
            try:
                state, generator, _ = load_checkpoint(resume_from, device)
            except ValueError as exc:
                print(f"lfit_python_tpu_torch fit: {exc}", file=sys.stderr)
                return 2
            if state.positions.dtype != dtype:
                print(f"lfit_python_tpu_torch fit: {resume_from} holds "
                      f"{state.positions.dtype} walkers but this run is "
                      f"{dtype} (--x64); resume it with the same precision",
                      file=sys.stderr)
                return 2
            print(f"resumed from {resume_from} at step {state.step}")
        else:
            generator = torch.Generator(device=device).manual_seed(args.seed)
            state = init_walkers(generator, start, ball(start, scatter_1),
                                 ln_prob, n_walkers)

        t0 = time.time()
        n_run = 0
        if resume_from is None and n_burn > 0:
            state, chain, chain_lp, _ = run_chunked(
                state, step_fn, n_burn, chunk_size=chunk,
                progress=lambda s, a: log("burn", s, a))
            n_run += n_burn
            if cfg.get("double_burnin", False):
                # re-scatter around the best walker, and burn in again
                best = tensor(chain.reshape(-1, model.n_var)[
                    np.argmax(chain_lp.reshape(-1))])
                state = init_walkers(generator, best, ball(best, scatter_2),
                                     ln_prob, n_walkers)
                state, _, _, _ = run_chunked(
                    state, step_fn, n_burn, chunk_size=chunk,
                    progress=lambda s, a: log("burn2", s, a))
                n_run += n_burn
            # production counts its own steps from zero; checkpoints
            # store production steps
            state = state._replace(step=0)

        all_chain, all_lp = [], []
        with ChainWriter(outdir / "chain_prod.txt", model.var_names(),
                         append=resume_from is not None) as writer:
            done = state.step
            while done < n_prod:
                n = min(ckpt_every, n_prod - done)
                state, chain, chain_lp, _ = run_chunked(
                    state, step_fn, n, thin=thin, chunk_size=chunk,
                    progress=lambda s, a: log("prod", done + s, a))
                writer.append(chain, chain_lp)
                all_chain.append(chain)
                all_lp.append(chain_lp)
                done += n
                n_run += n
                save_checkpoint(outdir / f"checkpoint_{done:07d}.npz", state,
                                generator, {"input": str(args.input),
                                            "stage": "prod"})

    if resume_from is not None:
        # the segments before the resume live only in the chain file
        chain, lp, _ = read_chain(outdir / "chain_prod.txt")
    elif all_chain:
        chain, lp = np.concatenate(all_chain), np.concatenate(all_lp)
    else:
        chain = np.empty((0, n_walkers, model.n_var))
        lp = np.empty((0, n_walkers))
    dt = time.time() - t0
    n_evals = n_run * n_walkers
    print(f"total {dt:.1f}s, ~{n_evals / max(dt, 1e-9):.0f} ln-prob evals/s")
    _report(model, chain, lp, outdir, args)
    return 0


def _report(model, chain, lp, outdir, args):
    """Percentile table (``params.json``) and convergence diagnostics."""
    from .utils.chains import autocorr_time, gelman_rubin, summarize

    if not len(chain):
        return
    names = model.var_names()
    discard = len(chain) // 4
    table = summarize(chain, names, discard=discard)
    kept = chain[discard:]
    if len(kept) >= 8:
        # effective sample size from the integrated autocorrelation time:
        # n_eff = steps * walkers / tau
        tau = autocorr_time(kept)
        n_tot = kept.shape[0] * kept.shape[1]
        for row, t in zip(table, tau):
            row["ess"] = float(n_tot / max(t, 1.0))
            row["tau"] = float(t)
    with (outdir / "params.json").open("w") as fh:
        json.dump(table, fh, indent=1)
    print(f"{'parameter':22s} {'median':>12s} {'+err':>10s} {'-err':>10s}")
    for row in table:
        print(f"{row['name']:22s} {row['median']:12.6g} "
              f"{row['upper']:10.3g} {row['lower']:10.3g}")
    rhat = gelman_rubin(chain, discard=discard)
    print("max split-R-hat:", float(np.max(rhat)))
    if len(kept) >= 8:
        print("min effective sample size:",
              round(min(r["ess"] for r in table)))
    if not args.no_plots:
        print(f"plots: not made; the port's plots wait for {_ITEM6}")


def _wdparams(args):
    print(f"lfit_python_tpu_torch wdparams: waits for {_ITEM6}",
          file=sys.stderr)
    return 2


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="lfit_python_tpu_torch",
        description="eclipsing-CV light-curve fitting on a CUDA card "
                    "(the PyTorch port)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    fit = sub.add_parser("fit", help="run an MCMC fit from an input.dat")
    fit.add_argument("input")
    fit.add_argument("--outdir", default="out")
    fit.add_argument("--device", default="cuda",
                     help="torch device to fit on (default: the CUDA card; "
                          "an error where there is none)")
    fit.add_argument("--seed", type=int, default=0)
    fit.add_argument("--nburn", type=int, default=None,
                     help="override input-file nburn")
    fit.add_argument("--nprod", type=int, default=None)
    fit.add_argument("--x64", action="store_true",
                     help="float64 evaluation")
    fit.add_argument("--resume", action="store_true",
                     help="resume from the latest checkpoint in outdir")
    fit.add_argument("--checkpoint-every", type=int, default=500)
    fit.add_argument("--resolution", choices=("full", "low"),
                     default="full",
                     help="element-grid fidelity (low: quick looks, tests)")
    fit.add_argument("--no-plots", action="store_true")
    fit.add_argument("--quiet", action="store_true")
    # the JAX package's options that the port refuses (see _refusal)
    fit.add_argument("--sampler", choices=("ensemble", "hmc", "nuts"),
                     default="ensemble",
                     help="only ensemble (the stretch move) runs here yet")
    fit.add_argument("--hmc-leapfrog", type=int, default=None)
    fit.add_argument("--nuts-max-depth", type=int, default=None)
    fit.add_argument("--precise", action="store_true")
    fit.add_argument("--pallas", action="store_true")
    fit.add_argument("--no-pallas", action="store_true")
    fit.add_argument("--shard", action="store_true")
    fit.add_argument("--profile", default=None, metavar="DIR")
    fit.add_argument("--notify-cmd", default=None)
    fit.add_argument("--notify-file", default=None)
    fit.set_defaults(func=_fit)

    wd = sub.add_parser("wdparams", help="not ported yet")
    wd.add_argument("rest", nargs=argparse.REMAINDER)
    wd.set_defaults(func=_wdparams)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
