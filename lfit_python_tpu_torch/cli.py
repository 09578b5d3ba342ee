"""Command line of the port: an MCMC fit from an input file.

    python -m lfit_python_tpu_torch.cli fit mcmc_input.dat [--outdir out]
        [--device cuda|cpu] [--seed N] [--nburn N] [--nprod N] [--x64]
        [--precise] [--sampler ensemble|hmc|nuts] [--hmc-leapfrog N]
        [--nuts-max-depth N] [--resume] [--checkpoint-every N]
        [--resolution full|low] [--shard] [--no-plots] [--quiet]
        [--profile DIR] [--notify-cmd CMD] [--notify-file FILE]

    python -m lfit_python_tpu_torch.cli wdparams wd_input.dat
        [--outdir out_wd] [--grid FILE] [--device cuda|cpu] [--seed N]
        [--nburn N] [--nprod N] [--nwalkers N]

    torchrun --nproc-per-node N -m lfit_python_tpu_torch.cli fit \
        mcmc_input.dat --shard [...]

Port of ``lfit_python_tpu/cli.py``'s ``fit``: parse the input, build the
model tree, scatter the walker ball, burn in, then run production in
segments of ``--checkpoint-every`` steps, each appended to
``chain_prod.txt`` and checkpointed, and end with the percentile table
(``params.json``) and the convergence diagnostics.  ``metrics.jsonl`` gets
one line a chunk.  The sampler is the stretch-move ensemble (burn-in twice
with ``double_burnin``), or, with ``usePT = 1`` in the input, the
parallel-tempered ensemble over ``ntemps`` rungs (the cold rung is the
chain; ``evidence.json`` holds the thermodynamic-integration evidence of
the production ladder), or, with ``--sampler hmc|nuts``, HMC or NUTS over
``nwalkers`` chains (``nburn`` steps of adaptive warmup).  The posterior is
float32 (the CUDA kernel K1 in float32 solves the contacts), float64 with
``--x64`` (K1 in float64), or float32 in the mixed-precision mode with
``--precise`` (K1 in mixed precision; not with HMC or NUTS, which need the
gradient).  A resume continues the latest checkpoint of the same sampler
kind and precision, and refuses any other.  The fit ends with the
percentile table, the chain in ArviZ form (``chains.npz``, or ``chains.nc``
where arviz is installed) and, unless ``--no-plots``, the corner plots
(global, and one per tree node) and ``eclipse_<k>.png`` for each eclipse
the input plots, where matplotlib is installed.  ``--profile DIR`` writes a
Chrome trace of the ensemble's first ``PROFILE_STEPS`` steps from burn-in
on (no other branch is traced); ``--notify-cmd`` / ``--notify-file`` / ``notify = 1`` send a
completion notification.

The fit runs on the CUDA card unless ``--device`` names another device,
and stops with an error where there is no card.  With ``--shard`` every
batch of walkers (chains) is split over the ranks of a process group
(``parallel.mesh``): under ``torchrun`` one rank per card (NCCL; gloo with
``--device cpu``), each on ``cuda:LOCAL_RANK``; without torchrun a
one-rank group that goes through the same collectives.  Every rank runs
the same chain; only rank 0 writes the output directory, and every rank
reads the checkpoint it resumes from.  ``--pallas`` / ``--no-pallas``
are refused with exit code 2: the port routes the contact solve by dtype.

``wdparams`` fits the white dwarf's (Teff, log g, parallax) to its fluxes
(``post.wdparams``), on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

__all__ = ["main"]

# steps of the ensemble that ``fit --profile`` traces: a trace keeps every
# event, ~64 MiB a step of 1024 walkers (NVIDIA H100, chip_smoke.py phase 18)
PROFILE_STEPS = 4


class _Refused(Exception):
    """A fit the port does not run as asked: exit code 2."""


def _refusal(args, cfg):
    """Why the port cannot run this fit as asked, or None."""
    if args.sampler in ("hmc", "nuts"):
        # the gradient samplers differentiate the posterior: the precise
        # path is primal-only, and there is no tempered ladder
        if args.precise:
            return (f"--sampler {args.sampler} is incompatible with "
                    "--precise (that path is not differentiable); drop one "
                    "flag")
        if cfg.get("usePT", False):
            return (f"--sampler {args.sampler} ignores usePT (no tempered "
                    "ladder); unset usePT or use the default ensemble "
                    "sampler")
    if args.pallas or args.no_pallas:
        return ("--pallas / --no-pallas do not apply to the port: it routes "
                "the contact solve by dtype (the CUDA kernel K1 in float32, "
                "in float64 with --x64, in mixed precision with --precise)")
    return None


def _fit(args):
    from .device import resolve_device
    from .utils.config import parse_input_dat

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
    if not args.shard:
        return _fit_on(args, cfg, device, None)
    import torch.distributed as dist

    from .parallel.mesh import walker_mesh

    created = not dist.is_initialized()
    try:
        mesh = walker_mesh(device)
    except RuntimeError as exc:
        print(f"lfit_python_tpu_torch fit: --shard: {exc}", file=sys.stderr)
        return 1
    try:
        if mesh.rank == 0:
            how = ("ranks started by torchrun" if mesh.launched else
                   "a one-rank group: not started by torchrun (torchrun "
                   "--nproc-per-node N shards over N ranks)")
            print(f"--shard: {mesh.world_size} rank(s), "
                  f"{dist.get_backend()}, {how}; rank 0 on {mesh.device}")
        return _fit_on(args, cfg, mesh.device, mesh)
    finally:
        if created:
            dist.destroy_process_group()


def _fit_on(args, cfg, device, mesh):
    """The fit on ``device``, sharded over ``mesh`` where one is given
    (only its rank 0 writes files and prints)."""
    import torch

    from .models.cv import CVConfig
    from .utils.config import build_model_from_config

    lead = mesh is None or mesh.rank == 0
    if not lead:
        args.quiet = True
    outdir = Path(args.outdir)
    if lead:
        outdir.mkdir(parents=True, exist_ok=True)
    model = build_model_from_config(cfg).compile()
    dtype = torch.float64 if args.x64 else torch.float32
    # element-grid fidelity: 'low' is for quick looks and tests
    cvcfg = (CVConfig() if args.resolution == "full"
             else CVConfig(n_disc_rad=5, n_disc_az=8, n_spot=8,
                           n_donor_lat=6, n_donor_lon=8))
    cvcfg = cvcfg._replace(mixed_precision=args.precise)

    n_burn = args.nburn if args.nburn is not None else int(cfg.get("nburn", 100))
    n_prod = args.nprod if args.nprod is not None else int(cfg.get("nprod", 100))
    ckpt_every = max(args.checkpoint_every, 1)
    # the JAX command line's chunk length, so that metrics.jsonl gets its
    # lines on the same steps as there
    chunk = math.gcd(math.gcd(n_burn or ckpt_every, n_prod or ckpt_every),
                     ckpt_every)
    if chunk < 8:
        chunk = 64

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    start = tensor(model.var_start())
    # per-parameter scatter fractions with comp_scat, else the plain
    # scatter_1 ball
    comp_mult = (tensor(model.var_scatter())
                 if cfg.get("comp_scat", False) else torch.ones_like(start))
    scatter_1 = float(cfg.get("scatter_1", 1e-3))

    def ball(centre, frac=scatter_1):
        return frac * comp_mult * centre.abs().clamp(min=1e-2)

    if cfg.get("usePT", False):
        branch = _fit_pt
    elif args.sampler in ("hmc", "nuts"):
        branch = _fit_gradient
    else:
        branch = _fit_ensemble
    if args.profile is not None and branch is not _fit_ensemble and lead:
        # as the JAX command line, which traces the ensemble alone
        print(f"--profile: no trace taken on the "
              f"{'tempered' if branch is _fit_pt else args.sampler} branch "
              "(only the ensemble's steps are traced)")
    with ((outdir / "metrics.jsonl").open("a") if lead
          else contextlib.nullcontext()) as metrics:
        def log(stage, step, acc):
            if not lead:
                return
            rec = {"t": time.time(), "stage": stage, "step": step,
                   "accept": round(float(acc), 4)}
            metrics.write(json.dumps(rec) + "\n")
            metrics.flush()
            if not args.quiet:
                print(f"[{stage}] step {step} accept={acc:.3f}", flush=True)

        run = SimpleNamespace(
            args=args, cfg=cfg, model=model, cvcfg=cvcfg, dtype=dtype,
            device=device, outdir=outdir, log=log, tensor=tensor,
            n_walkers=int(cfg.get("nwalkers", 64)), n_burn=n_burn,
            n_prod=n_prod, chunk=chunk, ckpt_every=ckpt_every,
            thin=int(cfg.get("thin", 1)), start=start, ball=ball,
            mesh=mesh, lead=lead)
        try:
            chain, lp = branch(run)
        except _Refused as exc:
            print(f"lfit_python_tpu_torch fit: {exc}", file=sys.stderr)
            return 2
    if lead:
        _report(model, chain, lp, outdir, args, device)
        _notify_done(args, cfg, outdir)
    return 0


def _resume(run, kind):
    """(state, generator, meta, path) of the latest checkpoint in the
    output directory when ``--resume`` asks for it (Nones otherwise, or
    where there is none); raises _Refused for a checkpoint of another
    sampler ``kind`` or another precision."""
    from .utils.checkpoints import latest_checkpoint, load_checkpoint

    path = latest_checkpoint(run.outdir) if run.args.resume else None
    if path is None:
        return None, None, None, None
    try:
        state, generator, meta = load_checkpoint(path, run.device, kind)
    except ValueError as exc:
        raise _Refused(str(exc)) from None
    if state.positions.dtype != run.dtype:
        raise _Refused(f"{path} holds {state.positions.dtype} walkers but "
                       f"this run is {run.dtype} (--x64); resume it with the "
                       "same precision")
    if run.lead:
        print(f"resumed from {path} at step {state.step}")
    return state, generator, meta, path


def _shard(run, shard_fn, state, generator):
    """``state`` as every rank runs it (``shard_fn``: ``shard_state``,
    ``shard_pt_state`` or ``shard_hmc_state``), when the fit is sharded;
    a walker count the ranks do not divide is refused."""
    if run.mesh is None:
        return state
    try:
        return shard_fn(state, run.mesh, generator)
    except ValueError as exc:
        raise _Refused(f"--shard: {exc}") from None


def _production(run, state, generator, step_fn, extract, sampler, resumed,
                after_segment=None):
    """Production from ``state.step`` to ``run.n_prod`` in checkpoint
    segments of ``run_chunked``, each appended to ``chain_prod.txt``
    (continued after a resume, else started anew) and checkpointed with
    ``sampler`` in its meta, by rank 0 alone in a sharded fit.  Returns
    (state, the production chain and its ln p to report, aux of each
    segment, steps run)."""
    from .sampling.ensemble import run_chunked
    from .utils.chains import ChainWriter, read_chain
    from .utils.checkpoints import save_checkpoint

    all_chain, all_lp, all_aux = [], [], []
    step0 = done = state.step
    path = run.outdir / "chain_prod.txt"
    with (ChainWriter(path, run.model.var_names(),
                      append=resumed is not None) if run.lead
          else contextlib.nullcontext()) as writer:
        while done < run.n_prod:
            n = min(run.ckpt_every, run.n_prod - done)
            state, chain, chain_lp, aux = run_chunked(
                state, step_fn, n, thin=run.thin, chunk_size=run.chunk,
                progress=lambda s, a: run.log("prod", done + s, a),
                extract=extract)
            if run.lead:
                writer.append(chain, chain_lp)
            all_chain.append(chain)
            all_lp.append(chain_lp)
            all_aux.append(aux)
            if after_segment is not None:
                after_segment(aux)
            done += n
            if run.lead:
                save_checkpoint(
                    run.outdir / f"checkpoint_{done:07d}.npz", state,
                    generator, {"input": str(run.args.input),
                                "stage": "prod", "kind": sampler})
    if resumed is not None and run.lead:
        # the segments before the resume live only in the chain file
        chain, lp, _ = read_chain(path)
    elif all_chain:
        chain, lp = np.concatenate(all_chain), np.concatenate(all_lp)
    else:
        chain = np.empty((0, run.n_walkers, run.model.n_var))
        lp = np.empty((0, run.n_walkers))
    return state, chain, lp, all_aux, done - step0


def _rows(state):
    return state.positions, state.log_prob


def _cold_rows(state):
    """The cold (beta = 1) rung's positions and ln posterior."""
    return state.positions[0], state.ln_prior[0] + state.ln_like[0]


def _fit_ensemble(run):
    """The stretch-move ensemble: burn-in (twice with double_burnin), then
    production."""
    import torch

    from .models.likelihood import make_ln_prob
    from .parallel.mesh import shard_state, sharded_batch_ln_prob
    from .sampling.ensemble import ensemble_step, init_walkers, run_chunked

    ln_prob = make_ln_prob(run.model, config=run.cvcfg, dtype=run.dtype,
                           device=run.device)
    if run.mesh is not None:
        ln_prob = sharded_batch_ln_prob(ln_prob, run.mesh)

    trace = None

    def step_fn(state):
        out = ensemble_step(state, ln_prob, generator)
        if trace is not None:
            trace.step()
        return out

    state, generator, _, resumed = _resume(run, "ensemble")
    if resumed is None:
        generator = torch.Generator(device=run.device).manual_seed(
            run.args.seed)
        state = init_walkers(generator, run.start, run.ball(run.start),
                             ln_prob, run.n_walkers)
    state = _shard(run, shard_state, state, generator)

    # --profile traces from burn-in on, as the JAX command line, but only
    # the first PROFILE_STEPS steps
    profile = contextlib.nullcontext()
    if run.args.profile is not None and run.lead:
        from .utils.tracing import trace_to
        profile = trace_to(run.args.profile, steps=PROFILE_STEPS)
    with profile as trace:
        t0 = time.time()
        n_run = 0
        if resumed is None and run.n_burn > 0:
            state, chain, chain_lp, _ = run_chunked(
                state, step_fn, run.n_burn, chunk_size=run.chunk,
                progress=lambda s, a: run.log("burn", s, a))
            n_run += run.n_burn
            if run.cfg.get("double_burnin", False):
                # re-scatter around the best walker, and burn in again
                best = run.tensor(chain.reshape(-1, run.model.n_var)[
                    np.argmax(chain_lp.reshape(-1))])
                scatter_2 = float(run.cfg.get(
                    "scatter_2", run.cfg.get("scatter_1", 1e-3)))
                state = init_walkers(generator, best,
                                     run.ball(best, scatter_2), ln_prob,
                                     run.n_walkers)
                state = _shard(run, shard_state, state, generator)
                state, _, _, _ = run_chunked(
                    state, step_fn, run.n_burn, chunk_size=run.chunk,
                    progress=lambda s, a: run.log("burn2", s, a))
                n_run += run.n_burn
            # production counts its own steps from zero; checkpoints store
            # production steps
            state = state._replace(step=0)

        state, chain, lp, _, n = _production(
            run, state, generator, step_fn, _rows, "ensemble", resumed)
        dt = time.time() - t0
        rate = (n_run + n) * run.n_walkers / max(dt, 1e-9)
        if run.lead:
            print(f"total {dt:.1f}s, ~{rate:.0f} ln-prob evals/s")
    return chain, lp


def _fit_pt(run):
    """The parallel-tempered ensemble over ``ntemps`` rungs: burn-in, then
    production of the cold rung, and the evidence of the production
    ladder."""
    import torch

    from .models.likelihood import make_ln_prob_parts
    from .parallel.mesh import shard_pt_state, sharded_pt_batch_parts
    from .sampling import pt
    from .sampling.ensemble import run_chunked

    ln_prior_fn, ln_like_fn, _ = make_ln_prob_parts(
        run.model, config=run.cvcfg, dtype=run.dtype, device=run.device)
    batch_parts = (None if run.mesh is None else
                   sharded_pt_batch_parts(ln_prior_fn, ln_like_fn, run.mesh))

    def step_fn(state):
        return pt.pt_step(state, ln_prior_fn, ln_like_fn, generator,
                          batch_parts_fn=batch_parts)

    t0 = time.time()
    state, generator, _, resumed = _resume(run, "pt")
    if resumed is None:
        generator = torch.Generator(device=run.device).manual_seed(
            run.args.seed)
        state = pt.init_pt(generator, run.start, run.ball(run.start),
                           ln_prior_fn, ln_like_fn, run.n_walkers,
                           int(run.cfg.get("ntemps", 4)),
                           batch_parts_fn=batch_parts)
    state = _shard(run, shard_pt_state, state, generator)
    n_temps = state.positions.shape[0]

    n_run = 0
    if resumed is None and run.n_burn > 0:
        state = run_chunked(state, step_fn, run.n_burn, chunk_size=run.chunk,
                            progress=lambda s, a: run.log("burn", s, a),
                            extract=_cold_rows)[0]
        n_run += run.n_burn
        state = state._replace(step=0)

    state, chain, lp, all_aux, n = _production(
        run, state, generator, step_fn, _cold_rows, "pt", resumed)
    dt = time.time() - t0
    rate = (n_run + n) * run.n_walkers * n_temps / max(dt, 1e-9)
    if not run.lead:
        return chain, lp
    print(f"PT ({n_temps} rungs) total {dt:.1f}s, ~{rate:.0f} ln-prob "
          f"evals/s")
    if all_aux:
        # thermodynamic integration over this run's production ladder
        mean_ll = np.concatenate([aux[1] for aux in all_aux]).mean(axis=0)
        betas = state.betas.double().cpu().numpy()
        ln_z, dln_z = pt.log_evidence(betas, mean_ll)
        (run.outdir / "evidence.json").write_text(json.dumps({
            "ln_evidence": ln_z, "dln_evidence": dln_z,
            "betas": betas.tolist(),
            "mean_ln_like_per_rung": mean_ll.tolist(),
            "note": ("thermodynamic integration over the production "
                     "ladder; dln = full vs half-ladder difference"),
        }, indent=1))
        print(f"ln evidence (thermodynamic integration): {ln_z:.3f} +- "
              f"{dln_z:.3f}")
    return chain, lp


def _fit_gradient(run):
    """HMC or NUTS over ``nwalkers`` chains: ``nburn`` steps of adaptive
    warmup (step size and diagonal metric), then production."""
    import torch

    from .models.likelihood import make_ln_prob
    from .parallel import mesh as pm
    from .sampling import hmc, nuts

    args, kind = run.args, run.args.sampler
    ln_prob = make_ln_prob(run.model, config=run.cvcfg, dtype=run.dtype,
                           device=run.device)
    vg = traj = None
    if run.mesh is not None:
        vg = pm.sharded_value_and_grad(ln_prob, run.mesh)
        traj = hmc.batch_trajectories(ln_prob, args.hmc_leapfrog, vg_fn=vg)

    def step_fn(state):
        if kind == "nuts":
            state, astat, _, div, depth = nuts.nuts_step(
                state, ln_prob, generator, args.nuts_max_depth, vg_fn=vg)
            return state, (astat, div, depth)
        state, acc, _, div = hmc.hmc_step(state, ln_prob, generator,
                                          args.hmc_leapfrog, traj)
        return state, (acc, div)

    state, generator, meta, resumed = _resume(run, "hmc")
    if resumed is not None and meta.get("kind", kind) != kind:
        raise _Refused(f"{resumed} is a {meta['kind']} checkpoint but "
                       f"--sampler is {kind}; refusing to resume across "
                       "sampler kinds")
    if resumed is None:
        generator = torch.Generator(device=run.device).manual_seed(args.seed)
        state = hmc.init_hmc(generator, run.start, run.ball(run.start),
                             ln_prob, run.n_walkers, vg_fn=vg)
    state = _shard(run, pm.shard_hmc_state, state, generator)
    if resumed is None:
        t_w = time.time()
        if kind == "nuts":
            state = nuts.warmup_nuts(state, ln_prob, run.n_burn, generator,
                                     max_depth=args.nuts_max_depth,
                                     vg_fn=vg)
        else:
            state = hmc.warmup_hmc(state, ln_prob, run.n_burn, generator,
                                   n_leapfrog=args.hmc_leapfrog,
                                   traj_batch_fn=traj)
        run.log("warmup", run.n_burn, 0.0)
        if not args.quiet:
            print(f"warmup {time.time() - t_w:.1f}s: step_size="
                  f"{float(state.step_size):.3e}")

    def warn(aux):
        div = float(np.mean(aux[1]))
        if div > 0.02 and not args.quiet:
            print(f"warning: {100 * div:.1f}% divergent trajectories; "
                  "results may be biased", file=sys.stderr)

    t0 = time.time()
    state, chain, lp, all_aux, n = _production(
        run, state, generator, step_fn, _rows, kind, resumed, warn)
    dt = time.time() - t0
    if not run.lead:
        return chain, lp
    if kind == "nuts":
        depth = (np.mean(np.concatenate([a[2] for a in all_aux]))
                 if all_aux else math.nan)
        print(f"NUTS total {dt:.1f}s, {n} steps x {run.n_walkers} chains, "
              f"mean depth {depth:.1f}, "
              f"~{n * run.n_walkers / max(dt, 1e-9):.1f} trajectories/s")
    else:
        rate = n * run.n_walkers * args.hmc_leapfrog / max(dt, 1e-9)
        print(f"HMC total {dt:.1f}s, ~{rate:.0f} gradient evals/s")
    return chain, lp


def _report(model, chain, lp, outdir, args, device):
    """The chain in ArviZ form, the percentile table (``params.json``),
    the convergence diagnostics and, unless ``--no-plots``, the plots (the
    eclipse curves evaluated on ``device``)."""
    from .utils.chains import (autocorr_time, gelman_rubin, save_arviz,
                               summarize)

    if not len(chain):
        return
    names = model.var_names()
    save_arviz(chain, names, outdir / "chains", log_prob=lp)
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
    if len(kept) >= 2:
        rhat = gelman_rubin(chain, discard=discard)
        print("max split-R-hat:", float(np.max(rhat)))
    else:
        # the JAX package's command line divides by zero here
        print("max split-R-hat: not computed (it splits each walker's "
              f"kept rows in two; {len(kept)} kept)")
    if len(kept) >= 8:
        print("min effective sample size:",
              round(min(r["ess"] for r in table)))
    if not args.no_plots:
        _plots(model, chain, lp, outdir, device)


def _plots(model, chain, lp, outdir, device):
    """The global corner plot, one per tree node where the tree has more
    than one, and ``eclipse_<k>.png`` of the best walker for each eclipse
    the input plots; one line instead where matplotlib is not installed."""
    from .utils.plotting import corner_plot, have_matplotlib, plot_eclipse

    if not have_matplotlib():
        print("plots: not made (matplotlib is not installed)")
        return
    names = model.var_names()
    flat = chain[len(chain) // 4:].reshape(-1, model.n_var)
    corner_plot(flat, names, outdir / "corner.png")
    # per-node corners: max_params=19 exceeds the largest node (a complex
    # GP eclipse has 15), so every sampled parameter appears untruncated
    groups = model.var_groups()
    if len(groups) > 1:
        for label, idx in groups:
            corner_plot(flat[:, idx], [names[i] for i in idx],
                        outdir / f"corner_{label}.png", max_params=19)
    best = chain.reshape(-1, model.n_var)[np.argmax(lp.reshape(-1))]
    full_best = model.full_from_var(best)
    for k in range(model.n_eclipses):
        if model.plot_mask[k]:
            plot_eclipse(model, full_best, k,
                         path=outdir / f"eclipse_{k}.png", device=device)
    print(f"plots: written to {outdir}")


def _notify_done(args, cfg, outdir):
    """Completion notification through every configured channel."""
    if not (args.notify_cmd or args.notify_file or cfg.get("notify")):
        return
    from .utils.notify import notify

    notify(f"lfit_python_tpu_torch fit finished: {args.input}",
           f"results in {outdir}", cmd=args.notify_cmd,
           file=args.notify_file or (outdir / "notifications.jsonl"
                                     if cfg.get("notify") else None))


def _wdparams(args):
    from .device import resolve_device
    from .post.wdparams import run_wdparams

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"lfit_python_tpu_torch wdparams: {exc} (here: --device cpu)",
              file=sys.stderr)
        return 1
    return run_wdparams(args)


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
    fit.add_argument("--sampler", choices=("ensemble", "hmc", "nuts"),
                     default="ensemble",
                     help="ensemble = affine-invariant stretch move; hmc = "
                          "HMC with adaptive warmup; nuts = the No-U-Turn "
                          "sampler")
    fit.add_argument("--hmc-leapfrog", type=int, default=16,
                     help="leapfrog steps per HMC trajectory")
    fit.add_argument("--nuts-max-depth", type=int, default=8,
                     help="max tree doublings per NUTS trajectory")
    fit.add_argument("--precise", action="store_true",
                     help="mixed-precision mode: a float32 posterior with "
                          "float64 geometry solves and near-root "
                          "clearances")
    fit.add_argument("--shard", action="store_true",
                     help="split every batch of walkers over the ranks of "
                          "a process group (torchrun)")
    fit.add_argument("--profile", default=None, metavar="DIR",
                     help="write a torch.profiler Chrome trace of the "
                          f"ensemble's first {PROFILE_STEPS} steps (from "
                          "burn-in on) to DIR; ~64 MiB a step at 1024 "
                          "walkers on an H100")
    fit.add_argument("--notify-cmd", default=None,
                     help="shell command to notify on completion")
    fit.add_argument("--notify-file", default=None,
                     help="append a JSON completion record to this file")
    # the JAX package's options that the port refuses (see _refusal)
    fit.add_argument("--pallas", action="store_true")
    fit.add_argument("--no-pallas", action="store_true")
    fit.set_defaults(func=_fit)

    wd = sub.add_parser("wdparams",
                        help="fit WD atmosphere params to fitted fluxes")
    wd.add_argument("input")
    wd.add_argument("--outdir", default="out_wd")
    wd.add_argument("--grid", default=None,
                    help="path to a Bergeron-format DA grid table")
    wd.add_argument("--device", default="cuda",
                    help="torch device to fit on (default: the CUDA card; "
                         "an error where there is none)")
    wd.add_argument("--seed", type=int, default=0)
    wd.add_argument("--nburn", type=int, default=500)
    wd.add_argument("--nprod", type=int, default=1000)
    wd.add_argument("--nwalkers", type=int, default=64)
    wd.set_defaults(func=_wdparams)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
