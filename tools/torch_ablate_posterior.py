#!/usr/bin/env python3
"""Marginal stage costs inside the port's north-star posterior evaluation.

    python3 tools/torch_ablate_posterior.py [--floor | --parts]
        [--reps 5] [--device cuda]

Port of ``tools/ablate_posterior.py``.  The posterior (the north-star
model: 5 simple-spot eclipses, 2 bands, 128 points each; float32; 1024
walkers around its start) is evaluated with one stage at a time replaced
by a constant of the same shape (:func:`patched`); the difference from the
full evaluation is that stage's marginal cost.  The port's modules bind
functions by ``from ... import``, so :func:`patched` replaces every binding
of a stage's function in every loaded module of the package, and puts each
back on exit.

Ablations:
  full        the real posterior (reference point)
  no_wd       wd_flux -> ones          (the white dwarf's shadow sweep)
  no_contacts element_intervals -> fixed intervals (K1 and its setup)
  no_curve    element_flux_curve -> ones (also removes the contacts)
  no_donor    donor_flux -> ones       (keeps the donor grid's solve)
  no_dgrid    donor_grid -> unit grid  (also removes the grid's solve)
  geometry    all of the above at once (tree, prior and geometry floor)

``--floor`` dissects that floor: with every flux stage ablated, it removes
one floor stage at a time (the stream integration K2, findi, the spot
elements, the prior table) and then all four.  ``--parts`` times the
tempered sampler's parts instead (``ln_prior``, ``ln_like``, ``parts``
against the fused ``ln_prob``).

Each line: the host-clock ms of one evaluation (the least of ``--reps``
turns of 2, every ablation timed in turn in each round, all under
``torch.inference_mode`` as the sampler's), the marginal ms against ``full`` (or ``geometry`` with
``--floor``), and the device kernels, device ms and K1 kernels
(``contacts_kernel``) of one evaluation of that ablation, read with
``torch.profiler``: every ablation's evaluation
is recorded in one profiler window (a process's first window keeps every
kernel record), each inside its own ``record_function`` range, and a
device event (kernel, copy or set) is counted for the range in which it
starts.  The last line is a JSON object of every row.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PACKAGE = "lfit_python_tpu_torch"


def _rebind(orig, fake, saved):
    """Replace every binding of the function ``orig`` in the package's
    loaded modules by ``fake``, noting each in ``saved``."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == PACKAGE
                               or name.startswith(PACKAGE + ".")):
            continue
        for attr, val in list(vars(mod).items()):
            if val is orig:
                saved.append((mod, attr, orig))
                setattr(mod, attr, fake)


@contextlib.contextmanager
def patched(**which):
    """Replace the stages named in ``which`` (stream, findi, spotel,
    prior, wd, contacts, curve, donor, dgrid) by constants of their
    outputs' shapes, in every module that binds them; restore on exit."""
    import torch

    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.models import likelihood as lk
    from lfit_python_tpu_torch.ops import stream as ops_stream
    from lfit_python_tpu_torch.roche import geometry as geo

    fakes = []
    if which.get("stream"):
        def fake_impacts(q, rdiscs, xl1_val=None, n_steps=0, dt=0.0):
            # on the disc rim at azimuth 36.9 deg: physically valid
            d = torch.tensor([0.8, 0.6, 0.0], dtype=rdiscs.dtype,
                             device=rdiscs.device)
            return rdiscs[..., None] * d * (1.0 + 0.0 * q[:, None, None])
        fakes.append((ops_stream.stream_impacts, fake_impacts))
    if which.get("findi"):
        fakes.append((geo.findi, lambda q, dphi, x1=None, pl1=None:
                      85.0 + 0.0 * q))
    if which.get("spotel"):
        def fake_spot(q, rdisc, scale, az, exp1, exp2, n_elem=32,
                      max_extent=5.0, impact=None):
            lead = torch.broadcast_shapes(q.shape, rdisc.shape, scale.shape)
            pos = torch.tensor([0.3, 0.2, 0.0], dtype=scale.dtype,
                               device=scale.device)
            return (pos.expand(lead + (n_elem, 3)).clone(),
                    torch.full(lead + (n_elem,), 1.0 / n_elem,
                               dtype=scale.dtype, device=scale.device))
        fakes.append((comp.spot_elements, fake_spot))
    if which.get("prior"):
        fakes.append((lk.ln_prior_table,
                      lambda vals, table: (0.0 * vals).sum(dim=-1)))
    if which.get("wd"):
        fakes.append((comp.wd_flux,
                      lambda q, incl, phases, *a, **k: torch.ones_like(
                          phases)))
    if which.get("contacts"):
        def fake_intervals(q, incl, pos, x1, pl1, precise=None,
                           positions64=None, r_ins=None):
            lead = pos.shape[:-1]
            return (torch.full(lead, -0.01, dtype=pos.dtype,
                               device=pos.device),
                    torch.full(lead, 0.01, dtype=pos.dtype,
                               device=pos.device),
                    torch.ones(lead, dtype=torch.bool, device=pos.device))
        fakes.append((comp.element_intervals, fake_intervals))
    if which.get("curve"):
        def fake_curve(phases, widths, intervals, weights):
            lead = torch.broadcast_shapes(phases.shape[:-1],
                                          weights.shape[:-1])
            return torch.ones(lead + phases.shape[-1:], dtype=phases.dtype,
                              device=phases.device)
        fakes.append((comp.element_flux_curve, fake_curve))
    if which.get("donor"):
        fakes.append((comp.donor_flux,
                      lambda incl, phases, grid, ulimb_donor=0.9:
                      torch.ones_like(phases)))
    if which.get("dgrid"):
        def fake_grid(q, x1, pl1, n_lat=16, n_lon=24):
            one = torch.ones(q.shape + (n_lat * n_lon, 3), dtype=q.dtype,
                             device=q.device)
            return comp.DonorGrid(one, one, one[..., 0])
        fakes.append((comp.donor_grid, fake_grid))
    saved = []
    try:
        for orig, fake in fakes:
            _rebind(orig, fake, saved)
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


FLUX_OFF = {"wd": True, "contacts": True, "curve": True, "donor": True,
            "dgrid": True}
CASES = [
    ("full", {}),
    ("no_wd", {"wd": True}),
    ("no_contacts", {"contacts": True}),
    ("no_curve", {"curve": True, "contacts": True}),
    ("no_donor", {"donor": True}),
    ("no_dgrid", {"donor": True, "dgrid": True}),
    ("geometry", FLUX_OFF),
]
FLOOR_CASES = [
    ("geometry", FLUX_OFF),
    ("g-stream", dict(FLUX_OFF, stream=True)),
    ("g-findi", dict(FLUX_OFF, findi=True)),
    ("g-spotel", dict(FLUX_OFF, spotel=True)),
    ("g-prior", dict(FLUX_OFF, prior=True)),
    ("g-all", dict(FLUX_OFF, stream=True, findi=True, spotel=True,
                   prior=True)),
]


def walker_block(model, dtype, device, n_walkers, seed=0):
    """``n_walkers`` vectors around the model's start (0.1% scatter)."""
    import torch

    start = model.var_start()
    rng = np.random.default_rng(seed)
    pos = (start[None, :] + 0.001 * np.abs(start)[None, :]
           * rng.standard_normal((n_walkers, start.size)))
    return torch.tensor(pos, dtype=dtype, device=device)


def host_ms(fns, reps, context, per_turn=2):
    """{name: the least host-clock ms of one call of ``fns[name]``} over
    ``reps`` rounds, each timing ``per_turn`` calls of every function in
    turn (after one warm-up call each) inside ``context(name)``, the card
    synchronized around each turn: a drift of the host's speed reaches
    every function alike."""
    import torch

    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    for name, fn in fns.items():
        with context(name):
            fn()
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(reps):
        for name, fn in fns.items():
            with context(name):
                sync()
                t0 = time.perf_counter()
                for _ in range(per_turn):
                    fn()
                sync()
            best[name] = min(best[name],
                             (time.perf_counter() - t0) / per_turn * 1e3)
    return best


def _window_events(prof):
    """(name, on the card, start us, duration us) of every event of a
    finished profiler window: from the raw Kineto records where this
    PyTorch exposes them (quicker than building ``prof.events()``)."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == DeviceType.CUDA,
                 e.start_ns() / 1e3, e.duration_ns() / 1e3) for e in raw]
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA,
                 e.time_range.start, e.time_range.elapsed_us())
                for e in prof.events()]


def device_per_range(calls):
    """{name: (device kernels, device ms, K1 kernels)} of one call of each
    of ``calls`` ({name: fn}), recorded in one profiler window, each in
    its own ``record_function`` range; (None, None, None) each without a
    card.  A device event belongs to the range its start falls in; the
    ranges' own annotations on the card's timeline are not counted.  K1
    kernels are the events named ``contacts_kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        return {name: (None, None, None) for name in calls}
    tag = "ablation::"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            torch.cuda.synchronize()
            with record_function(tag + name):
                fn()
                torch.cuda.synchronize()
    events = _window_events(prof)
    ranges = {name[len(tag):]: (start, start + dur)
              for name, on_card, start, dur in events
              if not on_card and name.startswith(tag)}
    out = {name: [0, 0.0, 0] for name in calls}
    for name, on_card, start, dur in events:
        if not on_card or name.startswith(tag):
            continue
        for case, (s, t) in ranges.items():
            if s <= start <= t:
                out[case][0] += 1
                out[case][1] += dur / 1e3
                out[case][2] += "contacts_kernel" in name
                break
    return {name: tuple(v) for name, v in out.items()}


def ablate(model, cases, dtype, device, n_walkers, reps):
    """One row per case: (name, ms, device kernels, device ms, K1
    kernels), each evaluation under ``torch.inference_mode`` as the
    sampler's, and eager: a CUDA graph's replay would run the kernels
    captured before a stage was ablated."""
    import torch

    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    post = make_ln_prob(model, dtype=dtype, device=device)
    pos = walker_block(model, dtype, device, n_walkers)
    kws = dict(cases)

    @contextlib.contextmanager
    def ablated(name):
        with patched(**kws[name]), torch.inference_mode():
            yield

    ms = host_ms({name: lambda: post._ln_prob(pos) for name in kws}, reps,
                 ablated)

    def call(name):
        with ablated(name):
            post._ln_prob(pos)
    dev = device_per_range({name: lambda name=name: call(name)
                            for name in kws})
    return [(name, ms[name], *dev[name]) for name, _ in cases]


def parts_mode(model, dtype, device, n_walkers, reps):
    """ms of the fused ln_prob and of the tempered sampler's parts."""
    import torch

    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    post = make_ln_prob(model, dtype=dtype, device=device)
    pos = walker_block(model, dtype, device, n_walkers)
    t = host_ms({name: lambda fn=fn: fn(pos) for name, fn in (
        ("fused", post), ("ln_prior", post.ln_prior),
        ("ln_like", post.ln_like), ("parts", post.parts))}, reps,
        lambda name: torch.inference_mode())
    print(f"fused ln_prob  {t['fused']:8.2f} ms")
    for name in ("ln_prior", "ln_like", "parts"):
        print(f"{name:14s} {t[name]:8.2f} ms ({t[name] / t['fused']:.2f}x "
              "fused)")
    print(f"prior + like   {t['ln_prior'] + t['ln_like']:8.2f} ms "
          f"({(t['ln_prior'] + t['ln_like']) / t['fused']:.2f}x fused; "
          "parts shares one pass)")
    return t


def _fmt_device(kernels, dev_ms, k1):
    if kernels is None:
        return "device: not measured (no card)"
    return f"device {kernels:6d} kernels {dev_ms:8.2f} ms (K1 {k1})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", action="store_true",
                    help="time the tempered sampler's parts against the "
                         "fused posterior instead of the stage ablations")
    ap.add_argument("--floor", action="store_true",
                    help="dissect the geometry floor: with every flux "
                         "stage ablated, remove one floor stage at a time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.examples import build_model

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print("device:", torch.cuda.get_device_name(device))
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    dtype = torch.float32
    n_walkers = 1024
    if args.parts:
        t = parts_mode(model, dtype, device, n_walkers, args.reps)
        print(json.dumps({"parts": t}))
        return 0
    cases = FLOOR_CASES if args.floor else CASES
    rows = ablate(model, cases, dtype, device, n_walkers, args.reps)
    base = rows[0][1]
    out = []
    for name, ms, kernels, dev_ms, k1 in rows:
        marginal = None if name == cases[0][0] else base - ms
        note = "" if marginal is None else f"  (marginal {marginal:7.2f} ms)"
        print(f"{name:12s} {ms:8.2f} ms{note:28s} "
              f"{_fmt_device(kernels, dev_ms, k1)}", flush=True)
        out.append({"name": name, "ms": ms, "marginal_ms": marginal,
                    "device_kernels": kernels, "device_ms": dev_ms,
                    "k1_kernels": k1})
    print(json.dumps({"walkers": n_walkers, "floor": args.floor,
                      "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
