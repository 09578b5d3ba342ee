#!/usr/bin/env python3
"""Per-stage times of the port's north-star posterior on the card.

    python3 tools/torch_profile_posterior.py [--device cuda]

Port of ``tools/profile_posterior.py``.  Times each stage of an
evaluation alone, batched over the walkers (float32; q, dphi, incl and
rdisc scattered around 0.15, 0.04, 84 deg and 0.3; 1024 walkers): the
L1 solve, L1
and findi, the gas stream K2 and its impact, the contact intervals K1 on
992 elements (the full-resolution disc and spot), the white dwarf's
curve on 128 phases, the donor grid and its curve (384 elements); then
the whole posterior of the 1-eclipse and the 5-eclipse north-star model,
fast (float32) and precise (the mixed-precision mode).  Stages fuse and
overlap inside an evaluation, so these do not add up to it:
``tools/torch_ablate_posterior.py`` measures each stage's marginal cost.

Each line is the host-clock ms of one call, the mean of 10 calls in a
row with the card synchronized around them; a last JSON line holds them
all.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, reps):
    """ms of one call of ``fn``: a warm-up call, then ``reps`` in a row."""
    import torch

    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else (lambda: None))
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops.stream import stream_impacts
    from lfit_python_tpu_torch.roche.geometry import findi, l1_potential, xl1

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print("device:", torch.cuda.get_device_name(dev))
    dtype, W, reps = torch.float32, 1024, 10
    rng = np.random.default_rng(0)

    def around(mean, sd, shape=(W,)):
        return torch.tensor(mean + sd * rng.standard_normal(shape),
                            dtype=dtype, device=dev)

    qs, dphis = around(0.15, 0.003), around(0.04, 0.0005)
    incls, rdiscs = around(84.0, 0.05), around(0.3, 0.003)
    times = {}

    def stage(name, fn):
        with torch.inference_mode():
            times[name] = timeit(fn, reps)
        print(f"{name:28s} {times[name]:9.3f} ms", flush=True)

    x1 = xl1(qs)
    pl1 = l1_potential(qs, x1)
    stage("xl1", lambda: xl1(qs))
    stage("xl1 + l1 + findi",
          lambda: findi(qs, dphis, xl1(qs), l1_potential(qs, xl1(qs))))
    stage("stream impact (K2)",
          lambda: stream_impacts(qs, (rdiscs * x1)[:, None], x1))

    cfg = CVConfig()
    n_elem = cfg.n_disc_rad * cfg.n_disc_az + cfg.n_spot
    r = rng.uniform(0.05, 0.45, n_elem)
    th = rng.uniform(0, 2 * np.pi, n_elem)
    pos = torch.tensor(np.stack([r * np.cos(th), r * np.sin(th),
                                 np.zeros(n_elem)], -1), dtype=dtype,
                       device=dev).expand(W, n_elem, 3)
    stage(f"contacts ({n_elem} elements, K1)",
          lambda: comp.element_intervals(qs, incls, pos, x1, pl1))
    phases = torch.linspace(-0.1, 0.1, 128, dtype=dtype, device=dev)
    stage("wd_flux (128 phases)",
          lambda: comp.wd_flux(qs[:, None], incls[:, None], phases,
                               torch.full_like(qs[:, None], 0.01),
                               torch.full_like(qs[:, None], 0.3),
                               x1[:, None], pl1[:, None]))
    n_donor = cfg.n_donor_lat * cfg.n_donor_lon
    stage(f"donor grid + curve ({n_donor})",
          lambda: comp.donor_flux(incls, phases, comp.donor_grid(
              qs, x1, pl1, cfg.n_donor_lat, cfg.n_donor_lon)))

    for n_ecl in (1, 5):
        model = build_model(n_eclipses=n_ecl, complex_spot=[False] * n_ecl,
                            n_points=128,
                            bands=("g",) if n_ecl == 1 else ("g", "r")
                            ).compile()
        start = model.var_start()
        walk = torch.tensor(start[None, :] + 0.001 * np.abs(start)[None, :]
                            * rng.standard_normal((W, start.size)),
                            dtype=dtype, device=dev)
        for mixed in (False, True):
            post = make_ln_prob(model, CVConfig(mixed_precision=mixed),
                                dtype=dtype, device=dev)
            name = (f"posterior {n_ecl}-eclipse "
                    f"{'precise' if mixed else 'fast'}")
            stage(name, lambda: post(walk))
            print(f"{'':28s} {W / times[name] * 1e3:9.0f} evals/s")
    print(json.dumps({"walkers": W, "reps": reps, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
