#!/usr/bin/env python3
"""Micro-benchmark of the contact-interval solve on the card: K1 against
the plain solver at 1024 walkers x 992 elements.

    python3 tools/torch_bench_contacts.py [--device cuda]

Port of ``tools/bench_contacts.py``.  An element cloud of the
full-resolution disc and spot's size (992 elements, radius 0.05-0.45)
for 1024 walkers around q = 0.15, incl = 84 deg, float32: the time of one
``ops.contacts.element_intervals_kernel`` call (K1), of its plain
version, and of the whole ``models.components.element_intervals`` (K1
with the inscribed radius and the row setup), each the mean of 20 calls
(2 for the plain version) timed with CUDA events; the largest phase
difference of K1 against the plain version and their flag agreement.
The last line is a JSON object.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def time_ms(fn, reps):
    """Mean ms of one call of ``fn`` over ``reps`` calls (after one):
    CUDA events on the card, the host clock elsewhere."""
    import torch

    fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.ops import contacts
    from lfit_python_tpu_torch.roche.geometry import (inscribed_radius,
                                                      l1_potential, xl1)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print("device:", torch.cuda.get_device_name(dev))
    W, n_elem, f32, reps = 1024, 992, torch.float32, 20
    rng = np.random.default_rng(0)
    r = rng.uniform(0.05, 0.45, n_elem)
    th = rng.uniform(0, 2 * np.pi, n_elem)
    pos = torch.tensor(np.stack([r * np.cos(th), r * np.sin(th),
                                 np.zeros(n_elem)], -1), dtype=f32,
                       device=dev).expand(W, n_elem, 3)
    qs = torch.tensor(0.15 + 0.001 * rng.standard_normal(W), dtype=f32,
                      device=dev)
    incls = torch.tensor(84.0 + 0.05 * rng.standard_normal(W), dtype=f32,
                         device=dev)
    with torch.inference_mode():
        x1 = xl1(qs)
        pl1 = l1_potential(qs, x1)
        rows = (qs, incls, pos[..., 0].contiguous(),
                pos[..., 1].contiguous(), x1, pl1,
                inscribed_radius(qs, x1, pl1))
        ms = {"k1": time_ms(lambda: contacts.element_intervals_kernel(
                  *rows), reps),
              "plain": time_ms(lambda: contacts.element_intervals_plain(
                  *rows), 2),
              "element_intervals": time_ms(lambda: comp.element_intervals(
                  qs, incls, pos, x1, pl1), reps)}
        k = contacts.element_intervals_kernel(*rows)
        p = contacts.element_intervals_plain(*rows)
    both = k[2] & p[2]
    dphi = max(float((k[i] - p[i])[both].abs().max()) for i in (0, 1))
    report = {"walkers": W, "elements": n_elem, "ms": ms,
              "max_abs_dphi": dphi,
              "flag_agreement": float((k[2] == p[2]).double().mean()),
              "eclipsed_fraction": float(p[2].double().mean())}
    for name, t in ms.items():
        print(f"{name:18s} {W} walkers x {n_elem} elements: {t:9.3f} ms "
              f"({W / t * 1e3:.0f} walkers/s)")
    print(f"K1 against the plain solver: max |dphi| {dphi:.2e} cycles, flag "
          f"agreement {report['flag_agreement']:.6f}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
