#!/usr/bin/env python3
"""Micro-benchmark of the donor curve's formulations on the card at 1024
walkers.

    python3 tools/torch_bench_donor.py [--walkers 1024] [--n-quad 256]
        [--device cuda]

Port of ``tools/bench_donor.py``, whose variants compare TPU
formulations of the donor quadrature's nodes.  Here, on each walker's
donor grid (16 x 24 elements) in float32:

  nodes, broadcast sum  ``models.components.donor_curve_nodes``: the
                        (n_quad + 1) x 384 sweep as a broadcast product
                        and a sum over the elements (the port's form)
  nodes, matmul         the same nodes as two batched matrix products
                        (the JAX package's form; TF32 off)
  curve by gather       ``donor_curve_eval`` of those nodes at the data
                        phases of 5 eclipses x 128 points (four taps
                        gathered a phase)
  curve, exact sums     ``donor_flux`` at the same phases: the broadcast
                        sum over the elements for every phase

Each the mean ms of 30 calls (CUDA events on the card), with the
largest difference of each variant from its counterpart relative to the
largest value.  The last line is a JSON object.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--walkers", type=int, default=1024)
    ap.add_argument("--n-quad", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.roche.geometry import (earth_vector,
                                                      l1_potential, xl1)
    from torch_bench_contacts import time_ms

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print("device:", torch.cuda.get_device_name(dev))
    W, f32, ulimb = args.walkers, torch.float32, 0.9
    rng = np.random.default_rng(0)
    q = torch.tensor(0.12 + 0.02 * rng.standard_normal(W), dtype=f32,
                     device=dev)
    incl = torch.tensor(86.9 + 0.2 * rng.standard_normal(W), dtype=f32,
                        device=dev)
    phases = torch.tensor(rng.uniform(-0.2, 0.2, (W, 5, 128)), dtype=f32,
                          device=dev)
    with torch.inference_mode():
        x1 = xl1(q)
        grid = comp.donor_grid(q, x1, l1_potential(q, x1), 16, 24)
        th = torch.linspace(0.0, 0.5, args.n_quad + 1, dtype=f32,
                            device=dev)

        def nodes_sum():
            return comp.donor_curve_nodes(incl, grid, ulimb, args.n_quad)

        def nodes_matmul():
            e = earth_vector(th, incl[:, None])                 # (W, P, 3)
            mu = torch.bmm(e, grid.normals.transpose(1, 2)).clamp(min=0.0)
            w = mu * (1.0 - ulimb) + ulimb * mu * mu
            return torch.bmm(w, grid.areas[..., None])[..., 0]

        nodes = nodes_sum()

        def curve_gather():
            return comp.donor_curve_eval(nodes, phases)

        def curve_exact():
            return comp.donor_flux(incl[:, None], phases,
                                   comp.DonorGrid(*(a[:, None]
                                                    for a in grid)), ulimb)

        ms = {name: time_ms(fn, 30) for name, fn in (
            ("nodes_broadcast_sum", nodes_sum),
            ("nodes_matmul", nodes_matmul),
            ("curve_gather", curve_gather),
            ("curve_exact_sums", curve_exact))}

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        delta = {"nodes_matmul_vs_broadcast_sum": rel(nodes_matmul(), nodes),
                 "curve_gather_vs_exact": rel(curve_gather(), curve_exact())}
    for name, t in ms.items():
        print(f"{name:22s} {t:9.3f} ms")
    for name, d in delta.items():
        print(f"max relative difference, {name}: {d:.3e}")
    print(json.dumps({"walkers": W, "n_quad": args.n_quad, "ms": ms,
                      "max_rel_delta": delta}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
