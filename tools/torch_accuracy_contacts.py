#!/usr/bin/env python3
"""Stress accuracy of the float32 contact solvers against the float64
solve.

    python3 tools/torch_accuracy_contacts.py [--device cuda]

Port of ``tools/accuracy_contacts.py``.  On a stress ensemble spanning
deep eclipses through grazes (512 rows: q 0.05-0.5, inclination 75-90
deg; 256 elements each across the disc and spot footprint, radius
0.02-0.45), the contact phases of K1 in float32
(``ops.contacts.element_intervals`` on the card) and of the plain solver
in float32 are compared with the plain solver's float64 phases on the
same rows: eclipsed-flag agreement, and the phase errors (phi_in,
phi_out, eclipse width; median, p99, p99.9, max, in cycles) on the
elements both call eclipsed.

The gate is the port's p99 gate (``tests/test_torch_contacts.py``,
``TestAccuracyAgainstTheOracle``; ``tests/test_pallas.py`` holds two
float32 solvers to the same bound): over both edges of the elements
eclipsed in both, p99 <= 1e-5 cycles and at most 2% of edges above
1e-5.  The last line is a JSON object; the exit code is 1 if a solver
fails the gate.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

P99_LIMIT = 1e-5
ABOVE_SHARE_LIMIT = 0.02


def stress_rows(dtype, device, n_rows=512, n_elem=256, seed=42):
    """(q, incl, px, py, x1, pl1, r_ins) of the stress ensemble, as
    ``ops.contacts.element_intervals`` takes them, built in float64 and
    cast to ``dtype``."""
    import torch

    from lfit_python_tpu_torch.roche.geometry import (inscribed_radius,
                                                      l1_potential, xl1)

    rng = np.random.default_rng(seed)
    q = rng.uniform(0.05, 0.5, n_rows)
    incl = rng.uniform(75.0, 90.0, n_rows)
    r = rng.uniform(0.02, 0.45, (n_rows, n_elem))
    th = rng.uniform(0, 2 * np.pi, (n_rows, n_elem))

    def t(a):
        return torch.tensor(a, dtype=torch.float64, device=device)

    q64 = t(q)
    x1 = xl1(q64)
    pl1 = l1_potential(q64, x1)
    args = [q64, t(incl), t(r * np.cos(th)), t(r * np.sin(th)), x1, pl1,
            inscribed_radius(q64, x1, pl1)]
    return [a.to(dtype) for a in args]


def errors(got, ref):
    """Flag agreement and phase errors of ``got`` against ``ref`` (each
    (phi_in, phi_out, eclipsed) as numpy), on the elements both call
    eclipsed."""
    pin, pout, ecl = (np.asarray(a, np.float64 if a.dtype != bool else bool)
                      for a in got)
    rin, rout, recl = ref
    both = ecl & recl
    e_in = np.abs(pin[both] - rin[both])
    e_out = np.abs(pout[both] - rout[both])
    e_w = np.abs((pout - pin)[both] - (rout - rin)[both])
    edges = np.concatenate([e_in, e_out])
    p99 = float(np.percentile(edges, 99))
    above = float((edges > P99_LIMIT).mean())
    out = {"flag_agreement": float((ecl == recl).mean()),
           "flags_differ": int((ecl != recl).sum()),
           "eclipsed_both": int(both.sum()),
           "edge_p99": p99, "edge_share_above_1e-5": above,
           "gate_ok": bool(p99 <= P99_LIMIT and above <= ABOVE_SHARE_LIMIT)}
    for name, e in (("phi_in", e_in), ("phi_out", e_out), ("width", e_w)):
        out[name] = {"median": float(np.median(e)),
                     "p99": float(np.percentile(e, 99)),
                     "p99.9": float(np.percentile(e, 99.9)),
                     "max": float(e.max())}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--elements", type=int, default=256)
    args = ap.parse_args(argv)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.ops import contacts

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print("device:", torch.cuda.get_device_name(dev))

    def run(fn, rows):
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        out = fn(*rows)
        sync()
        return [o.cpu().numpy() for o in out], time.perf_counter() - t0

    rows64 = stress_rows(torch.float64, dev, args.rows, args.elements)
    rows32 = stress_rows(torch.float32, dev, args.rows, args.elements)
    ref, t_ref = run(contacts.element_intervals_plain, rows64)
    print(f"float64 plain solve: {t_ref:.2f} s; {args.rows} rows x "
          f"{args.elements} elements, eclipsed fraction {ref[2].mean():.4f}")
    launches = contacts.LAUNCHES
    report = {"rows": args.rows, "elements": args.elements,
              "eclipsed_fraction": float(ref[2].mean())}
    for name, fn in (("K1 float32", contacts.element_intervals),
                     ("plain float32", contacts.element_intervals_plain)):
        got, dt = run(fn, rows32)
        r = errors(got, ref)
        r["seconds"] = dt
        report[name] = r
        print(f"{name}: {dt:.2f} s; flag agreement {r['flag_agreement']:.6f} "
              f"({r['flags_differ']} differ)")
        for stat in ("phi_in", "phi_out", "width"):
            e = r[stat]
            print(f"  {stat:8s} err: median {e['median']:.3e}  p99 "
                  f"{e['p99']:.3e}  p99.9 {e['p99.9']:.3e}  max "
                  f"{e['max']:.3e} cycles")
        print(f"  gate (p99 <= 1e-5 cycles, <= 2% of edges above): edges' "
              f"p99 {r['edge_p99']:.3e}, {r['edge_share_above_1e-5']:.3%} "
              f"above: {'pass' if r['gate_ok'] else 'FAIL'}")
    report["k1_launches"] = contacts.LAUNCHES - launches
    print(json.dumps(report))
    return 0 if all(report[n]["gate_ok"] for n in ("K1 float32",
                                                   "plain float32")) else 1


if __name__ == "__main__":
    sys.exit(main())
