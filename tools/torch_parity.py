#!/usr/bin/env python3
"""Flux parity of the port in float32 on the card against float64 on the
CPU, with the error attributed to the model's components.

    python3 tools/torch_parity.py [--device cuda] [--draws 32]

Port of ``tools/parity.py``.  32 complex-spot parameter vectors around a
typical eclipse (q clipped to 0.05-0.5, dphi to 0.02-0.06, rwd to
0.005-0.02; float32-representable, so that only the computation differs)
are evaluated on 256 phases by ``models.cv.cv_fluxes``: in float64 on the
CPU (the plain path), and in float32 on ``--device`` (K1 and K2 on the
card), fast and in the mixed-precision mode (``--precise``).  For each
mode: the total flux's error relative to each vector's largest total
(median, p99, max) and each component's (max, p99), held to PERF.md
section 2's limits on the total (median 1e-6, p99 1e-4, max 5e-2).  Then
the contact phases of the disc's 960 elements at q = 0.15, dphi = 0.04,
float32 on the device against float64 on the CPU, and the eclipsed-flag
agreement.  The last line is a JSON object; the exit code is 1 if a mode
passes a limit.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LIMITS = {"median": 1e-6, "p99": 1e-4, "max": 5e-2}
COMPONENTS = ("ywd", "ydisc", "yspot", "ysec")


def draws(n_draw=32, seed=42):
    """``n_draw`` float32-representable complex-spot vectors (n, 18)."""
    rng = np.random.default_rng(seed)
    base = np.array([0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.011,
                     0.025, 160.0, 0.2, 1.5, 0.0, 1.0, 1.0, 90.0, 0.0])
    jitter = np.abs(base) * 0.1 + 1e-3
    d = base[None, :] + jitter[None, :] * rng.standard_normal((n_draw, 18))
    d[:, 4] = np.clip(d[:, 4], 0.05, 0.5)     # q
    d[:, 5] = np.clip(d[:, 5], 0.02, 0.06)    # dphi
    d[:, 8] = np.clip(d[:, 8], 0.005, 0.02)   # rwd
    return d.astype(np.float32).astype(np.float64)


def flux_errors(test, oracle):
    """{total: {median, p99, max}, <component>: {max, p99}} of ``test``
    against ``oracle`` (CVFluxes of numpy arrays (n, P)), each relative to
    the vector's largest oracle total."""
    scale = np.abs(oracle.total).max(axis=-1, keepdims=True)
    tot = np.abs(test.total - oracle.total) / scale
    out = {"total": {"median": float(np.median(tot)),
                     "p99": float(np.percentile(tot, 99)),
                     "max": float(tot.max())}}
    for name in COMPONENTS:
        e = np.abs(getattr(test, name) - getattr(oracle, name)) / scale
        out[name] = {"max": float(e.max()),
                     "p99": float(np.percentile(e, 99))}
    out["ok"] = all(out["total"][k] <= v for k, v in LIMITS.items())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=32)
    args = ap.parse_args(argv)

    import torch

    from lfit_python_tpu_torch.device import resolve_device
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.models.cv import CVConfig, CVFluxes, cv_fluxes
    from lfit_python_tpu_torch.ops import contacts
    from lfit_python_tpu_torch.roche.geometry import (findi,
                                                      inscribed_radius,
                                                      l1_potential, xl1)

    dev = resolve_device(args.device)
    cpu = torch.device("cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"oracle: float64 on the CPU; test: float32 on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""))
    cfg = CVConfig(complex_spot=True)
    d = draws(args.draws)
    phases = np.linspace(-0.1, 0.1, 256)

    def fluxes(config, dtype, device):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)
        with torch.inference_mode():
            out = cv_fluxes(t(d), t(phases), config=config)
            return CVFluxes(*(o.double().cpu().numpy() for o in out))

    oracle = fluxes(cfg, torch.float64, cpu)
    report = {"draws": len(d), "phases": len(phases), "limits": LIMITS}
    for mode, mixed in (("fast", False), ("precise", True)):
        launches = contacts.LAUNCHES + contacts.MIXED_LAUNCHES
        r = flux_errors(fluxes(cfg._replace(mixed_precision=mixed),
                               torch.float32, dev), oracle)
        r["k1_launches"] = contacts.LAUNCHES + contacts.MIXED_LAUNCHES \
            - launches
        report[mode] = r
        t = r["total"]
        print(f"[{mode}] total flux rel err: max {t['max']:.3e}  p99 "
              f"{t['p99']:.3e}  median {t['median']:.3e}  (limits "
              f"5e-2 / 1e-4 / 1e-6: {'pass' if r['ok'] else 'FAIL'})")
        for name in COMPONENTS:
            print(f"  {name:6s}: max {r[name]['max']:.3e}  p99 "
                  f"{r[name]['p99']:.3e}")

    # contact phases of the disc's elements, float32 on the device against
    # float64 on the CPU
    q64 = torch.tensor([0.15], dtype=torch.float64)
    x1 = xl1(q64)
    pl1 = l1_potential(q64, x1)
    incl = findi(q64, torch.tensor([0.04], dtype=torch.float64), x1, pl1)
    pos, _ = comp.disc_elements(*(torch.tensor([v], dtype=torch.float64)
                                  for v in (0.011, 0.25, 1.5)), 24, 40)
    rows = [q64, incl, pos[..., 0], pos[..., 1], x1, pl1,
            inscribed_radius(q64, x1, pl1)]
    i64 = [a.numpy() for a in contacts.element_intervals_plain(*rows)]
    with torch.inference_mode():
        i32 = [a.cpu().numpy() for a in contacts.element_intervals(
            *(a.to(device=dev, dtype=torch.float32) for a in rows))]
    ecl = i64[2].astype(bool)
    report["contacts"] = {"elements": int(ecl.size),
                          "flag_agreement": float((i64[2] == i32[2]).mean())}
    for name, a, b in (("phi_in", i64[0], i32[0]),
                       ("phi_out", i64[1], i32[1])):
        e = np.abs(a - b.astype(np.float64))[ecl]
        report["contacts"][name] = {"max": float(e.max()),
                                    "median": float(np.median(e))}
        print(f"  contact {name}: max {e.max():.3e}  median "
              f"{np.median(e):.3e} (cycles, eclipsed elements)")
    print(f"  eclipsed-flag agreement: "
          f"{report['contacts']['flag_agreement']:.4f}")
    print(json.dumps(report))
    return 0 if report["fast"]["ok"] and report["precise"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
