"""The readings that a cell's limits are set from: the program's numbers
compared on many seeds, and the control's, the reference put in the
program's place in the precision below the configuration's (:data:`BELOW`)
and, beside it for scale, in the configuration's own.

    python3 -m lfit_bench.control --workload NAME --seeds 1,2,3 \\
        --seconds 5 [--controls 3]

One process runs the cell on each seed in turn (the kernels built once),
each with a window of ``--seconds``, and prints one JSON line a seed:
its numbers and, for the first ``--controls`` seeds, the controls'.  With
``--fault NAME`` the stretch move runs with a fault planted in the port
(:data:`FAULTS`), for the readings of the numbers that a control in a
lower precision cannot read.  The benchmark's own runs make neither.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from . import run as bench

# the precision below each a configuration may state: the control's
BELOW = {"float64": "float32", "float32": "bfloat16", "bfloat16": "float16"}


def _accept_all(half_update):
    """Every proposal taken: the acceptance uniforms all 0."""
    def fn(movers, movers_lp, others, ln_prob, a, j, u, u_acc):
        return half_update(movers, movers_lp, others, ln_prob, a, j, u,
                           u_acc * 0)
    return fn


def _wrong_stretch(half_update):
    """z drawn for 1.5 a where the traffic states a."""
    def fn(movers, movers_lp, others, ln_prob, a, j, u, u_acc):
        return half_update(movers, movers_lp, others, ln_prob, 1.5 * a, j,
                           u, u_acc)
    return fn


# faults planted in the port's stretch move (its ``_half_update``)
FAULTS = {"accept_all": _accept_all, "wrong_stretch": _wrong_stretch}


def _num(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--fault", choices=sorted(FAULTS))
    a = p.parse_args(argv)
    import torch

    if a.fault:
        from lfit_python_tpu_torch.sampling import ensemble

        ensemble._half_update = FAULTS[a.fault](ensemble._half_update)

    stated = bench.load_cell(a.workload)["config"]["dtype"]
    pair = (getattr(torch, BELOW[stated]), getattr(torch, stated))
    for k, seed in enumerate(int(s) for s in a.seeds.split(",")):
        dts = pair if k < a.controls else ()
        result, rows = bench.run(a.workload, seed, a.seconds, False,
                                 controls=dts)
        line = {"seed": seed, "fault": a.fault,
                "correct": result["correct"],
                "numbers": {n: _num(v) for n, v, _ in rows},
                "controls": {d: {n: _num(v) for n, v in r.items()}
                             for d, r in result.get("controls", {}).items()},
                "metrics": {n: m["value"]
                            for n, m in result["metrics"].items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
