#!/usr/bin/env python3
"""Run the port's fit command on the demo input on one CUDA card, and time
it.

    python3 tools/torch_demo_fit.py OUTDIR [fit options ...]

Runs ``lfit_python_tpu_torch.cli.main(["fit", "examples/demo_input.dat",
"--outdir", OUTDIR, "--quiet", ...])`` in this process (the demo's 1024
walkers, 300 burn-in and 300 production steps, float32, full resolution,
unless the options say otherwise) and prints the fit's own output, then
one JSON line: the exit code, the wall seconds of the call, the fit's
printed total (burn-in and production, after the walker ball) and
ln-prob evaluations per second, the seconds per step (that total over the
steps metrics.jsonl counts), the kept chain's shape, and the card's name
and power limit as nvidia-smi gives them.

The fit is host-bound: compare two checkouts only within one call, in
turns.
"""

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    import torch

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.utils.chains import read_chain

    out_dir, extra = Path(sys.argv[1]), sys.argv[2:]
    if not torch.cuda.is_available():
        raise SystemExit("torch_demo_fit: no CUDA card")
    shutil.rmtree(out_dir, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit", str(ROOT / "examples" / "demo_input.dat"),
                       "--outdir", str(out_dir), "--quiet", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="")
    total = re.search(r"^total ([\d.]+)s, ~(\d+) ln-prob evals/s$", text,
                      re.M)
    last = {}
    for ln in (out_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(ln)
        last[rec["stage"]] = rec["step"]
    n_steps = sum(last.values())
    s_step = float(total.group(1)) / n_steps if total and n_steps else None
    chain, _, _ = read_chain(out_dir / "chain_prod.txt")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "rc": rc, "wall_s": wall,
        "total_s": float(total.group(1)) if total else None,
        "evals_per_s": int(total.group(2)) if total else None,
        "steps": n_steps, "s_per_step": s_step,
        "chain_shape": list(chain.shape),
        "card": smi, "torch": torch.__version__}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
