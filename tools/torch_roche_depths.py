#!/usr/bin/env python3
"""Time K4 (``findi_kernel``), K5 (``xl1_kernel``) and K6
(``lobe_radius_kernel``) of ``roche.cu`` at each group depth d, and
optionally another tree's ``roche.cu`` beside them, in turns on one CUDA
card.

    python3 tools/torch_roche_depths.py [--parent TREE]

``roche.cu`` builds K4-K6 at one depth each (``FINDI_DEPTH``,
``XL1_DEPTH``, ``LOBE_DEPTH``: 2^d lanes a solve).  This builds the
checkout's source once for each d of DEPTHS with ``-DFINDI_DEPTH=d
-DXL1_DEPTH=d -DLOBE_DEPTH=d`` (nvcc with the port's flags, all builds
at once, into ``build/roche_depths/``) and, with ``--parent``, TREE's
``roche.cu`` as it stands (any tree whose launchers take the same
arguments: one whose K5 runs one thread a solve, say), and launches each
through its C entry point.  The inputs are the north star's: the
arguments one float32 evaluation at 1024 walkers hands K4, K5 and K6
(1024 solves each; its first K6 call, where a tree makes two), and the
same cast to float64.  It prints one JSON line with,
for each build, kernel and dtype: whether the output has the plain
loop's bits and a SHA-256 of it; the device time as the profiler traces
it (the least of 5 launches, in the process's one profiler window); us
a launch over back-to-back launches between two CUDA events (their
arguments bound once, so that the card sets the pace), in turns (each
turn runs the builds in the opposite order to the last); and ptxas's
registers and stack frame of each build's kernels.
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "lfit_python_tpu_torch" / "ops" / "csrc" / "roche.cu"
OUT = ROOT / "build" / "roche_depths"
# the group depths timed (2^d lanes a solve; a warp holds at most 32)
DEPTHS = (3, 4, 5)
# each kernel's launcher and its number of input arrays
LAUNCHERS = {"findi": 4, "xl1": 1, "lobe_radius": 6}
F32, F64 = torch.float32, torch.float64


def build(depths=DEPTHS, parent=None):
    """{label: (ctypes library, ptxas log)}: ``d<d>`` for the checkout's
    roche.cu at each depth, ``parent`` for ``parent``'s roche.cu as it
    stands; every nvcc started at once.  Raises with nvcc's output if a
    build fails."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    jobs = {f"d{d}": (SOURCE, (f"-DFINDI_DEPTH={d}", f"-DXL1_DEPTH={d}",
                               f"-DLOBE_DEPTH={d}"))
            for d in depths}
    if parent is not None:
        jobs["parent"] = (Path(parent) / SOURCE.relative_to(ROOT), ())

    def one(label):
        src, defines = jobs[label]
        flags = (*_build.NVCC_FLAGS, *defines)
        key = hashlib.sha256(src.read_bytes()
                             + " ".join(flags).encode()).hexdigest()[:16]
        out = OUT / f"{label}-{key}"
        out.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v",
                               "-o", str(out / "libroche.so"), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label} ({src}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        return label, out / "libroche.so", proc.stderr

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(one, jobs))
    libs = {}
    for label, so, log in built:
        lib = ctypes.CDLL(str(so))
        for name, n_in in LAUNCHERS.items():
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (n_in + 1)
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[label] = (lib, log)
    return libs


def launcher(lib, name, args, out, iters):
    """A function of no arguments that launches ``name`` ("findi", "xl1"
    or "lobe_radius") from a library of ``build`` on the contiguous card
    tensors ``args``, into ``out``, on the current stream, and raises if
    the launch fails.  Its arguments are read once, here, so that
    back-to-back launches are paced by the card rather than the host."""
    fn = getattr(lib, f"{name}_launch")
    call = (int(out.dtype == F64), *(t.data_ptr() for t in args),
            out.data_ptr(), out.numel(), iters,
            torch.cuda.current_stream().cuda_stream)

    def go():
        err = fn(*call)
        if err != 0:
            raise RuntimeError(f"{name}_launch: cudaError {err}")
    return go


def ptxas(log):
    """{``findi_kernel<f32>``: (registers, stack frame bytes)} of K4-K6's
    instantiations in a ``-Xptxas -v`` log."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?_kernel)I([fd])",
                      line)
        if m:
            entry = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'f64'}>"
        m = re.search(r"(\d+) bytes stack frame", line)
        if entry and m:
            out[entry] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if entry and m and entry in out:
            out[entry][0] = int(m.group(1))
            entry = None
    return {e: tuple(v) for e, v in out.items()
            if e.split("_kernel")[0] in LAUNCHERS}


def north_star_inputs(dev):
    """{"findi": args, "xl1": args, "lobe_radius": args}: the arguments
    one float32 evaluation of the north-star model at 1024 walkers hands
    K4, K5 and (its first call) K6."""
    sys.path.insert(0, str(ROOT))
    from torch_eval_turns import walkers

    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import roche

    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    lp = make_ln_prob(model, dtype=F32, device=dev)
    recs = {n: mock.patch.object(roche, f"{n}_kernel",
                                 wraps=getattr(roche, f"{n}_kernel"))
            for n in LAUNCHERS}
    with contextlib.ExitStack() as stack, torch.inference_mode():
        rec = {n: stack.enter_context(r) for n, r in recs.items()}
        lp(walkers(model.var_start(), 1024, 0))
    return {n: r.call_args_list[0].args for n, r in rec.items()}


def measure(libs, inputs, reps=200, n_turns=4, traced=True):
    """{label: {"findi_float32": {...}, ...}} for each build of ``libs``
    (``build``'s), each kernel of ``inputs`` ({name: its float32
    arguments, on the card}), float32 and float64: ``same_bits`` against
    the plain loop, ``sha256``, ``us`` (us a launch over ``reps`` back-to-back launches,
    the median of ``n_turns`` turns; each turn in ``us_turns``) and, if
    ``traced``, ``traced_us`` (the least device time of 5 launches, all
    in one profiler window: only a process's first keeps every record)."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.roche import geometry

    loops = {"findi": (geometry._findi_loop, geometry._FINDI_ITERS),
             "xl1": (geometry._xl1_loop, geometry._XL1_ITERS),
             "lobe_radius": (geometry._lobe_loop, geometry._LOBE_ITERS)}
    cases = []
    for name, args in inputs.items():
        for dt in (F32, F64):
            a = [t.to(dt).contiguous() for t in args]
            cases.append((name, str(dt)[6:], a, torch.empty_like(a[0])))
    run = {(label, i): launcher(libs[label][0], name, a, out,
                                loops[name][1])
           for label in libs for i, (name, _, a, out) in enumerate(cases)}

    res = {label: {} for label in libs}
    for i, (name, dt, a, out) in enumerate(cases):
        with torch.inference_mode():
            ref = loops[name][0](*a)
        for label in libs:
            run[label, i]()
            torch.cuda.synchronize()
            nan = torch.isnan(out)
            same = (torch.equal(nan, torch.isnan(ref))
                    and torch.equal(out[~nan], ref[~nan]))
            res[label][f"{name}_{dt}"] = {
                "solves": out.numel(), "same_bits": bool(same),
                "sha256": hashlib.sha256(
                    out.cpu().numpy().tobytes()).hexdigest()[:16]}
    if traced:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        order = [(label, i) for i in range(len(cases)) for label in libs]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for label, i in order:
                for _ in range(5):
                    run[label, i]()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and re.search(
                           r"\b(findi|xl1|lobe_radius)_kernel\b", e.name)),
                      key=lambda e: e.time_range.start)
        if len(kern) != 5 * len(order):
            raise RuntimeError(f"the trace holds {len(kern)} K4-K6 "
                               f"kernels of {5 * len(order)} launched")
        for k, (label, i) in enumerate(order):
            name, dt = cases[i][:2]
            res[label][f"{name}_{dt}"]["traced_us"] = min(
                e.time_range.elapsed_us() for e in kern[5 * k:5 * k + 5])
    for i, (name, dt) in enumerate(c[:2] for c in cases):
        turns = {label: [] for label in libs}
        for t in range(n_turns):
            for label in (list(libs) if t % 2 == 0 else list(libs)[::-1]):
                for _ in range(3):
                    run[label, i]()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    run[label, i]()
                end.record()
                torch.cuda.synchronize()
                turns[label].append(start.elapsed_time(end) / reps * 1e3)
        for label, us in turns.items():
            res[label][f"{name}_{dt}"].update(
                us=statistics.median(us), us_turns=us)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a tree whose roche.cu is timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    libs = build(parent=args.parent)
    res = measure(libs, north_star_inputs(dev))
    print(json.dumps({"card": smi, "depths": DEPTHS,
                      "ptxas": {lb: ptxas(log) for lb, (_, log)
                                in libs.items()},
                      "kernels": res}))
    if not all(c["same_bits"] for r in res.values() for c in r.values()):
        raise SystemExit("a build differs from the plain loop")


if __name__ == "__main__":
    main()
