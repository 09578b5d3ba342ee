#!/usr/bin/env python3
"""Time builds of ``sweeps.cu`` side by side in turns on one CUDA card:
K7, K8 and their backward kernels on the north star's inputs.

    python3 tools/torch_sweeps_variants.py [--parent TREE] [--only A,B]

Each entry of ``VARIANTS`` is this checkout's ``sweeps.cu`` built with
its ``-D`` flags and its text substitutions ("kept": the source as it
stands); ``--parent`` adds TREE's ``sweeps.cu`` as it stands (any tree
whose launchers take the same arguments), ``--only`` keeps the labels
named.  Every source is built at once with nvcc and the port's flags into
``build/sweeps_variants/`` and launched through its C entry points.  The
inputs are the arguments one float32 evaluation of the north-star model
at 1024 walkers hands K7 (the disc's rows without widths, 5120 x 128 x
960: ``k7_disc``) and K8 (the donor curve, 5120 x 128 x 384, and its
normaliser, 5120 x 1 x 384), and one value_and_grad of the same model
with .calib exposure widths at 256 chains hands K7 (the disc's rows with
widths, 1280 x 128 x 960: ``k7w_disc``), K7's backward kernel (the same
rows) and K8's (the donor curve, 1280 x 128 x 384, and its normaliser,
1280 x 1 x 384: ``k8b_curve``, ``k8b_normaliser``), float32 and cast to
float64.  It prints one JSON line with, for each build and case: the
forward kernels' bits against their plain versions (``same_bits``), the
backward kernels' largest distance from autograd on the plain forward in
float64 over the largest |gradient| of each cotangent (``rel_err``), a
SHA-256 of the outputs; the device time as the
profiler traces it (the least of 5 launches, every build in one profiler
window: only a process's first keeps every record); us a launch over
back-to-back launches between two CUDA events, in turns (each turn runs
the builds in the opposite order to the last); ptxas's registers, stack
frame and spills of each build's kernels; and the instructions per term
of its SASS (``tools/sweeps_sass_counts.py`` on ``cuobjdump -sass``).
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
SOURCE = ROOT / "lfit_python_tpu_torch" / "ops" / "csrc" / "sweeps.cu"
OUT = ROOT / "build" / "sweeps_variants"
F32, F64 = torch.float32, torch.float64
# label: (-D flags, [(text, its replacement)]) on this checkout's source
VARIANTS = {
    "kept": ((), ()),
    # K7's backward: slabs a lane and warps a block (the disc's 30 slabs)
    "k7b_2slabs_16warps": (("K7B_SLABS=2", "K7B_WARPS=16"), ()),
    "k7b_1slab_32warps": (("K7B_SLABS=1", "K7B_WARPS=32"), ()),
    # K7's backward's minimum and clamp by compare and select in float32
    # too, not min.NaN / max.NaN
    "k7b_select_minmax": ((), tuple(
        (f"#ifdef __CUDA_ARCH__\n  float r;\n  asm(\"{op}.NaN",
         f"#if 0\n  float r;\n  asm(\"{op}.NaN") for op in ("min", "max"))),
    # K8: a warp a (row, phase) pair at every P, and a thread a phase at
    # every P (the layout of rows of 32 phases or more)
    "k8_lanes_everywhere": (("DONOR_LANES_BELOW=2147483647",), ()),
    "k8_threads_everywhere": (("DONOR_LANES_BELOW=1",), ()),
    # K8's backward: slabs a lane and warps a block (the grid's 12 slabs:
    # 6 slab groups x 2 phase groups, 2 x 6, 3 x 5)
    "k8b_2slabs": (("K8B_SLABS=2",), ()),
    "k8b_6slabs": (("K8B_SLABS=6",), ()),
    "k8b_16warps": (("K8B_WARPS=16",), ()),
    # K7 without widths in float32: one phase a thread; K7 at most 85
    # registers (6 blocks of 128 threads an SM)
    "k7_1phase": (("K7_PHASES=1",), ()),
    "k7_6blocks": ((), ((
        "__launch_bounds__(SWEEP_THREADS)\nelement_curve_kernel(",
        "__launch_bounds__(SWEEP_THREADS, 6)\nelement_curve_kernel("),)),
    # K7 without widths: the floor on every term (its fused sum kept); with
    # widths: the divide on every term
    "k7_floor_everywhere": ((), ((
        "FAST ? rel_near(d) : d - floor_(d)", "d - floor_(d)"),)),
    "k7_divide_everywhere": ((), ((
        "fast = wc <= quot_wc_max<T>();", "fast = false;"),)),
}


def _build_one(label, src, defines, text=None):
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    flags = (*_build.NVCC_FLAGS, *(f"-D{d}" for d in defines))
    body = src.read_bytes() if text is None else text.encode()
    key = hashlib.sha256(body + " ".join(flags).encode()).hexdigest()[:16]
    out = OUT / f"{label}-{key}"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "sweeps.cu"
    cu.write_bytes(body)
    proc = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v", "-o",
                           str(out / "libsweeps.so"), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {label}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    sass = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
         str(out / "libsweeps.so")], capture_output=True, text=True,
        check=True).stdout
    return label, out / "libsweeps.so", proc.stderr, sass


def build(labels, parent=None):
    """{label: (ctypes library, ptxas log, SASS listing)}; every nvcc
    started at once.  Raises with nvcc's output if a build fails."""
    jobs = []
    text = SOURCE.read_text()
    for label in labels:
        defines, subs = VARIANTS[label]
        t = text
        for old, new in subs:
            if t.count(old) != 1:
                raise RuntimeError(f"{label}: {old!r} is not in the source "
                                   f"once")
            t = t.replace(old, new)
        jobs.append((label, SOURCE, defines, t))
    if parent is not None:
        jobs.append(("parent", Path(parent) / SOURCE.relative_to(ROOT), (),
                     None))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: _build_one(*j), jobs))
    libs = {}
    i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    types = {"element_curve_launch": [i, i] + [p] * 7 + [i] * 3 + [p],
             "element_curve_backward_launch": [i, i] + [p] * 11 + [i] * 3
             + [p],
             "donor_sum_launch": [i] + [p] * 3 + [d, d, p] + [i] * 4 + [p],
             "donor_sum_backward_launch": [i] + [p] * 3 + [d, d] + [p] * 4
             + [i] * 4 + [p]}
    for label, so, log, sass in built:
        lib = ctypes.CDLL(str(so))
        for name, argtypes in types.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[label] = (lib, log, sass)
    return libs


def ptxas(log):
    """{kernel entry: [registers, stack frame bytes, spilled bytes]} of
    K7, K8 and their backward kernels in a ``-Xptxas -v`` log."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z\d+(element_curve|"
                      r"donor_sum)\w*_kernel\w*)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if entry and m:
            out[entry] = [None, int(m.group(1)),
                          int(m.group(2)) + int(m.group(3))]
        m = re.search(r"Used (\d+) registers", line)
        if entry and m and entry in out:
            out[entry][0] = int(m.group(1))
            entry = None
    return out


def north_star_inputs(dev):
    """{case: args}: the float32 arguments of the wrappers
    ``element_curve_kernel`` (the disc's call of an evaluation,
    ``k7_disc``, and of a gradient evaluation, ``k7w_disc``),
    ``donor_sum_kernel`` (an evaluation's two calls),
    ``element_curve_backward_kernel`` (a gradient evaluation's disc call)
    and ``donor_sum_backward_kernel`` (a gradient evaluation's two
    calls)."""
    sys.path.insert(0, str(ROOT))
    from torch_eval_turns import walkers

    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import sweeps

    spec = dict(n_eclipses=5, complex_spot=[False] * 5, n_points=128,
                bands=("g", "r"))
    model = build_model(**spec).compile()
    lp = make_ln_prob(model, dtype=F32, device=dev)
    lpw = make_ln_prob(with_calib_widths(build_model(**spec)).compile(),
                       dtype=F32, device=dev)

    def recorded(run):
        names = ("element_curve", "element_curve_backward", "donor_sum",
                 "donor_sum_backward")
        with contextlib.ExitStack() as stack:
            rec = {n: stack.enter_context(mock.patch.object(
                sweeps, f"{n}_kernel", wraps=getattr(sweeps, f"{n}_kernel")))
                for n in names}
            run()
        return {n: [[a.detach() if isinstance(a, torch.Tensor) else a
                     for a in c.args] for c in r.call_args_list]
                for n, r in rec.items()}

    def forward():
        with torch.inference_mode():
            lp(walkers(model.var_start(), 1024, 0))
    fwd = recorded(forward)
    grad = recorded(lambda: lpw.value_and_grad(
        walkers(model.var_start(), 256, 1)))

    def disc(calls):
        return max(calls, key=lambda a: a[2].shape[-1])

    def by_phases(calls):
        return sorted(calls, key=lambda a: -a[0].shape[1])
    return {"k7_disc": disc(fwd["element_curve"]),
            "k7w_disc": disc(grad["element_curve"]),
            "k8_curve": fwd["donor_sum"][0],
            "k8_normaliser": fwd["donor_sum"][1],
            "k7b_disc": disc(grad["element_curve_backward"]),
            **dict(zip(("k8b_curve", "k8b_normaliser"),
                       by_phases(grad["donor_sum_backward"])))}


def _cast(args, dtype):
    return [a.to(dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point() else a for a in args]


def cases(inputs):
    """[(case, kernel, args, outputs, plain result)] for each input at
    float32 and float64."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.ops import sweeps

    out = []
    for name, args in inputs.items():
        for dt in (F32, F64):
            a = _cast(args, dt)
            tag = f"{name}_{str(dt)[6:]}"
            if name.startswith("k8b"):
                res = [torch.empty_like(x) for x in a[:3]]
                plain = sweeps._donor_backward_plain(*_cast(args, F64))
                out.append((tag, "donor_backward", a, res, list(plain)))
            elif name.startswith("k8"):
                e, nrm, areas, u = a
                res = [torch.empty(e.shape[:2], dtype=dt, device=e.device)]
                plain = [comp._donor_sum_plain(e, nrm, areas, u)]
                out.append((tag, "donor", a, res, plain))
            elif name.startswith("k7b"):
                res = [torch.empty_like(a[i]) for i in (0, 2, 3, 5)]
                plain = sweeps._curve_backward_plain(*_cast(args, F64))
                out.append((tag, "curve_backward", a, res, list(plain)))
            else:
                res = [torch.empty_like(a[0])]
                plain = [comp._element_curve_plain(*a)]
                out.append((tag, "curve", a, res, plain))
    return out


def launcher(lib, kernel, a, res):
    """A function of no arguments that launches ``kernel`` of ``lib`` on
    ``a`` into ``res`` on the current stream; raises if the launch
    fails.  Its arguments are read once, here."""
    stream = torch.cuda.current_stream().cuda_stream
    dbl = int(res[0].dtype == F64)
    if kernel.startswith("donor"):
        e, nrm, areas, u = a[:4]
        (R, P), (G, N) = e.shape[:2], areas.shape
        fn = lib.donor_sum_launch
        call = (dbl, e.data_ptr(), nrm.data_ptr(), areas.data_ptr(),
                1.0 - u, float(u), *(x.data_ptr() for x in (*a[4:], *res)),
                R, P, N, R // G, stream)
        if kernel == "donor_backward":
            fn = lib.donor_sum_backward_launch
    elif kernel == "curve":
        ph, wd, pin, pout, ecl, w = a
        (R, P), N = ph.shape, pin.shape[1]
        fn = lib.element_curve_launch
        call = (dbl, int(wd is not None), ph.data_ptr(),
                None if wd is None else wd.data_ptr(), pin.data_ptr(),
                pout.data_ptr(), ecl.data_ptr(), w.data_ptr(),
                res[0].data_ptr(), R, P, N, stream)
    else:
        ph, wd, pin, pout, ecl, w, g = a
        (R, P), N = ph.shape, pin.shape[1]
        fn = lib.element_curve_backward_launch
        call = (dbl, 1, ph.data_ptr(), wd.data_ptr(), pin.data_ptr(),
                pout.data_ptr(), ecl.data_ptr(), w.data_ptr(), g.data_ptr(),
                *(r.data_ptr() for r in res), R, P, N, stream)

    def go():
        err = fn(*call)
        if err != 0:
            raise RuntimeError(f"{kernel}: cudaError {err}")
    return go


def measure(libs, inputs, reps=20, n_turns=4):
    """{label: {case: {...}}} for each build of ``libs`` (``build``'s)
    and each case of ``inputs`` (``north_star_inputs``'s)."""
    cs = cases(inputs)
    run = {(label, i): launcher(libs[label][0], k, a, res)
           for label in libs for i, (_, k, a, res, _) in enumerate(cs)}
    out = {label: {} for label in libs}
    for i, (tag, kernel, a, res, plain) in enumerate(cs):
        for label in libs:
            run[label, i]()
            torch.cuda.synchronize()
            r = {"sha256": hashlib.sha256(b"".join(
                x.cpu().numpy().tobytes() for x in res)).hexdigest()[:16]}
            if kernel in ("donor", "curve"):
                k, p = res[0], plain[0]
                nan = torch.isnan(k)
                r["same_bits"] = bool(torch.equal(nan, torch.isnan(p))
                                      and torch.equal(k[~nan], p[~nan]))
            else:
                r["rel_err"] = [
                    float(torch.nan_to_num(x.double() - y).abs().max())
                    / max(float(torch.nan_to_num(y).abs().max()), 1e-300)
                    for x, y in zip(res, plain)]
            out[label][tag] = r
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    order = [(label, i) for i in range(len(cs)) for label in libs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, i in order:
            for _ in range(5):
                run[label, i]()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA and re.search(
                       r"\b(element_curve|donor_sum)(_backward)?_kernel\b",
                       e.name)), key=lambda e: e.time_range.start)
    if len(kern) != 5 * len(order):
        raise RuntimeError(f"the trace holds {len(kern)} sweep kernels of "
                           f"{5 * len(order)} launched")
    for k, (label, i) in enumerate(order):
        out[label][cs[i][0]]["traced_us"] = min(
            e.time_range.elapsed_us() for e in kern[5 * k:5 * k + 5])
    for i, tag in enumerate(c[0] for c in cs):
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
            out[label][tag].update(us=statistics.median(us), us_turns=us)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a tree whose sweeps.cu is timed too")
    ap.add_argument("--only", help="the VARIANTS labels to build, by commas")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    labels = args.only.split(",") if args.only else list(VARIANTS)
    libs = build(labels, parent=args.parent)
    res = measure(libs, north_star_inputs(torch.device("cuda", 0)))
    sys.path.insert(0, str(ROOT / "tools"))
    from sweeps_sass_counts import counts

    sass = {}
    for label, (_, _, listing) in libs.items():
        sass[label] = {k: {c: v.get(c) for c in ("per_term",
                                                 "issue_cycles_per_term",
                                                 "cycles_per_term")}
                       for k, v in counts(listing).items()}
    print(json.dumps({"card": smi, "variants": {
        lb: {"defines": VARIANTS[lb][0], "substitutions": len(VARIANTS[lb][1])}
        for lb in labels},
        "ptxas": {lb: ptxas(log) for lb, (_, log, _) in libs.items()},
        "sass_per_term": sass, "kernels": res}))
    if not all(c.get("same_bits", True) for r in res.values()
               for c in r.values()):
        raise SystemExit("a build's K7 or K8 differs from its plain "
                         "version")


if __name__ == "__main__":
    main()
