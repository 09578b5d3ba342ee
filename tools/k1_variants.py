#!/usr/bin/env python3
"""Time variants of K1's float64 and mixed-precision kernels on one CUDA
card, in turns, against the checkout's own source and a parent's.

    python3 tools/k1_variants.py [PARENT_ROOT] [--out DIR]

Builds ``lfit_python_tpu_torch/ops/csrc/contacts.cu`` as it stands, each
variant of it named in ``VARIANTS`` (a text substitution of one design
choice: a ``__launch_bounds__`` minimum, unfused float64 arithmetic, IEEE
divides for the steering quotients or the constants, the mixed tails one
edge after the other, the libm sin / cos), and PARENT_ROOT's contacts.cu
where given, each by nvcc with the port's flags, all at once.  Then, on
the contact rows one float64 and one precise north-star evaluation hand
K1 (1024 walkers: 5120 x 512) and one half-step of the demo fit (512
walkers of examples/demo_input.dat: 512 x 512), it times each library's
float64 and mixed kernel by CUDA events (20 launches, the C entry point
alone), every library once in order and once in reverse, and holds its
outputs to the plain version of the mode.  Prints one JSON line per
library: ptxas registers and stack frame of each kernel; per row set and
mode, the times, the flag disagreement, max |dphi| at the elements
eclipsed in both, the share of those above 1e-12 (float64) or 1e-7
cycles (mixed), and whether its outputs are the checkout's bits.  Each
library, its ptxas report and its ``cuobjdump -sass`` go under --out
(build/k1_variants).
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import _short_entry, _stack_frames  # noqa: E402
from torch_eval_turns import event_ms, k1_mode_rows, walkers  # noqa: E402

SOURCE = ROOT / "lfit_python_tpu_torch" / "ops" / "csrc" / "contacts.cu"
KERNEL_T = ("template <typename T>\n"
            "__global__ void __launch_bounds__(kBlock, kMinBlocks)\n")
MIXED = ("__global__ void __launch_bounds__(kBlock, kMinBlocks)\n"
         "contacts_mixed_kernel(")


def f64_min_blocks(k):
    """__launch_bounds__(128, k) on the float64 instantiation alone (no
    minimum for k = 0)."""
    bounds = "(kBlock)" if k == 0 else "(kBlock, MinBlocks<T>::value)"
    return [(KERNEL_T, (
        "template <typename T> struct MinBlocks { enum { value = 1 }; };\n"
        "template <> struct MinBlocks<double> "
        f"{{ enum {{ value = {k} }}; }};\n"
        + KERNEL_T.replace("(kBlock, kMinBlocks)", bounds)))]


def mixed_min_blocks(k):
    """__launch_bounds__(128, k) on the mixed kernel (no minimum for
    k = 0)."""
    return [(MIXED, MIXED.replace("kMinBlocks", str(k)) if k else
             MIXED.replace("(kBlock, kMinBlocks)", "(kBlock)"))]


INTERLEAVED = """#pragma unroll 1
        for (int it = 0; it < kEdgeItersF64; ++it) {
            tail_step(u, x, sc[1], sc[2], ta);
            tail_step(u, x, sc[1], sc[2], tb);
        }"""
SEQUENTIAL = """#pragma unroll 1
        for (int it = 0; it < kEdgeItersF64; ++it)
            tail_step(u, x, sc[1], sc[2], ta);
#pragma unroll 1
        for (int it = 0; it < kEdgeItersF64; ++it)
            tail_step(u, x, sc[1], sc[2], tb);"""
VARIANTS = {
    **{f"f64_min_blocks_{k}": f64_min_blocks(k) for k in (0, 4, 5, 6, 8)},
    "f64_unfused": [
        ("c) { return fma(a, b, c); }", "c) { return a * b + c; }"),
        ("    return fma(t, t, fma(2.0 * b, t, c));",
         "    return t * t + 2.0 * b * t + c;")],
    "f64_ieee_steer": [("    return fma(-n, rcp_(d), x);",
                        "    return x - n / d;")],
    "f64_constant_divides": [
        ("K1_FN double over_pi(double x) { return x * kInvPi; }",
         "K1_FN double over_pi(double x) { return x / kPi; }"),
        ("K1_FN double over_two_pi(double x) { return x * kInvTwoPi; }",
         "K1_FN double over_two_pi(double x) { return x / kTwoPi; }")],
    "mixed_sequential_tails": [(INTERLEAVED, SEQUENTIAL)],
    "mixed_libm_sin_cos": [
        ("    sincospi(2.0 * phi, &s, &c);",
         "    s = sin(kTwoPi * phi);\n    c = cos(kTwoPi * phi);"),
        ("    sincospif(2.0f * (float)g.phi, &s32, &c32);",
         "    const float th = float(kTwoPi) * (float)g.phi;\n"
         "    s32 = sinf(th);\n    c32 = cosf(th);")],
    **{f"mixed_min_blocks_{k}": mixed_min_blocks(k) for k in (0, 6, 8)},
}
TIGHT = {"f64": 1e-12, "mixed": 1e-7}


def variant_text(subs):
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant text not in contacts.cu: {old!r}")
        text = text.replace(old, new)
    return text


def build(name, text, out):
    from lfit_python_tpu_torch.ops import _build

    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "contacts.cu").write_text(text)
    so = d / "libcontacts.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(so), str(d / "contacts.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    (d / "ptxas.txt").write_text(proc.stderr)
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")),
                           "-sass", str(so)], capture_output=True, text=True)
    (d / "sass.txt").write_text(sass.stdout)
    lib = ctypes.CDLL(str(so))
    f64 = lib.contacts_launch
    f64.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    mixed = lib.contacts_mixed_launch
    mixed.argtypes = ([ctypes.c_void_p] * 9
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    for fn in (f64, mixed):
        fn.restype = ctypes.c_int
    frames = {_short_entry(e): {"registers": r, "stack_frame_bytes": b}
              for e, (b, r) in _stack_frames(proc.stderr).items()}
    return {"f64": f64, "mixed": mixed}, frames


def launcher(contacts, mode, fn, args):
    """() -> None launching ``fn`` (a variant's C entry) on the wrapper
    arguments ``args`` of ``mode``, and the outputs it writes."""
    q, incl, px, py, x1, pl1, r_ins = args[:7]
    rows, n = px.shape
    scal = contacts._row_scalars(q, incl, x1, pl1, r_ins)
    out = (torch.empty_like(px), torch.empty_like(px),
           torch.empty((rows, n), dtype=torch.bool, device=px.device))
    ptrs = [t.data_ptr() for t in out] + [
        rows, n, torch.cuda.current_stream().cuda_stream]
    scal64 = None
    if mode == "f64":
        call = (1, scal.data_ptr(), px.data_ptr(), py.data_ptr(), *ptrs)
    else:
        q64, incl64, _, pl164 = args[7]
        scal64 = torch.stack([q64 / (1.0 + q64),
                              torch.sin(torch.deg2rad(incl64)), pl164],
                             dim=-1).contiguous()
        call = (scal.data_ptr(), scal64.data_ptr(), px.data_ptr(),
                py.data_ptr(), args[8][0].data_ptr(), args[8][1].data_ptr(),
                *ptrs)
    def run():
        err = fn(*call)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    run.inputs = (scal, scal64)     # the kernel reads them by address
    return run, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--out", default=str(ROOT / "build" / "k1_variants"))
    a = ap.parse_args()
    out = Path(a.out)
    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.ops import contacts
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)

    texts = {"tree": SOURCE.read_text(),
             **{k: variant_text(v) for k, v in VARIANTS.items()}}
    if a.parent:
        texts["parent"] = (Path(a.parent) / SOURCE.relative_to(ROOT)
                           ).read_text()
    with ThreadPoolExecutor(len(texts)) as pool:
        futs = {k: pool.submit(build, k, t, out) for k, t in texts.items()}
        libs = {k: f.result() for k, f in futs.items()}

    model = build_model(n_eclipses=5, complex_spot=[False] * 5, n_points=128,
                        bands=("g", "r")).compile()
    demo = build_model_from_config(parse_input_dat(
        ROOT / "examples" / "demo_input.dat")).compile()
    sets = {}
    for tag, m, p in (("5120", model, walkers(model.var_start(), 1024, 0)),
                      ("512", demo, walkers(demo.var_start(), 512, 2))):
        for mode, (_, args) in k1_mode_rows(contacts, m, p).items():
            kw = ({} if mode == "f64" else
                  dict(precise=args[7], p64=args[8]))
            plain = contacts.element_intervals_plain(*args[:7], **kw)
            sets[tag, mode] = (args, plain)

    order = list(libs)
    res = {k: {"frames": libs[k][1], "rows": {}} for k in order}
    for (tag, mode), (args, plain) in sets.items():
        runs = {k: launcher(contacts, mode, libs[k][0][mode], args)
                for k in order}
        times = {k: [] for k in order}
        for k in order + order[::-1]:
            times[k].append(event_ms(runs[k][0], 20))
        torch.cuda.synchronize()
        ref_out = runs["tree"][1]
        for k in order:
            got = runs[k][1]
            both = got[2] & plain[2]
            err = torch.cat([(got[i] - plain[i]).abs()[both].double()
                             for i in (0, 1)])
            res[k]["rows"][f"{mode}_{tag}"] = {
                "ms": times[k],
                "flag_disagreement": (got[2] != plain[2]).float().mean()
                .item(),
                "max_abs_err": err.max().item(),
                "share_above_tight": (err > TIGHT[mode]).double().mean()
                .item(),
                "tree_bits": all(torch.equal(x, y)
                                 for x, y in zip(got, ref_out))}
    print(json.dumps({"card": torch.cuda.get_device_name(0)}))
    for k in order:
        print(json.dumps({"library": k, **res[k]}))


if __name__ == "__main__":
    main()
