#!/usr/bin/env python3
"""Measure on one CUDA card how fast an SM issues a float floor
(``cvt.rmi``, SASS ``FRND.FLOOR``), a NaN-passing maximum (``max.NaN``,
``FMNMX``), a comparison to a float 0 or 1 (``set``, ``FSET.BF``) and a
comparison to a predicate (``setp``, ``FSETP``) against a float add
(``FADD``).

    python3 tools/conv_pipe_rate.py

Builds a small CUDA source (written below) with nvcc and the port's flags
into ``build/conv_pipe_rate/`` and launches through ctypes, on 8 blocks
of 256 threads an SM (64 warps), loops of 8 independent chains a thread,
each step of a chain one of:

- ``fadd``:        x = x + y                (FADD)
- ``frnd_fadd``:   x = floor(x + y)         (FADD, FRND.FLOOR)
- ``fmnmx_fadd``:  x = max.NaN(x + y, z)    (FADD, FMNMX)
- ``fset_fadd``:   x = x + (x < z)          (FSET.BF, FADD)
- ``fsetp_fadd``:  x = x + y where x < z    (FSETP, a predicated FADD)
- ``dfrnd_dadd``:  the float64 floor and add

The operations are inline PTX (``asm volatile``), so none is folded.  Each
loop is timed with CUDA events (the least of 5 launches) and its
instructions counted from the build's SASS (``cuobjdump``).  Prints one
JSON line: for each loop its ms, its steps, and the lanes a clock of each
SM its steps take at the SM clock ``nvidia-smi`` reads right after
(``steps_per_sm_clock``: 128 for an op the FP32 pipe issues at full rate),
with the card's name and power limit.  A loop of two instructions a step
whose steps run at a quarter of ``fadd``'s rate is bound by its second
instruction's pipe at 16 lanes an SM a clock.
"""

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "conv_pipe_rate"
CHAINS, THREADS, BLOCKS_PER_SM, ITERS = 8, 256, 8, 2048

SOURCE = r"""
#include <cuda_runtime.h>

#define CHAINS 8

__device__ __forceinline__ float op_fadd(float x, float y, float) {
  float r;
  asm volatile("add.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ float op_frnd_fadd(float x, float y, float) {
  float r;
  asm volatile("add.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  asm volatile("cvt.rmi.f32.f32 %0, %0;" : "+f"(r));
  return r;
}
__device__ __forceinline__ float op_fmnmx_fadd(float x, float y, float z) {
  float r;
  asm volatile("add.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  asm volatile("max.NaN.f32 %0, %0, %1;" : "+f"(r) : "f"(z));
  return r;
}
__device__ __forceinline__ float op_fset_fadd(float x, float, float z) {
  float r;
  asm volatile("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(z));
  asm volatile("add.f32 %0, %0, %1;" : "+f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float op_fsetp_fadd(float x, float y, float z) {
  asm volatile("{\n .reg .pred p;\n setp.lt.f32 p, %0, %2;\n"
               " @p add.f32 %0, %0, %1;\n}" : "+f"(x) : "f"(y), "f"(z));
  return x;
}
__device__ __forceinline__ double op_dfrnd_dadd(double x, double y,
                                                double) {
  double r;
  asm volatile("add.f64 %0, %1, %2;" : "=d"(r) : "d"(x), "d"(y));
  asm volatile("cvt.rmi.f64.f64 %0, %0;" : "+d"(r));
  return r;
}

#define LOOP(NAME, T)                                                      \
  __global__ void loop_##NAME(T* out, T y, T z, int iters) {               \
    T x[CHAINS];                                                           \
    _Pragma("unroll") for (int c = 0; c < CHAINS; ++c)                     \
        x[c] = T(threadIdx.x % 7) + T(c);                                  \
    for (int i = 0; i < iters; ++i) {                                      \
      _Pragma("unroll") for (int c = 0; c < CHAINS; ++c)                   \
          x[c] = op_##NAME(x[c], y, z);                                    \
    }                                                                      \
    T s = T(0);                                                            \
    _Pragma("unroll") for (int c = 0; c < CHAINS; ++c) s = s + x[c];       \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                        \
  }

LOOP(fadd, float)
LOOP(frnd_fadd, float)
LOOP(fmnmx_fadd, float)
LOOP(fset_fadd, float)
LOOP(fsetp_fadd, float)
LOOP(dfrnd_dadd, double)

extern "C" int launch(int which, void* out, int blocks, int threads,
                      int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0: loop_fadd<<<blocks, threads, 0, s>>>((float*)out, 0.5f, 0.25f,
                                                  iters); break;
    case 1: loop_frnd_fadd<<<blocks, threads, 0, s>>>((float*)out, 0.5f,
                                                       0.25f, iters); break;
    case 2: loop_fmnmx_fadd<<<blocks, threads, 0, s>>>((float*)out, 0.5f,
                                                        0.25f, iters); break;
    case 3: loop_fset_fadd<<<blocks, threads, 0, s>>>((float*)out, 0.5f,
                                                       0.25f, iters); break;
    case 4: loop_fsetp_fadd<<<blocks, threads, 0, s>>>((float*)out, 0.5f,
                                                        0.25f, iters); break;
    default: loop_dfrnd_dadd<<<blocks, threads, 0, s>>>((double*)out, 0.5,
                                                         0.25, iters);
  }
  return (int)cudaGetLastError();
}
"""
LOOPS = ("fadd", "frnd_fadd", "fmnmx_fadd", "fset_fadd", "fsetp_fadd",
         "dfrnd_dadd")


def build():
    """(ctypes library, SASS listing) of SOURCE, built with nvcc."""
    sys.path.insert(0, str(ROOT))
    from lfit_python_tpu_torch.ops import _build

    key = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    out = OUT / key
    out.mkdir(parents=True, exist_ok=True)
    (out / "rate.cu").write_text(SOURCE)
    so = out / "librate.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(out / "rate.cu")], check=True, capture_output=True,
                   text=True)
    sass = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    lib = ctypes.CDLL(str(so))
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] \
        * 3 + [ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    return lib, sass


def loop_ops(sass):
    """{loop: {opcode: count}} of each loop kernel's innermost loop body
    in the SASS listing."""
    sys.path.insert(0, str(ROOT / "tools"))
    from sweeps_sass_counts import _INS, loops

    out, cur, name = {}, None, None
    for ln in sass.splitlines() + ["Function : end"]:
        if "Function : " in ln:
            if cur:
                spans = loops(cur)
                lo, hi = min(spans, key=lambda s: s[1] - s[0])
                ops = {}
                for _, _, op, _ in cur[lo:hi + 1]:
                    ops[op] = ops.get(op, 0) + 1
                out[name] = ops
            cur = None
            for lp in LOOPS:
                if f"loop_{lp}P" in ln or f"loop_{lp}E" in ln or \
                        ln.rstrip().endswith(f"loop_{lp}"):
                    cur, name = [], lp
            continue
        m = _INS.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2) is not None,
                        m.group(3), m.group(4).strip()))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib, sass = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for which, name in enumerate(LOOPS):
        def go():
            err = lib.launch(which, out.data_ptr(), blocks, THREADS, ITERS,
                             stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        go()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            go()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        clock = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits"], capture_output=True, text=True,
            check=True).stdout.split()[0]) * 1e6
        steps = blocks * THREADS * ITERS * CHAINS
        ms = min(times)
        res[name] = {"ms": ms, "steps": steps, "sm_clock_hz": clock,
                     "steps_per_sm_clock": steps / (ms * 1e-3 * clock * sms)}
    base = res["fadd"]["steps_per_sm_clock"]
    for r in res.values():
        r["rate_vs_fadd"] = r["steps_per_sm_clock"] / base
    print(json.dumps({"card": smi, "loops": res,
                      "sass_loop_ops": loop_ops(sass)}))


if __name__ == "__main__":
    main()
