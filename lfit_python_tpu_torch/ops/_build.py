"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C entry point and loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds.  Libraries go to ``build/kernels/<hash>/`` beside
the package (the directory is listed in ``.gitignore``), keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is reused.  Nothing is built when a module is imported: the first
launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "BUILD_SECONDS", "PTXAS_LOGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}
# seconds spent in nvcc by this process, per source name
BUILD_SECONDS: dict = {}
# the ``-Xptxas -v`` report of each loaded library, per source name
PTXAS_LOGS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to the "
                           "directory that holds bin/nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu`` as a ``ctypes.CDLL``, building it
    on first use.  Raises on any build failure."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _BUILD_ROOT / digest
    so = out_dir / f"lib{name}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {src.name} (rc={proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        BUILD_SECONDS[name] = time.perf_counter() - t0
        (out_dir / f"{name}.ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, so)          # atomic: concurrent builders agree
    lib = ctypes.CDLL(str(so))
    PTXAS_LOGS[name] = out_dir / f"{name}.ptxas.txt"
    _LOADED[name] = lib
    return lib
