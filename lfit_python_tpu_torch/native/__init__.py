"""The native (C++) chain-file writer and reader, loaded with ctypes.

Port of ``lfit_python_tpu/native/__init__.py``.  ``chainio.cpp`` (the
port's own copy) is built by ``g++`` on first use into
``build/native/<hash>/`` beside the package (``build/`` is listed in
``.gitignore``), keyed by a hash of the source and the flags.  Nothing is
built when the module is imported.

A build that fails raises ``RuntimeError`` with the compiler's output:
a caller that asked for the native writer gets it or an error, never the
numpy writer in its place.  ``utils.chains.ChainWriter`` writes with
numpy unless it is given ``use_native=True``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["chain_write", "chain_read_rows", "load"]

_SRC = Path(__file__).resolve().parent / "chainio.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The compiled ``chainio.cpp``, built on first use; raises
    ``RuntimeError`` with the compiler's output where the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(
            _SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
        out_dir = _BUILD_ROOT / digest
        so = out_dir / "libchainio.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            try:
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, str(_SRC), "-o", tmp],
                    capture_output=True, text=True, timeout=300)
            except OSError as exc:
                os.unlink(tmp)
                raise RuntimeError(f"cannot run g++ to build {_SRC.name}: "
                                   f"{exc}") from exc
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"g++ failed for {_SRC.name} (rc={proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)          # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(so))
        lib.chainio_write.restype = ctypes.c_int
        lib.chainio_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_long]
        lib.chainio_count_rows.restype = ctypes.c_long
        lib.chainio_count_rows.argtypes = [ctypes.c_char_p]
        lib.chainio_read.restype = ctypes.c_long
        lib.chainio_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_long]
        _lib = lib
        return lib


def chain_write(path, rows: np.ndarray):
    """Append (n_rows, n_cols) float64 rows to ``path``: column 0 (the
    walker index) as an integer, the others as ``%.10e``."""
    rows = np.ascontiguousarray(rows, np.float64)
    rc = load().chainio_write(
        str(path).encode(),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.shape[0], rows.shape[1])
    if rc != 0:
        raise OSError(f"native chain write failed for {path}")


def chain_read_rows(path, n_cols: int) -> np.ndarray:
    """Every data row of a chain file: (n_rows, n_cols) float64."""
    lib = load()
    n_rows = lib.chainio_count_rows(str(path).encode())
    if n_rows < 0:
        raise OSError(f"cannot read {path}")
    out = np.empty((n_rows, n_cols), np.float64)
    got = lib.chainio_read(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows, n_cols)
    if got < 0:
        raise OSError(f"native chain read failed for {path}")
    return out[:got]
