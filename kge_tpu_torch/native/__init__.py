"""The port's host operations in C++ (``hostops.cpp``): the triple
parser of the dataset loader and the stable counting sort of the R-GNN
graph builders (counterpart of ``kge_tpu/native``, with its own copy of
the source).

At first use ``g++ -O3 -shared -fPIC`` compiles ``hostops.cpp`` into
``kge_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags, so an edited source is rebuilt and a current one reused;
the library is loaded with ``ctypes``. Where it cannot be built (no
``g++``) each operation falls back to numpy, which gives the same
arrays, and the fallback is logged once. Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostops.cpp"
#: where the library is built (read at build time)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_log = logging.getLogger(__name__)
_LOCK = threading.Lock()
#: the loaded library, or the error of a failed build (not retried)
_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return Path(BUILD_DIR) / f"libhostops-{digest.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        compiler = shutil.which("g++")
        if compiler is None:
            raise RuntimeError("g++ not found on PATH")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed: {proc.stderr[-2000:]}")
        os.replace(tmp, out)  # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(out))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.parse_triples.restype = ctypes.c_long
    lib.parse_triples.argtypes = [ctypes.c_char_p, i32p, ctypes.c_long]
    lib.counting_argsort.restype = ctypes.c_long
    lib.counting_argsort.argtypes = [i32p, ctypes.c_long, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_int64)]
    return lib


def library():
    """The loaded library, built at first use, or None where it cannot
    be built (logged once; the callers take numpy's route)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                _LIB = _build()
            except (OSError, RuntimeError) as e:
                _LIB = e
                _log.warning("kge_tpu_torch host ops unavailable (%s): "
                             "falling back to numpy", e)
        return None if isinstance(_LIB, Exception) else _LIB


def parse_triples(path: str) -> np.ndarray:
    """[n, 3] int32 triples of a whitespace-separated file: the first
    three integer fields of each line (``np.loadtxt``'s result)."""
    lib = library()
    if lib is None:
        data = np.loadtxt(path, dtype=np.int64, usecols=(0, 1, 2), ndmin=2)
        return np.ascontiguousarray(data.astype(np.int32))
    max_rows = os.path.getsize(path) // 6 + 2  # a line is at least "0 0 0\n"
    out = np.empty((max_rows, 3), dtype=np.int32)
    n = lib.parse_triples(os.fsencode(path),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          max_rows)
    if n < 0:
        raise ValueError(f"cannot parse triples from {path} (code {n})")
    return np.ascontiguousarray(out[:n])


def counting_argsort(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    """The int64 permutation that sorts ``keys`` (ints in
    ``[0, num_buckets)``) stably: ``np.argsort(kind="stable")``'s, in
    O(n + num_buckets)."""
    lib = library()
    if lib is None:
        return np.argsort(keys, kind="stable").astype(np.int64)
    k = np.ascontiguousarray(keys, dtype=np.int32)
    order = np.empty(k.shape[0], dtype=np.int64)
    rc = lib.counting_argsort(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), k.shape[0],
        max(int(num_buckets), 0),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError(f"counting_argsort: a key outside [0, "
                         f"{num_buckets}) (code {rc})")
    return order
