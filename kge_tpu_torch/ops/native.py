"""Build and load the port's hand-written CUDA kernels.

Each source ``kge_tpu_torch/csrc/<name>.cu`` exports plain C functions.
At first use ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared
library under ``kge_tpu_torch/_build/`` (git-ignored), named by a hash of
the source and the flags, so an edited source is rebuilt and a current
one is reused; the library is then loaded with ``ctypes``. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: every kernel source of the port (``csrc/<name>.cu``)
KERNELS = ("rank_count", "negsamp_loss", "row_update", "ccorr_reduce")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return path


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named source whose library is missing, with one
    ``nvcc`` process each, all started together. The compiler's report
    (registers, spills; ``-Xptxas -v``) is kept beside each library as
    ``.log``. Raises if a compile fails."""
    names = list(names)
    compiler = None
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        report, _ = proc.communicate()
        out.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{report[-4000:]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
