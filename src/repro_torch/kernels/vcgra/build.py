"""Build and bind the Hopper VCGRA kernels (``csrc/vcgra.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface, which is loaded with ``ctypes``.  The library is built at first
use from the repository's own source into ``build/repro_torch_kernels/``
(listed in ``.gitignore``), named by a digest of the source and the flags
so an edit rebuilds it.  Nothing here runs on import: machines without
``nvcc`` (the CPU test hosts) import the package freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "vcgra.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_VOID_P, _INT, _INT64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper kernels "
            "are built from csrc/vcgra.cu at first use"
        )
    return nvcc


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir / f"libvcgra_{digest.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR, verbose: bool = False) -> Path:
    """Compile ``csrc/vcgra.cu`` unless a library of the same source and
    flags exists; returns its path.  ``verbose`` rebuilds with
    ``-Xptxas -v`` and prints the compiler's per-kernel register, shared
    memory and spill report to standard error."""
    out = library_path(build_dir)
    if out.exists() and not verbose:
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose and proc.stderr:
        print(proc.stderr, end="", file=sys.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The bound kernel library (built on first call, then cached for the
    life of the process, like any loaded shared object)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.vcgra_fused_batched.argtypes = (
            [_INT] + [_VOID_P] * 8 + [_INT] * 8 + [_VOID_P]
        )
        lib.vcgra_fused_batched.restype = _INT
        lib.vcgra_batched.argtypes = (
            [_INT] + [_VOID_P] * 6 + [_INT, _INT64] + [_INT] * 4 + [_VOID_P]
        )
        lib.vcgra_batched.restype = _INT
        lib.vcgra_max_vals.argtypes = []
        lib.vcgra_max_vals.restype = _INT
        _lib = lib
    return _lib
