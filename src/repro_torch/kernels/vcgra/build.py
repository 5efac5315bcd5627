"""Build and bind the Hopper VCGRA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface, loaded with ``ctypes``: ``vcgra.cu`` holds B1/B2 and
``vcgra_pipeline.cu`` holds B3; both include ``vcgra_pe.cuh``, the PE
semantics.  The libraries are built at first use from the repository's
own sources into ``build/repro_torch_kernels/`` (listed in
``.gitignore``), each named by a digest of its source, the shared header
and the flags, so an edit rebuilds it.  :func:`build_all` starts one
``nvcc`` per source at once.  Nothing here runs on import: machines
without ``nvcc`` (the CPU test hosts) import the package freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"vcgra": CSRC / "vcgra.cu", "vcgra_pipeline": CSRC / "vcgra_pipeline.cu"}
HEADERS = (CSRC / "vcgra_pe.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_VOID_P, _INT, _INT64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: ``(name, argtypes)`` of every entry point, per library; all return int.
SIGNATURES = {
    "vcgra": (
        ("vcgra_fused_batched", [_INT] + [_VOID_P] * 8 + [_INT] * 8 + [_VOID_P]),
        ("vcgra_batched", [_INT] + [_VOID_P] * 6 + [_INT, _INT64] + [_INT] * 4 + [_VOID_P]),
        ("vcgra_max_vals", []),
    ),
    "vcgra_pipeline": (
        ("vcgra_pipeline_batched", [_INT] + [_VOID_P] * 11 + [_INT] * 9 + [_VOID_P]),
        ("vcgra_max_vals", []),
        ("vcgra_max_radius", []),
    ),
}

_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper kernels "
            "are built from their csrc/ sources at first use"
        )
    return nvcc


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(build_dir: Path = BUILD_DIR, verbose: bool = False,
              names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every library (or ``names``) that is missing, one ``nvcc``
    per source, all started together; returns ``{name: path}``.
    ``verbose`` rebuilds with ``-Xptxas -v`` and prints the compiler's
    per-kernel register, shared memory and spill report to standard
    error."""
    names = list(SOURCES) if names is None else list(names)
    paths = {name: library_path(name, build_dir) for name in names}
    todo = [n for n in names if verbose or not paths[n].exists()]
    if not todo:
        return paths
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in todo:
        tmp = paths[name].with_name(f"{paths[name].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (cmd, tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            continue
        if verbose and err:
            print(err, end="", file=sys.stderr, flush=True)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The bound kernel library ``name`` (built on first call, then cached
    for the life of the process, like any loaded shared object)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all(names=[name])[name]))
        for fn, argtypes in SIGNATURES[name]:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _INT
        _libs[name] = lib
    return lib
