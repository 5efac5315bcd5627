"""Build and bind the port's Hopper kernels (``*/csrc/*.cu``).

``nvcc`` compiles each source into a shared library with a plain C
interface, loaded with ``ctypes``: ``vcgra/csrc/vcgra.cu`` holds B1, B2 and
B4, ``vcgra/csrc/vcgra_pipeline.cu`` holds B3 (both include
``vcgra_vec.cuh``, the vectorised pipeline of B1 to B4, which
includes ``vcgra_pe.cuh``, the PE semantics), ``vcgra/csrc/vcgra_specialize.cu`` is
the host shim that NVRTC-compiles and launches the per-app B5 kernels,
``stencil/csrc/stencil.cu`` holds B6 and
``flash_attention/csrc/flash_decode.cu`` holds B7.  The libraries are
built at first use from the repository's own sources into
``build/repro_torch_kernels/`` (listed in ``.gitignore``), each named by
a digest of its source, the shared headers, the flags and the libraries it
links, so an edit rebuilds it.  :func:`build_all` starts one ``nvcc``
per source at once.  Nothing here runs on import: machines without
``nvcc`` (the CPU test hosts) import the package freely.

A library that cannot be built or loaded raises :class:`KernelBuildError`.
The fleet's self-healing ladder re-raises it and never serves around it:
a missing kernel is a broken deployment, not a fault to degrade past.
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

KERNELS = Path(__file__).resolve().parent
VCGRA_CSRC = KERNELS / "vcgra" / "csrc"
SOURCES = {
    "vcgra": VCGRA_CSRC / "vcgra.cu",
    "vcgra_pipeline": VCGRA_CSRC / "vcgra_pipeline.cu",
    "vcgra_specialize": VCGRA_CSRC / "vcgra_specialize.cu",
    "stencil": KERNELS / "stencil" / "csrc" / "stencil.cu",
    "flash_decode": KERNELS / "flash_attention" / "csrc" / "flash_decode.cu",
}
PE_HEADER = VCGRA_CSRC / "vcgra_pe.cuh"
#: Every header a source includes: each library's digest covers them all.
HEADERS = (PE_HEADER, VCGRA_CSRC / "vcgra_vec.cuh")
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
#: Toolkit libraries a source links (the B5 shim: NVRTC and libcuda's cu*
#: API, the latter against the toolkit's link stub; the system's
#: libcuda.so.1 is what loads at run time).
LINK_LIBS = {"vcgra_specialize": ("nvrtc", "cuda")}

_VOID_P, _INT, _INT64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: ``(name, argtypes)`` of every entry point, per library; all return int.
SIGNATURES = {
    "vcgra": (
        ("vcgra_fused_batched", [_INT] + [_VOID_P] * 11 + [_INT] * 11 + [_VOID_P]),
        ("vcgra_batched", [_INT] + [_VOID_P] * 7 + [_INT, _INT64] + [_INT] * 7 + [_VOID_P]),
        ("vcgra_conventional",
         [_INT] + [_VOID_P] * 7 + [_INT64, _INT64] + [_INT] * 7 + [_VOID_P]),
        ("vcgra_max_vals", []),
        ("vcgra_window_max_radius", []),
        ("vcgra_fused_max_radius", []),
        ("vcgra_record_ints", [_INT] * 4),
        ("vcgra_fused_smem", [_INT] * 9),
        ("vcgra_batched_smem", [_INT] * 8),
        ("vcgra_kernel_regs", [_INT] * 2),
        ("vcgra_conventional_static_smem", [_INT]),
    ),
    "vcgra_pipeline": (
        ("vcgra_pipeline_batched", [_INT] + [_VOID_P] * 13 + [_INT] * 12 + [_VOID_P]),
        ("vcgra_pipeline_record_ints", [_INT] * 4),
        ("vcgra_pipeline_smem", [_INT] * 9),
        ("vcgra_pipeline_regs", [_INT]),
        ("vcgra_max_vals", []),
        ("vcgra_max_radius", []),
    ),
    "vcgra_specialize": (
        ("vcgra_spec_compile",
         [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
          _INT, ctypes.c_char_p, _INT, ctypes.POINTER(_VOID_P), ctypes.c_char_p,
          ctypes.c_size_t]),
        ("vcgra_spec_launch", [_VOID_P] * 3 + [_INT64] * 3 + [_INT, _VOID_P]),
        ("vcgra_spec_free", [_VOID_P]),
        ("vcgra_spec_cubin", [_VOID_P, _VOID_P, _INT]),
        ("vcgra_spec_attribute", [_VOID_P, _INT]),
    ),
    "stencil": (
        ("stencil_fused", [_INT] * 3 + [_VOID_P] * 2 + [_INT] * 3 + [_VOID_P]),
        ("stencil_max_block_h", []),
    ),
    "flash_decode": (
        ("flash_decode", [_INT] * 4 + [_VOID_P] * 8 + [_INT] * 7 + [ctypes.c_float, _VOID_P]),
        ("flash_decode_supported", [_INT, _INT]),
        ("flash_decode_max_splits", []),
        ("flash_decode_tc_rows", []),
        ("flash_decode_tc_smem", [_INT] * 3),
        ("flash_decode_tc_regs", [_INT] * 3),
    ),
}

_libs: Dict[str, ctypes.CDLL] = {}

#: Where the toolkit's compiler lives when ``nvcc`` is not on PATH.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


class KernelBuildError(RuntimeError):
    """A kernel library could not be built (no ``nvcc``, a compile error)
    or loaded (a missing shared object or entry point)."""


def find_nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    nvcc = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(nvcc):
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the Hopper kernels "
            "are built from their csrc/ sources at first use"
        )
    return nvcc


def cuda_home() -> Path:
    """The CUDA toolkit that ``nvcc`` belongs to (its ``include/`` and
    ``lib64/``)."""
    return Path(find_nvcc()).resolve().parents[1]


def _link_flags(name: str) -> List[str]:
    libs = LINK_LIBS.get(name, ())
    if not libs:
        return []
    lib64 = cuda_home() / "lib64"
    return [f"-L{lib64}", f"-L{lib64 / 'stubs'}", "-Xlinker", f"-rpath={lib64}",
            *(f"-l{lib}" for lib in libs)]


def library_path(name: str, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_LIBS.get(name, ())).encode())
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
               "-o", str(tmp), str(SOURCES[name]), *_link_flags(name)]
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
        raise KernelBuildError("\n".join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The bound kernel library ``name`` (built on first call, then cached
    for the life of the process, like any loaded shared object)."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all(names=[name])[name]
        if "nvrtc" in LINK_LIBS.get(name, ()):
            # libnvrtc opens its builtins library by soname when it compiles;
            # loading the toolkit's copy first lets that lookup find it
            # whatever the dynamic linker's search path.
            builtins = cuda_home() / "lib64" / "libnvrtc-builtins.so"
            if builtins.exists():
                ctypes.CDLL(str(builtins), mode=ctypes.RTLD_GLOBAL)
        try:
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name]:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _INT
        except (OSError, AttributeError) as exc:
            raise KernelBuildError(f"cannot load kernel library {path}: {exc}") from exc
        _libs[name] = lib
    return lib
