"""The specialized VCGRA kernel (B5): one CUDA kernel generated per app.

Twin of the reference's Pallas ``vcgra_specialized``, whose settings are
trace-time constants.  For one (grid, config, dtype, bake_consts) this
module writes straight-line CUDA from the app's live slots
(``core.specialize._live_slots``): one ``pe(<opcode>, a, b)`` per live PE
with the opcode a literal, every VC mux select folded into the name of the
register it reads, NONE slots a literal zero, and loads of the live input
rows only -- the paper's "VC mux -> wiring" cut.  A
:class:`SpecializedKernel` compiles it with NVRTC for ``sm_90a``
(``--fmad=false``, the PE semantics of ``csrc/vcgra_pe.cuh`` passed as a
named header) and loads the module into the card's primary context
through the host shim ``csrc/vcgra_specialize.cu``: generate + compile +
load is the micro-reconfiguration.  Modules are cached for the life of the process by
a digest of the generated source, so reloading an app costs no compile.

A compile failure raises with NVRTC's log; nothing falls back to another
kernel.  On a CPU device nothing is compiled: the wrapper
(``ops.vcgra_specialized``) computes the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import struct
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import GridSpec
from repro_torch.core.ops import UNARY_OPS, Op
from repro_torch.core.specialize import _live_slots, baked_consts, const_value
from repro_torch.kernels import build

#: The generated kernel's name and threads per block.
KERNEL_NAME = "vcgra_specialized"
THREADS = 256

_C_TYPES = {torch.int32: "int32_t", torch.int16: "int16_t", torch.float32: "float",
            torch.bfloat16: "__nv_bfloat16"}

#: (source digest, device index) -> loaded module handle, for the process.
_MODULES: Dict[Tuple[str, int], int] = {}


def _literal(value: float, dtype: torch.dtype) -> str:
    """A coefficient as a C literal of the grid dtype, bitwise the value a
    packed const channel holds."""
    t = const_value(value, dtype)
    if dtype == torch.float32:
        bits = struct.unpack("<I", struct.pack("<f", float(t)))[0]
        return f"__uint_as_float(0x{bits:08x}u)"
    if dtype == torch.bfloat16:
        bits = int(t.view(torch.int16)) & 0xFFFF
        return f"__ushort_as_bfloat16((unsigned short)0x{bits:04x})"
    v = int(t)
    return "INT32_MIN" if v == -2 ** 31 else f"({v})"


def live_inputs(grid: GridSpec, config: VCGRAConfig,
                live: Optional[List[set]] = None) -> List[int]:
    """The input channels the live level-0 PEs read, in order."""
    live = _live_slots(grid, config) if live is None else live
    rows = set()
    for slot in live[0]:
        op = Op(int(config.opcodes[0][slot]))
        if op == Op.NONE:
            continue
        rows.add(int(config.selects[0][slot, 0]))
        if op not in UNARY_OPS:
            rows.add(int(config.selects[0][slot, 1]))
    return sorted(rows)


def generate_source(grid: GridSpec, config: VCGRAConfig, bake_consts: bool = False) -> str:
    """The CUDA source of this app's specialized kernel (deterministic:
    the same settings give the same text)."""
    live = _live_slots(grid, config)
    consts = baked_consts(config) if bake_consts else {}
    dtype = grid.dtype
    lines = [
        f"// B5: {config.app_name!r} specialized on grid {grid.name!r} ({_C_TYPES[dtype]}"
        f"{', consts baked' if consts else ''}).",
        '#include "vcgra_pe.cuh"',
        "",
        f"typedef {_C_TYPES[dtype]} T;",
        "",
        f'extern "C" __global__ void __launch_bounds__({THREADS})',
        f"{KERNEL_NAME}(const T* __restrict__ x, T* __restrict__ y, long long n,",
        "                  long long ldx, long long block_n) {",
        "  const long long start = (long long)blockIdx.x * block_n;",
        "  const long long end = start + block_n < n ? start + block_n : n;",
        "  for (long long p = start + threadIdx.x; p < end; p += blockDim.x) {",
    ]
    for i in live_inputs(grid, config, live):
        value = (_literal(consts[i], dtype) if i in consts
                 else f"x[{i}LL * ldx + p]")
        lines.append(f"    const T x{i} = {value};")
    for lvl in range(grid.num_levels):
        src = "x" if lvl == 0 else f"l{lvl - 1}_"
        for slot in sorted(live[lvl]):
            op = Op(int(config.opcodes[lvl][slot]))
            if op == Op.NONE:
                value = "zero_value<T>()"
            else:
                a = f"{src}{int(config.selects[lvl][slot, 0])}"
                b = a if op in UNARY_OPS else f"{src}{int(config.selects[lvl][slot, 1])}"
                value = f"pe({int(op)} /* {op.name} */, {a}, {b})"
            lines.append(f"    const T l{lvl}_{slot} = {value};")
    last = grid.num_levels - 1
    for k, s in enumerate(config.out_sel):
        lines.append(f"    y[{k}LL * n + p] = l{last}_{int(s)};")
    lines += ["  }", "}", ""]
    return "\n".join(lines)


def nvrtc_options() -> List[str]:
    return ["--gpu-architecture=sm_90a", "--fmad=false", "-std=c++17",
            f"-I{build.cuda_home() / 'include'}"]


def source_digest(source: str) -> str:
    """Cache key of a generated kernel: its text and the shared header."""
    h = hashlib.sha256(source.encode())
    h.update(build.PE_HEADER.read_bytes())
    return h.hexdigest()


def compile_module(source: str, device_index: int) -> int:
    """NVRTC-compile ``source`` for ``sm_90a`` and load it on the card;
    returns the shim's module handle (uncached).  Raises with NVRTC's log
    when the compiler refuses the source."""
    lib = build.load_library("vcgra_specialize")
    opts = [o.encode() for o in nvrtc_options()]
    log = ctypes.create_string_buffer(1 << 16)
    handle = ctypes.c_void_p()
    rc = lib.vcgra_spec_compile(
        source.encode(), build.PE_HEADER.read_bytes(), build.PE_HEADER.name.encode(),
        (ctypes.c_char_p * len(opts))(*opts), len(opts), KERNEL_NAME.encode(),
        int(device_index), ctypes.byref(handle), log, len(log),
    )
    if rc != 0:
        what = {1: "NVRTC refused the source", 2: "NVRTC failed"}.get(rc, "module load failed")
        raise RuntimeError(f"B5 {what} (code {rc}):\n{log.value.decode(errors='replace')}")
    return int(handle.value)


class SpecializedKernel:
    """One app's B5 kernel: the generated source and, on a CUDA device,
    the loaded module (compiled here unless the process cache holds it);
    run it with ``ops.vcgra_specialized``.  ``compile_s`` is the wall time
    of the generate + NVRTC + load that made it (``cached`` when the module
    came from the process cache)."""

    def __init__(self, grid: GridSpec, config: VCGRAConfig, bake_consts: bool = False,
                 device="cuda"):
        t0 = time.perf_counter()
        self.grid, self.config, self.bake_consts = grid, config, bool(bake_consts)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.source = generate_source(grid, config, self.bake_consts)
        self.digest = source_digest(self.source)
        baked = baked_consts(config) if self.bake_consts else {}
        read = [i for i in live_inputs(grid, config) if i not in baked]
        #: Channels ``x`` must hold: the kernel reads every live, unbaked row.
        self.num_channels = read[-1] + 1 if read else 0
        self.handle: Optional[int] = None
        self.cached = False
        if dev.type == "cuda":
            key = (self.digest, dev.index)
            self.cached = key in _MODULES
            if not self.cached:
                _MODULES[key] = compile_module(self.source, dev.index)
            self.handle = _MODULES[key]
        self.compile_s = time.perf_counter() - t0

