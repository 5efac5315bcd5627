"""Resource analysis: the analogue of the paper's Table I on a PyTorch
program and on the card.

Twin of the reference's ``core/analysis.py``.  The paper reports LUT/TCON/
wire-length/channel-width deltas between the conventional and the
parameterized implementation of each VCGRA component.  Those are FPGA
place-and-route artefacts; the reference censuses XLA's optimized HLO
instead.  The port has two resources to count:

* **the program** (:func:`compile_and_census`): the ATen ops an executor
  dispatches when it runs once (``repro_torch.roofline.hlo_analysis``), by
  the reference's categories --

    routing ops   (index_select/gather/cat/slice/...)  <->  VC connection muxes / TCONs
    mux ops       (where/clamp)                         <->  generic-PE output muxes
    arith ops     (add/mul/div/compare/...)             <->  PE functional-unit LUTs
    flops/bytes   (the census)                          <->  overall datapath cost

  One eager op covers every PE lane of a level where XLA emits one
  instruction per functional unit, so each op counts once per element it
  writes (a lane op): an ``add`` over a 15-PE level of 4096 pixels counts
  61,440, one PE's ``add`` 4096.  The names are ATen's, not HLO's, so the
  counts differ from the reference's; the direction of each
  conventional -> parameterized change is what the two share.
* **the card** (:func:`kernel_census`): one launchable kernel's registers a
  thread, static and dynamic shared memory and SASS instructions -- the
  conventional kernel (B4, settings read at run time) against the
  parameterized one generated for one app (B5), the closest thing the
  card has to the LUTs and TCONs the paper counts.

Reduction percentages between the two variants are the direct analogue of
the paper's 82 % (VC) / 24 % (FP PE) / 6 % (grid) resource cuts.
"""

from __future__ import annotations

import ctypes
import importlib.util
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

import torch

from repro_torch.core import applications as apps
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec, custom, paper_4x4, sobel_grid
from repro_torch.core.pixie import map_app
from repro_torch.core.plan import OverlayPlan, compile_plan
from repro_torch.core.specialize import build_specialized_fn
from repro_torch.roofline.hlo_analysis import analyze

# The reference's HLO categories, as ATen overload-packet names (in-place
# forms count under the same name without the trailing ``_``).
ROUTING_OPS = {
    "index_select", "gather", "cat", "slice", "select", "constant_pad_nd", "pad", "flip",
    "index", "index_put", "scatter", "scatter_add", "narrow", "take", "roll",
    "slice_scatter", "select_scatter", "unbind", "split", "split_with_sizes", "stack",
}
MUX_OPS = {"where", "clamp", "clamp_min", "clamp_max"}
ARITH_OPS = {
    "add", "sub", "rsub", "mul", "div", "floor_divide", "remainder", "fmod", "maximum",
    "minimum", "eq", "ne", "gt", "ge", "lt", "le", "abs", "neg", "sign", "floor", "pow",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_not", "__and__", "__or__", "__xor__",
}
MOVE_OPS = {
    "copy", "_to_copy", "clone", "view", "_unsafe_view", "reshape", "expand", "permute",
    "transpose", "t", "unsqueeze", "squeeze", "contiguous", "alias", "detach",
    "as_strided", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "fill", "empty", "empty_like", "empty_strided", "arange", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "scalar_tensor",
}


def hlo_op_census(op_counts: Dict[str, int]) -> Dict[str, int]:
    """Sum a census's ``{ATen op name: count}`` by category (the reference
    counts optimized-HLO ops; the port passes lane ops, a census's
    ``op_elements``, or executed ops, its ``op_counts``)."""
    counts: Dict[str, int] = {}
    for name, n in op_counts.items():
        key = name.rstrip("_") if name.endswith("_") and not name.startswith("_") else name
        counts[key] = counts.get(key, 0) + n
    total = sum(counts.values())
    summary = {
        "total_ops": total,
        "routing_ops": sum(v for k, v in counts.items() if k in ROUTING_OPS),
        "mux_ops": sum(v for k, v in counts.items() if k in MUX_OPS),
        "arith_ops": sum(v for k, v in counts.items() if k in ARITH_OPS),
        "move_ops": sum(v for k, v in counts.items() if k in MOVE_OPS),
    }
    summary["other_ops"] = total - sum(
        summary[k] for k in ("routing_ops", "mux_ops", "arith_ops", "move_ops")
    )
    return summary


def compile_and_census(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once, eagerly, and return the resource census:
    the op categories in lane ops (each executed op once per element it
    writes), ``flops`` (products' FLOPs plus one per elementwise output
    element, as XLA's ``cost_analysis`` counts them) and ``bytes`` (operand
    + result bytes of every op that moves any)."""
    census = analyze(fn, *args)
    summary: Dict[str, float] = dict(hlo_op_census(census.op_elements))
    summary["flops"] = float(census.flops + census.elementwise_ops)
    summary["bytes"] = float(census.hbm_bytes)
    return summary


def reduction_row(
    name: str, conventional: Dict[str, float], parameterized: Dict[str, float]
) -> Dict[str, object]:
    """One Table-I row: conventional vs parameterized + reduction %."""
    row: Dict[str, object] = {"component": name}
    for key in ("total_ops", "routing_ops", "mux_ops", "arith_ops", "flops", "bytes"):
        c, p = float(conventional.get(key, 0)), float(parameterized.get(key, 0))
        row[f"{key}_conv"] = c
        row[f"{key}_param"] = p
        row[f"{key}_reduction_pct"] = reduction_pct(c, p)
    return row


def reduction_pct(conventional: float, parameterized: float) -> float:
    """The reduction from ``conventional`` to ``parameterized``, in %."""
    return (100.0 * (conventional - parameterized) / conventional) if conventional else 0.0


def format_table(rows: Iterable[Dict[str, object]], keys=None) -> str:
    rows = list(rows)
    if not rows:
        return "(empty)"
    keys = keys or list(rows[0].keys())
    widths = {k: max(len(str(k)), *(len(_fmt(r.get(k))) for r in rows)) for k in keys}
    head = " | ".join(str(k).ljust(widths[k]) for k in keys)
    sep = "-+-".join("-" * widths[k] for k in keys)
    body = "\n".join(
        " | ".join(_fmt(r.get(k)).ljust(widths[k]) for k in keys) for r in rows
    )
    return f"{head}\n{sep}\n{body}"


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:,.1f}"
    return str(v)


# -- Table I's components (the reference's benchmarks/resource_table.py) ------

#: The paper's LUT reductions per component (Table I), beside which the
#: port's rows are read.  The Sobel grid has no row of its own in Table I.
PAPER_LUT_REDUCTION_PCT = {
    "VC (8->4 routing)": 82.0, "PE fixed-point": 5.0, "PE floating-point": 24.0,
    "4x4 grid (reduce8)": 6.0, "Sobel grid (45 PE, Fig.5)": None,
}
#: The reference's census batch (pixels).
CENSUS_BATCH = 4096


def _vc_only() -> Tuple[GridSpec, VCGRAConfig]:
    """A single virtual channel in isolation: one level of BUF PEs routing
    8 inputs to 4 outputs (pure routing fabric)."""
    g = DFG("vc_only")
    ins = [g.input(f"i{k}") for k in range(8)]
    for k in (3, 1, 6, 3):      # fan-out + permutation, like a real VC config
        g.output(g.buf(ins[k]))
    grid = custom("vc1", 8, [4], num_outputs=4)
    return grid, map_app(g, grid)


def _pe_only(float_pe: bool) -> Tuple[GridSpec, VCGRAConfig]:
    g = DFG("pe_only")
    a, b = g.input("a"), g.input("b")
    g.output(g.mul(a, b))
    grid = custom("pe1", 2, [1], num_outputs=1, float_pe=float_pe)
    return grid, map_app(g, grid)


def _grid_4x4() -> Tuple[GridSpec, VCGRAConfig]:
    """The paper's fully parameterized 4x4 grid running an 8-input
    reduction tree."""
    g = DFG("reduce8")
    ins = [g.input(f"i{k}") for k in range(8)]
    terms = [g.add(ins[i], ins[i + 1]) for i in range(0, 8, 2)]
    terms = [g.add(terms[0], terms[1]), g.add(terms[2], terms[3])]
    g.output(g.add(terms[0], terms[1]))
    grid = paper_4x4()
    return grid, map_app(g, grid)


def _sobel() -> Tuple[GridSpec, VCGRAConfig]:
    grid = sobel_grid()
    return grid, map_app(apps.sobel_x(), grid)


def table_one_components() -> List[Tuple[str, GridSpec, VCGRAConfig]]:
    """The five components of the reference's Table I analogue, each as
    ``(name, grid, config)``."""
    return [
        ("VC (8->4 routing)", *_vc_only()),
        ("PE fixed-point", *_pe_only(False)),
        ("PE floating-point", *_pe_only(True)),
        ("4x4 grid (reduce8)", *_grid_4x4()),
        ("Sobel grid (45 PE, Fig.5)", *_sobel()),
    ]


def census_pair(grid: GridSpec, config: VCGRAConfig) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(conventional, parameterized)`` program census of one component:
    the eager interpreter (``backend="torch"``, settings as runtime
    tensors) against ``specialize.build_specialized_fn`` (settings baked),
    on ``[num_inputs, CENSUS_BATCH]`` zeros on the CPU."""
    x = torch.zeros((grid.num_inputs, CENSUS_BATCH), dtype=grid.dtype)
    overlay = compile_plan(OverlayPlan(grid=grid, backend="torch"))
    conv = compile_and_census(overlay, config.to_torch(), x)
    spec = compile_and_census(build_specialized_fn(grid, config), x)
    return conv, spec


# -- the card's census of one kernel ---------------------------------------------

#: cuFuncGetAttribute's attributes (CUfunction_attribute).
_CU_FUNC_SHARED_SIZE_BYTES, _CU_FUNC_NUM_REGS = 1, 4
#: Template-argument manglings of the grid dtypes (Itanium ABI).
_MANGLED = {torch.int32: "i", torch.int16: "s", torch.float32: "f",
            torch.bfloat16: "13__nv_bfloat16"}
_FUNCTION = re.compile(r"Function\s*:\s*(\S+)|^\s*\.section\s+\.text\.([^,\s]+)")
_COMMENT = re.compile(r"/\*.*?\*/")


def find_sass_tool(name: str) -> Path:
    """``cuobjdump`` or ``nvdisasm``: the CUDA toolkit's, else the copy
    Triton's package carries under ``triton/backends/nvidia/bin/``.  Raises
    when neither has it."""
    from repro_torch.kernels import build

    candidates = []
    try:
        candidates.append(build.cuda_home() / "bin" / name)
    except build.KernelBuildError:
        pass
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        candidates.append(Path(list(spec.submodule_search_locations)[0]) / "backends"
                          / "nvidia" / "bin" / name)
    for path in candidates:
        if path.exists():
            return path
    raise RuntimeError(f"{name} not found (looked in {[str(c) for c in candidates]}): the "
                       "card's census needs it")


def sass_counts(listing: str) -> Dict[str, int]:
    """SASS instructions per function of a ``cuobjdump -sass`` or
    ``nvdisasm`` listing: every instruction line of the function's body,
    the alignment ``NOP``s after its end left out."""
    counts: Dict[str, int] = {}
    current = None
    for line in listing.splitlines():
        m = _FUNCTION.search(line)
        if m:
            current = m.group(1) or m.group(2)
            counts.setdefault(current, 0)
            continue
        body = _COMMENT.sub("", line).strip()
        if current is None or not body.endswith(";") or body.startswith("."):
            continue
        if not body.startswith("NOP"):
            counts[current] += 1
    return counts


def _run_tool(name: str, *args: str) -> str:
    proc = subprocess.run([str(find_sass_tool(name)), *args], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} {' '.join(args)} failed ({proc.returncode}): "
                           f"{proc.stderr[-2000:]}")
    return proc.stdout


def _one(counts: Dict[str, int], needle: str, where: str) -> Tuple[str, int]:
    hits = [(name, n) for name, n in counts.items() if needle in name]
    if len(hits) != 1 or hits[0][1] <= 0:
        raise RuntimeError(f"{where}: expected one function matching {needle!r} with "
                           f"instructions, found {hits}")
    return hits[0]


def kernel_census(kernel, grid: GridSpec = None) -> Dict[str, object]:
    """The card's census of one launchable kernel: registers a thread,
    static and dynamic shared memory bytes of a block, threads a block and
    SASS instructions of its body.

    ``kernel`` is ``"vcgra_conventional"`` (B4 over ``grid``'s dtype and
    shape, at its default block; also the settings-pack kernel B4 launches
    first)
    or a loaded ``kernels.vcgra.SpecializedKernel`` (B5, one app).  Builds
    or reads the kernel on the card; raises where a count cannot be read
    (no card, no SASS tool), never reporting 0."""
    from repro_torch.core.tiling import itemsize
    from repro_torch.kernels import build
    from repro_torch.kernels.vcgra import ops
    from repro_torch.kernels.vcgra.specialized import KERNEL_NAME, THREADS, SpecializedKernel

    if isinstance(kernel, SpecializedKernel):
        if kernel.handle is None:
            raise RuntimeError("B5's census needs its kernel loaded on a card")
        lib = build.load_library("vcgra_specialize")
        size = lib.vcgra_spec_cubin(kernel.handle, None, 0)
        if size <= 0:
            raise RuntimeError(f"B5: no CUBIN held for {kernel.config.app_name!r}")
        buf = ctypes.create_string_buffer(size)
        if lib.vcgra_spec_cubin(kernel.handle, ctypes.cast(buf, ctypes.c_void_p), size) != size:
            raise RuntimeError(f"B5: the CUBIN of {kernel.config.app_name!r} changed size")
        path = build.BUILD_DIR / "census" / f"b5_{kernel.digest[:16]}.cubin"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(buf.raw)
        name, sass = _one(sass_counts(_run_tool("nvdisasm", "-c", str(path))), KERNEL_NAME,
                          f"nvdisasm {path.name}")
        regs = lib.vcgra_spec_attribute(kernel.handle, _CU_FUNC_NUM_REGS)
        static = lib.vcgra_spec_attribute(kernel.handle, _CU_FUNC_SHARED_SIZE_BYTES)
        out = {"kernel": "vcgra_specialized", "function": name, "app": kernel.config.app_name,
               "threads": THREADS, "registers_per_thread": regs, "static_smem_bytes": static,
               "dynamic_smem_bytes": 0, "sass_instructions": sass}
    elif kernel == "vcgra_conventional":
        if grid is None:
            raise ValueError("B4's census needs the grid it runs")
        lib = build.load_library("vcgra")
        code = ops._DTYPE_CODES[grid.dtype]
        threads, dynamic, passes = ops.conventional_launch(
            itemsize(grid.dtype), grid.num_inputs, grid.pes_per_level, grid.num_outputs,
            ops.BLOCK_N)
        path = build.library_path("vcgra")
        counts = sass_counts(_run_tool("cuobjdump", "-sass", str(path)))
        t = _MANGLED[grid.dtype]
        name, sass = _one(counts, f"20vcgra_batched_kernelI{t}Li0E", f"cuobjdump {path.name}")
        _, pack = _one(counts, f"19vcgra_pack_settingsI{t}E", f"cuobjdump {path.name}")
        regs = lib.vcgra_kernel_regs(3, code)
        static = lib.vcgra_conventional_static_smem(code)
        out = {"kernel": "vcgra_conventional", "function": name, "grid": grid.name,
               "threads": threads, "passes": passes, "block_n": ops.BLOCK_N,
               "registers_per_thread": regs, "static_smem_bytes": static,
               "dynamic_smem_bytes": dynamic, "sass_instructions": sass,
               "settings_pack_sass_instructions": pack}
    else:
        raise ValueError(f"no census for kernel {kernel!r}")
    for key in ("registers_per_thread", "static_smem_bytes"):
        if out[key] < 0:
            raise RuntimeError(f"{out['kernel']}: {key} could not be read ({out[key]})")
    return out
