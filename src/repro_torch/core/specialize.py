"""Parameterized VCGRA execution: constant-propagated specialization.

Twin of the reference package's ``core/specialize.py``.  The paper's
headline optimization treats the infrequently-changing settings as
*parameters*: they become constants and the design is re-optimized for
new values by (micro-)reconfiguration.  With the config fixed,

* each PE runs only its configured functional unit (dead units gone --
  the 24% PE resource cut of Table I),
* each VC mux select becomes direct wiring (gathers gone -- the 82% VC
  resource cut),
* NONE PEs and BUF chains that feed nothing are never emitted at all.

:func:`build_specialized_fn` is the eager PyTorch form (the port's oracle,
twin of the reference's XLA trace).  :func:`jit_specialized` is the
micro-reconfiguration: it generates this app's Hopper kernel (B5,
``repro_torch.kernels.vcgra.specialized``) and NVRTC-compiles it for the
card; its wall time is the reconfiguration cost.

Optionally the coefficient inputs (``dfg.const``) are baked too -- a second
specialization level the paper leaves implicit (its red coefficient nodes
are data), exposed here as ``bake_consts=True``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Set

import torch

from repro_torch.core import ops as pe_ops
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import GridSpec
from repro_torch.core.ops import Op


def _live_slots(grid: GridSpec, config: VCGRAConfig) -> List[Set[int]]:
    """Backward liveness over the grid: which PE slots contribute to any
    output.  The hardware analogue: frames never touched by the app's
    bitstream."""
    nl = grid.num_levels
    live: List[Set[int]] = [set() for _ in range(nl)]
    live[nl - 1].update(int(s) for s in config.out_sel)
    for lvl in range(nl - 1, 0, -1):
        for slot in live[lvl]:
            op = Op(int(config.opcodes[lvl][slot]))
            if op == Op.NONE:
                continue
            live[lvl - 1].add(int(config.selects[lvl][slot, 0]))
            if op not in pe_ops.UNARY_OPS:
                live[lvl - 1].add(int(config.selects[lvl][slot, 1]))
    return live


def baked_consts(config: VCGRAConfig) -> Dict[int, float]:
    """Input channel -> coefficient, for every channel ``bake_consts``
    burns into the datapath."""
    return {i: config.const_values[name] for i, name in enumerate(config.input_order)
            if name in config.const_values}


def const_value(value: float, dtype: torch.dtype, device=None) -> torch.Tensor:
    """A coefficient as a 0-d tensor of the grid dtype: the value a packed
    const channel holds (``pack_inputs`` casts from float64)."""
    return torch.tensor(value, dtype=torch.float64, device=device).to(dtype)


def build_specialized_fn(grid: GridSpec, config: VCGRAConfig, bake_consts: bool = False):
    """Emit the app-specific executor with the settings burned in.

    Returns ``fn(x) -> y`` with the conventional overlay's contract
    (``[num_inputs, batch] -> [num_outputs, batch]``), so the two paths are
    drop-in interchangeable and directly comparable.  ``x`` may be any
    object with ``shape``, ``dtype``, ``device`` and per-channel indexing
    (the chain executor feeds channels lazily from a tap bank)."""
    live = _live_slots(grid, config)
    const_idx = baked_consts(config) if bake_consts else {}

    def fn(x) -> torch.Tensor:
        dtype, device = x.dtype, x.device
        batch = tuple(x.shape[1:])
        prev: Dict[int, torch.Tensor] = {}
        for lvl in range(grid.num_levels):
            cur: Dict[int, torch.Tensor] = {}
            for slot in sorted(live[lvl]):
                op = Op(int(config.opcodes[lvl][slot]))
                if op == Op.NONE:
                    # A live select pointing at a NONE PE only happens for
                    # padded outputs; emit zero like the idle PE.
                    cur[slot] = torch.zeros(batch, dtype=dtype, device=device)
                    continue

                def fetch(idx: int) -> torch.Tensor:
                    if lvl == 0:
                        if idx in const_idx:
                            return const_value(const_idx[idx], dtype, device)
                        return x[idx]
                    return prev[idx]

                a = fetch(int(config.selects[lvl][slot, 0]))
                b = a if op in pe_ops.UNARY_OPS else fetch(int(config.selects[lvl][slot, 1]))
                cur[slot] = pe_ops.apply_op(op, a, b)
            prev = cur
        return torch.stack([prev[int(s)].broadcast_to(batch) for s in config.out_sel])

    return fn


def jit_specialized(grid: GridSpec, config: VCGRAConfig, bake_consts: bool = False,
                    device="cuda"):
    """The micro-reconfiguration step: generate this app's specialized
    Hopper kernel (B5) and, on a CUDA device, NVRTC-compile and load it.
    Returns ``fn(x) -> y`` (the B5 wrapper bound to the loaded kernel; for
    tensors on the CPU it computes the kernel's plain version).  Re-invoking
    this for a new config is what a parameterized reconfiguration costs."""
    from repro_torch.kernels.vcgra.ops import vcgra_specialized
    from repro_torch.kernels.vcgra.specialized import SpecializedKernel

    return partial(vcgra_specialized, SpecializedKernel(grid, config, bake_consts, device))
