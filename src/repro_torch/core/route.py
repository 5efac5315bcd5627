"""Router: resolve placed operands onto Virtual-Channel mux selects.

Paper Sec. III-B: every input port of a succeeding PE has one multiplexer
whose inputs are *all* outputs of the predecessor level (plus, for level 0,
all memory-interface inputs); the select line of that mux is exactly the
configuration word the router produces here (bit-width per Eq. (3)).  A
channel input may fan out to several outputs; in-level connections are
impossible by construction (levelized placement).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.grid import GridSpec
from repro_torch.core.ops import Op
from repro_torch.core.place import Placement, PlacementError, VKey


class RoutingError(ValueError):
    pass


@dataclasses.dataclass
class Routing:
    """Per-level mux selects. ``sel[l][slot, port]`` indexes the VC-above-
    level-l channel inputs; ``out_sel[k]`` indexes last-level PE outputs."""

    sel: List[np.ndarray]          # per level: int32 [pes_in_level, 2]
    out_sel: np.ndarray            # int32 [num_outputs]
    fanout: Dict[int, int]         # per level: max fan-out observed (stats)


def route(placement: Placement, grid: GridSpec) -> Routing:
    dfg = placement.dfg
    input_index = {name: i for i, name in enumerate(dfg.inputs)}

    def channel_source(v: VKey, level: int) -> int:
        """Index of value `v` among the channel inputs of the VC above
        `level`: memory inputs for level 0, predecessor PE outputs else."""
        if level == 0:
            if v[0] != "in":
                raise RoutingError(f"level-0 operand {v} is not a memory input")
            return input_index[v[1]]
        try:
            return placement.avail[(v, level - 1)]
        except KeyError:
            raise RoutingError(
                f"value {v} not available at level {level - 1} "
                f"(mapper must insert a BUF carrier)"
            ) from None

    sel: List[np.ndarray] = []
    fanout: Dict[int, int] = {}
    for lvl, cells in enumerate(placement.cells):
        width = grid.pes_per_level[lvl]
        table = np.zeros((width, 2), dtype=np.int32)  # NONE PEs: select 0
        counts: Dict[int, int] = {}
        for slot, c in enumerate(cells):
            if c.op == Op.NONE:
                continue
            sa = channel_source(c.a, lvl)
            sb = channel_source(c.b, lvl)
            table[slot, 0] = sa
            table[slot, 1] = sb
            counts[sa] = counts.get(sa, 0) + 1
            counts[sb] = counts.get(sb, 0) + 1
        # Validate select ranges against the physical mux width.
        if table.size and table.max(initial=0) >= grid.vc_in_width(lvl):
            raise RoutingError(f"select out of range at level {lvl}")
        sel.append(table)
        fanout[lvl] = max(counts.values(), default=0)

    last = grid.num_levels - 1
    out_sel = np.zeros((grid.num_outputs,), dtype=np.int32)
    for k, ref in enumerate(dfg.outputs):
        v: VKey = ("in", ref.name) if hasattr(ref, "name") else ("node", ref.idx)
        try:
            out_sel[k] = placement.avail[(v, last)]
        except KeyError:
            raise RoutingError(f"output {k} value {v} not at bottom level") from None
    return Routing(sel, out_sel, fanout)
