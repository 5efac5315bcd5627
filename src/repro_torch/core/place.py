"""Mapper/placer: DFG netlist -> PE slots on the grid.

Implements the paper's mapping rules (Sec. III/IV):

* data flows strictly top-to-bottom; every PE level is one pipeline stage;
* **level bypassing is not supported** -- a value produced at level ``p``
  and consumed at level ``c > p + 1`` is carried by PEs configured as BUF
  in every intermediate level ("The weighted pixel value ... is buffered in
  every stage of the array until it is used in the last addition");
* external inputs enter only through the top memory-interface VC, so an
  input consumed below level 0 is buffered down from level 0;
* outputs leave only through the bottom VC, so "for bigger arrays with more
  stages than necessary, an output value has to be buffered in every stage
  until it reaches the data output channel at the bottom";
* unused PEs are configured NONE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.dfg import DFG, InRef, NodeRef, Ref
from repro_torch.core.grid import GridSpec
from repro_torch.core.ops import Op, UNARY_OPS

# A value key: ("in", input_name) or ("node", node_idx).
VKey = Tuple[str, object]


class PlacementError(ValueError):
    pass


def _key(r: Ref) -> VKey:
    if isinstance(r, InRef):
        return ("in", r.name)
    return ("node", r.idx)


@dataclasses.dataclass
class Cell:
    """One occupied PE slot before routing: opcode + symbolic operands."""

    op: Op
    a: VKey
    b: VKey
    produces: VKey
    is_buf_fill: bool = False  # True for mapper-inserted BUF carriers


@dataclasses.dataclass
class Placement:
    dfg: DFG
    grid: GridSpec
    cells: List[List[Cell]]                  # per level, in slot order
    avail: Dict[Tuple[VKey, int], int]       # (value, level) -> slot
    num_buf: int
    num_none: int

    @property
    def used_pes(self) -> int:
        return sum(len(c) for c in self.cells)

    def stats(self) -> Dict[str, int]:
        return {
            "levels": self.grid.num_levels,
            "grid_pes": self.grid.num_pes,
            "used_pes": self.used_pes,
            "op_pes": self.used_pes - self.num_buf,
            "buf_pes": self.num_buf,
            "none_pes": self.num_none,
        }


def expand(dfg: DFG, num_levels: int) -> List[List[Cell]]:
    """Expand a DFG into per-level cells with BUF carriers inserted.

    Deterministic: original nodes first (by node index), then BUF carriers
    (by value key).  Raises PlacementError if the graph is deeper than the
    grid.
    """
    dfg.validate()
    levels = dfg.asap_levels()
    depth = dfg.depth()
    if num_levels < max(depth, 1):
        raise PlacementError(
            f"DFG {dfg.name!r} has depth {depth}, grid has only {num_levels} levels"
        )

    prod: Dict[VKey, int] = {("in", n): -1 for n in dfg.inputs}
    for i, lvl in enumerate(levels):
        prod[("node", i)] = lvl

    # Deepest level at which each value must exist as a *cell output*.
    maxneed: Dict[VKey, int] = {}

    def need(v: VKey, lvl: int) -> None:
        if lvl > prod[v]:
            maxneed[v] = max(maxneed.get(v, prod[v]), lvl)

    for i, n in enumerate(dfg.nodes):
        for r in (n.a, n.b):
            need(_key(r), levels[i] - 1)
    for r in dfg.outputs:
        need(_key(r), num_levels - 1)

    cells: List[List[Cell]] = [[] for _ in range(num_levels)]
    for i, n in enumerate(dfg.nodes):
        cells[levels[i]].append(Cell(n.op, _key(n.a), _key(n.b), ("node", i)))
    for v in sorted(maxneed, key=lambda k: (k[0], str(k[1]))):
        for lvl in range(prod[v] + 1, maxneed[v] + 1):
            # A BUF PE gets the same value on both ports (paper Sec. III-A).
            cells[lvl].append(Cell(Op.BUF, v, v, v, is_buf_fill=True))
    return cells


def level_demand(dfg: DFG) -> List[int]:
    """Per-level PE demand including BUF carriers, for the minimal-depth
    grid -- consumed by the grid-generator tool (`grid.for_dfg`)."""
    cells = expand(dfg, max(dfg.depth(), 1))
    return [len(c) for c in cells]


def place(dfg: DFG, grid: GridSpec) -> Placement:
    """Assign every cell a (level, slot) on `grid`; fail on overflow."""
    if len(dfg.inputs) > grid.num_inputs:
        raise PlacementError(
            f"DFG {dfg.name!r} needs {len(dfg.inputs)} memory inputs, "
            f"grid provides {grid.num_inputs}"
        )
    if len(dfg.outputs) > grid.num_outputs:
        raise PlacementError(
            f"DFG {dfg.name!r} needs {len(dfg.outputs)} outputs, "
            f"grid provides {grid.num_outputs}"
        )
    cells = expand(dfg, grid.num_levels)
    for lvl, cs in enumerate(cells):
        cap = grid.pes_per_level[lvl]
        if len(cs) > cap:
            raise PlacementError(
                f"level {lvl} needs {len(cs)} PEs but grid {grid.name!r} "
                f"provides {cap}; regenerate the grid with core.grid.for_dfg"
            )

    avail: Dict[Tuple[VKey, int], int] = {}
    num_buf = 0
    for lvl, cs in enumerate(cells):
        for slot, c in enumerate(cs):
            avail[(c.produces, lvl)] = slot
            if c.is_buf_fill:
                num_buf += 1
    num_none = grid.num_pes - sum(len(c) for c in cells)
    return Placement(dfg, grid, cells, avail, num_buf, num_none)
