"""Settings ("bitstream") assembly for the Pixie overlay.

The specialization stage of the paper's tool flow combines the PaR result
with the parameterized components into reconfiguration bitstreams.  Our
configuration is the exact software analogue: per-level PE opcode vectors
plus per-level VC mux-select tables.  In the *conventional* path these are
runtime arrays (settings registers updated over a bus -> swapping them
never recompiles anything); in the *parameterized* path they are baked
constants (micro-reconfiguration -> re-specialization = re-jit).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.grid import GridSpec
from repro_torch.core.ingest import IngestError, IngestPlan, plan_for
from repro_torch.core.place import Placement
from repro_torch.core.route import Routing


@dataclasses.dataclass
class VCGRAConfig:
    """The full settings of one application mapped on one grid."""

    app_name: str
    grid_name: str
    opcodes: List[np.ndarray]        # per level: int32 [pes_in_level]
    selects: List[np.ndarray]        # per level: int32 [pes_in_level, 2]
    out_sel: np.ndarray              # int32 [num_outputs]
    input_order: Tuple[str, ...]     # memory-VC channel ordering
    const_values: Dict[str, float]   # default coefficient values
    # Stable identity set by caching layers (runtime/fleet.py): the DFG
    # structural hash + grid.  None for configs assembled outside a cache.
    cache_key: Optional[str] = None
    # How each memory-VC channel is produced from a raw image frame
    # (core/ingest.py); None when the app is not image-feedable (a channel
    # is neither a stencil tap nor a const) and needs named inputs.
    ingest: Optional[IngestPlan] = None

    # -- conventional-path form (settings registers as device tensors) -----

    def to_torch(self, device=None):
        """``(opcodes, selects, out_sel)`` as int32 tensors on ``device``."""
        return (
            tuple(torch.as_tensor(o, dtype=torch.int32, device=device)
                  for o in self.opcodes),
            tuple(torch.as_tensor(s, dtype=torch.int32, device=device)
                  for s in self.selects),
            torch.as_tensor(self.out_sel, dtype=torch.int32, device=device),
        )

    # -- multi-tenant form (stacked settings registers) ----------------------

    def config_shapes(self) -> Tuple:
        """Shape signature of the settings arrays.  Two configs with equal
        signatures were mapped on structurally identical grids and can be
        stacked into one batched settings bank."""
        return (
            tuple(o.shape for o in self.opcodes),
            tuple(s.shape for s in self.selects),
            tuple(self.out_sel.shape),
        )

    @staticmethod
    def stack(configs: Sequence["VCGRAConfig"], device=None):
        """Stack N same-grid configs into batched settings arrays.

        Every application mapped on one grid yields identically-shaped
        config arrays (the invariant the overlay executors exploit for
        their compile-once claim); stacking them along a new leading axis
        is the multi-tenant extension: one vmapped overlay executable then
        runs N *different* applications in a single dispatch (a batched
        ``OverlayPlan``, see ``core/plan.py``).

        Returns ``(opcodes, selects, out_sel)`` int32 tensors on ``device``
        with per-level leaves of shape ``[N, pes]`` / ``[N, pes, 2]`` and
        ``out_sel: [N, num_outputs]``.  Stacked on the host and copied once.
        """
        if not configs:
            raise ValueError("cannot stack an empty config list")
        sig = configs[0].config_shapes()
        for c in configs[1:]:
            if c.config_shapes() != sig:
                raise ValueError(
                    f"config {c.app_name!r} (grid {c.grid_name!r}) does not "
                    f"match the stack's grid {configs[0].grid_name!r}: "
                    f"{c.config_shapes()} != {sig}"
                )
        num_levels = len(configs[0].opcodes)

        def stacked(arrays):
            return torch.as_tensor(
                np.stack([np.asarray(a, np.int32) for a in arrays]), device=device
            )

        return (
            tuple(stacked([c.opcodes[lvl] for c in configs])
                  for lvl in range(num_levels)),
            tuple(stacked([c.selects[lvl] for c in configs])
                  for lvl in range(num_levels)),
            stacked([c.out_sel for c in configs]),
        )

    # -- size accounting (the "bitstream size" analogue) --------------------

    def settings_words(self) -> int:
        return int(
            sum(o.size for o in self.opcodes)
            + sum(s.size for s in self.selects)
            + self.out_sel.size
        )

    def settings_bits(self, grid: GridSpec) -> int:
        bits = 4 * sum(int(o.size) for o in self.opcodes)
        for lvl, s in enumerate(self.selects):
            bw = max(1, math.ceil(math.log2(max(grid.vc_in_width(lvl), 2))))
            bits += bw * int(s.size)
        out_bw = max(1, math.ceil(math.log2(max(grid.pes_per_level[-1], 2))))
        bits += out_bw * int(self.out_sel.size)
        return bits

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "app_name": self.app_name,
                "grid_name": self.grid_name,
                "opcodes": [o.tolist() for o in self.opcodes],
                "selects": [s.tolist() for s in self.selects],
                "out_sel": self.out_sel.tolist(),
                "input_order": list(self.input_order),
                "const_values": self.const_values,
                "ingest": self.ingest.to_dict() if self.ingest else None,
            }
        )

    @staticmethod
    def from_json(text: str) -> "VCGRAConfig":
        d = json.loads(text)
        return VCGRAConfig(
            app_name=d["app_name"],
            grid_name=d["grid_name"],
            opcodes=[np.asarray(o, dtype=np.int32) for o in d["opcodes"]],
            selects=[np.asarray(s, dtype=np.int32).reshape(-1, 2) for s in d["selects"]],
            out_sel=np.asarray(d["out_sel"], dtype=np.int32),
            input_order=tuple(d["input_order"]),
            const_values={k: float(v) for k, v in d["const_values"].items()},
            ingest=IngestPlan.from_dict(d["ingest"]) if d.get("ingest") else None,
        )


def assemble(placement: Placement, routing: Routing, grid: GridSpec) -> VCGRAConfig:
    """PaR result + grid -> settings (paper's specialization-stage input)."""
    opcodes: List[np.ndarray] = []
    for lvl, cells in enumerate(placement.cells):
        ops = np.zeros((grid.pes_per_level[lvl],), dtype=np.int32)  # NONE fill
        for slot, c in enumerate(cells):
            ops[slot] = int(c.op)
        opcodes.append(ops)
    input_order = tuple(placement.dfg.inputs)
    const_values = dict(placement.dfg.const_values)
    try:
        ingest = plan_for(input_order, const_values, grid.num_inputs)
    except IngestError:
        ingest = None  # not image-feedable; unfused named-channel path only
    return VCGRAConfig(
        app_name=placement.dfg.name,
        grid_name=grid.name,
        opcodes=opcodes,
        selects=[s.copy() for s in routing.sel],
        out_sel=routing.out_sel.copy(),
        input_order=input_order,
        const_values=const_values,
        ingest=ingest,
    )


def from_reference(
    opcodes: Sequence[np.ndarray],
    selects: Sequence[np.ndarray],
    out_sel: np.ndarray,
    input_order: Sequence[str],
    const_values: Dict[str, float],
    ingest: Optional[dict] = None,
    *,
    app_name: str = "",
    grid_name: str = "",
) -> VCGRAConfig:
    """Carry settings mapped by the JAX reference package into the port.

    Settings play the part weights play in a model port: the reference's
    ``VCGRAConfig`` fields arrive as numpy arrays plus a plain dict (its
    ``IngestPlan.to_dict()``), so the port never imports the reference.
    The result serializes byte-identically to the source config."""
    return VCGRAConfig(
        app_name=app_name,
        grid_name=grid_name,
        opcodes=[np.asarray(o, dtype=np.int32) for o in opcodes],
        selects=[np.asarray(s, dtype=np.int32).reshape(-1, 2) for s in selects],
        out_sel=np.asarray(out_sel, dtype=np.int32),
        input_order=tuple(input_order),
        const_values={k: float(v) for k, v in const_values.items()},
        ingest=IngestPlan.from_dict(ingest) if ingest else None,
    )
