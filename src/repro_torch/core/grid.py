"""VCGRA grid specification and the grid-generator tool.

Paper Sec. III-C: "Describing the whole VCGRA grid in VHDL is a time
consuming task. Therefore we developed a tool that automatically creates
the VHDL top-level description of a VCGRA from a description of the
hardware structure. The only inputs needed are the number of input
elements from memory and the structure of the grid ... All other
parameters (e.g. for the channels) are automatically derived."

Our generator emits a :class:`GridSpec` (consumed by the interpreter and
the Hopper kernels) instead of VHDL; the derived channel
parameters follow the paper's Eqs. (1)-(3):

  N  = max{A, B, C, D, ...}                  (internal channel bitwidth)
  M  = #predecessors                         (valid-vector width)
  bw = ceil(log2(#predecessors))             (mux config-word width)

Shapes: in addition to the rectangular style the generator supports an
arbitrary number of PEs per level ("application specific grid designs"),
e.g. the inverted-triangular shape the paper suggests for reduction trees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.dfg import DFG


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static structure of a VCGRA overlay instance.

    The structure (like the FPGA overlay bitstream's *shape*) is fixed at
    overlay-compile time; only the settings (opcodes, routing selects) are
    reconfigurable afterwards.
    """

    name: str
    num_inputs: int                      # memory-interface VC width (top)
    pes_per_level: Tuple[int, ...]       # PEs in each pipeline level
    num_outputs: int                     # bottom (memory-interface) VC width
    data_bits: int = 32                  # PE data bitwidth (paper: configurable)
    float_pe: bool = False               # fixed-point vs FloPoCo-float PE flavour

    # -- derived structure -------------------------------------------------

    @property
    def num_levels(self) -> int:
        return len(self.pes_per_level)

    @property
    def num_pes(self) -> int:
        return sum(self.pes_per_level)

    def vc_in_width(self, level: int) -> int:
        """#predecessor signals entering the VC above `level` (M in Eq. 2)."""
        if level == 0:
            return self.num_inputs
        return self.pes_per_level[level - 1]

    def vc_out_ports(self, level: int) -> int:
        """#mux outputs of the VC above `level` = 2 ports per PE."""
        return 2 * self.pes_per_level[level]

    @property
    def num_vcs(self) -> int:
        # One VC above each PE level plus the bottom output VC.
        return self.num_levels + 1

    @property
    def dtype(self) -> torch.dtype:
        if self.float_pe:
            return torch.float32 if self.data_bits > 16 else torch.bfloat16
        return torch.int32 if self.data_bits > 16 else torch.int16

    # -- paper Eq. (1)-(3) resource model -----------------------------------

    def channel_params(self, level: int) -> Dict[str, int]:
        preds = self.vc_in_width(level)
        return {
            "N_internal_bitwidth": self.data_bits,          # Eq. (1), uniform bw here
            "M_valid_vector": preds,                        # Eq. (2)
            "bw_mux_config_word": max(1, math.ceil(math.log2(max(preds, 2)))),  # Eq. (3)
        }

    def settings_bits(self) -> Dict[str, int]:
        """Total settings-register ("bitstream") size of the overlay."""
        op_bits = 4  # 12 opcodes
        pe_bits = self.num_pes * op_bits
        vc_bits = 0
        for lvl in range(self.num_levels):
            bw = self.channel_params(lvl)["bw_mux_config_word"]
            vc_bits += bw * self.vc_out_ports(lvl)
        out_bw = max(1, math.ceil(math.log2(max(self.pes_per_level[-1], 2))))
        vc_bits += out_bw * self.num_outputs
        return {"pe_bits": pe_bits, "vc_bits": vc_bits, "total_bits": pe_bits + vc_bits}

    def resource_model(self) -> Dict[str, int]:
        """Structural resource counts (mux instances, buffer registers):
        the architecture-level analogue of the paper's LUT/TCON budget."""
        muxes = sum(self.vc_out_ports(l) for l in range(self.num_levels)) + self.num_outputs
        mux_inputs = sum(
            self.vc_in_width(l) * self.vc_out_ports(l) for l in range(self.num_levels)
        ) + self.pes_per_level[-1] * self.num_outputs
        buffers = self.num_inputs + 2 * self.num_pes + self.num_outputs
        return {
            "pes": self.num_pes,
            "vcs": self.num_vcs,
            "muxes": muxes,
            "mux_input_legs": mux_inputs,
            "data_buffers": buffers,
            **self.settings_bits(),
        }

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        shape = "x".join(str(p) for p in self.pes_per_level)
        kind = "float" if self.float_pe else "fixed"
        return f"GridSpec({self.name}: in={self.num_inputs} [{shape}] out={self.num_outputs} {kind}{self.data_bits})"


# -- the generator tool ------------------------------------------------------


def rectangular(
    name: str,
    num_inputs: int,
    levels: int,
    width: int,
    num_outputs: int = 1,
    data_bits: int = 32,
    float_pe: bool = False,
) -> GridSpec:
    """The paper's default rectangular style: every level has `width` PEs."""
    return GridSpec(name, num_inputs, (width,) * levels, num_outputs, data_bits, float_pe)


def custom(
    name: str,
    num_inputs: int,
    pes_per_level: Sequence[int],
    num_outputs: int = 1,
    data_bits: int = 32,
    float_pe: bool = False,
) -> GridSpec:
    """Arbitrary per-level PE counts ("application specific grid designs")."""
    return GridSpec(name, num_inputs, tuple(int(p) for p in pes_per_level), num_outputs, data_bits, float_pe)


def paper_4x4(data_bits: int = 32, float_pe: bool = False) -> GridSpec:
    """The fully parameterized 4x4 grid of paper Sec. V-C."""
    return rectangular("paper-4x4", 8, 4, 4, num_outputs=4, data_bits=data_bits, float_pe=float_pe)


def sobel_grid(data_bits: int = 32, float_pe: bool = False) -> GridSpec:
    """The Sobel demonstration grid of paper Sec. IV / Fig. 5:
    45 PEs in 5 levels of 9, 4 inter-level VCs, 18 memory inputs
    (9 pixels + 9 coefficients)."""
    return rectangular(
        "sobel-5x9", 18, 5, 9, num_outputs=1, data_bits=data_bits, float_pe=float_pe
    )


def for_dfg(
    dfg: DFG,
    name: str | None = None,
    shape: str = "exact",
    data_bits: int = 32,
    float_pe: bool = False,
) -> GridSpec:
    """Auto-generate a grid that fits `dfg` ("Automatic generation of these
    grids for a specific application class is currently work in progress"
    -- here it is implemented).

    shape='exact'       per-level PE count = per-level demand incl. buffers
    shape='rect'        rectangular, width = max level demand (paper default;
                        yields the many-NONE-PEs effect of Fig. 5)
    shape='triangular'  monotonically non-increasing widths (the paper's
                        suggested optimization for reduction trees)
    """
    from repro_torch.core.place import level_demand  # local import to avoid cycle

    demand = level_demand(dfg)
    if shape == "exact":
        pes = tuple(demand)
    elif shape == "rect":
        pes = (max(demand),) * len(demand)
    elif shape == "triangular":
        pes: List[int] = []
        cur = max(demand)
        for d in demand:
            cur = max(d, min(cur, d if not pes else pes[-1]))
            pes.append(cur)
        pes = tuple(pes)
    else:
        raise ValueError(f"unknown shape {shape!r}")
    return GridSpec(
        name or f"{dfg.name}-{shape}",
        num_inputs=len(dfg.inputs),
        pes_per_level=pes,
        num_outputs=len(dfg.outputs),
        data_bits=data_bits,
        float_pe=float_pe,
    )
