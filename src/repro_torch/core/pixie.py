"""The VCGRA tool flow entry point: application graph -> settings.

Only :func:`map_app` is ported so far; the ``Pixie`` facade (timed
compile/map/reconfigure/execute stages) comes with the single-app kernels.
"""

from __future__ import annotations

from repro_torch.core.bitstream import VCGRAConfig, assemble
from repro_torch.core.dfg import DFG
from repro_torch.core.grid import GridSpec
from repro_torch.core.place import place
from repro_torch.core.route import route


def map_app(dfg: DFG, grid: GridSpec) -> VCGRAConfig:
    """The full VCGRA tool flow: netlist -> placement -> routing -> settings."""
    placement = place(dfg, grid)
    routing = route(placement, grid)
    return assemble(placement, routing, grid)
