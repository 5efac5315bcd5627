"""The Pixie overlay core: graph IR, the textual synthesis front-end,
grid generator, mapper, settings, eager interpreter, specialization, the
plan layer (with its ``MeshSpec`` device placement) and the ``Pixie``
facade."""

from repro_torch.core.bitstream import VCGRAConfig, assemble, from_reference
from repro_torch.core.dfg import DFG, InRef, NodeRef, reference_eval
from repro_torch.core.grid import GridSpec, custom, for_dfg, paper_4x4, rectangular, sobel_grid
from repro_torch.core.ingest import IngestError, IngestPlan, plan_for, tap_offsets
from repro_torch.core.ops import Op
from repro_torch.core.pixie import Pixie, map_app, sobel_pixie
from repro_torch.core.place import Placement, PlacementError, level_demand, place
from repro_torch.core.plan import (
    OverlayExecutable, OverlayPlan, PipelineSpec, PipelineStage, compile_plan,
    register_executor,
)
from repro_torch.core.route import Routing, RoutingError, route
from repro_torch.core.synthesis import SOBEL_SOURCE, SynthesisError, synthesize
from repro_torch.parallel.axes import MeshSpec

__all__ = [
    "DFG", "InRef", "NodeRef", "reference_eval",
    "GridSpec", "custom", "for_dfg", "paper_4x4", "rectangular", "sobel_grid",
    "IngestError", "IngestPlan", "plan_for", "tap_offsets",
    "MeshSpec",
    "Op", "OverlayExecutable", "OverlayPlan", "PipelineSpec", "PipelineStage",
    "compile_plan", "register_executor",
    "Pixie", "map_app", "sobel_pixie",
    "Placement", "PlacementError", "level_demand", "place",
    "Routing", "RoutingError", "route",
    "VCGRAConfig", "assemble", "from_reference",
    "SOBEL_SOURCE", "SynthesisError", "synthesize",
]
