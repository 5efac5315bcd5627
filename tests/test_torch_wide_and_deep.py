"""Image requests past the shapes the library apps need, on the port's
hopper path against the JAX reference: chains whose stage radii add up to
more than one B3 window holds (16 px), served as segments
(``ops.chain_segments``) that hand each other their masked forward, and
grids wider than 64 values (a 7 x 7 convolution mapped on its exact grid).

On the CPU the hopper wrappers run their plain versions, segment by
segment as the card runs its kernels, so these tests hold the segment plan
and the forward to ``repro``'s XLA backend.  The kernels themselves are
held to the same plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.core.dfg import DFG
from repro.core.grid import for_dfg as r_for_dfg
from repro.core.ingest import plan_for as r_plan_for
from repro.core.pixie import map_app as r_map_app
from repro.runtime.fleet import FleetRequest as RRequest, PixieFleet as RFleet

from repro_torch.kernels.vcgra import (
    LAUNCHES, pack_settings_batched, reset_launch_counts, vcgra_pipeline_batched,
    vcgra_pipeline_batched_ref,
)
from repro_torch.kernels.vcgra.ops import chain_segments
from repro_torch.runtime.fleet import FleetRequest, PixieFleet

from test_torch_core import assert_parity, port_config, port_grid, with_dtype
from test_torch_fleet import frames
from test_torch_pipeline import (
    R_GRID, T_GRID, port_chain, r_spec, ragged_stack, reference_chain, staged_numpy_oracle,
    t_spec, t_stage_settings,
)

#: Deep chains by total radius and their segments: 17 and 33 gauss3
#: stages (a lone stage past 16 px is the segment planner's test in
#: ``test_torch_vcgra_launch.py`` and the card's; the reference's XLA chain
#: compiles a radius-20 stage's 1,681-tap bank in ~20 s).
DEEP = {
    17: ([("gauss3", 1)] * 17, ((0, 16), (16, 17))),
    33: ([("gauss3", 1)] * 33, ((0, 16), (16, 32), (32, 33))),
}


def chain_operands(specs, grid, hw, canvas):
    """B3's stage-stacked operands, packed as ``ops.pipeline_fn`` packs a
    plan's stage settings."""
    stages = t_stage_settings(specs, grid)
    packed = [pack_settings_batched(grid, configs) for configs, _, _ in stages]
    return (tuple(torch.stack([p[j] for p in packed]) for j in range(3)),
            (torch.stack([ing[0].to(torch.int32) for _, ing, _ in stages]),
             torch.stack([ing[1].to(grid.dtype) for _, ing, _ in stages])),
            torch.stack([oc.to(torch.int32) for _, _, oc in stages]),
            torch.from_numpy(hw), torch.from_numpy(canvas))


#: The dtypes in which a chain is also held to the reference's XLA chain
#: (one XLA compile of ~2-3 s each): every dtype at R = 17, int32 at R = 33,
#: whose third segment and second forward run the code R = 17 runs.
REFERENCE_DTYPES = {17: ("int32", "int16", "float32", "bfloat16"), 33: ("int32",)}


@pytest.mark.parametrize("dtype_name", ["int32", "int16", "float32", "bfloat16"])
@pytest.mark.parametrize("R", sorted(DEEP))
def test_segmented_chain_equals_the_whole_chain_and_the_reference(R, dtype_name):
    """A chain past one window: the hopper executor (segments, each
    forwarding its masked output as the next one's frame) and the hopper
    plan's chain equal the plain chain run whole, bitwise, and the
    reference's XLA chain (:data:`REFERENCE_DTYPES`)."""
    chain, segments = DEEP[R]
    r_grid = with_dtype(R_GRID, dtype_name)
    t_grid = port_grid(r_grid)
    spec = r_spec(chain, grid=r_grid)
    assert sum(spec.radii) == R and chain_segments(spec.radii) == segments
    canvas, hw = ragged_stack(R, [(20, 24), (13, 9)])
    args = chain_operands([t_spec(spec)] * 2, t_grid, hw, canvas)
    whole = vcgra_pipeline_batched_ref(t_grid, spec.radii, *args)
    reset_launch_counts()
    segmented = vcgra_pipeline_batched(t_grid, spec.radii, *args)
    assert LAUNCHES["vcgra_pipeline_batched"] == 0   # CPU tensors: the plain versions
    assert torch.equal(segmented, whole)
    assert torch.equal(port_chain([t_spec(spec)] * 2, canvas, hw, "hopper", grid=t_grid), whole)
    if dtype_name in REFERENCE_DTYPES[R]:
        assert_parity(whole, reference_chain([spec] * 2, canvas, hw, grid=r_grid), dtype_name)


def conv7_dfg():
    """A 7 x 7 convolution built as ``applications.conv3x3`` builds its
    3 x 3: a tap and a coefficient const a product, a left-paired sum
    tree."""
    g = DFG("conv7")
    prods = []
    for dj in range(-3, 4):
        for di in range(-3, 4):
            k = g.const(f"k{dj + 3}{di + 3}", float((dj + 4) * (di + 5) % 7 - 3))
            prods.append(g.mul(g.input(r_apps.tap_name(dj, di)), k))
    g.output(r_apps._sum_tree(g, prods))
    return g


@pytest.mark.parametrize("dtype_name", ["int32", "float32"])
def test_conv7_on_its_exact_grid_is_served_as_the_reference_serves_it(dtype_name):
    """``for_dfg(conv7, shape="exact")`` is 98 values wide; with the fused
    ingest of a radius-3 tap bank a hopper fleet serves it bitwise as the
    reference's xla fleet, without a refusal at submit."""
    bits = {"int32": (32, False), "float32": (32, True)}[dtype_name]
    r_grid = r_for_dfg(conv7_dfg(), shape="exact", data_bits=bits[0], float_pe=bits[1])
    assert r_grid.name == "conv7-exact" and r_grid.num_inputs == 98
    assert list(r_grid.pes_per_level) == [49, 25, 13, 7, 4, 2, 1]
    cfg = r_map_app(conv7_dfg(), r_grid)
    cfg.ingest = r_plan_for(cfg.input_order, cfg.const_values, r_grid.num_inputs, radius=3)
    imgs = [f.astype(np.float32 if bits[1] else np.int32)
            for f in frames(70, [(23, 31), (9, 12)])]
    want = RFleet(backend="xla", default_grid=r_grid).run_many(
        [RRequest(app=cfg, image=img) for img in imgs])
    t_cfg, t_grid = port_config(cfg), port_grid(r_grid)
    fleet = PixieFleet(backend="hopper", device="cpu", default_grid=t_grid)
    got = fleet.run_many([FleetRequest(app=t_cfg, image=img) for img in imgs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert fleet.stats.fused_dispatches == 1 and fleet.stats.fallback_dispatches == 0


def test_mixed_flush_with_a_17_stage_chain_serves_every_request():
    """One flush on the pipe-shared grid: a 17-stage gauss3 chain (two B3
    segments) beside a depth-3 chain and single-stage requests; every
    request served, bitwise the reference's xla fleet and the staged numpy
    oracle."""
    deep = ["gauss3"] * 17
    trace = [(deep, (20, 24)), (["gauss3", "sobel_x", "threshold"], (16, 11)),
             ("gauss3", (13, 13)), ("threshold", (9, 17)), (deep, (7, 30))]
    imgs = frames(71, [hw for _, hw in trace])

    def requests(Request):
        return [Request(pipeline=app, image=img) if isinstance(app, list)
                else Request(app=app, image=img) for (app, _), img in zip(trace, imgs)]

    want = RFleet(backend="xla", default_grid=R_GRID).run_many(requests(RRequest))
    fleet = PixieFleet(backend="hopper", device="cpu", default_grid=T_GRID)
    got = fleet.run_many(requests(FleetRequest))
    for (app, _), img, g, w in zip(trace, imgs, got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        if isinstance(app, list):
            np.testing.assert_array_equal(g, staged_numpy_oracle(app, img))
    assert fleet.stats.pipeline_dispatches == 2
    assert fleet.stats.fallback_dispatches == fleet.stats.retries == 0
