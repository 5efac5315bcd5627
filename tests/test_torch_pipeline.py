"""Port parity, chained requests: the pipeline plan axis, the chain
executors, B3's plain version and the fleet/front-end chain path of
``repro_torch`` against the JAX reference on the same settings and frames.

Outputs are bitwise for int32/int16/float32 grids and within the
reference's 0.5 for bf16.  The reference's Pallas chain runs in interpret
mode, as ``tests/test_pipeline.py`` runs it off the TPU.  The port's
``backend="hopper"`` on the CPU is B3's plain version (``ref.py``); the
CUDA kernel itself is held against that plain version on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import shared_app_grid

from repro.core import applications as r_apps
from repro.core import compile_plan as r_compile_plan
from repro.core import map_app as r_map_app
from repro.core.bitstream import VCGRAConfig as RConfig
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.core.ingest import IngestPlan as RPlan
from repro.core.plan import OverlayPlan as ROverlayPlan
from repro.core.plan import PipelineSpec as RSpec, PipelineStage as RStage
from repro.kernels.vcgra import pack_settings_batched as r_pack
from repro.kernels.vcgra.vcgra_kernel import vcgra_pipeline_batched as r_pallas_pipeline
from repro.runtime.fleet import FleetRequest as RRequest, PixieFleet as RFleet
from repro.serve.fleet_frontend import FleetFrontend as RFrontend

from repro_torch.core import applications as t_apps
from repro_torch.core.bitstream import VCGRAConfig as TConfig
from repro_torch.core.ingest import IngestPlan as TPlan
from repro_torch.core.plan import OverlayPlan, PipelineSpec, PipelineStage, compile_plan
from repro_torch.core.plan import pipeline_digest, replace_plan
from repro_torch.kernels.vcgra import (
    LAUNCHES, pack_settings_batched, reset_launch_counts, vcgra_pipeline_batched,
    vcgra_pipeline_batched_ref,
)
from repro_torch.runtime.fleet import FleetRequest as TRequest, PixieFleet as TFleet
from repro_torch.serve import FleetFrontend as TFrontend

from test_torch_core import DTYPES, assert_parity, port_config, port_grid, with_dtype
from test_torch_fleet import assert_same_stats, frames

CHAIN = ["gauss3", "sobel_x", "threshold"]
R_GRID = shared_app_grid(CHAIN, name="pipe-shared")
T_GRID = port_grid(R_GRID)
PORT_BACKENDS = ["torch", "hopper"]

#: Chains of library apps on the pipe-shared grid, as (name, stage radius).
CHAINS = {
    "depth3": [("gauss3", 1), ("sobel_x", 1), ("threshold", 1)],
    "r10": [("gauss3", 1), ("threshold", 0)],
    "r01": [("threshold", 0), ("sobel_x", 1)],
    "depth4": [("gauss3", 1), ("threshold", 0), ("sobel_x", 1), ("threshold", 1)],
}


def r_spec(stages, grid=R_GRID):
    """A reference chain of library apps re-planned at the given radii."""
    return RSpec(tuple(
        RStage(r_map_app(r_apps.ALL_APPS[name](), grid)).at_radius(r) for name, r in stages
    ))


def t_spec(spec):
    """The port's twin of a reference chain, settings carried through JSON."""
    return PipelineSpec(tuple(
        PipelineStage(port_config(s.config), s.out_channel) for s in spec.stages
    ))


def r_stage_settings(specs, grid):
    return tuple(
        (RConfig.stack([s.stages[si].config for s in specs]),
         RPlan.stack([s.stages[si].config.ingest for s in specs], grid.dtype),
         jnp.asarray([s.stages[si].out_channel for s in specs], jnp.int32))
        for si in range(specs[0].depth)
    )


def t_stage_settings(specs, grid):
    return tuple(
        (TConfig.stack([s.stages[si].config for s in specs]),
         TPlan.stack([s.stages[si].config.ingest for s in specs], grid.dtype),
         torch.tensor([s.stages[si].out_channel for s in specs], dtype=torch.int32))
        for si in range(specs[0].depth)
    )


def ragged_stack(seed, hws):
    """Frames of the given sizes embedded top-left in one zero canvas."""
    rng = np.random.default_rng(seed)
    canvas = np.zeros((len(hws), max(h for h, _ in hws), max(w for _, w in hws)), np.int32)
    for i, (h, w) in enumerate(hws):
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w))
    return canvas, np.asarray(hws, np.int32)


def reference_chain(specs, canvas, hw, grid=R_GRID):
    plan = ROverlayPlan(grid=grid, batched=True, pipeline=tuple(specs), backend="xla")
    return r_compile_plan(plan)(r_stage_settings(specs, grid), jnp.asarray(hw),
                                jnp.asarray(canvas))


def port_chain(specs, canvas, hw, backend, grid=T_GRID, tile_rows=None):
    plan = OverlayPlan(grid=grid, batched=True, pipeline=tuple(specs), backend=backend,
                       tile_rows=tile_rows)
    return compile_plan(plan)(t_stage_settings(specs, grid), torch.from_numpy(hw),
                              torch.from_numpy(canvas))


# -- spec and plan algebra -----------------------------------------------------


STAGE = {"ref": RStage, "port": PipelineStage}
SPEC = {"ref": RSpec, "port": PipelineSpec}


def _cfg(pkg, name, grid=R_GRID):
    cfg = r_map_app(r_apps.ALL_APPS[name](), grid)
    return port_config(cfg) if pkg == "port" else cfg


def _plan(pkg, batched=True, radius=None, grid=R_GRID, specs=None):
    specs = (SPEC[pkg].chain([_cfg(pkg, n) for n in CHAIN]),) if specs is None else specs
    if pkg == "port":
        return OverlayPlan(grid=port_grid(grid), batched=batched, radius=radius,
                           pipeline=specs)
    return ROverlayPlan(grid=grid, batched=batched, radius=radius, pipeline=specs)


#: case -> (message both packages raise, builder taking "ref" or "port").
VALIDATION_CASES = {
    "stage without ingest": ("no ingest", lambda pkg: STAGE[pkg](
        dataclasses.replace(_cfg(pkg, "gauss3"), ingest=None))),
    "out_channel range": ("out_channel", lambda pkg: STAGE[pkg](
        _cfg(pkg, "gauss3"), out_channel=1)),
    "empty spec": ("at least one stage", lambda pkg: SPEC[pkg](())),
    "mixed grids": ("ONE overlay grid", lambda pkg: SPEC[pkg].chain([
        _cfg(pkg, "gauss3"), _cfg(pkg, "sobel_x", shared_app_grid(CHAIN, name="pipe-other"))])),
    "out_channels length": ("out_channels for", lambda pkg: SPEC[pkg].chain(
        [_cfg(pkg, "gauss3")], [0, 0])),
    "plan not batched": ("batched", lambda pkg: _plan(pkg, batched=False)),
    "plan with radius": ("radius is derived", lambda pkg: _plan(pkg, radius=1)),
    "plan on another grid": ("cannot run on plan grid", lambda pkg: _plan(
        pkg, grid=shared_app_grid(CHAIN, name="pipe-other2"))),
    "plan with two structures": ("stage structure", lambda pkg: _plan(pkg, specs=(
        SPEC[pkg].chain([_cfg(pkg, n) for n in CHAIN]),
        SPEC[pkg].chain([_cfg(pkg, n) for n in CHAIN[:2]])))),
    "plan with no specs": ("non-empty sequence", lambda pkg: _plan(pkg, specs=())),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_spec_and_plan_validation_match_reference(case):
    match, build = VALIDATION_CASES[case]
    for pkg in ("ref", "port"):
        with pytest.raises(ValueError, match=match):
            build(pkg)


def test_depth1_chain_canonicalizes_to_plain_fused_plan():
    spec = t_spec(r_spec(CHAINS["depth3"][:1]))
    p_pipe = OverlayPlan(grid=T_GRID, batched=True, pipeline=(spec, spec), backend="hopper")
    p_plain = OverlayPlan(grid=T_GRID, batched=True, fused=True, radius=1, backend="hopper")
    assert p_pipe.pipeline is None and p_pipe.fused and p_pipe.radius == 1
    assert p_pipe == p_plain and hash(p_pipe) == hash(p_plain)
    assert p_pipe.key() == p_plain.key()


@pytest.mark.parametrize("tile_rows", [None, "auto", 5])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_port_keys_equal_reference_keys_but_for_backend(backend, tile_rows):
    """The digest is byte-identical to the reference's: only the backend
    segment of a chain plan's key differs."""
    for stages in CHAINS.values():
        rs = r_spec(stages)
        r_plan = ROverlayPlan(grid=R_GRID, batched=True, pipeline=(rs, rs),
                              tile_rows=tile_rows)
        t_plan = OverlayPlan(grid=T_GRID, batched=True, pipeline=(t_spec(rs),) * 2,
                             backend=backend, tile_rows=tile_rows)
        assert t_spec(rs).digest == rs.digest
        assert t_plan.key() == r_plan.key().replace("|xla|", f"|{backend}|")
        assert t_plan.radius == max(rs.radii)
        assert f"|pipe{pipeline_digest(t_plan.pipeline)[:12]}" in t_plan.key()
        assert replace_plan(t_plan, tile_rows=None).pipeline == t_plan.pipeline


def test_at_radius_suffixes_the_cache_key():
    thr = _cfg("port", "threshold")
    thr.cache_key = "thr@pipe-shared"
    stage = PipelineStage(thr)
    r0 = stage.at_radius(0)
    assert stage.radius == 1 and r0.radius == 0 and r0 != stage
    assert r0.config.cache_key == "thr@pipe-shared@r0"
    assert thr.cache_key == "thr@pipe-shared"
    assert stage.at_radius(1) is stage
    r_thr = _cfg("ref", "threshold")
    r_thr.cache_key = "thr@pipe-shared"
    assert RStage(r_thr).at_radius(0).digest == r0.digest


# -- chain executors -----------------------------------------------------------

RAGGED = [(24, 16), (20, 13), (17, 16)]


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_executor_matches_reference_xla(backend, chain):
    """A ragged 3-frame stack through every chain shape (depth 2-4, radius
    0 stages first and last): both port backends equal the reference's
    XLA chain for every row-tile height."""
    spec = r_spec(CHAINS[chain])
    canvas, hw = ragged_stack(0, RAGGED)
    want = reference_chain([spec] * 3, canvas, hw)
    for tile_rows in (None, 5, 8):
        got = port_chain([t_spec(spec)] * 3, canvas, hw, backend, tile_rows=tile_rows)
        assert_parity(got, want, "int32")


@pytest.mark.parametrize("dtype_name", ["int16", "float32", "bfloat16"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_executor_matches_reference_xla_dtypes(backend, dtype_name):
    r_grid = with_dtype(R_GRID, dtype_name)
    spec = r_spec(CHAINS["depth3"], grid=r_grid)
    canvas, hw = ragged_stack(1, RAGGED[:2])
    want = reference_chain([spec] * 2, canvas, hw, grid=r_grid)
    got = port_chain([t_spec(spec)] * 2, canvas, hw, backend, grid=port_grid(r_grid))
    assert_parity(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", ["int32", "bfloat16"])
def test_plain_version_matches_pallas_chain(dtype_name):
    """B3's plain version against the reference's Pallas chain (interpret
    mode) on library configs: the depth-3 chain over a ragged stack with
    per-app hw (int32 also with a tile height that does not divide the
    canvas)."""
    r_grid = with_dtype(R_GRID, dtype_name)
    t_grid = port_grid(r_grid)
    _, _, jdt, tdt = DTYPES[dtype_name]
    tile_rows = 4 if dtype_name == "int32" else None
    spec = r_spec(CHAINS["depth3"], grid=r_grid)
    specs = [spec] * 3
    canvas, hw = ragged_stack(2, [(11, 9), (7, 6), (9, 8)])
    r_settings, t_settings = [], []
    for si in range(spec.depth):
        r_cfgs = [s.stages[si].config for s in specs]
        r_settings.append(r_pack(r_grid, RConfig.stack(r_cfgs)))
        t_settings.append(pack_settings_batched(
            t_grid, TConfig.stack([port_config(c) for c in r_cfgs])))
    r_ings = [RPlan.stack([s.stages[si].config.ingest for s in specs], jdt)
              for si in range(spec.depth)]
    out_chs = np.zeros((spec.depth, len(specs)), np.int32)
    want = r_pallas_pipeline(
        r_grid, spec.radii, tuple(jnp.stack([s[j] for s in r_settings]) for j in range(3)),
        (jnp.stack([i[0] for i in r_ings]), jnp.stack([i[1] for i in r_ings])),
        jnp.asarray(out_chs), jnp.asarray(hw), jnp.asarray(canvas), interpret=True,
        tile_rows=tile_rows)
    t_ings = [TPlan.stack([port_config(s.stages[si].config).ingest for s in specs], tdt)
              for si in range(spec.depth)]
    args = (tuple(torch.stack([s[j] for s in t_settings]) for j in range(3)),
            (torch.stack([i[0] for i in t_ings]), torch.stack([i[1] for i in t_ings])),
            torch.from_numpy(out_chs), torch.from_numpy(hw), torch.from_numpy(canvas))
    assert_parity(vcgra_pipeline_batched_ref(t_grid, spec.radii, *args), want, dtype_name)
    reset_launch_counts()
    got = vcgra_pipeline_batched(t_grid, spec.radii, *args, tile_rows=tile_rows)
    assert LAUNCHES["vcgra_pipeline_batched"] == 0   # CPU tensors: the plain version
    assert_parity(got, want, dtype_name)


def permuted_gauss3():
    """gauss3 with its last level's slots 0 and 1 swapped and the output
    mux pointing at slot 1: the same application, another slot layout."""
    g = r_map_app(r_apps.ALL_APPS["gauss3"](), R_GRID)
    assert list(g.out_sel) == [0] and len(g.opcodes[-1]) >= 2
    ops, sel = g.opcodes[-1].copy(), g.selects[-1].copy()
    ops[[0, 1]], sel[[0, 1]] = ops[[1, 0]], sel[[1, 0]]
    return g, dataclasses.replace(g, opcodes=g.opcodes[:-1] + [ops],
                                  selects=g.selects[:-1] + [sel],
                                  out_sel=np.asarray([1], np.int32), cache_key=None)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_permuted_out_sel_follows_the_xla_oracle(backend):
    """Between stages the port forwards output channel ``out_ch`` (the
    output mux's pick, ``ys[out_ch]``), as the reference's XLA oracle does.
    The reference's Pallas chain body forwards the raw last-level slot
    ``prev[out_ch]`` instead (``vcgra_kernel.py:551-554``); the two agree
    only when ``out_sel[out_ch] == out_ch``, which this config breaks on
    purpose, so the Pallas chain is not the reference here."""
    g, perm = permuted_gauss3()
    sob = r_map_app(r_apps.ALL_APPS["sobel_x"](), R_GRID)
    canvas, hw = ragged_stack(3, [(13, 11)])
    single = ROverlayPlan(grid=R_GRID, batched=True, fused=True, radius=1)
    one = [r_compile_plan(single)(RConfig.stack([c]), RPlan.stack([c.ingest], jnp.int32),
                                  jnp.asarray(canvas)) for c in (g, perm)]
    np.testing.assert_array_equal(np.asarray(one[0]), np.asarray(one[1]))
    spec = RSpec.chain([perm, sob])
    want = reference_chain([spec], canvas, hw)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(reference_chain([RSpec.chain([g, sob])], canvas, hw)))
    assert_parity(port_chain([t_spec(spec)], canvas, hw, backend), want, "int32")


# -- fleet and front-end -------------------------------------------------------


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_mixed_fleet_flush_matches_reference(backend):
    """Two chain radii groups (the short chain with explicit default
    ``out_channels``), a depth-1 chain, single-stage image and
    named-channel requests in ONE flush, twice (the repeat hits every
    cache): bitwise outputs, equal counters and plan keys that differ only
    in the backend segment."""
    r_grid = r_sobel_grid()
    imgs = frames(7, [(9, 13), (16, 5), (6, 6), (11, 11), (7, 9)])
    taps = {k: np.asarray(v) for k, v in r_apps.stencil_inputs(imgs[2]).items()}
    trace = [
        ("pipe", ["sharpen", "sobel_x", "threshold"], imgs[0]),
        ("app", "laplace", imgs[1]),
        ("pipe", ["sobel_x", "threshold"], imgs[2]),
        ("inputs", "sharpen", taps),
        ("pipe", ["sharpen", "sobel_x", "threshold"], imgs[3]),
        ("pipe", ["threshold"], imgs[4]),
    ]

    def requests(Request):
        out = []
        for kind, app, data in trace:
            if kind == "pipe":
                out.append(Request(pipeline=app, image=data,
                                   out_channels=[0] * len(app) if len(app) == 2 else None))
            elif kind == "app":
                out.append(Request(app=app, image=data))
            else:
                out.append(Request(app=app, inputs=data))
        return out

    r_fleet = RFleet(default_grid=r_grid, backend="xla", batch_tile=2)
    t_fleet = TFleet(default_grid=port_grid(r_grid), backend=backend, batch_tile=2,
                     device="cpu")
    for _ in range(2):
        want = r_fleet.run_many(requests(RRequest))
        got = t_fleet.run_many(requests(TRequest))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert_same_stats(t_fleet.stats, r_fleet.stats, backend)
    assert t_fleet.stats.pipeline_dispatches == 4
    assert sum("|pipe" in k for k in t_fleet.stats.dispatch_plans) == 2
    for i in (0, 2, 4):
        np.testing.assert_array_equal(got[i], staged_numpy_oracle(trace[i][1], trace[i][2]))


def staged_numpy_oracle(names, img):
    """The library's numpy oracles composed stage by stage, each stage on
    the previous stage's [h, w] output."""
    kernels = {"sobel_x": (t_apps.SOBEL_X, 1.0), "sharpen": (t_apps.SHARPEN, 1.0),
               "laplace": (t_apps.LAPLACE, 1.0), "gauss3": (t_apps.GAUSS3, 16.0)}
    cur = img.astype(np.int32)
    for name in names:
        if name == "threshold":
            cur = (cur > 128).astype(np.int32)
        else:
            cur = t_apps.conv2d_reference(cur, *kernels[name])
    return cur


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_frontend_chain_submit_naming_and_depth1_demotion(backend):
    img = frames(8, [(10, 12)])[0]
    svc = TFrontend(fleet=TFleet(default_grid=T_GRID, backend=backend, device="cpu"))
    r_svc = RFrontend(fleet=RFleet(default_grid=R_GRID))
    h, r_h = svc.submit(CHAIN, img), r_svc.submit(CHAIN, img)
    np.testing.assert_array_equal(h.result(), np.asarray(r_h.result()))
    np.testing.assert_array_equal(h.result(), staged_numpy_oracle(CHAIN, img))
    assert h.job().app == r_h.job().app == "gauss3+sobel_x+threshold"
    assert svc.stats.pipeline_dispatches == 1 and svc.stats.dispatches == 1

    plain = TFrontend(fleet=TFleet(default_grid=T_GRID, backend=backend, device="cpu"))
    a = plain.submit("sobel_x", img).result()
    b = plain.submit(("sobel_x",), img).result()
    np.testing.assert_array_equal(a, b)
    assert plain.stats.pipeline_dispatches == 0 and plain.stats.overlay_builds == 1
    assert all("|pipe" not in k for k in plain.stats.dispatch_plans)
    assert plain.available_apps() == r_svc.available_apps()


SUBMIT_ERRORS = {
    "app and pipeline": ("not both", dict(app="sobel_x", pipeline=CHAIN)),
    "neither": ("app= or pipeline=", {}),
    "pipeline with inputs": ("image", dict(pipeline=CHAIN, inputs={"x": np.zeros(4)})),
    "empty pipeline": ("at least one stage", dict(pipeline=[])),
    "flat image": (r"image must be \[H, W\]", dict(pipeline=CHAIN, image=np.zeros(4))),
    "out_channels length": ("out_channels for", dict(pipeline=CHAIN, out_channels=[0])),
}


@pytest.mark.parametrize("case", sorted(SUBMIT_ERRORS))
def test_pipeline_submit_errors_match_reference(case):
    match, fields = SUBMIT_ERRORS[case]
    fields = {"image": np.zeros((8, 8), np.int32), **fields}
    for fleet, Request in ((RFleet(default_grid=R_GRID), RRequest),
                           (TFleet(default_grid=T_GRID, device="cpu"), TRequest)):
        with pytest.raises(ValueError, match=match):
            fleet.submit(Request(**fields))
        assert fleet.pending_count() == 0


def test_pipeline_stage_without_ingest_plan_is_refused_at_submit():
    cfg = dataclasses.replace(_cfg("port", "sobel_x"), ingest=None)
    fleet = TFleet(default_grid=T_GRID, device="cpu")
    with pytest.raises(ValueError, match="no ingest plan"):
        fleet.submit(TRequest(pipeline=["gauss3", cfg], image=np.zeros((4, 4))))
