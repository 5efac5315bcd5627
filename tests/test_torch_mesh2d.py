"""Port parity, the overlay mesh: ``MeshSpec`` on ``OverlayPlan``, app and
row-band sharding with the seam halo exchange, and the fleet's stamps --
twin of ``tests/test_mesh2d.py`` and ``tests/test_mesh2d_property.py``.

A *logical* mesh stands in for the reference CI's four forced host
devices: ``repro_torch.parallel.axes.local_devices`` is replaced by
``[cpu] * 4``, so every shard runs on the CPU, one after another, through
the same split, halo exchange, crop and reassembly a multi-card mesh runs.
Inputs are numpy-seeded.  Every sharded result must be bitwise equal to
the reference's single-device ``backend="xla"`` run for int32, int16 and
float32, and for bf16 within the reference's 0.5 and bitwise equal to the
port's own single-device run.  Without the patch the CPU host has one
device, and a fleet asked for a 2-D mesh degrades and says so.
"""

import contextlib
import dataclasses
import functools
import warnings
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import MeshSpec as RMeshSpec
from repro.core import applications as r_apps
from repro.core import compile_plan as r_compile_plan
from repro.core import map_app as r_map_app
from repro.core import tiling as r_tiling
from repro.core.bitstream import VCGRAConfig as RConfig
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.core.ingest import IngestPlan as RPlan
from repro.core.plan import OverlayPlan as ROverlayPlan
from repro.core.plan import fallback_chain as r_fallback_chain
from repro.runtime import BreakerBoard as RBreakerBoard
from repro.runtime import FaultInjector as RFaultInjector
from repro.runtime.fleet import FleetRequest as RRequest, PixieFleet as RFleet
from repro.serve import FleetFrontend as RFrontend

import repro_torch.parallel.axes as axes
from repro_torch.core import MeshSpec, Pixie, applications as t_apps
from repro_torch.core.bitstream import VCGRAConfig as TConfig
from repro_torch.core.ingest import IngestPlan as TPlan
from repro_torch.core.plan import OverlayPlan, compile_plan, fallback_chain
from repro_torch.core.tiling import row_band
from repro_torch.parallel import ShardedFrames, build_mesh, frame_sharding, halo_exchange_rows
from repro_torch.runtime import BreakerBoard, FaultInjector
from repro_torch.runtime.fleet import FleetRequest, PixieFleet
from repro_torch.serve import FleetFrontend, StreamingFrontend

from test_torch_core import DTYPES, as_numpy, assert_parity, port_config, port_grid, with_dtype
from test_torch_pipeline import (
    R_GRID as R_PIPE_GRID, T_GRID as T_PIPE_GRID, r_spec, ragged_stack,
    reference_chain, t_spec, t_stage_settings,
)

CPU = torch.device("cpu")
R_GRID = r_sobel_grid()
T_GRID = port_grid(R_GRID)
WAIT = 120.0
# Ragged, non-square, mixed-app: the reference's 2-D parity workload.
NAMES = ("sobel_x", "threshold", "sobel_y", "identity")
HWS = ((13, 17), (8, 8), (21, 9), (5, 30))
#: Logical meshes of the parity matrix: rows 2 and 4 do not divide the
#: 21-row canvas, rows 3 does.
SPECS = [MeshSpec(app=2), MeshSpec(rows=2), MeshSpec(app=2, rows=2), MeshSpec(rows=4),
         MeshSpec(rows=3)]
APP_SPECS = [MeshSpec(app=2), MeshSpec(app=4)]
PORT_BACKENDS = ["torch", "hopper"]


@contextlib.contextmanager
def logical_mesh(n=4):
    """``n`` shards of one CPU device, in place of ``n`` local devices."""
    with mock.patch.object(axes, "local_devices", lambda kind="cuda": [CPU] * n):
        yield


@pytest.fixture
def four_devices():
    with logical_mesh():
        yield


def r_mesh(spec):
    return RMeshSpec(app=spec.app, rows=spec.rows)


def port_key(key, backend="torch"):
    return key.replace("|xla|", f"|{backend}|").replace("|pallas|", "|hopper|")


# -- MeshSpec, row_band, keys, validation --------------------------------------


def test_meshspec_validation_and_identity():
    assert MeshSpec() == MeshSpec(app=1, rows=1)
    spec = MeshSpec(app=2, rows=3)
    ref = RMeshSpec(app=2, rows=3)
    assert (spec.size, spec.shape(), str(spec)) == (ref.size, ref.shape(), str(ref)) \
        == (6, (2, 3), "2x3")
    assert spec.app_only() == MeshSpec(app=2)
    assert len({MeshSpec(), MeshSpec(app=1), MeshSpec(rows=2)}) == 2
    for bad, field in ((dict(app=0), "app"), (dict(rows=-1), "rows"), (dict(rows=True), "rows"),
                       (dict(app=2.0), "app")):
        with pytest.raises(ValueError, match=field):
            MeshSpec(**bad)
        with pytest.raises(ValueError, match=field):
            RMeshSpec(**bad)
    with pytest.raises(dataclasses.FrozenInstanceError):
        MeshSpec(app=2).app = 3


@pytest.mark.parametrize("H", [1, 2, 13, 16, 21, 1080])
@pytest.mark.parametrize("rows", [1, 3, 4])
@pytest.mark.parametrize("radius", [0, 1, 7])
def test_row_band_matches_reference(H, rows, radius):
    assert row_band(H, rows, radius) == r_tiling.row_band(H, rows, radius)


def _plans(spec, backend, **kw):
    r_backend = {"torch": "xla", "hopper": "pallas"}[backend]
    return (ROverlayPlan(grid=R_GRID, backend=r_backend, mesh=r_mesh(spec), **kw),
            OverlayPlan(grid=T_GRID, backend=backend, mesh=spec, **kw))


#: (mesh, plan keywords) of the key cases: a rows mesh only on fused plans.
KEY_CASES = [(spec, kw) for spec in (MeshSpec(), MeshSpec(app=2), MeshSpec(app=2, rows=2))
             for kw in (dict(fused=True, radius=1), dict(fused=True, radius=2, tile_rows=8),
                        dict(fused=False)) if spec.rows == 1 or kw["fused"]]


@pytest.mark.parametrize("spec,kw", KEY_CASES, ids=lambda v: str(v) if isinstance(
    v, MeshSpec) else "-".join(f"{k}{w}" for k, w in v.items()))
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_plan_key_equals_reference_key(spec, kw, backend):
    r_plan, t_plan = _plans(spec, backend, batched=True, **kw)
    assert t_plan.key() == port_key(r_plan.key(), backend)
    other = dataclasses.replace(t_plan, mesh=MeshSpec(app=spec.app + 1))
    assert t_plan.mesh == spec and t_plan != other and t_plan.key() != other.key()


def test_deprecated_plan_spelling_is_the_same_plan():
    via_mesh = OverlayPlan(grid=T_GRID, batched=True, fused=True, mesh=MeshSpec(app=2))
    with pytest.warns(DeprecationWarning, match="MeshSpec"):
        via_devices = OverlayPlan(grid=T_GRID, batched=True, fused=True, devices=2)
    assert via_mesh == via_devices and hash(via_mesh) == hash(via_devices)
    assert via_mesh.key() == via_devices.key()
    assert "dev2" in via_mesh.key() and "rows" not in via_mesh.key()
    plan2d = OverlayPlan(grid=T_GRID, batched=True, fused=True, mesh=MeshSpec(app=2, rows=2))
    assert "dev2" in plan2d.key() and "rows2" in plan2d.key() and plan2d != via_mesh


#: case -> (message both packages raise, plan keywords in port names).
PLAN_ERRORS = {
    "not a MeshSpec": ("MeshSpec", dict(batched=True, mesh=2)),
    "app mesh unbatched": ("batched", dict(mesh="app2")),
    "rows mesh unfused": ("fused", dict(batched=True, fused=False, mesh="rows2")),
    "rows mesh single": ("fused", dict(fused=True, mesh="rows2")),
    "both spellings": ("not both", dict(batched=True, mesh="app2", devices=2)),
    "zero devices": ("devices must be", dict(batched=True, devices=0)),
}


@pytest.mark.parametrize("case", sorted(PLAN_ERRORS))
def test_plan_mesh_validation_matches_reference(case):
    message, kw = PLAN_ERRORS[case]
    meshes = {"app2": (RMeshSpec(app=2), MeshSpec(app=2)),
              "rows2": (RMeshSpec(rows=2), MeshSpec(rows=2))}
    for pkg, Plan, grid in ((0, ROverlayPlan, R_GRID), (1, OverlayPlan, T_GRID)):
        args = {k: (meshes[v][pkg] if k == "mesh" and v in meshes else v) for k, v in kw.items()}
        with pytest.raises(ValueError, match=message), warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            Plan(grid=grid, **args)


# -- the deprecated bare device count on every entry point ---------------------


ENTRY_POINTS = {
    "OverlayPlan": lambda **kw: OverlayPlan(grid=T_GRID, batched=True, **kw),
    "PixieFleet": lambda **kw: PixieFleet(default_grid=T_GRID, device="cpu", **kw),
    "Pixie": lambda **kw: Pixie(T_GRID, device="cpu", **kw),
    "FleetFrontend": lambda **kw: FleetFrontend(device="cpu", **kw),
    "StreamingFrontend": lambda **kw: StreamingFrontend(device="cpu", autostart=False, **kw),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_deprecated_device_count_warns_and_means_app_mesh(entry):
    with pytest.warns(DeprecationWarning, match=f"{entry} is deprecated.*MeshSpec"):
        obj = ENTRY_POINTS[entry](devices=1)
    assert obj.mesh == MeshSpec()
    if entry != "OverlayPlan":
        assert obj.devices == 1
    if entry == "StreamingFrontend":
        obj.close()


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_both_device_spellings_are_refused(entry):
    with pytest.raises(ValueError, match="not both"):
        ENTRY_POINTS[entry](mesh=MeshSpec(app=2), devices=1)


def test_pixie_refuses_rows_and_a_parameterized_mesh():
    with pytest.raises(ValueError, match="rows"):
        Pixie(T_GRID, device="cpu", mesh=MeshSpec(rows=2))
    with pytest.raises(ValueError, match="parameterized"):
        Pixie(T_GRID, mode="parameterized", device="cpu", mesh=MeshSpec(app=2))


def test_frontend_mesh_conflict_and_shim():
    fleet = PixieFleet(default_grid=T_GRID, device="cpu", mesh=MeshSpec())
    with pytest.raises(ValueError, match="conflicts"):
        FleetFrontend(fleet=fleet, mesh=MeshSpec(app=2))
    with pytest.raises(ValueError, match="conflicts"):
        StreamingFrontend(fleet=fleet, mesh=MeshSpec(app=2), autostart=False)
    assert FleetFrontend(fleet=fleet, mesh=MeshSpec()).mesh == MeshSpec()


# -- mesh realization and the halo exchange ------------------------------------


def test_build_mesh_grants_only_what_the_host_has():
    assert build_mesh(MeshSpec(), "cpu") is None
    assert build_mesh(MeshSpec(app=2), "cpu") is None     # one CPU device
    assert axes.local_devices("cpu") == [CPU]
    with logical_mesh():
        mesh = build_mesh(MeshSpec(app=2, rows=2))
        assert mesh.shape == {"app": 2, "rows": 2} and mesh.first == CPU
        assert build_mesh(MeshSpec(app=2)).axis_names == ("app",)
        assert build_mesh(MeshSpec(app=4, rows=2)) is None
        assert axes.app_mesh(1) is None and axes.app_mesh(3).app == 3


def test_radius_zero_makes_no_halo_copy(four_devices):
    bands = [torch.ones((2, 4, 8), dtype=torch.int32) * j for j in range(4)]
    axes.reset_copy_counts()
    out = halo_exchange_rows(bands, 0)
    assert all(o is b for o, b in zip(out, bands)) and axes.halo_copies == 0
    # A row-sharded radius-0 dispatch (pointwise apps) exchanges nothing
    # either, and is bitwise the single-device one ...
    _, _, canvas, _ = port_workload("int32")
    cfgs = [port_config(r_map_app(r_apps.ALL_APPS[n](), R_GRID)) for n in ("threshold",
                                                                           "identity") * 2]
    cfgs = [dataclasses.replace(c, ingest=c.ingest.at_radius(0)) for c in cfgs]
    stacked = TConfig.stack(cfgs)
    ingests = TPlan.stack([c.ingest for c in cfgs], T_GRID.dtype)
    plan = OverlayPlan(grid=T_GRID, batched=True, fused=True, radius=0, mesh=MeshSpec(rows=4))
    got = compile_plan(plan)(stacked, ingests, canvas)
    assert axes.halo_copies == 0
    single = dataclasses.replace(plan, mesh=MeshSpec())
    assert torch.equal(got, compile_plan(single)(stacked, ingests, canvas))
    # ... and radius 1 does: each band gets its neighbours' edge rows.
    stacked, ingests, canvas, _ = port_workload("int32")
    compile_plan(dataclasses.replace(plan, radius=1))(stacked, ingests, canvas)
    assert axes.halo_copies == 2 * (4 - 1)


def test_halo_exchange_matches_neighbour_rows():
    """Each band's halo is its neighbours' edge rows, zeros at the frame
    border: ``form_tap_bank``'s zero-pad semantics."""
    full = torch.arange(2 * 8 * 4, dtype=torch.int32).reshape(2, 8, 4)
    r, band = 2, 4
    top, bot = halo_exchange_rows([full[:, :band], full[:, band:]], r)
    assert top.shape == bot.shape == (2, band + 2 * r, 4)
    assert not top[:, :r].any() and not bot[:, r + band:].any()
    assert torch.equal(top[:, r:r + band], full[:, :band])
    assert torch.equal(top[:, r + band:], full[:, band:band + r])
    assert torch.equal(bot[:, :r], full[:, band - r:band])
    assert torch.equal(bot[:, r:r + band], full[:, band:])
    with pytest.raises(ValueError, match="shallower"):
        halo_exchange_rows([full[:, :1], full[:, 1:]], 2)


def test_settings_replicas_are_copied_once_per_device():
    """A repeat flush of a cached bank copies nothing: the chunk on another
    device is made once per source tensor and reused until it changes."""
    bank = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    meta = torch.device("meta")
    axes.reset_copy_counts()
    first = axes.replica(bank, meta, 2, 4)
    assert axes.replica(bank, meta, 2, 4) is first and axes.replica_copies == 1
    assert axes.replica(bank, CPU, 2, 4).data_ptr() == bank[2:].data_ptr()
    bank.add_(1)
    assert axes.replica(bank, meta, 2, 4) is not first and axes.replica_copies == 2


def test_frame_sharding_blocks_feed_a_mesh_executable(four_devices):
    """The fleet's sharded ship path: a canvas handed over block by block
    (``frame_sharding``) gives the same output as the canvas itself."""
    stacked, ingests, canvas, _ = port_workload("int32")
    plan = OverlayPlan(grid=T_GRID, batched=True, fused=True, radius=1,
                       mesh=MeshSpec(app=2, rows=2))
    fn = compile_plan(plan)
    padded = torch.nn.functional.pad(canvas, (0, 0, 0, 1))     # 21 -> 2 bands of 11
    sharding = frame_sharding(fn.mesh)
    blocks = list(sharding.blocks(4, 22))
    assert [(b.i, b.j, b.apps, b.rows) for b in blocks] == [
        (0, 0, slice(0, 2), slice(0, 11)), (0, 1, slice(0, 2), slice(11, 22)),
        (1, 0, slice(2, 4), slice(0, 11)), (1, 1, slice(2, 4), slice(11, 22))]
    frames = sharding.assemble(padded.shape, [padded[b.apps, b.rows].clone() for b in blocks])
    assert isinstance(frames, ShardedFrames) and frames.shape == (4, 22, 30)
    assert torch.equal(fn(stacked, ingests, frames), fn(stacked, ingests, padded))
    with pytest.raises(ValueError, match="does not split"):
        list(sharding.blocks(3, 22))


# -- compiled-plan parity against the reference --------------------------------


@functools.lru_cache(maxsize=None)
def _workload(dtype_name, names=NAMES, hws=HWS, seed=0):
    rng = np.random.default_rng(seed)
    r_grid = with_dtype(R_GRID, dtype_name)
    r_cfgs = [r_map_app(r_apps.ALL_APPS[n](), r_grid) for n in names]
    canvas = np.zeros((len(names), max(h for h, _ in hws), max(w for _, w in hws)), np.int32)
    for i, (h, w) in enumerate(hws):
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w))
    return r_grid, r_cfgs, canvas


def port_workload(dtype_name):
    r_grid, r_cfgs, canvas = _workload(dtype_name)
    cfgs = [port_config(c) for c in r_cfgs]
    return (TConfig.stack(cfgs), TPlan.stack([c.ingest for c in cfgs], port_grid(r_grid).dtype),
            torch.from_numpy(canvas), port_grid(r_grid))


@functools.lru_cache(maxsize=None)
def reference_fused(dtype_name, tile_rows=None):
    r_grid, r_cfgs, canvas = _workload(dtype_name)
    plan = ROverlayPlan(grid=r_grid, batched=True, fused=True, radius=1, backend="xla",
                        tile_rows=tile_rows)
    return as_numpy(r_compile_plan(plan)(RConfig.stack(r_cfgs),
                                         RPlan.stack([c.ingest for c in r_cfgs], r_grid.dtype),
                                         jnp.asarray(canvas)))


def port_fused(dtype_name, spec, backend, tile_rows=None):
    stacked, ingests, canvas, grid = port_workload(dtype_name)
    plan = OverlayPlan(grid=grid, batched=True, fused=True, radius=1, backend=backend,
                       mesh=spec, tile_rows=tile_rows)
    fn = compile_plan(plan)
    assert (fn.mesh is None) == (spec.size == 1)
    return fn(stacked, ingests, canvas)


def assert_mesh_parity(got, want, single, dtype_name):
    """The reference's parity contract, and bitwise the port's own
    single-device run in every dtype."""
    assert_parity(got, want, dtype_name)
    assert got.dtype == single.dtype and torch.equal(got, single)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_fused_plan_on_a_logical_mesh_matches_reference(four_devices, dtype_name, spec, backend):
    single = port_fused(dtype_name, MeshSpec(), backend)
    assert_mesh_parity(port_fused(dtype_name, spec, backend), reference_fused(dtype_name),
                       single, dtype_name)


@pytest.mark.parametrize("spec", [MeshSpec(app=2, rows=2), MeshSpec(rows=4)], ids=str)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_row_sharding_composes_with_row_tiling(four_devices, spec, backend):
    single = port_fused("int32", MeshSpec(), backend, tile_rows=3)
    assert_mesh_parity(port_fused("int32", spec, backend, tile_rows=3),
                       reference_fused("int32", tile_rows=3), single, "int32")


@functools.lru_cache(maxsize=None)
def reference_packed(dtype_name):
    r_grid, r_cfgs, canvas = _workload(dtype_name)
    xs = np.stack([canvas[:, :, :16].reshape(len(r_cfgs), -1)[:, None].repeat(
        r_grid.num_inputs, axis=1)[i] + 3 * np.arange(r_grid.num_inputs)[:, None]
        for i in range(len(r_cfgs))])
    plan = ROverlayPlan(grid=r_grid, batched=True, backend="xla")
    want = r_compile_plan(plan)(RConfig.stack(r_cfgs), jnp.asarray(xs).astype(r_grid.dtype))
    return xs, as_numpy(want)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("spec", APP_SPECS, ids=str)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_packed_plan_on_an_app_mesh_matches_reference(four_devices, dtype_name, spec, backend):
    xs, want = reference_packed(dtype_name)
    stacked, _, _, grid = port_workload(dtype_name)
    x = torch.from_numpy(xs).to(grid.dtype)
    plans = [OverlayPlan(grid=grid, batched=True, backend=backend, mesh=m)
             for m in (spec, MeshSpec())]
    got, single = (compile_plan(p)(stacked, x) for p in plans)
    assert_mesh_parity(got, want, single, dtype_name)


CHAIN_HWS = [(17, 21), (9, 30), (21, 8)]


@functools.lru_cache(maxsize=None)
def chain_case(dtype_name):
    r_grid = with_dtype(R_PIPE_GRID, dtype_name)
    stages = [("gauss3", 1), ("sobel_x", 1), ("threshold", 1)]
    specs = [r_spec(stages, r_grid) for _ in CHAIN_HWS]
    canvas, hw = ragged_stack(5, CHAIN_HWS)
    return r_grid, specs, canvas, hw, as_numpy(reference_chain(specs, canvas, hw, r_grid))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("spec", [MeshSpec(app=2), MeshSpec(rows=2), MeshSpec(app=2, rows=2),
                                  MeshSpec(rows=4)], ids=str)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_depth3_chain_on_a_logical_mesh_matches_reference(four_devices, dtype_name, spec,
                                                          backend):
    """A granted mesh runs the chain stage by stage (the batched fused step
    per shard, a halo exchange per stage, the masked forward at global
    rows); the single-device chain runs B3's plain version or the
    specialized eager chain."""
    r_grid, r_specs, canvas, hw, want = chain_case(dtype_name)
    grid = port_grid(r_grid)
    specs = tuple(t_spec(s) for s in r_specs)
    outs = []
    for m in (spec, MeshSpec()):
        plan = OverlayPlan(grid=grid, batched=True, pipeline=specs, backend=backend, mesh=m)
        fn = compile_plan(plan)
        assert (fn.mesh is None) == (m.size == 1)
        outs.append(fn(t_stage_settings(specs, grid), torch.from_numpy(hw),
                       torch.from_numpy(canvas)))
    assert_mesh_parity(*outs[:1], want, outs[1], dtype_name)


# -- the fleet, the front-ends and the ladder ----------------------------------


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw).astype(np.int32) for hw in HWS]


def _channel_inputs(img):
    taps = t_apps.stencil_inputs(torch.from_numpy(img))
    return {k: v.numpy() for k, v in taps.items()}


def _serve_once(fleet, Request, frames):
    """One flush of fused, chained and packed requests; outputs in order."""
    tickets = [fleet.submit(Request(app=n, image=f)) for n, f in zip(NAMES, frames)]
    tickets += [fleet.submit(Request(pipeline=["sobel_x", "threshold", "sharpen"], image=f))
                for f in frames[:3]]
    tickets.append(fleet.submit(Request(app="sobel_x", inputs=_channel_inputs(frames[0]))))
    res = fleet.flush()
    return [np.asarray(res[t]) for t in tickets]


@pytest.mark.parametrize("ingest", ["sync", "async"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_fleet_on_a_2d_mesh_matches_reference(four_devices, ingest, backend):
    """Fused, chained and packed requests in one flush on a granted (2, 2)
    mesh, twice (the repeat flush reuses every pooled canvas and bank):
    bitwise the reference's single-device fleet, keys stamped rows2 (the
    packed dispatch on the app-only projection)."""
    frames = _frames()
    want = _serve_once(RFleet(default_grid=R_GRID, backend="xla", batch_tile=1), RRequest, frames)
    fleet = PixieFleet(default_grid=T_GRID, backend=backend, mesh=MeshSpec(app=2, rows=2),
                       ingest=ingest, batch_tile=1, device="cpu")
    for _ in range(2):
        got = _serve_once(fleet, FleetRequest, frames)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    stats = fleet.stats
    assert (stats.mesh_requested, stats.mesh_granted, stats.mesh_degraded) == ((2, 2), (2, 2),
                                                                               False)
    assert stats.devices == 2 and fleet.devices == 2
    keys = sorted(k.rsplit("|", 1)[0] for k in stats.dispatch_plans)
    assert [("rows2" in k, "channels" in k) for k in keys] == [
        (False, True), (True, False), (True, False)], keys
    # Async: each of the four shards fills its own pooled canvas; the
    # fused and the chain dispatch share their block shape, so the repeat
    # flush reuses all eight.
    assert stats.canvas_pool_device_hits == ({"cpu": 8} if ingest == "async" else {})


def test_fleet_mesh_degradation_is_recorded():
    """On the real one-device host a (2, 2) fleet degrades to the bitwise
    single-device path and says so -- the reference's stamps on the same
    host."""
    frames = _frames(1)
    r_fleet = RFleet(default_grid=R_GRID, mesh=RMeshSpec(app=2, rows=2), batch_tile=1)
    fleet = PixieFleet(default_grid=T_GRID, mesh=MeshSpec(app=2, rows=2), batch_tile=1,
                       device="cpu")
    for name in ("mesh_requested", "mesh_granted", "mesh_degraded", "devices"):
        assert getattr(fleet.stats, name) == getattr(r_fleet.stats, name), name
    assert (fleet.stats.mesh_requested, fleet.stats.mesh_granted,
            fleet.stats.mesh_degraded) == ((2, 2), (1, 1), True)
    got = _serve_once(fleet, FleetRequest, frames)
    plain = _serve_once(PixieFleet(default_grid=T_GRID, batch_tile=1, device="cpu"),
                        FleetRequest, frames)
    want = _serve_once(r_fleet, RRequest, frames)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
    assert not PixieFleet(default_grid=T_GRID, device="cpu").stats.mesh_degraded


@pytest.mark.parametrize("ingest", ["sync", "async"])
def test_streaming_frontend_on_a_2d_mesh(four_devices, ingest):
    img = np.random.default_rng(2).integers(0, 256, (16, 16)).astype(np.int32)
    want = np.asarray(RFrontend().submit("sobel_x", img).result())
    with StreamingFrontend(mesh=MeshSpec(app=2, rows=2), device="cpu", ingest=ingest) as svc:
        assert svc.mesh == MeshSpec(app=2, rows=2) and svc.devices == 2
        got = np.asarray(svc.submit("sobel_x", img).result(timeout=WAIT))
        chain = np.asarray(svc.submit(["sobel_x", "threshold"], img).result(timeout=WAIT))
        assert svc.stats.mesh_granted == (2, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        chain, np.asarray(RFrontend().submit(["sobel_x", "threshold"], img).result()))


def test_pixie_batched_runs_on_an_app_mesh(four_devices):
    frames = _frames(3)
    reqs = [(t_apps.ALL_APPS[n](), _channel_inputs(f)) for n, f in zip(NAMES, frames)]
    sharded = Pixie(T_GRID, device="cpu", mesh=MeshSpec(app=2))
    plain = Pixie(T_GRID, device="cpu")
    for g, w in zip(sharded.run_many(reqs), plain.run_many(reqs)):
        assert torch.equal(g, w)
    assert sharded._batched_overlay_fn.mesh.app == 2 and sharded.devices == 2
    chain = ["gauss3", "sobel_x", "threshold"]
    pipe = Pixie(T_PIPE_GRID, device="cpu", mesh=MeshSpec(app=2))
    assert torch.equal(pipe.run_pipeline(chain, frames[0]),
                       Pixie(T_PIPE_GRID, device="cpu").run_pipeline(chain, frames[0]))


@pytest.mark.parametrize("backends", [("pallas", "hopper"), ("xla", "torch")])
def test_fallback_chain_of_a_2d_plan_matches_reference(backends):
    r_backend, t_backend = backends
    r_plan = ROverlayPlan(grid=R_GRID, batched=True, fused=True, radius=1, backend=r_backend,
                          mesh=RMeshSpec(app=2, rows=2), tile_rows=8)
    t_plan = OverlayPlan(grid=T_GRID, batched=True, fused=True, radius=1, backend=t_backend,
                         mesh=MeshSpec(app=2, rows=2), tile_rows=8)
    r_chain, t_chain = r_fallback_chain(r_plan), fallback_chain(t_plan)
    assert len(t_chain) == len(r_chain) == (4 if t_backend == "hopper" else 3)
    for r_step, t_step in zip(r_chain, t_chain):
        assert t_step.key() == port_key(r_step.key())
        assert t_step.mesh.shape() == r_step.mesh.shape()
    assert [s.mesh for s in t_chain[-3:]] == [MeshSpec(app=2), MeshSpec(), MeshSpec()]


def test_breakers_route_a_2d_plan_to_app_only_then_one_device(four_devices):
    """A persistent fault on the row-banded plan is served by the app-only
    plan; one on every two-device plan by the single device -- bitwise,
    with the reference's ladder counters (its fleet, short of devices,
    runs every step on one device under the same keys)."""
    frames = _frames(4)
    for match, served in ((("|rows2|",), "dev2|"), (("|dev2|",), "dev1|")):
        r_inj = RFaultInjector(seed=0).inject("dispatch", transient=False, match=match)
        t_inj = FaultInjector(seed=0).inject("dispatch", transient=False, match=match)
        r = RFleet(default_grid=R_GRID, mesh=RMeshSpec(app=2, rows=2), faults=r_inj,
                   breakers=RBreakerBoard(clock=lambda: 0.0), batch_tile=1)
        t = PixieFleet(default_grid=T_GRID, backend="torch", mesh=MeshSpec(app=2, rows=2),
                       faults=t_inj, breakers=BreakerBoard(clock=lambda: 0.0), batch_tile=1,
                       device="cpu")
        outs = []
        for fleet, Request in ((r, RRequest), (t, FleetRequest)):
            tickets = [fleet.submit(Request(app=n, image=f)) for n, f in zip(NAMES, frames)]
            res = fleet.flush()
            outs.append([np.asarray(res[k]) for k in tickets])
        for g, w in zip(*outs[::-1]):
            np.testing.assert_array_equal(g, w)
        for name in ("fallback_dispatches", "retries", "quarantined_requests"):
            assert getattr(t.stats, name) == getattr(r.stats, name), name
        assert t.stats.fallback_dispatches == 1
        assert [k.split("|")[4] + "|" for k in t.stats.dispatch_plans] == [served]
        assert sorted(t.stats.dispatch_plans) == sorted(
            port_key(k) for k in r.stats.dispatch_plans)


# -- the property sweep --------------------------------------------------------


@st.composite
def mesh_cases(draw):
    """Random (H, W, radius, app, rows, seed) over four logical devices, as
    the reference draws them: rows not dividing H and bands shorter than
    the radius before padding arise from the ranges."""
    H = draw(st.integers(2, 20))
    W = draw(st.integers(2, 20))
    radius = draw(st.integers(1, 2))
    app = draw(st.integers(1, 2))
    rows = draw(st.integers(1, 4 // app))
    seed = draw(st.integers(0, 2**31 - 1))
    return H, W, radius, app, rows, seed


@functools.lru_cache(maxsize=None)
def _property_settings():
    r_cfgs = [r_map_app(r_apps.ALL_APPS[n](), R_GRID) for n in ("sobel_x", "threshold")]
    cfgs = [port_config(c) for c in r_cfgs]
    return ((RConfig.stack(r_cfgs), RPlan.stack([c.ingest for c in r_cfgs], R_GRID.dtype)),
            (TConfig.stack(cfgs), TPlan.stack([c.ingest for c in cfgs], T_GRID.dtype)))


@settings(max_examples=6, deadline=None)
@given(mesh_cases())
def test_property_2d_parity(case):
    H, W, radius, app, rows, seed = case
    (r_stacked, r_ingests), (stacked, ingests) = _property_settings()
    canvas = np.random.default_rng(seed).integers(0, 256, (2, H, W)).astype(np.int32)
    want = r_compile_plan(ROverlayPlan(grid=R_GRID, batched=True, fused=True, radius=radius,
                                       backend="xla"))(r_stacked, r_ingests, jnp.asarray(canvas))
    with logical_mesh():
        plan = OverlayPlan(grid=T_GRID, batched=True, fused=True, radius=radius,
                           mesh=MeshSpec(app=app, rows=rows))
        got = compile_plan(plan)(stacked, ingests, torch.from_numpy(canvas))
    np.testing.assert_array_equal(as_numpy(got), np.asarray(want))
