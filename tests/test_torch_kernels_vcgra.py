"""Port parity, kernel layer: the Hopper VCGRA kernels' wrappers.

On the CPU a wrapper computes its plain PyTorch version (``ref.py``), so
these tests hold the plain versions against the reference's Pallas
kernels run in interpret mode (as the reference's own suites run them off
the TPU), including the row-tile edge cases of
``tests/test_tiling.py``.  The CUDA kernels themselves are held against
these plain versions on the card by ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OverlayPlan as ROverlayPlan
from repro.core import applications as r_apps
from repro.core import compile_plan as r_compile_plan
from repro.core import map_app as r_map_app
from repro.core.bitstream import VCGRAConfig as RConfig
from repro.core.grid import custom as r_custom
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.core.ingest import IngestPlan as RPlan, tap_offsets
from repro.core.ops import Op as ROp
from repro.core.specialize import _live_slots
from repro.kernels.vcgra import (
    make_batched_fused_pallas_fn, make_batched_pallas_fn,
)
from repro.kernels.vcgra import pack_settings_batched as r_pack
from repro.kernels.vcgra.ops import _batched_fused_pallas_fn

from repro_torch.core.bitstream import VCGRAConfig as TConfig
from repro_torch.core.ingest import IngestPlan as TPlan
from repro_torch.core.plan import OverlayPlan, compile_plan
from repro_torch.kernels.vcgra import (
    LAUNCHES, pack_settings_batched, reset_launch_counts, vcgra_batched,
    vcgra_batched_ref, vcgra_fused_batched, vcgra_fused_batched_ref,
)

from test_torch_core import (
    ALL_APP_NAMES, DTYPES, R_SHARED, assert_parity, port_config, port_grid,
    with_dtype,
)

R_SOBEL = r_sobel_grid()
SOBEL_APPS = ["sobel_x", "sobel_y", "sharpen", "laplace", "threshold", "identity"]
#: B1/B2's grids of library apps: the Sobel grid and the all-apps grid.
R_APP_GRIDS = {"sobel": (R_SOBEL, SOBEL_APPS), "all-apps": (R_SHARED, ALL_APP_NAMES)}


def fused_operands(r_grid, names, images, dtype_name="int32"):
    """Dense banks for both packages plus the frames, from reference
    settings carried into the port."""
    _, _, jdt, tdt = DTYPES[dtype_name]
    refs = [r_map_app(r_apps.ALL_APPS[n](), r_grid) for n in names]
    ports = [port_config(c) for c in refs]
    t_grid = port_grid(r_grid)
    r_args = (RConfig.stack(refs), RPlan.stack([c.ingest for c in refs], jdt),
              jnp.asarray(images))
    t_settings = pack_settings_batched(t_grid, TConfig.stack(ports))
    t_ingests = TPlan.stack([c.ingest for c in ports], tdt)
    return t_grid, r_args, t_settings, t_ingests, torch.from_numpy(images)


def ragged_canvas(n, seed):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (6 + 2 * i, 19 - i)).astype(np.int32) for i in range(n)]
    canvas = np.zeros((n, max(i.shape[0] for i in images),
                       max(i.shape[1] for i in images)), np.int32)
    for i, img in enumerate(images):
        canvas[i, : img.shape[0], : img.shape[1]] = img
    return canvas


def test_pack_settings_batched_matches_reference():
    refs = [r_map_app(r_apps.ALL_APPS[n](), R_SHARED) for n in ["sobel_x", "gauss3", "box3"]]
    want = r_pack(R_SHARED, RConfig.stack(refs))
    got = pack_settings_batched(port_grid(R_SHARED), TConfig.stack([port_config(c) for c in refs]))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_plain_version_matches_pallas_all_apps():
    """Every library app stacked into ONE fused dispatch over ragged
    non-square frames: the plain version equals the reference megakernel."""
    canvas = ragged_canvas(len(ALL_APP_NAMES), seed=0)
    t_grid, r_args, settings, ingests, frames = fused_operands(R_SHARED, ALL_APP_NAMES, canvas)
    want = make_batched_fused_pallas_fn(R_SHARED, radius=1, interpret=True)(*r_args)
    got = vcgra_fused_batched(t_grid, 1, settings, ingests, frames)
    assert_parity(got, want, "int32")
    assert_parity(vcgra_fused_batched_ref(t_grid, 1, settings, ingests, frames), want, "int32")


@pytest.mark.parametrize("dtype_name", ["int16", "float32", "bfloat16"])
def test_fused_plain_version_matches_pallas_dtypes(dtype_name):
    r_grid = with_dtype(R_SOBEL, dtype_name)
    canvas = ragged_canvas(len(SOBEL_APPS), seed=1)
    t_grid, r_args, settings, ingests, frames = fused_operands(
        r_grid, SOBEL_APPS, canvas, dtype_name)
    want = make_batched_fused_pallas_fn(r_grid, radius=1, interpret=True)(*r_args)
    assert_parity(vcgra_fused_batched(t_grid, 1, settings, ingests, frames), want, dtype_name)


@pytest.mark.parametrize(
    "H,W,radius,tile_rows",
    [
        (1, 1, 0, 1),     # degenerate frame, radius-0 single-tap bank
        (7, 5, 0, 3),     # radius-0, tile does not divide H
        (13, 9, 1, 5),    # classic ragged tiling
        (6, 11, 1, 6),    # tile_rows == H (single tile, exact)
        (4, 7, 2, 3),     # radius exceeds tile_rows: halo > tile body
        (9, 3, 2, 64),    # tile_rows >> H clamps to untiled
    ],
)
def test_fused_tile_rows_edge_cases_match_pallas(H, W, radius, tile_rows):
    """The tiled reference megakernel over random *runtime* ingest settings
    (tap selects over the whole bank, zero row included, random consts):
    the port's output is the same for every tile height."""
    rng = np.random.default_rng(7)
    n = 3
    refs = [r_map_app(r_apps.ALL_APPS[SOBEL_APPS[i]](), R_SOBEL) for i in range(n)]
    taps = len(tap_offsets(radius))
    tap_sel = rng.integers(0, taps + 1, (n, R_SOBEL.num_inputs)).astype(np.int32)
    consts = rng.integers(-8, 9, (n, R_SOBEL.num_inputs)).astype(np.int32)
    images = rng.integers(0, 256, (n, H, W)).astype(np.int32)
    want = _batched_fused_pallas_fn(R_SOBEL, radius, interpret=True, tile_rows=tile_rows)(
        RConfig.stack(refs), (jnp.asarray(tap_sel), jnp.asarray(consts)), jnp.asarray(images))
    t_grid = port_grid(R_SOBEL)
    settings = pack_settings_batched(t_grid, TConfig.stack([port_config(c) for c in refs]))
    ingests = (torch.from_numpy(tap_sel), torch.from_numpy(consts))
    for tr in (tile_rows, None, "auto"):
        got = vcgra_fused_batched(t_grid, radius, settings, ingests,
                                  torch.from_numpy(images), tile_rows=tr)
        assert_parity(got, want, "int32")


def test_batched_plain_version_matches_pallas_unaligned_batch():
    """Pre-packed channels with a pixel batch no block size divides."""
    names = ["sobel_x", "sobel_y", "sharpen", "laplace"]
    refs = [r_map_app(r_apps.ALL_APPS[n](), R_SOBEL) for n in names]
    x = np.random.default_rng(2).integers(0, 256, (len(names), R_SOBEL.num_inputs, 45))
    x = x.astype(np.int32)
    want = make_batched_pallas_fn(R_SOBEL, interpret=True)(RConfig.stack(refs), jnp.asarray(x))
    t_grid = port_grid(R_SOBEL)
    settings = pack_settings_batched(t_grid, TConfig.stack([port_config(c) for c in refs]))
    got = vcgra_batched(t_grid, settings, torch.from_numpy(x))
    assert_parity(got, want, "int32")
    assert_parity(vcgra_batched_ref(t_grid, settings, torch.from_numpy(x)), want, "int32")


def test_wrappers_check_operands_and_count_no_cpu_launch():
    canvas = ragged_canvas(2, seed=3)
    t_grid, _, settings, ingests, frames = fused_operands(R_SOBEL, ["sobel_x", "laplace"], canvas)
    reset_launch_counts()
    vcgra_fused_batched(t_grid, 1, settings, ingests, frames)
    assert LAUNCHES == {"vcgra_fused_batched": 0, "vcgra_batched": 0,
                        "vcgra_pipeline_batched": 0, "vcgra_conventional": 0,
                        "vcgra_specialized": 0}
    ops, sel, out_sel = settings
    with pytest.raises(TypeError, match="dtype"):
        vcgra_fused_batched(t_grid, 1, (ops.long(), sel, out_sel), ingests, frames)
    with pytest.raises(ValueError, match="shape"):
        vcgra_fused_batched(t_grid, 1, (ops[:1], sel, out_sel), ingests, frames)
    with pytest.raises(ValueError, match="contiguous"):
        vcgra_fused_batched(t_grid, 1, settings, ingests, frames.transpose(1, 2))
    with pytest.raises(ValueError, match="radius"):
        vcgra_fused_batched(t_grid, -1, settings, ingests, frames)
    with pytest.raises(ValueError, match="tile_rows"):
        vcgra_fused_batched(t_grid, 1, settings, ingests, frames, tile_rows=0)
    with pytest.raises(ValueError, match="shape"):
        vcgra_batched(t_grid, settings, torch.zeros((2, 3, 8), dtype=torch.int32))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_hopper_plan_cells_match_torch_cells(batched, fused):
    """Every cell of the plan matrix: ``backend="hopper"`` (plain versions
    on the CPU) equals the eager ``"torch"`` oracle."""
    t_grid = port_grid(R_SOBEL)
    ports = [port_config(r_map_app(r_apps.ALL_APPS[n](), R_SOBEL)) for n in SOBEL_APPS[:3]]
    canvas = torch.from_numpy(ragged_canvas(3, seed=4))
    stacked = TConfig.stack(ports)
    if fused:
        ingests = TPlan.stack([c.ingest for c in ports], torch.int32)
        args = (stacked, ingests, canvas)
        single = (ports[0].to_torch(), ports[0].ingest.to_torch(torch.int32), canvas[0])
    else:
        xs = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, (3, t_grid.num_inputs, 77)).astype(np.int32))
        args = (stacked, xs)
        single = (ports[0].to_torch(), xs[0])
    kw = dict(radius=1, tile_rows="auto") if fused else {}
    outs = {}
    for backend in ("torch", "hopper"):
        plan = OverlayPlan(grid=t_grid, batched=batched, fused=fused, backend=backend, **kw)
        outs[backend] = compile_plan(plan)(*(args if batched else single))
    assert_parity(outs["hopper"], outs["torch"], "int32")



def bits(x):
    """The raw bits of a torch tensor or a JAX array, as signed integers of
    the element's width (bf16 too)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32).numpy()
    arr = np.asarray(x)
    return arr.view(np.int16 if arr.itemsize == 2 else np.int32)


def xla_fused(r_grid, r_args, radius=1):
    """``repro``'s XLA oracle of one batched fused dispatch."""
    plan = ROverlayPlan(grid=r_grid, batched=True, fused=True, radius=radius, backend="xla")
    return r_compile_plan(plan)(*r_args)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("grid_name", sorted(R_APP_GRIDS))
def test_dead_pes_set_to_none_change_no_bit(grid_name, dtype_name):
    """B1 and B2 evaluate only live PEs.  Here, on the CPU: every library
    app's plain version with each dead PE (``specialize._live_slots``)
    turned to NONE is bitwise the plain version and ``repro``'s XLA path."""
    base, names = R_APP_GRIDS[grid_name]
    r_grid = with_dtype(base, dtype_name)
    canvas = ragged_canvas(len(names), seed=8)
    t_grid, r_args, settings, ingests, frames = fused_operands(r_grid, names, canvas,
                                                               dtype_name)
    ops = settings[0].clone()
    dead = 0
    for i, name in enumerate(names):
        live = _live_slots(r_grid, r_map_app(r_apps.ALL_APPS[name](), r_grid))
        for lvl, width in enumerate(r_grid.pes_per_level):
            for slot in set(range(width)) - live[lvl]:
                ops[i, lvl, slot] = int(ROp.NONE)
                dead += 1
    assert dead > 0
    pruned = (ops, settings[1], settings[2])
    plain = vcgra_fused_batched_ref(t_grid, 1, settings, ingests, frames)
    got = vcgra_fused_batched_ref(t_grid, 1, pruned, ingests, frames)
    assert got.dtype == plain.dtype == DTYPES[dtype_name][3]
    np.testing.assert_array_equal(bits(got), bits(plain))
    np.testing.assert_array_equal(bits(got), bits(xla_fused(r_grid, r_args)))
    xs = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (len(names), r_grid.num_inputs, 77))).to(plain.dtype)
    np.testing.assert_array_equal(bits(vcgra_batched_ref(t_grid, pruned, xs)),
                                  bits(vcgra_batched_ref(t_grid, settings, xs)))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("width", [40, 64])
def test_wide_grid_matches_reference(width, fused):
    """A grid 33-64 values wide (B1 and B2 hold 64): the wrappers on CPU
    tensors against ``repro``'s XLA path, every library app stacked."""
    r_grid = r_custom(f"wide-{width}", width, [width, 11, 7, 5, 3, 3, 2], 1)
    names = ALL_APP_NAMES
    canvas = ragged_canvas(len(names), seed=10)
    t_grid, r_args, settings, ingests, frames = fused_operands(r_grid, names, canvas)
    assert max(t_grid.num_inputs, max(t_grid.pes_per_level)) == width
    if fused:
        got = vcgra_fused_batched(t_grid, 1, settings, ingests, frames)
        assert_parity(got, xla_fused(r_grid, r_args), "int32")
        return
    x = np.random.default_rng(11).integers(0, 256, (len(names), width, 45)).astype(np.int32)
    plan = ROverlayPlan(grid=r_grid, batched=True, backend="xla")
    want = r_compile_plan(plan)(r_args[0], jnp.asarray(x))
    assert_parity(vcgra_batched(t_grid, settings, torch.from_numpy(x)), want, "int32")
