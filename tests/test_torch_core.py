"""Port parity, core layer: PE semantics, graph hashing, settings data and
the mapping tool flow of ``repro_torch`` against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  Integer
and float32 results must match bitwise, bf16 within the reference's own
0.5 (``tests/test_kernels_vcgra.py``).  Also home of the small helpers the
other ``test_torch_*`` suites import.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import shared_app_grid

from repro.core import applications as r_apps
from repro.core import map_app as r_map_app
from repro.core import ops as r_ops
from repro.core import tiling as r_tiling
from repro.core.bitstream import VCGRAConfig as RConfig
from repro.core.grid import paper_4x4 as r_paper_4x4
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.core.ingest import IngestError as RIngestError
from repro.core.interpreter import pack_inputs as r_pack_inputs
from repro.core.place import PlacementError as RPlacementError

from repro_torch.core import applications as t_apps
from repro_torch.core import grid as t_grid
from repro_torch.core import ops as t_ops
from repro_torch.core import tiling as t_tiling
from repro_torch.core.bitstream import VCGRAConfig as TConfig
from repro_torch.core.bitstream import from_reference
from repro_torch.core.ingest import IngestError as TIngestError
from repro_torch.core.interpreter import pack_inputs as t_pack_inputs
from repro_torch.core.pixie import map_app as t_map_app
from repro_torch.core.place import PlacementError as TPlacementError

# -- shared helpers ------------------------------------------------------------

#: Grid dtype variants: name -> (data_bits, float_pe, jax dtype, torch dtype).
DTYPES = {
    "int32": (32, False, jnp.int32, torch.int32),
    "int16": (16, False, jnp.int16, torch.int16),
    "float32": (32, True, jnp.float32, torch.float32),
    "bfloat16": (16, True, jnp.bfloat16, torch.bfloat16),
}
#: The reference's own bf16 tolerance; every other dtype is bitwise.
BF16_TOL = 0.5

ALL_APP_NAMES = sorted(r_apps.ALL_APPS)
R_SHARED = shared_app_grid(ALL_APP_NAMES, name="torch-parity-shared")
R_GRIDS = {"sobel": r_sobel_grid(), "paper4x4": r_paper_4x4(), "shared": R_SHARED}


def with_dtype(grid, dtype_name):
    """A reference grid re-typed to one of :data:`DTYPES`."""
    bits, float_pe, _, _ = DTYPES[dtype_name]
    return dataclasses.replace(grid, data_bits=bits, float_pe=float_pe)


def port_grid(grid):
    """The port's twin of a reference GridSpec (same fields)."""
    return t_grid.GridSpec(**dataclasses.asdict(grid))


def port_config(cfg):
    """Carry a reference config into the port through its JSON settings."""
    out = TConfig.from_json(cfg.to_json())
    out.cache_key = cfg.cache_key
    return out


def as_numpy(x):
    """numpy view of a torch tensor or a JAX array, bf16 widened to f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def assert_parity(got, want, dtype_name):
    """Bitwise for int32/int16/float32, within 0.5 for bf16."""
    g, w = as_numpy(got), as_numpy(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if dtype_name == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL)
    else:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def operands(dtype_name, shape, seed):
    """Seeded operand pair with negatives and exact zeros (zero divisors)."""
    rng = np.random.default_rng(seed)
    if DTYPES[dtype_name][1]:
        a = (rng.standard_normal(shape) * 10).astype(np.float32)
        b = (rng.standard_normal(shape) * 10).astype(np.float32)
        b[..., ::5] = 0.0
        a[..., ::7] = b[..., ::7]       # equal pairs for EQ
    else:
        a = rng.integers(-20, 21, shape).astype(np.int32)
        b = rng.integers(-20, 21, shape).astype(np.int32)
        b[..., ::5] = 0
    return a, b


def both(arr, dtype_name):
    """The same numpy data as a JAX array and a torch tensor of the dtype."""
    _, _, jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


# -- PE semantics ---------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("op", [o for o in r_ops.Op if o != r_ops.Op.MAC])
def test_apply_op_matches_reference(op, dtype_name):
    a, b = operands(dtype_name, (257,), seed=int(op))
    (ja, ta), (jb, tb) = both(a, dtype_name), both(b, dtype_name)
    want = r_ops.apply_op(op, ja, jb)
    got = t_ops.apply_op(t_ops.Op(int(op)), ta, tb)
    assert_parity(got, want, dtype_name)


def test_apply_op_rejects_mac_like_reference():
    x = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="no combinational semantics"):
        t_ops.apply_op(t_ops.Op.MAC, x, x)
    with pytest.raises(ValueError, match="no combinational semantics"):
        r_ops.apply_op(r_ops.Op.MAC, jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_apply_generic_matches_reference_every_opcode(dtype_name):
    """One lane per opcode value 0..15: every unit, NONE, MAC and codes
    outside the set (all of which give 0)."""
    a, b = operands(dtype_name, (16, 40), seed=3)
    opcode = np.arange(16, dtype=np.int32)
    (ja, ta), (jb, tb) = both(a, dtype_name), both(b, dtype_name)
    want = r_ops.apply_generic(jnp.asarray(opcode), ja, jb)
    got = t_ops.apply_generic(torch.from_numpy(opcode), ta, tb)
    assert_parity(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", ["int32", "int16"])
def test_integer_div_extremes_match_reference(dtype_name):
    """Floor division of negatives, zero divisors and INT_MIN // -1."""
    jdt, tdt = DTYPES[dtype_name][2], DTYPES[dtype_name][3]
    lo = int(np.iinfo(np.int32 if dtype_name == "int32" else np.int16).min)
    a = np.array([lo, lo, -7, 7, -7, 5, 0, -1], np.int64)
    b = np.array([-1, 1, 2, -2, -2, 0, 0, 3], np.int64)
    want = r_ops._safe_div(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    got = t_ops._safe_div(torch.tensor(a).to(tdt), torch.tensor(b).to(tdt))
    assert_parity(got, want, dtype_name)


# -- graph hashing, settings data -----------------------------------------------


@pytest.mark.parametrize("app", ALL_APP_NAMES)
def test_structural_hash_matches_reference(app):
    assert t_apps.ALL_APPS[app]().structural_hash() == r_apps.ALL_APPS[app]().structural_hash()


@pytest.mark.parametrize("grid_name", sorted(R_GRIDS))
@pytest.mark.parametrize("app", ALL_APP_NAMES)
def test_map_app_matches_reference(app, grid_name):
    """Identical opcodes, selects, out_sel and ingest arrays wherever the
    reference maps the app, the same error where it does not; the JSON
    settings are byte-identical."""
    r_grid = R_GRIDS[grid_name]
    t_grid_ = port_grid(r_grid)
    try:
        ref = r_map_app(r_apps.ALL_APPS[app](), r_grid)
    except RPlacementError as exc:
        with pytest.raises(TPlacementError) as got:
            t_map_app(t_apps.ALL_APPS[app](), t_grid_)
        assert str(got.value) == str(exc)
        return
    cfg = t_map_app(t_apps.ALL_APPS[app](), t_grid_)
    for lvl in range(r_grid.num_levels):
        np.testing.assert_array_equal(cfg.opcodes[lvl], ref.opcodes[lvl])
        np.testing.assert_array_equal(cfg.selects[lvl], ref.selects[lvl])
    np.testing.assert_array_equal(cfg.out_sel, ref.out_sel)
    assert (cfg.ingest is None) == (ref.ingest is None)
    if ref.ingest is not None:
        np.testing.assert_array_equal(cfg.ingest.tap_sel, ref.ingest.tap_sel)
        np.testing.assert_array_equal(cfg.ingest.const_vals, ref.ingest.const_vals)
    assert cfg.to_json() == ref.to_json()


@pytest.mark.parametrize("app", ALL_APP_NAMES)
def test_settings_json_and_from_reference_round_trip(app):
    """Reference settings load into the port and come back out
    byte-identical, through JSON and through ``from_reference``."""
    ref = r_map_app(r_apps.ALL_APPS[app](), R_SHARED)
    text = ref.to_json()
    assert TConfig.from_json(text).to_json() == text
    carried = from_reference(
        ref.opcodes, ref.selects, ref.out_sel, ref.input_order,
        ref.const_values, ref.ingest.to_dict() if ref.ingest else None,
        app_name=ref.app_name, grid_name=ref.grid_name,
    )
    assert carried.to_json() == text
    assert carried.config_shapes() == ref.config_shapes()
    assert carried.settings_bits(port_grid(R_SHARED)) == ref.settings_bits(R_SHARED)


def test_config_stack_matches_reference():
    names = ["sobel_x", "gauss3", "threshold"]
    refs = [r_map_app(r_apps.ALL_APPS[n](), R_SHARED) for n in names]
    r_ops_, r_sel, r_out = RConfig.stack(refs)
    t_ops_, t_sel, t_out = TConfig.stack([port_config(c) for c in refs])
    for r, t in zip(r_ops_ + r_sel + (r_out,), t_ops_ + t_sel + (t_out,)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize("radius", [0, 2])
def test_ingest_at_radius_matches_reference(radius):
    for app in ["threshold", "sobel_x", "identity"]:
        ref = r_map_app(r_apps.ALL_APPS[app](), R_SHARED).ingest
        port = port_config(r_map_app(r_apps.ALL_APPS[app](), R_SHARED)).ingest
        try:
            want = ref.at_radius(radius)
        except RIngestError as exc:
            with pytest.raises(TIngestError) as got:
                port.at_radius(radius)
            assert str(got.value) == str(exc)
            continue
        assert port.at_radius(radius).to_dict() == want.to_dict()


def test_ingest_stack_casts_consts_like_reference():
    refs = [r_map_app(r_apps.ALL_APPS[n](), R_SHARED) for n in ["gauss3", "box3"]]
    for dtype_name in DTYPES:
        _, _, jdt, tdt = DTYPES[dtype_name]
        from repro.core.ingest import IngestPlan as RPlan
        from repro_torch.core.ingest import IngestPlan as TPlan

        r_tap, r_const = RPlan.stack([c.ingest for c in refs], jdt)
        t_tap, t_const = TPlan.stack([port_config(c).ingest for c in refs], tdt)
        np.testing.assert_array_equal(t_tap.numpy(), np.asarray(r_tap))
        assert_parity(t_const, r_const, dtype_name)


# -- memory-interface helpers and numpy oracles ----------------------------------


def test_stencil_inputs_and_pack_inputs_match_reference():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (7, 12)).astype(np.int32)
    r_taps = r_apps.stencil_inputs(jnp.asarray(img))
    t_taps = t_apps.stencil_inputs(torch.from_numpy(img))
    assert sorted(r_taps) == sorted(t_taps)
    for name in r_taps:
        np.testing.assert_array_equal(t_taps[name].numpy(), np.asarray(r_taps[name]))
    ref = r_map_app(r_apps.ALL_APPS["gauss3"](), R_SHARED)
    feed = {k: v for k, v in r_taps.items() if k in ref.input_order}
    want = r_pack_inputs(ref, feed, jnp.int32)
    got = t_pack_inputs(port_config(ref), {k: t_taps[k] for k in feed}, torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_numpy_oracles_match_reference():
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (9, 6)).astype(np.int32)
    for kernel, div in [(r_apps.SOBEL_X, 1.0), (r_apps.GAUSS3, 16.0), (r_apps.BOX3, 9.0)]:
        np.testing.assert_array_equal(
            t_apps.conv2d_reference(img, kernel, div),
            r_apps.conv2d_reference(img, kernel, div),
        )
    np.testing.assert_array_equal(
        t_apps.sobel_magnitude_reference(img), r_apps.sobel_magnitude_reference(img)
    )


# -- tiling primitives -----------------------------------------------------------


@pytest.mark.parametrize("tile_rows", [None, 1, 3, "auto", 4096])
@pytest.mark.parametrize("hw", [(1, 1), (13, 9), (1080, 1920), (4096, 4096)])
def test_resolve_tile_rows_matches_reference(hw, tile_rows):
    H, W = hw
    for dtype_name in DTYPES:
        for r_grid in (r_sobel_grid(), R_SHARED):
            r_grid = with_dtype(r_grid, dtype_name)
            for radius in (0, 1, 2):
                assert t_tiling.resolve_tile_rows(
                    tile_rows, H, W, radius, port_grid(r_grid)
                ) == r_tiling.resolve_tile_rows(tile_rows, H, W, radius, r_grid)


def test_bucket_helpers_match_reference():
    for n in [0, 1, 15, 16, 17, 1080, 1920, 2160, 3840]:
        for floor in (1, 16, 256):
            assert t_tiling.pow2_bucket(n, floor) == r_tiling.pow2_bucket(n, floor)
            assert t_tiling.round_up(n, floor) == r_tiling.round_up(n, floor)
    for bad in (0, -3, "x"):
        with pytest.raises(ValueError):
            t_tiling.check_tile_rows(bad)


def test_halo_row_slabs_match_reference():
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (2, 13, 5)).astype(np.int32)
    for tr, r in [(5, 1), (3, 2), (13, 0), (1, 1)]:
        want = r_tiling.halo_row_slabs(jnp.asarray(imgs), tr, r)
        got = t_tiling.halo_row_slabs(torch.from_numpy(imgs), tr, r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_dtypes_map_to_torch():
    for dtype_name, (bits, float_pe, _, tdt) in DTYPES.items():
        assert t_grid.sobel_grid(data_bits=bits, float_pe=float_pe).dtype == tdt
    g = port_grid(R_SHARED)
    assert g.resource_model() == R_SHARED.resource_model()
    assert json.dumps(dataclasses.asdict(g)) == json.dumps(dataclasses.asdict(R_SHARED))
