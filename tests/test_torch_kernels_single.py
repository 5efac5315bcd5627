"""Port parity, single-app kernels: ``vcgra_apply`` / ``vcgra_apply_image``
in both modes -- B5 (``mode="specialized"``) and B4
(``mode="conventional"``) -- against the reference's, whose Pallas kernels
run in interpret mode as ``tests/test_kernels_vcgra.py`` runs them off the
TPU.

On the CPU the port's wrappers compute their kernels' plain versions
(``ref.py``); the CUDA kernels are held against those on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.  Int and
float32 results are bitwise, bf16 within the reference's 0.5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.core import for_dfg as r_for_dfg
from repro.core import map_app as r_map_app
from repro.core.grid import custom as r_custom
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.core.interpreter import pack_inputs as r_pack_inputs
from repro.kernels.vcgra import vcgra_apply as r_vcgra_apply
from repro.kernels.vcgra import vcgra_apply_image as r_vcgra_apply_image
from repro.kernels.vcgra import vcgra_ref as r_vcgra_ref
from repro.kernels.vcgra.vcgra_kernel import _pack_settings as r_pack_settings
from repro.kernels.vcgra.vcgra_kernel import vcgra_conventional as r_vcgra_conventional

from repro_torch.core import applications as t_apps
from repro_torch.core.interpreter import pack_inputs
from repro_torch.kernels.vcgra import (
    LAUNCHES, reset_launch_counts, vcgra_apply, vcgra_apply_image, vcgra_conventional,
    vcgra_conventional_ref, vcgra_ref,
)
from repro_torch.kernels.vcgra.ops import _pack_settings

from test_torch_core import assert_parity, port_config, port_grid

MODES = ["specialized", "conventional"]


def setup(app_name, data_bits=32, float_pe=False):
    dfg = r_apps.ALL_APPS[app_name]()
    r_grid = r_for_dfg(dfg, shape="exact", data_bits=data_bits, float_pe=float_pe)
    cfg = r_map_app(dfg, r_grid)
    return r_grid, cfg, port_grid(r_grid), port_config(cfg)


def packed(cfg, t_cfg, img, jdt, tdt):
    """The two-step channel pack of one frame in both packages."""
    taps = r_apps.stencil_inputs(jnp.asarray(img).astype(jdt))
    r_x = r_pack_inputs(cfg, {k: v for k, v in taps.items() if k in cfg.input_order}, jdt)
    t_taps = t_apps.stencil_inputs(torch.from_numpy(img).to(tdt))
    t_x = pack_inputs(t_cfg, {k: v for k, v in t_taps.items() if k in t_cfg.input_order}, tdt)
    return r_x, t_x


@pytest.mark.parametrize("hw", [(8, 16), (16, 128), (30, 67)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("app_name", ["sobel_x", "sobel_mag", "gauss3", "threshold"])
def test_vcgra_apply_matches_reference_int(app_name, mode, hw):
    r_grid, cfg, t_grid, t_cfg = setup(app_name)
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw).astype(np.int32)
    r_x, t_x = packed(cfg, t_cfg, img, jnp.int32, torch.int32)
    want = r_vcgra_apply(r_grid, cfg, r_x, mode=mode, block_n=256)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(r_vcgra_ref(r_grid, cfg, r_x)))
    got = vcgra_apply(t_grid, t_cfg, t_x, mode=mode, block_n=256)
    assert_parity(got, want, "int32")
    assert_parity(vcgra_ref(t_grid, t_cfg, t_x), want, "int32")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_vcgra_apply_matches_reference_float(mode, dtype_name):
    bits, jdt, tdt = {"float32": (32, jnp.float32, torch.float32),
                      "bfloat16": (16, jnp.bfloat16, torch.bfloat16)}[dtype_name]
    r_grid, cfg, t_grid, t_cfg = setup("sobel_mag", data_bits=bits, float_pe=True)
    img = (np.random.default_rng(1).random((16, 32)) * 100).astype(np.float32)
    r_x, t_x = packed(cfg, t_cfg, img, jdt, tdt)
    want = r_vcgra_apply(r_grid, cfg, r_x, mode=mode, block_n=128)
    assert_parity(vcgra_apply(t_grid, t_cfg, t_x, mode=mode, block_n=128), want, dtype_name)


@pytest.mark.parametrize("block_n", [128, 256, 1024])
@pytest.mark.parametrize("mode", MODES)
def test_vcgra_apply_image_block_size_sweep(mode, block_n):
    r_grid, cfg, t_grid, t_cfg = setup("sobel_x")
    img = np.random.default_rng(2).integers(0, 256, (24, 53)).astype(np.int32)
    want = r_vcgra_apply_image(r_grid, cfg, jnp.asarray(img), mode=mode, block_n=block_n)
    got = vcgra_apply_image(t_grid, t_cfg, img, mode=mode, block_n=block_n, device="cpu")
    assert_parity(got, want, "int32")
    np.testing.assert_array_equal(got.numpy(), t_apps.conv2d_reference(img, t_apps.SOBEL_X))


@pytest.mark.parametrize("mode", MODES)
def test_vcgra_apply_image_on_rect_grid_with_none_pes(mode):
    """The Fig. 5 mapping (45-PE rect grid, 25 NONE PEs) through each mode."""
    r_grid = r_sobel_grid()
    cfg = r_map_app(r_apps.sobel_x(), r_grid)
    img = np.random.default_rng(3).integers(0, 256, (12, 12)).astype(np.int32)
    want = r_vcgra_apply_image(r_grid, cfg, jnp.asarray(img), mode=mode, block_n=128)
    got = vcgra_apply_image(port_grid(r_grid), port_config(cfg), img, mode=mode,
                            block_n=128, device="cpu")
    assert_parity(got, want, "int32")


def test_apply_image_without_ingest_plan_takes_the_two_step_path():
    r_grid, cfg, t_grid, t_cfg = setup("laplace")
    t_cfg.ingest = None
    img = np.random.default_rng(4).integers(0, 256, (9, 14)).astype(np.int32)
    want = r_vcgra_apply_image(r_grid, cfg, jnp.asarray(img), block_n=128)
    for mode in MODES:
        got = vcgra_apply_image(t_grid, t_cfg, img, mode=mode, block_n=128, device="cpu")
        assert_parity(got, want, "int32")


def test_pack_settings_round_trip_matches_reference():
    r_grid, cfg, t_grid, t_cfg = setup("sobel_mag")
    ops_arr, sel_arr, out_sel, max_w = _pack_settings(t_grid, t_cfg)
    r_ops, r_sel, r_out, r_max_w = r_pack_settings(r_grid, cfg)
    assert max_w == r_max_w == max(t_grid.pes_per_level)
    assert ops_arr.shape == (t_grid.num_levels, max_w)
    assert sel_arr.shape == (t_grid.num_levels, max_w, 2)
    for got, want in ((ops_arr, r_ops), (sel_arr, r_sel), (out_sel, r_out)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for lvl in range(t_grid.num_levels):
        w = t_grid.pes_per_level[lvl]
        np.testing.assert_array_equal(ops_arr[lvl, :w].numpy(), t_cfg.opcodes[lvl])
        np.testing.assert_array_equal(sel_arr[lvl, :w].numpy(), t_cfg.selects[lvl])
        assert not ops_arr[lvl, w:].any()


def test_launch_counters_stay_at_zero_on_the_cpu():
    """The CPU computes plain versions; no kernel launches are counted."""
    r_grid, cfg, t_grid, t_cfg = setup("gauss3")
    img = np.random.default_rng(5).integers(0, 256, (6, 7)).astype(np.int32)
    reset_launch_counts()
    for mode in MODES:
        vcgra_apply_image(t_grid, t_cfg, img, mode=mode, device="cpu")
    assert LAUNCHES["vcgra_conventional"] == LAUNCHES["vcgra_specialized"] == 0


def test_single_app_wrappers_validate_like_the_reference():
    _, _, t_grid, t_cfg = setup("sobel_x")
    x = torch.zeros((t_grid.num_inputs, 300), dtype=torch.int32)
    for bad in (0, 100, 129, -128, 1.5):
        with pytest.raises(ValueError, match="block_n"):
            vcgra_apply(t_grid, t_cfg, x, block_n=bad)
    with pytest.raises(ValueError, match="unknown mode"):
        vcgra_apply(t_grid, t_cfg, x, mode="fast")
    settings = _pack_settings(t_grid, t_cfg)[:3]
    with pytest.raises(TypeError, match="dtype"):
        vcgra_conventional(t_grid, settings, x.float())
    with pytest.raises(ValueError, match="shape"):
        vcgra_conventional(t_grid, settings, x[:3])
    with pytest.raises(ValueError, match="channels"):
        vcgra_apply(t_grid, t_cfg, x[:3], mode="specialized")
    # Ragged N needs no padding, and the output does not depend on block_n.
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 9, (t_grid.num_inputs, 300))
                         .astype(np.int32))
    want = vcgra_conventional_ref(t_grid, settings, x)
    for block_n in (128, 384):
        assert torch.equal(vcgra_conventional(t_grid, settings, x, block_n=block_n), want)
        assert torch.equal(vcgra_apply(t_grid, t_cfg, x, block_n=block_n), want)


@pytest.mark.parametrize("app_name", ["sobel_mag", "gauss3"])
def test_conventional_on_a_40_wide_grid_matches_reference(app_name):
    """B4's plain version on a grid 40 values wide (past 32, inside the
    kernel's 64) against the reference's Pallas
    ``vcgra_conventional`` in interpret mode, N = 256."""
    r_grid = r_custom("wide-40", 40, [40, 11, 7, 5, 3, 3, 2], 1)
    cfg = r_map_app(r_apps.ALL_APPS[app_name](), r_grid)
    x = np.random.default_rng(7).integers(-8, 256, (40, 256)).astype(np.int32)
    r_ops, r_sel, r_out, _ = r_pack_settings(r_grid, cfg)
    want = r_vcgra_conventional(r_grid, (r_ops, r_sel, r_out), jnp.asarray(x), block_n=128,
                                interpret=True)
    t_grid = port_grid(r_grid)
    settings = _pack_settings(t_grid, port_config(cfg))[:3]
    assert_parity(vcgra_conventional(t_grid, settings, torch.from_numpy(x), block_n=128),
                  want, "int32")
