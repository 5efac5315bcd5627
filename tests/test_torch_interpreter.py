"""Port parity, interpreter layer: the eager torch overlay interpreter (the
port's oracle, ``backend="torch"``) against the reference's XLA functions.

Every ``ALL_APPS`` entry is stacked on one shared grid over ragged,
non-square frames embedded in a zero canvas, on int32, int16 and float32
grids (bitwise) and bf16 (within 0.5).  Settings are mapped by the
reference and carried into the port through their JSON.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.core import interpreter as r_interp
from repro.core import map_app as r_map_app
from repro.core.bitstream import VCGRAConfig as RConfig
from repro.core.ingest import IngestPlan as RPlan, tap_offsets

from repro_torch.core import interpreter as t_interp
from repro_torch.core.bitstream import VCGRAConfig as TConfig
from repro_torch.core.ingest import IngestPlan as TPlan

from test_torch_core import (
    ALL_APP_NAMES, DTYPES, R_SHARED, assert_parity, port_config, port_grid,
    with_dtype,
)


def jitted(fn, *static):
    """The reference function with its static leading arguments bound,
    jitted: one XLA compile instead of one per eager op."""
    return jax.jit(partial(fn, *static))


def workload(dtype_name, seed=0):
    """Both packages' operands for all nine apps on the shared grid:
    ragged non-square frames (values 0..255) in one zero canvas."""
    r_grid = with_dtype(R_SHARED, dtype_name)
    _, _, jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    images = [
        rng.integers(0, 256, (6 + 2 * i, 19 - i)).astype(np.int32)
        for i in range(len(ALL_APP_NAMES))
    ]
    canvas = np.zeros((len(images), max(i.shape[0] for i in images),
                       max(i.shape[1] for i in images)), np.int32)
    for i, img in enumerate(images):
        canvas[i, : img.shape[0], : img.shape[1]] = img
    refs = [r_map_app(r_apps.ALL_APPS[n](), r_grid) for n in ALL_APP_NAMES]
    ports = [port_config(c) for c in refs]
    r_ops = (RConfig.stack(refs), RPlan.stack([c.ingest for c in refs], jdt),
             jnp.asarray(canvas))
    t_ops = (TConfig.stack(ports), TPlan.stack([c.ingest for c in ports], tdt),
             torch.from_numpy(canvas))
    return r_grid, port_grid(r_grid), r_ops, t_ops, refs, ports, canvas


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_batched_fused_overlay_step_all_apps(dtype_name):
    r_grid, t_grid, r_ops, t_ops, *_ = workload(dtype_name)
    want = jitted(r_interp.batched_fused_overlay_step, r_grid, 1)(*r_ops)
    got = t_interp.batched_fused_overlay_step(t_grid, 1, *t_ops)
    assert got.dtype == t_grid.dtype
    assert_parity(got, want, dtype_name)


@pytest.mark.parametrize(
    "dtype_name,tile_rows",
    [("int32", 1), ("int32", 3), ("int32", 7), ("int32", 25), ("int32", "auto"),
     ("float32", 3)],
)
def test_tiled_batched_fused_overlay_step_all_apps(dtype_name, tile_rows):
    """The row-tiled twin over tile heights that do and do not divide H
    (the canvas is 22 rows), one row, beyond H, and the budget pick."""
    r_grid, t_grid, r_ops, t_ops, *_ = workload(dtype_name, seed=1)
    want = jitted(r_interp.tiled_batched_fused_overlay_step, r_grid, 1, tile_rows)(*r_ops)
    got = t_interp.tiled_batched_fused_overlay_step(t_grid, 1, tile_rows, *t_ops)
    assert_parity(got, want, dtype_name)
    untiled = t_interp.batched_fused_overlay_step(t_grid, 1, *t_ops)
    assert_parity(got, untiled, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_batched_overlay_step_all_apps(dtype_name):
    """Pre-packed channels: every app's host-packed taps, ragged pixel
    batches zero-padded to one length."""
    r_grid, t_grid, _, _, refs, ports, canvas = workload(dtype_name, seed=2)
    _, _, jdt, tdt = DTYPES[dtype_name]
    xs = []
    for cfg, frame in zip(refs, canvas):
        taps = r_apps.stencil_inputs(jnp.asarray(frame))
        feed = {k: v for k, v in taps.items() if k in cfg.input_order}
        xs.append(np.asarray(r_interp.pad_channels(
            r_interp.pack_inputs(cfg, feed, jnp.int32), r_grid.num_inputs)))
    xs = np.stack(xs)[:, :, :397]           # a batch no block size divides
    want = jitted(r_interp.batched_overlay_step, r_grid)(
        RConfig.stack(refs), jnp.asarray(xs).astype(jdt))
    got = t_interp.batched_overlay_step(t_grid, TConfig.stack(ports),
                                        torch.from_numpy(xs).to(tdt))
    assert_parity(got, want, dtype_name)


@pytest.mark.parametrize("app", ALL_APP_NAMES)
def test_single_app_steps(app):
    """``fused_overlay_step`` and ``overlay_step`` for one app and frame."""
    r_grid, t_grid = R_SHARED, port_grid(R_SHARED)
    ref = r_map_app(r_apps.ALL_APPS[app](), r_grid)
    port = port_config(ref)
    img = np.random.default_rng(3).integers(0, 256, (11, 8)).astype(np.int32)
    want = jitted(r_interp.fused_overlay_step, r_grid, 1)(
        ref.to_jax(), ref.ingest.to_jax(r_grid.dtype), jnp.asarray(img))
    got = t_interp.fused_overlay_step(
        t_grid, 1, port.to_torch(), port.ingest.to_torch(t_grid.dtype),
        torch.from_numpy(img))
    assert_parity(got, want, "int32")
    x = np.asarray(r_interp.pad_channels(r_interp.pack_inputs(
        ref, {k: v for k, v in r_apps.stencil_inputs(jnp.asarray(img)).items()
              if k in ref.input_order}, jnp.int32), r_grid.num_inputs))
    want = jitted(r_interp.overlay_step, r_grid)(ref.to_jax(), jnp.asarray(x))
    got = t_interp.overlay_step(t_grid, port.to_torch(), torch.from_numpy(x.copy()))
    assert_parity(got, want, "int32")


@pytest.mark.parametrize("radius", [0, 2])
def test_random_runtime_ingest_settings(radius):
    """Any ingest settings, not only the library's: tap selects drawn over
    the whole radius-``radius`` bank (zero row included) and random const
    values, through the untiled and tiled executors."""
    rng = np.random.default_rng(40 + radius)
    r_grid, t_grid = R_SHARED, port_grid(R_SHARED)
    n = 4
    refs = [r_map_app(r_apps.ALL_APPS[ALL_APP_NAMES[i]](), r_grid) for i in range(n)]
    taps = len(tap_offsets(radius))
    tap_sel = rng.integers(0, taps + 1, (n, r_grid.num_inputs)).astype(np.int32)
    consts = rng.integers(-8, 9, (n, r_grid.num_inputs)).astype(np.int32)
    images = rng.integers(0, 256, (n, 9, 7)).astype(np.int32)
    r_args = (RConfig.stack(refs), (jnp.asarray(tap_sel), jnp.asarray(consts)),
              jnp.asarray(images))
    t_args = (TConfig.stack([port_config(c) for c in refs]),
              (torch.from_numpy(tap_sel), torch.from_numpy(consts)),
              torch.from_numpy(images))
    want = jitted(r_interp.batched_fused_overlay_step, r_grid, radius)(*r_args)
    assert_parity(t_interp.batched_fused_overlay_step(t_grid, radius, *t_args), want, "int32")
    assert_parity(
        t_interp.tiled_batched_fused_overlay_step(t_grid, radius, 2, *t_args), want, "int32")


def test_form_tap_bank_and_select_channels_match_reference():
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (3, 5, 8)).astype(np.int32)
    for radius in (0, 1, 2):
        want = r_interp.form_tap_bank(jnp.asarray(imgs), radius, jnp.int32)
        got = t_interp.form_tap_bank(torch.from_numpy(imgs), radius, torch.int32)
        assert_parity(got, want, "int32")
    tap_sel = rng.integers(0, 10, (3, 6)).astype(np.int32)
    consts = rng.integers(-5, 5, (3, 6)).astype(np.int32)
    want = r_interp.select_channels_batched(
        r_interp.form_tap_bank(jnp.asarray(imgs), 1, jnp.int32),
        (jnp.asarray(tap_sel), jnp.asarray(consts)))
    got = t_interp.select_channels_batched(
        t_interp.form_tap_bank(torch.from_numpy(imgs), 1, torch.int32),
        (torch.from_numpy(tap_sel), torch.from_numpy(consts)))
    assert_parity(got, want, "int32")


def test_check_backend_and_device():
    assert t_interp.check_backend("hopper") == "hopper"
    with pytest.raises(ValueError, match="unknown backend"):
        t_interp.check_backend("xla")
    assert t_interp.check_device("cpu") == torch.device("cpu")
