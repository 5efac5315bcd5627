"""Port parity, the single-app path: ``repro_torch.core.Pixie`` (both modes,
both port backends), the specialized "torch" chain cell and
``PixiePreprocessor`` against the reference's ``repro.core.Pixie``, XLA
chain and preprocessor, on the same seeded frames and settings.

``backend="hopper"`` on the CPU runs the kernels' plain versions
(``ref.py``); the CUDA kernels are held against those on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.  Int and
float32 results are bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import shared_app_grid

from repro.core import Pixie as RPixie
from repro.core import applications as r_apps
from repro.core import for_dfg as r_for_dfg
from repro.core import map_app as r_map_app
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.data.imaging import PixiePreprocessor as RPreprocessor
from repro.data.imaging import synthetic_images as r_synthetic_images

from repro_torch.core import Pixie, sobel_pixie
from repro_torch.core import applications as t_apps
from repro_torch.core.interpreter import pipeline_batched_fused_step, batched_fused_overlay_step
from repro_torch.core.plan import OverlayPlan, compile_plan
from repro_torch.data import PixiePreprocessor, patch_embed_stub, synthetic_images
from repro_torch.kernels.vcgra import LAUNCHES

from test_torch_core import assert_parity, port_config, port_grid
from test_torch_pipeline import (
    CHAINS, R_GRID, T_GRID, r_spec, ragged_stack, reference_chain, t_spec, t_stage_settings,
)

MODES = ["conventional", "parameterized"]
BACKENDS = ["torch", "hopper"]
_REFERENCE = {}


def exact(name, data_bits=32, float_pe=False):
    dfg = r_apps.ALL_APPS[name]()
    r_grid = r_for_dfg(dfg, shape="exact", data_bits=data_bits, float_pe=float_pe)
    return r_grid, r_map_app(dfg, r_grid)


def reference_run_image(name, mode, img, float_pe=False, bake_consts=False):
    """The reference Pixie's run_image of one app, computed once per case."""
    key = (name, mode, img.dtype.name, img.shape, float_pe, bake_consts)
    if key not in _REFERENCE:
        r_grid, cfg = exact(name, float_pe=float_pe)
        pix = RPixie(r_grid, mode=mode, bake_consts=bake_consts)
        pix.load(cfg, batch=img.size)
        _REFERENCE[key] = np.asarray(pix.run_image(jnp.asarray(img)))
    return _REFERENCE[key]


def port_pixie(r_grid, cfg, mode, backend, **kw):
    pix = Pixie(port_grid(r_grid), mode=mode, backend=backend, device="cpu", **kw)
    pix.load(port_config(cfg))
    return pix


INT_IMG = np.random.default_rng(0).integers(0, 256, (12, 17)).astype(np.int32)
FLOAT_IMG = (np.random.default_rng(1).random((9, 11)) * 255.0).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(r_apps.ALL_APPS))
def test_run_image_matches_reference_int32(name, mode, backend):
    r_grid, cfg = exact(name)
    got = port_pixie(r_grid, cfg, mode, backend).run_image(INT_IMG)
    assert_parity(got, reference_run_image(name, mode, INT_IMG), "int32")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["sobel_mag", "gauss3", "threshold"])
def test_run_image_matches_reference_float(name, mode, backend):
    r_grid, cfg = exact(name, float_pe=True)
    got = port_pixie(r_grid, cfg, mode, backend).run_image(FLOAT_IMG)
    assert_parity(got, reference_run_image(name, mode, FLOAT_IMG, float_pe=True), "float32")


@pytest.mark.parametrize("backend", BACKENDS)
def test_bake_consts_matches_reference(backend):
    for name in ("sobel_x", "gauss3", "threshold"):
        r_grid, cfg = exact(name)
        pix = port_pixie(r_grid, cfg, "parameterized", backend, bake_consts=True)
        want = reference_run_image(name, "parameterized", INT_IMG[:5, :8], bake_consts=True)
        assert_parity(pix.run_image(INT_IMG[:5, :8]), want, "int32")


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_dfg_and_named_inputs_match_reference(backend):
    """map + load + run through ``__call__`` on the Fig. 5 grid, and
    ``run_raw`` on a batch whose const rows differ from the defaults."""
    r_grid = r_sobel_grid()
    taps = {k: np.array(v) for k, v in r_apps.stencil_inputs(jnp.asarray(INT_IMG)).items()}
    for mode in MODES:
        rpix = RPixie(r_grid, mode=mode)
        want = np.asarray(rpix.run_dfg(r_apps.laplace(), **taps))
        pix = Pixie(port_grid(r_grid), mode=mode, backend=backend, device="cpu")
        assert_parity(pix.run_dfg(t_apps.laplace(), **taps), want, "int32")
        x = np.random.default_rng(2).integers(-9, 9, (r_grid.num_inputs, 77)).astype(np.int32)
        assert_parity(pix.run_raw(x), rpix.run_raw(jnp.asarray(x)), "int32")


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_many_ragged_matches_reference(backend):
    r_grid = shared_app_grid(["sobel_x", "gauss3", "threshold"], name="pixie-many")
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, hw).astype(np.int32) for hw in ((5, 9), (7, 7), (3, 4))]
    names = ["sobel_x", "gauss3", "threshold"]
    r_reqs, t_reqs = [], []
    for name, img in zip(names, frames):
        cfg = r_map_app(r_apps.ALL_APPS[name](), r_grid)
        taps = {k: np.array(v) for k, v in r_apps.stencil_inputs(jnp.asarray(img)).items()}
        feed = {k: v for k, v in taps.items() if k in cfg.input_order}
        r_reqs.append((cfg, {k: jnp.asarray(v) for k, v in feed.items()}))
        t_reqs.append((port_config(cfg), feed))
    rpix = RPixie(r_grid)
    pix = Pixie(port_grid(r_grid), backend=backend, device="cpu")
    for batch_pad in (None, 80):
        want = rpix.run_many(r_reqs, batch_pad=batch_pad)
        got = pix.run_many(t_reqs, batch_pad=batch_pad)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_parity(g, w, "int32")
    assert pix.run_many([]) == []
    assert pix.timings["run_many_s"] >= 0
    with pytest.raises(ValueError, match="batch_pad"):
        pix.run_many(t_reqs, batch_pad=8)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("depth", [1, 3])
def test_run_pipeline_matches_reference(depth, backend):
    chain = ["gauss3", "sobel_x", "threshold"][:depth]
    img = np.random.default_rng(4).integers(0, 256, (13, 19)).astype(np.int32)
    want = RPixie(R_GRID).run_pipeline(chain, jnp.asarray(img))
    pix = Pixie(T_GRID, backend=backend, device="cpu")
    got = pix.run_pipeline(chain, img)
    assert_parity(got, want, "int32")
    if depth > 1:
        assert pix.timings["run_pipeline_s"] >= 0
        assert len(pix._pipeline_fns) == 1
        pix.run_pipeline(chain, img)
        assert len(pix._pipeline_fns) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_conventional_reconfiguration_reuses_one_executable(backend):
    """The overlay's central claim: swapping the application swaps
    settings; the plan executables are bound once and reused."""
    grid = port_grid(r_sobel_grid())
    pix = Pixie(grid, mode="conventional", backend=backend, device="cpu")
    pix.compile_overlay(batch=INT_IMG.size)
    overlay = pix._overlay_fn
    outs = []
    for dfg, kernel in ((t_apps.sobel_x(), t_apps.SOBEL_X), (t_apps.sobel_y(), t_apps.SOBEL_Y)):
        pix.load(pix.map(dfg))
        outs.append(pix.run_image(INT_IMG))
        assert len(pix._fused_fns) == 1 and pix._overlay_fn is overlay
        np.testing.assert_array_equal(outs[-1].numpy(), t_apps.conv2d_reference(INT_IMG, kernel))
    fused = pix._fused_fns[1]
    pix.load(pix.map(t_apps.sharpen()))
    pix.run_image(INT_IMG)
    assert pix._fused_fns == {1: fused}
    assert {"overlay_compile_s", "map_s", "reconfig_s"} <= set(pix.timings)


def test_parameterized_hopper_reconfig_loads_a_kernel_per_app():
    grid = port_grid(r_sobel_grid())
    pix = sobel_pixie(mode="parameterized", device="cpu")
    assert (pix.backend, pix.grid.name) == ("hopper", grid.name)
    kernels = []
    for dfg in (t_apps.sobel_x(), t_apps.sobel_y()):
        pix.load(pix.map(dfg))
        kernels.append(pix._spec_fn.args[0])
    assert kernels[0].digest != kernels[1].digest
    assert kernels[0].config.app_name == "sobel_x" and kernels[1].config.app_name == "sobel_y"
    np.testing.assert_array_equal(pix.run_image(INT_IMG).numpy(),
                                  t_apps.conv2d_reference(INT_IMG, t_apps.SOBEL_Y))
    assert LAUNCHES["vcgra_specialized"] == 0   # the CPU ran the plain version


def test_errors_match_reference():
    r_grid, cfg = exact("sobel_x")
    grid = port_grid(r_grid)
    pix = Pixie(grid, mode="conventional", device="cpu")
    pix.load(port_config(cfg))
    with pytest.raises(KeyError):
        pix(p00=np.zeros((4,), np.int32))  # taps missing
    fresh = Pixie(grid, mode="conventional", device="cpu")
    with pytest.raises(RuntimeError, match="no application loaded"):
        fresh(p00=np.zeros((4,), np.int32))
    for call in (lambda p: p.run_raw(np.zeros((18, 4), np.int32)),
                 lambda p: p.run_image(INT_IMG)):
        with pytest.raises(RuntimeError, match="no application loaded"):
            call(fresh)
    par = Pixie(grid, mode="parameterized", device="cpu")
    with pytest.raises(RuntimeError, match="run_many requires mode='conventional'"):
        par.run_many([(port_config(cfg), {})])
    with pytest.raises(RuntimeError, match="run_pipeline requires mode='conventional'"):
        par.run_pipeline(["sobel_x"], INT_IMG)
    with pytest.raises(ValueError, match="unknown mode"):
        Pixie(grid, mode="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        Pixie(grid, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="at least one stage"):
        pix.run_pipeline([], INT_IMG)
    thr = port_config(r_map_app(r_apps.threshold(), r_grid))
    thr.ingest = None
    with pytest.raises(ValueError, match="no ingest plan"):
        pix.run_pipeline([thr, thr], INT_IMG)


def test_default_construction_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pixie(port_grid(r_sobel_grid()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PixiePreprocessor()


@pytest.mark.parametrize("chain", ["depth3", "depth4", "r10"])
def test_torch_chain_cell_is_specialized_and_matches_reference(chain):
    """The "torch" chain cell runs the specialized per-(app, stage)
    executor: bitwise the reference's XLA chain and the operand-settings
    chain the port keeps for the mesh."""
    spec = r_spec(CHAINS[chain])
    canvas, hw = ragged_stack(5, [(24, 16), (20, 13), (17, 16)])
    specs = [t_spec(spec)] * 3
    want = reference_chain([spec] * 3, canvas, hw)
    plan = OverlayPlan(grid=T_GRID, batched=True, pipeline=tuple(specs), backend="torch")
    fn = compile_plan(plan)
    settings = t_stage_settings(specs, T_GRID)
    got = fn(settings, torch.from_numpy(hw), torch.from_numpy(canvas))
    assert_parity(got, want, "int32")
    assert fn._fn.__name__ == "fn" and "_pipeline_specialized_fn" in fn._fn.__qualname__

    def stage(radius, configs, ingests, x):
        return batched_fused_overlay_step(T_GRID, radius, configs, ingests, x)

    operand_chain = pipeline_batched_fused_step(T_GRID, spec.radii, stage, settings,
                                                torch.from_numpy(hw), torch.from_numpy(canvas))
    assert torch.equal(got, operand_chain)
    with pytest.raises(ValueError, match="app slots"):
        fn(settings, torch.from_numpy(hw[:2]), torch.from_numpy(canvas[:2]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_preprocessor_matches_reference(backend):
    images = synthetic_images(2, (10, 13), seed=3)
    np.testing.assert_array_equal(images, r_synthetic_images(2, (10, 13), seed=3))
    ref = RPreprocessor()
    pre = PixiePreprocessor(backend=backend, device="cpu")
    assert pre.grid.name == ref.grid.name and pre.grid.pes_per_level == ref.grid.pes_per_level
    for name in ref.filters:
        ref.reconfigure(name)
        pre.reconfigure(name)
        want = ref.batch(jnp.asarray(images))
        assert_parity(pre.batch(images), want, "float32")
        assert_parity(pre(images[0]), want[0], "float32")
    with pytest.raises(KeyError, match="unknown filter"):
        pre.reconfigure("nope")
    emb = patch_embed_stub(images, 4, 8)
    assert emb.shape == (2, 4, 8) and np.isfinite(emb).all()
