"""Port parity, fused stencil: ``sobel_magnitude_fused``, ``conv3x3_fused``
and ``stencil_ref`` of ``repro_torch.kernels.stencil`` against the
reference's, whose Pallas ``stencil_fused`` runs in interpret mode as
``tests/test_kernels_stencil.py`` runs it off the TPU.

On the CPU the wrapper computes B6's plain version; the CUDA kernel is
held against it on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.  Tolerances: int32 results are bitwise.  float32
results are bitwise (the same row-major sum on both sides), stricter than
the reference's own tolerances, for every filter whose coefficients are
powers of two; ``sharpen`` (its 5 is not) is held at the reference's
``rtol=1e-5, atol=1e-4`` for single filters, because XLA on the CPU
contracts its multiply-add into an FMA where the port rounds the product
(as the card does under ``--fmad=false``).  bf16, a case the reference
suite has no test for, is held within two bf16 units in the last place
plus 0.5, because XLA on the CPU may keep a fused chain of bf16 ops in
float32 where the port rounds after every op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.kernels.stencil import conv3x3_fused as r_conv3x3_fused
from repro.kernels.stencil import sobel_magnitude_fused as r_sobel_magnitude_fused
from repro.kernels.stencil import stencil_ref as r_stencil_ref

from repro_torch.core import Pixie, for_dfg, map_app
from repro_torch.core import applications as t_apps
from repro_torch.kernels.stencil import (
    LAUNCHES, conv3x3_fused, sobel_magnitude_fused, stencil_fused, stencil_fused_ref,
    stencil_ref,
)

from test_torch_core import as_numpy

SOBEL_PAIR = (t_apps.SOBEL_X, t_apps.SOBEL_Y)
DTYPES = {"float32": (jnp.float32, torch.float32), "int32": (jnp.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def frames(data, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(data).astype(jdt), torch.from_numpy(data).to(tdt)


def assert_matches(got, want, dtype_name):
    g, w = as_numpy(got), as_numpy(want)
    assert g.shape == w.shape
    if dtype_name == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=0.5)
    else:
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("hw", [(8, 128), (16, 126), (33, 200), (7, 9)])
@pytest.mark.parametrize("dtype_name", ["float32", "int32", "bfloat16"])
def test_fused_sobel_matches_reference(hw, dtype_name):
    data = np.random.default_rng(sum(hw)).integers(0, 255, hw).astype(np.float32)
    jimg, timg = frames(data, dtype_name)
    want = r_sobel_magnitude_fused(jimg)
    got = sobel_magnitude_fused(timg, device="cpu")
    assert got.dtype == timg.dtype
    assert_matches(got, want, dtype_name)
    if dtype_name != "bfloat16":
        assert_matches(stencil_ref(timg, SOBEL_PAIR),
                       r_stencil_ref(jimg, (r_apps.SOBEL_X, r_apps.SOBEL_Y)), dtype_name)


@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "gauss3", "sharpen", "laplace", "box3"])
def test_fused_single_kernels_match_reference(name):
    data = (np.random.default_rng(1).random((20, 40)) * 255).astype(np.float32)
    jimg, timg = frames(data, "float32")
    got, want = conv3x3_fused(timg, name, device="cpu"), r_conv3x3_fused(jimg, name)
    if name == "sharpen":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    else:
        assert_matches(got, want, "float32")
    kq = getattr(r_apps, {"gauss3": "GAUSS3", "box3": "BOX3"}.get(name, name.upper()))
    np.testing.assert_allclose(as_numpy(stencil_ref(timg, (kq,))),
                               np.asarray(r_stencil_ref(jimg, (kq,))), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("block_h", [4, 8, 16])
def test_fused_block_sweep(block_h):
    data = np.random.default_rng(2).random((30, 70)).astype(np.float32)
    jimg, timg = frames(data, "float32")
    want = r_sobel_magnitude_fused(jimg, block_h=block_h)
    assert_matches(sobel_magnitude_fused(timg, block_h=block_h, device="cpu"), want, "float32")
    assert torch.equal(sobel_magnitude_fused(timg, block_h=block_h, device="cpu"),
                       sobel_magnitude_fused(timg, device="cpu"))


def test_output_dtypes_of_the_oracle_and_the_fused_path_differ_for_int32():
    """A reference quirk the port keeps: the oracle returns float32 for an
    int32 image, the fused kernel the image dtype (float -> int32
    truncation)."""
    data = np.random.default_rng(3).integers(0, 255, (9, 11)).astype(np.float32)
    jimg, timg = frames(data, "int32")
    r_oracle = r_stencil_ref(jimg, (r_apps.SOBEL_X, r_apps.SOBEL_Y))
    r_fused = r_sobel_magnitude_fused(jimg)
    assert (str(r_oracle.dtype), str(r_fused.dtype)) == ("float32", "int32")
    t_oracle, t_fused = stencil_ref(timg, SOBEL_PAIR), sobel_magnitude_fused(timg, device="cpu")
    assert (t_oracle.dtype, t_fused.dtype) == (torch.float32, torch.int32)
    assert torch.equal(stencil_fused_ref(timg, SOBEL_PAIR), t_fused)
    np.testing.assert_array_equal(t_oracle.numpy(), np.asarray(r_oracle))
    np.testing.assert_array_equal(t_fused.numpy(), t_oracle.to(torch.int32).numpy())


def test_fused_equals_overlay_path():
    """The paper-faithful overlay and the fused stencil compute the same
    Sobel magnitude: the comparison of the two is apples to apples."""
    img32 = np.random.default_rng(4).integers(0, 256, (14, 22)).astype(np.int32)
    dfg = t_apps.sobel_magnitude()
    grid = for_dfg(dfg, shape="exact")
    fused = sobel_magnitude_fused(img32, device="cpu")
    for backend in ("torch", "hopper"):
        pix = Pixie(grid, mode="parameterized", backend=backend, device="cpu")
        pix.load(map_app(dfg, grid))
        assert torch.equal(pix.run_image(img32), fused)
    np.testing.assert_array_equal(fused.numpy(), t_apps.sobel_magnitude_reference(img32))


def test_wrapper_validation_and_cpu_launch_count():
    img = torch.zeros((5, 6), dtype=torch.int32)
    before = LAUNCHES["stencil_fused"]
    with pytest.raises(ValueError, match="block_h"):
        stencil_fused(img, SOBEL_PAIR, block_h=0)
    with pytest.raises(ValueError, match="one or two filters"):
        stencil_fused(img, SOBEL_PAIR * 2)
    with pytest.raises(TypeError, match="int32, float32"):
        stencil_fused(img.to(torch.int16), SOBEL_PAIR)
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        stencil_fused(img[None], SOBEL_PAIR)
    stencil_fused(img, SOBEL_PAIR)
    assert LAUNCHES["stencil_fused"] == before
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            sobel_magnitude_fused(img)
        else:
            raise RuntimeError("device='cpu'")
