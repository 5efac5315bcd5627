"""The Hopper VCGRA kernels on the card, held against their plain PyTorch
versions on the same inputs (bitwise for int32, int16 and float32; bf16
within the reference's 0.5).

Every test needs a CUDA device and skips itself elsewhere; on a GPU host
run ``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.
The file imports only the port (no JAX), so it runs where JAX is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import applications as apps
from repro_torch.core.bitstream import VCGRAConfig
from repro_torch.core.grid import custom, sobel_grid
from repro_torch.core.ingest import IngestPlan
from repro_torch.core.pixie import map_app
from repro_torch.core.place import level_demand
from repro_torch.kernels.vcgra import (
    LAUNCHES, pack_settings_batched, vcgra_batched, vcgra_batched_ref,
    vcgra_fused_batched, vcgra_fused_batched_ref,
)

pytestmark = pytest.mark.cuda

DTYPES = {"int32": (32, False), "int16": (16, False), "float32": (32, True),
          "bfloat16": (16, True)}
SOBEL_APPS = ["sobel_x", "sobel_y", "sharpen", "laplace", "threshold", "identity"]
ALL_APPS = sorted(apps.ALL_APPS)


def all_apps_grid():
    demands = [level_demand(apps.ALL_APPS[n]()) for n in ALL_APPS]
    depth = max(len(d) for d in demands)
    demands = [list(d) + [1] * (depth - len(d)) for d in demands]
    widths = [max(d[lvl] for d in demands) + 1 for lvl in range(depth)]
    inputs = max(len(apps.ALL_APPS[n]().inputs) for n in ALL_APPS)
    return custom("all-apps", inputs, widths, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


def assert_close(got, want, dtype_name):
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    if dtype_name == "bfloat16":
        torch.testing.assert_close(got.float(), want.float(), rtol=0.5, atol=0.5)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("radius", [0, 1])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_fused_kernel_matches_plain_version(cuda, dtype_name, radius):
    rng = np.random.default_rng(0)
    for base, names in ((sobel_grid(), SOBEL_APPS), (all_apps_grid(), ALL_APPS)):
        bits, float_pe = DTYPES[dtype_name]
        grid = dataclasses.replace(base, data_bits=bits, float_pe=float_pe)
        n, H, W = len(names) + 1, 23, 41
        cfgs = [map_app(apps.ALL_APPS[names[i % len(names)]](), grid) for i in range(n)]
        settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=cuda))
        if radius == 1:
            ingests = IngestPlan.stack([c.ingest for c in cfgs], grid.dtype, device=cuda)
        else:   # random runtime ingest settings over the one-tap bank
            ingests = (
                torch.as_tensor(rng.integers(0, 2, (n, grid.num_inputs)),
                                dtype=torch.int32, device=cuda),
                torch.as_tensor(rng.integers(-8, 9, (n, grid.num_inputs)),
                                device=cuda).to(grid.dtype),
            )
        frames = torch.as_tensor(rng.integers(0, 256, (n, H, W)), device=cuda).to(grid.dtype)
        want = vcgra_fused_batched_ref(grid, radius, settings, ingests, frames)
        for tile_rows in (None, 1, 3, H + 1, "auto"):
            before = LAUNCHES["vcgra_fused_batched"]
            got = vcgra_fused_batched(grid, radius, settings, ingests, frames,
                                      tile_rows=tile_rows)
            assert LAUNCHES["vcgra_fused_batched"] == before + 1
            assert_close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_batched_kernel_matches_plain_version(cuda, dtype_name):
    rng = np.random.default_rng(1)
    bits, float_pe = DTYPES[dtype_name]
    grid = sobel_grid(data_bits=bits, float_pe=float_pe)
    cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in SOBEL_APPS]
    settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=cuda))
    for B in (45, 1000):
        xs = torch.as_tensor(rng.integers(0, 256, (len(cfgs), grid.num_inputs, B)),
                             device=cuda).to(grid.dtype)
        before = LAUNCHES["vcgra_batched"]
        got = vcgra_batched(grid, settings, xs)
        assert LAUNCHES["vcgra_batched"] == before + 1
        assert_close(got, vcgra_batched_ref(grid, settings, xs), dtype_name)


def test_wrapper_rejects_operands_on_two_devices(cuda):
    grid = sobel_grid()
    cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in SOBEL_APPS[:2]]
    settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs))
    ingests = IngestPlan.stack([c.ingest for c in cfgs], grid.dtype)
    frames = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        vcgra_fused_batched(grid, 1, settings, ingests, frames)
