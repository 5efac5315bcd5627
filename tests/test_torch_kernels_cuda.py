"""The Hopper kernels on the card -- B1, B2, the chain kernel B3, the
single-app kernels B4 (conventional) and B5 (specialized, NVRTC-compiled
per app), the fused stencil B6 and the flash decode kernel B7 -- held
against their plain PyTorch versions on the same inputs (B1, B2 and B4
bitwise in every dtype, bf16 included; B3, B5 and B6 bitwise for int32,
int16 and float32, bf16 within the reference's 0.5; B7's float32 outputs
at the reference's 2e-5, its bf16 outputs within one bf16 unit).

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
from repro_torch.core.grid import custom, for_dfg, sobel_grid
from repro_torch.core.ingest import IngestPlan
from repro_torch.core.pixie import map_app
from repro_torch.core.place import level_demand
from repro_torch.kernels import flash_attention, stencil
from repro_torch.kernels.flash_attention import parity
from repro_torch.kernels.build import load_library
from repro_torch.kernels.vcgra import (
    LAUNCHES, SpecializedKernel, pack_settings_batched, vcgra_batched, vcgra_batched_ref,
    vcgra_conventional, vcgra_conventional_ref, vcgra_fused_batched,
    vcgra_fused_batched_ref, vcgra_pipeline_batched, vcgra_pipeline_batched_ref,
    vcgra_specialized, vcgra_specialized_ref,
)
from repro_torch.kernels.vcgra.ops import (
    FUSED_MAX_RADIUS, MAX_VALS, WINDOW_MAX_RADIUS, _pack_settings, batched_launch,
    conventional_launch, fused_launch, pipeline_launch, record_ints, value_slots,
)
from repro_torch.kernels.vcgra.specialized import compile_module

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


def wide_grid():
    """A grid 40 values wide (past 32, inside the kernels' 64) that every
    library app maps on."""
    return custom("wide-40", 40, [40, 11, 7, 5, 3, 3, 2], 1)


def widest_grid():
    """A grid at the kernels' 64-value limit that every library app maps
    on."""
    return custom("wide-64", 64, [64, 11, 7, 5, 3, 3, 2], 1)


#: B1/B2's grids: (grid, apps mapped on it).
VEC_GRIDS = ((sobel_grid, SOBEL_APPS), (all_apps_grid, ALL_APPS), (wide_grid, ALL_APPS))
#: B1's frames (H, W): not multiples of the 32-row tile or of P, one pixel,
#: and a row past a 2048-column tile edge.
FUSED_FRAMES = ((23, 41), (37, 53), (1, 1), (33, 2049))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


def assert_bitwise(got, want):
    """Equal bit for bit (bf16 too), the contract of B1 and B2."""
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


def assert_close(got, want, dtype_name):
    torch.cuda.synchronize()
    got, want = got.cpu(), want.cpu()
    if dtype_name == "bfloat16":
        torch.testing.assert_close(got.float(), want.float(), rtol=0.5, atol=0.5)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("radius", [0, 1, 2, WINDOW_MAX_RADIUS + 1])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_fused_kernel_matches_plain_version(cuda, dtype_name, radius):
    """B1 bitwise: the Sobel, all-apps and 40-wide grids, library ingests
    at radius 1 and random runtime ones at radius 0, 2 and one past the
    shared-memory window (taps from device memory), ragged frames."""
    rng = np.random.default_rng(0)
    bits, float_pe = DTYPES[dtype_name]
    for make_grid, names in VEC_GRIDS:
        grid = dataclasses.replace(make_grid(), data_bits=bits, float_pe=float_pe)
        n = len(names) + 1
        cfgs = [map_app(apps.ALL_APPS[names[i % len(names)]](), grid) for i in range(n)]
        settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=cuda))
        if radius == 1:
            ingests = IngestPlan.stack([c.ingest for c in cfgs], grid.dtype, device=cuda)
        else:   # random runtime ingest settings over the whole bank, zero row included
            taps = (2 * radius + 1) ** 2
            ingests = (
                torch.as_tensor(rng.integers(-1, taps + 2, (n, grid.num_inputs)),
                                dtype=torch.int32, device=cuda),
                torch.as_tensor(rng.integers(-8, 9, (n, grid.num_inputs)),
                                device=cuda).to(grid.dtype),
            )
        for H, W in FUSED_FRAMES:
            frames = torch.as_tensor(rng.integers(0, 256, (n, H, W)),
                                     device=cuda).to(grid.dtype)
            want = vcgra_fused_batched_ref(grid, radius, settings, ingests, frames)
            for tile_rows in ((None, 1, 3, H + 1, "auto") if H == 23 else (None,)):
                before = LAUNCHES["vcgra_fused_batched"]
                got = vcgra_fused_batched(grid, radius, settings, ingests, frames,
                                          tile_rows=tile_rows)
                assert LAUNCHES["vcgra_fused_batched"] == before + 1
                assert_bitwise(got, want)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_batched_kernel_matches_plain_version(cuda, dtype_name):
    """B2 bitwise on the Sobel, all-apps and 40-wide grids, at pixel
    batches aligned and not to P (and to a block's groups)."""
    rng = np.random.default_rng(1)
    bits, float_pe = DTYPES[dtype_name]
    for make_grid, names in VEC_GRIDS:
        grid = dataclasses.replace(make_grid(), data_bits=bits, float_pe=float_pe)
        cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in names]
        settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=cuda))
        for B in (1, 45, 1000, 4099, 8192):
            xs = torch.as_tensor(rng.integers(0, 256, (len(cfgs), grid.num_inputs, B)),
                                 device=cuda).to(grid.dtype)
            before = LAUNCHES["vcgra_batched"]
            got = vcgra_batched(grid, settings, xs)
            assert LAUNCHES["vcgra_batched"] == before + 1
            assert_bitwise(got, vcgra_batched_ref(grid, settings, xs))


def test_fused_and_batched_launch_shape_matches_its_mirror(cuda):
    """The wrappers' launch-shape mirrors (``fused_launch``,
    ``batched_launch``, ``record_ints``) equal the C side's layout, and the
    limits the wrappers hold equal the library's."""
    lib = load_library("vcgra")
    assert lib.vcgra_max_vals() == 64 == MAX_VALS["vcgra_conventional"]
    assert lib.vcgra_window_max_radius() == WINDOW_MAX_RADIUS
    assert lib.vcgra_fused_max_radius() == FUSED_MAX_RADIUS
    for itemsize in (4, 2):
        for C, widths in ((18, [9] * 5), (27, [19, 11, 7, 5, 3, 3, 2]), (64, [64] * 3),
                          (1, [1])):
            for radius in (0, 1, 2, WINDOW_MAX_RADIUS, WINDOW_MAX_RADIUS + 1, 100):
                threads, smem, window = fused_launch(itemsize, radius, C, widths, 2)
                assert window == (radius <= WINDOW_MAX_RADIUS)
                assert lib.vcgra_fused_smem(itemsize, radius, *value_slots(C, widths), threads,
                                            C, len(widths), max(widths), 2) == smem
            threads, smem = batched_launch(itemsize, C, widths, 2)
            assert lib.vcgra_batched_smem(itemsize, *value_slots(C, widths), threads, C,
                                          len(widths), max(widths), 2) == smem
            assert lib.vcgra_record_ints(C, len(widths), max(widths), 2) == \
                record_ints(C, widths, 2)
    assert all(lib.vcgra_kernel_regs(kernel, code) > 0 for kernel in range(3)
               for code in range(4))


def test_conventional_launch_shape_matches_its_mirror(cuda):
    """B4's mirror (``conventional_launch``) equals the C side's B2 layout
    it launches with, at every block_n, and its block reports registers."""
    lib = load_library("vcgra")
    for itemsize in (4, 2):
        for C, widths in ((27, [18, 10, 6, 4, 2, 2, 1]), (18, [9] * 5), (64, [64] * 3),
                          (40, [40, 11, 7, 5, 3, 3, 2]), (1, [1])):
            for block_n in (128, 1024, 4096):
                threads, smem, passes = conventional_launch(itemsize, C, widths, 1, block_n)
                assert passes == max(1, -(-block_n // (threads * 16 // itemsize)))
                assert lib.vcgra_batched_smem(itemsize, *value_slots(C, widths), threads, C,
                                              len(widths), max(widths), 1) == smem
    assert conventional_launch(4, 27, [18, 10, 6, 4, 2, 2, 1], 1, 1024) == (128, 93_760, 2)
    assert all(lib.vcgra_kernel_regs(3, code) > 0 for code in range(4))


def test_fused_and_batched_kernels_refuse_what_they_cannot_launch(cuda):
    """Past 64 values B1, B2 and B4 raise (naming the kernel); the C entry
    points refuse a bad dtype code or block_n without launching."""
    lib = load_library("vcgra")
    too_wide = custom("wide-65", 65, [9], 1)
    frames = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda)
    settings = (torch.zeros((1, 1, 9), dtype=torch.int32, device=cuda),
                torch.zeros((1, 1, 9, 2), dtype=torch.int32, device=cuda),
                torch.zeros((1, 1), dtype=torch.int32, device=cuda))
    ingests = (torch.zeros((1, 65), dtype=torch.int32, device=cuda),
               torch.zeros((1, 65), dtype=torch.int32, device=cuda))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="vcgra_fused_batched holds at most 64"):
        vcgra_fused_batched(too_wide, 1, settings, ingests, frames)
    with pytest.raises(ValueError, match="vcgra_batched holds at most 64"):
        vcgra_batched(too_wide, settings, torch.zeros((1, 65, 8), dtype=torch.int32,
                                                      device=cuda))
    b4_settings = tuple(torch.zeros(t.shape[1:], dtype=torch.int32, device=cuda)
                        for t in settings)
    with pytest.raises(ValueError, match="vcgra_conventional holds at most 64"):
        vcgra_conventional(too_wide, b4_settings,
                           torch.zeros((65, 128), dtype=torch.int32, device=cuda))
    assert LAUNCHES == before
    grid = wide_grid()   # 40 values: past 32, inside 64
    cfg = map_app(apps.sobel_x(), grid)
    x = torch.zeros((40, 128), dtype=torch.int32, device=cuda)
    assert vcgra_conventional(grid, _pack_settings(grid, cfg, device=cuda)[:3], x).shape == \
        (1, 128)
    before = dict(LAUNCHES)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.vcgra_fused_batched(9, *([frames.data_ptr()] * 11), 1, 8, 8, 1, 9, 1, 18, 1,
                                   128, 18, 9, stream) != 0
    assert lib.vcgra_batched(9, *([frames.data_ptr()] * 7), 1, 8, 1, 9, 1, 18, 128, 18, 9,
                             stream) != 0
    for dtype, block_n in ((9, 128), (0, 100), (0, 0)):
        assert lib.vcgra_conventional(dtype, *([frames.data_ptr()] * 7), 8, block_n, 1, 9, 1,
                                      18, 128, 18, 9, stream) != 0
    assert LAUNCHES == before


def test_wrapper_rejects_operands_on_two_devices(cuda):
    grid = sobel_grid()
    cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in SOBEL_APPS[:2]]
    settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs))
    ingests = IngestPlan.stack([c.ingest for c in cfgs], grid.dtype)
    frames = torch.zeros((2, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        vcgra_fused_batched(grid, 1, settings, ingests, frames)


def shared_grid(names, name, num_outputs=1):
    demands = [level_demand(apps.ALL_APPS[n]()) for n in names]
    depth = max(len(d) for d in demands)
    demands = [list(d) + [1] * (depth - len(d)) for d in demands]
    widths = [max(d[lvl] for d in demands) + 1 for lvl in range(depth)]
    inputs = max(len(apps.ALL_APPS[n]().inputs) for n in names)
    return custom(name, inputs, widths, num_outputs)


CHAIN = ["gauss3", "sobel_x", "threshold"]
#: (app, radius) chains: radii (1,1,1), (1,0), (0,1) and a depth-4 chain.
CHAINS = [
    [("gauss3", 1), ("sobel_x", 1), ("threshold", 1)],
    [("gauss3", 1), ("threshold", 0)],
    [("threshold", 0), ("sobel_x", 1)],
    [("gauss3", 1), ("threshold", 0), ("sobel_x", 1), ("threshold", 1)],
]


def chain_operands(grid, chain, n, H, W, device, rng):
    """B3's stage-stacked operands for ``n`` apps running ``chain``; with
    K > 1 the output muxes and the forwarded channels are random."""
    K = grid.num_outputs
    stages = []
    for name, radius in chain:
        cfgs = []
        for _ in range(n):
            cfg = map_app(apps.ALL_APPS[name](), grid)
            cfg = dataclasses.replace(cfg, ingest=cfg.ingest.at_radius(radius))
            if K > 1:
                cfg.out_sel = rng.integers(0, grid.pes_per_level[-1], K).astype(np.int32)
            cfgs.append(cfg)
        stages.append((pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=device)),
                       IngestPlan.stack([c.ingest for c in cfgs], grid.dtype, device=device)))
    settings = tuple(torch.stack([st[0][j] for st in stages]) for j in range(3))
    ingests = tuple(torch.stack([st[1][j] for st in stages]) for j in range(2))
    out_chs = torch.as_tensor(rng.integers(0, K, (len(chain), n)), dtype=torch.int32,
                              device=device)
    hw = np.stack([rng.integers(1, H + 1, n), rng.integers(1, W + 1, n)], axis=1)
    hw[0] = (1, 1)
    hw[-1] = (H, W)
    frames = torch.as_tensor(rng.integers(0, 256, (n, H, W)), device=device).to(grid.dtype)
    return (settings, ingests, out_chs,
            torch.as_tensor(hw, dtype=torch.int32, device=device), frames)


@pytest.mark.parametrize("num_outputs", [1, 2])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_pipeline_kernel_matches_plain_version(cuda, dtype_name, num_outputs):
    rng = np.random.default_rng(2)
    bits, float_pe = DTYPES[dtype_name]
    grid = dataclasses.replace(shared_grid(CHAIN, "pipe-shared", num_outputs),
                               data_bits=bits, float_pe=float_pe)
    for chain in CHAINS:
        radii = tuple(r for _, r in chain)
        for n, H, W in ((3, 37, 53), (11, 45, 33)):
            args = chain_operands(grid, chain, n, H, W, cuda, rng)
            want = vcgra_pipeline_batched_ref(grid, radii, *args)
            for tile_rows in (None, 1, 3, "auto"):
                before = LAUNCHES["vcgra_pipeline_batched"]
                got = vcgra_pipeline_batched(grid, radii, *args, tile_rows=tile_rows)
                assert LAUNCHES["vcgra_pipeline_batched"] == before + 1
                assert_close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_pipeline_kernel_spans_several_tiles_with_ragged_edges(cuda, dtype_name):
    """Frames of several 32 x 32P output tiles, ragged in both directions."""
    rng = np.random.default_rng(11)
    bits, float_pe = DTYPES[dtype_name]
    grid = dataclasses.replace(shared_grid(CHAIN, "pipe-shared", 2), data_bits=bits,
                               float_pe=float_pe)
    for chain in (CHAINS[0], CHAINS[3]):
        radii = tuple(r for _, r in chain)
        for n, H, W in ((2, 200, 331), (3, 130, 67)):
            args = chain_operands(grid, chain, n, H, W, cuda, rng)
            want = vcgra_pipeline_batched_ref(grid, radii, *args)
            assert_close(vcgra_pipeline_batched(grid, radii, *args), want, dtype_name)


def test_pipeline_kernel_launch_shape_matches_its_mirror(cuda):
    """The wrapper's shared-memory mirror equals the kernel's layout."""
    lib = load_library("vcgra_pipeline")
    for itemsize in (4, 2):
        for R, C, widths in ((3, 19, [11, 7, 5, 4, 3, 2]), (16, 64, [64] * 3), (0, 1, [1])):
            threads, smem = pipeline_launch(itemsize, R, C, widths, 2)
            slots_a, slots_b = value_slots(C, widths)
            assert lib.vcgra_pipeline_smem(itemsize, R, slots_a, slots_b, threads, C,
                                           len(widths), max(widths), 2) == smem
            assert lib.vcgra_pipeline_record_ints(C, len(widths), max(widths), 2) == \
                record_ints(C, widths, 2)
    assert all(lib.vcgra_pipeline_regs(code) > 0 for code in range(4))


def test_pipeline_kernel_refuses_what_it_cannot_launch(cuda):
    rng = np.random.default_rng(3)
    grid = shared_grid(CHAIN, "pipe-shared")
    chain = [("gauss3", 1)] * 2
    settings, ingests, out_chs, hw, frames = chain_operands(grid, chain, 2, 8, 8, cuda, rng)
    before = LAUNCHES["vcgra_pipeline_batched"]
    lib = load_library("vcgra_pipeline")
    too_far = (lib.vcgra_max_radius() + 1, 0)
    with pytest.raises(ValueError, match="halo holds at most"):
        vcgra_pipeline_batched(grid, too_far, settings, ingests, out_chs, hw, frames)
    with pytest.raises(ValueError, match="expected cuda"):
        vcgra_pipeline_batched(grid, (1, 1), settings, ingests, out_chs, hw.cpu(), frames)
    # The C entry point itself refuses a bad dtype code without launching.
    assert lib.vcgra_pipeline_batched(
        9, *([frames.data_ptr()] * 13), 2, 2, 8, 8, grid.num_levels,
        max(grid.pes_per_level), grid.num_outputs, grid.num_inputs, 2, 128,
        *value_slots(grid.num_inputs, grid.pes_per_level),
        torch.cuda.current_stream().cuda_stream) != 0
    assert LAUNCHES["vcgra_pipeline_batched"] == before


def single_app_cases(dtype_name):
    """(grid, config) of every library app on its exact grid and of the
    Sobel-grid apps on ``sobel_grid()``, in one grid dtype."""
    bits, float_pe = DTYPES[dtype_name]
    cases = []
    for name in ALL_APPS:
        dfg = apps.ALL_APPS[name]()
        grid = for_dfg(dfg, shape="exact", data_bits=bits, float_pe=float_pe)
        cases.append((grid, map_app(dfg, grid)))
    grid = sobel_grid(data_bits=bits, float_pe=float_pe)
    cases += [(grid, map_app(apps.ALL_APPS[n](), grid)) for n in SOBEL_APPS]
    return cases


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_conventional_kernel_matches_plain_version(cuda, dtype_name):
    rng = np.random.default_rng(4)
    for grid, cfg in single_app_cases(dtype_name):
        ops, sel, out_sel, _ = _pack_settings(grid, cfg, device=cuda)
        for N in (1, 45, 1000, 4099):
            x = torch.as_tensor(rng.integers(0, 256, (grid.num_inputs, N)),
                                device=cuda).to(grid.dtype)
            want = vcgra_conventional_ref(grid, (ops, sel, out_sel), x)
            for block_n in (128, 256, 1024):
                before = LAUNCHES["vcgra_conventional"]
                got = vcgra_conventional(grid, (ops, sel, out_sel), x, block_n=block_n)
                assert LAUNCHES["vcgra_conventional"] == before + 1
                assert_bitwise(got, want)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_conventional_kernel_takes_64_wide_grids(cuda, dtype_name):
    """B4 on the 40- and 64-wide grids (past 32 values, up to its limit),
    every library app, bitwise at ragged N and three block_n."""
    rng = np.random.default_rng(12)
    bits, float_pe = DTYPES[dtype_name]
    for make_grid in (wide_grid, widest_grid):
        grid = dataclasses.replace(make_grid(), data_bits=bits, float_pe=float_pe)
        for name in ALL_APPS:
            settings = _pack_settings(grid, map_app(apps.ALL_APPS[name](), grid), device=cuda)[:3]
            for N in (1, 45, 4099):
                x = torch.as_tensor(rng.integers(-8, 256, (grid.num_inputs, N)),
                                    device=cuda).to(grid.dtype)
                want = vcgra_conventional_ref(grid, settings, x)
                for block_n in (128, 256, 1024):
                    before = LAUNCHES["vcgra_conventional"]
                    got = vcgra_conventional(grid, settings, x, block_n=block_n)
                    assert LAUNCHES["vcgra_conventional"] == before + 1
                    assert_bitwise(got, want)


@pytest.mark.parametrize("bake_consts", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_specialized_kernel_matches_plain_version(cuda, dtype_name, bake_consts):
    rng = np.random.default_rng(5)
    for grid, cfg in single_app_cases(dtype_name):
        kernel = SpecializedKernel(grid, cfg, bake_consts, device=cuda)
        assert kernel.handle is not None
        for N in (1, 45, 4099):
            x = torch.as_tensor(rng.integers(-8, 256, (grid.num_inputs, N)),
                                device=cuda).to(grid.dtype)
            want = vcgra_specialized_ref(grid, cfg, x, bake_consts)
            for block_n in (128, 1024):
                before = LAUNCHES["vcgra_specialized"]
                got = vcgra_specialized(kernel, x, block_n=block_n)
                assert LAUNCHES["vcgra_specialized"] == before + 1
                assert_close(got, want, dtype_name)


def test_specialized_compile_error_raises_with_the_log(cuda):
    with pytest.raises(RuntimeError, match="NVRTC refused the source") as info:
        compile_module('#include "vcgra_pe.cuh"\nextern "C" __global__ void '
                       'vcgra_specialized() { undeclared_name = 1; }\n', cuda.index or 0)
    assert "undeclared_name" in str(info.value)


#: B6's frames (H, W): odd non-square, one pixel, one row, widths that are
#: not a multiple of its V columns a thread (4 or 8) or below V, and 1080p.
STENCIL_FRAMES = ((37, 53), (1, 1), (130, 7), (5, 4097), (3, 6), (1, 3), (2, 9), (1, 1920),
                  (1080, 1920))


@pytest.mark.parametrize("dtype_name", ["int32", "float32", "bfloat16"])
def test_stencil_kernel_matches_plain_version(cuda, dtype_name):
    """B6 bitwise in int32 and float32 (bf16 within the reference's 0.5) on
    every filter form, frame and block_h, from 16-byte aligned frames and
    from a view one element past an aligned start (scalar loads)."""
    rng = np.random.default_rng(6)
    dtype = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}
    forms = [(apps.SOBEL_X, apps.SOBEL_Y)] + [(k,) for k in stencil.ops.FILTERS.values()]
    for H, W in STENCIL_FRAMES:
        flat = torch.as_tensor(rng.integers(0, 256, H * W + 1), device=cuda).to(dtype[dtype_name])
        for img in (flat[:-1].view(H, W), flat[1:].view(H, W)):
            assert img.is_contiguous()
            for kernels in forms:
                want = stencil.stencil_fused_ref(img, kernels)
                for block_h in (1, 8, 128):
                    before = stencil.LAUNCHES["stencil_fused"]
                    got = stencil.stencil_fused(img, kernels, block_h=block_h)
                    assert stencil.LAUNCHES["stencil_fused"] == before + 1
                    assert got.dtype == img.dtype
                    assert_close(got, want, dtype_name)


def test_stencil_kernel_refuses_what_it_cannot_launch(cuda):
    img = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    limit = load_library("stencil").stencil_max_block_h()
    with pytest.raises(ValueError, match="at most"):
        stencil.stencil_fused(img, (apps.SOBEL_X,), block_h=limit + 1)
    with pytest.raises(ValueError, match="compiled filters"):
        stencil.stencil_fused(img, (((1, 1, 1), (1, 0, 1), (1, 1, 1)),))
    with pytest.raises(ValueError, match="Sobel pair"):
        stencil.stencil_fused(img, (apps.GAUSS3, apps.BOX3))
    with pytest.raises(TypeError, match="int32, float32"):
        stencil.stencil_fused(img.to(torch.int16), (apps.SOBEL_X,))


@pytest.mark.parametrize("q_dtype,kv_dtype", parity.DTYPES)
def test_flash_decode_matches_plain_version(cuda, q_dtype, kv_dtype):
    """B7 over the shared case table (``flash_attention.parity``), held to
    its tolerance: float32 outputs 2e-5, bf16 outputs one bf16 unit."""
    rng = np.random.default_rng(9)
    for B, H, G, D, S, chunk in parity.CASES:
        q = torch.as_tensor(rng.standard_normal((B, H, D)), dtype=torch.float32,
                            device=cuda).to(q_dtype)
        k, v = (torch.as_tensor(rng.standard_normal((B, S, G, D)), dtype=torch.float32,
                                device=cuda).to(kv_dtype) for _ in range(2))
        for lengths in (parity.lengths(rng, B, S), [S] * B):
            lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
            before = flash_attention.LAUNCHES["flash_decode"]
            got = flash_attention.decode_attention(q, k, v, lens, chunk=chunk)
            assert flash_attention.LAUNCHES["flash_decode"] == before + 1
            want = flash_attention.decode_ref(q, k, v, lens)
            torch.cuda.synchronize()
            assert got.dtype == q_dtype and got.shape == (B, H, D)
            parity.check(got, want, lengths, f"B7 {(B, H, G, D, S, chunk)} lengths {lengths}")


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_over_a_ring_matches_plain_version(cuda, q_dtype):
    """B7 over the window kinds' 1,024-slot rings (gemma3-12b's Hg 2 at D
    256, hymba-1.5b's Hg 5 at D 64), bf16, with the lengths the ring decode
    hands it: below, at and capped at W."""
    rng = np.random.default_rng(12)
    for B, H, G, D, W, chunk in parity.RING_CASES:
        q = torch.as_tensor(rng.standard_normal((B, H, D)), dtype=torch.float32,
                            device=cuda).to(q_dtype)
        k, v = (torch.as_tensor(rng.standard_normal((B, W, G, D)), dtype=torch.float32,
                                device=cuda).bfloat16() for _ in range(2))
        lengths = parity.ring_lengths(rng, B, W)
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        got = flash_attention.decode_attention(q, k, v, lens, chunk=chunk)
        want = flash_attention.decode_ref(q, k, v, lens)
        torch.cuda.synchronize()
        parity.check(got, want, lengths, f"B7 ring {(B, H, G, D, W, chunk)} lengths {lengths}")


@pytest.mark.parametrize("window", [0, 7, 1024])
def test_ring_and_window_decode_on_the_card_follow_the_cpu(cuda, window):
    """The models' decode attention on the card (B7) against the same call
    on the CPU (B7's plain version): a 1,024-slot ring from positions
    below, at and past its end (``window`` 1024), a full cache (0) and a
    window of 7 over it.  The cache writes within one bf16 unit plus 1e-3
    (float32 projections on two devices, roped at positions up to 3,000
    rad: a last-bit difference in a float32 RoPE frequency moves such an
    angle by ~3e-4 rad, as ``tests/test_torch_lm.py``'s rope test notes;
    then rounded to bf16), the outputs within 2e-3 (B7's float32
    tolerance, plus what those move)."""
    from repro_torch.models import attention

    rng = np.random.default_rng(13)
    B, G, Hg, hd, D = 3, 8, 2, 256, 512
    params = {name: torch.as_tensor(rng.standard_normal(shape) * D ** -0.5,
                                    dtype=torch.float32)
              for name, shape in (("wq", (D, G, Hg, hd)), ("wk", (D, G, hd)),
                                  ("wv", (D, G, hd)), ("wo", (G, Hg, hd, D)))}
    S = 1024 if window == 1024 else 2048
    k, v = (torch.as_tensor(rng.standard_normal((B, S, G, hd)),
                            dtype=torch.float32).bfloat16() for _ in range(2))
    lengths = torch.tensor([5, 1023, 3000] if window == 1024 else [0, 700, 2047],
                           dtype=torch.int32)
    x = torch.as_tensor(rng.standard_normal((B, 1, D)), dtype=torch.float32)
    kw = dict(num_heads=G * Hg, num_kv_heads=G, head_dim=hd, rope_theta=10_000.0)
    outs = []
    for dev in ("cpu", cuda):
        p = {n: t.to(dev) for n, t in params.items()}
        cache = (k.to(dev).clone(), v.to(dev).clone())
        before = flash_attention.LAUNCHES["flash_decode"]
        if window == 1024:
            y, cache = attention.attention_decode_ring(p, x.to(dev), cache, lengths.to(dev), **kw)
        else:
            y, cache = attention.attention_decode(p, x.to(dev), cache, lengths.to(dev),
                                                  window=window, **kw)
        assert flash_attention.LAUNCHES["flash_decode"] == before + (dev != "cpu")
        outs.append((y.cpu(), cache[0].cpu(), cache[1].cpu()))
    (y_cpu, k_cpu, v_cpu), (y_gpu, k_gpu, v_gpu) = outs
    for got, want in ((k_gpu, k_cpu), (v_gpu, v_cpu)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-3)
    torch.testing.assert_close(y_gpu, y_cpu, rtol=2e-3, atol=2e-3)


def test_flash_decode_never_reads_past_the_lengths(cuda):
    """Rows past each sequence's length, poisoned with 1e9, change nothing."""
    rng = np.random.default_rng(10)
    B, H, G, D, S = 2, 4, 2, 64, 512
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=cuda)
               for s in ((B, H, D), (B, S, G, D), (B, S, G, D)))
    lens = torch.tensor([100, 257], dtype=torch.int32, device=cuda)
    out1 = flash_attention.decode_attention(q, k, v, lens, chunk=128)
    tail = torch.arange(S, device=cuda)[None, :, None, None] >= lens[:, None, None, None]
    out2 = flash_attention.decode_attention(q, k.masked_fill(tail, 1e9),
                                            v.masked_fill(tail, 1e9), lens, chunk=128)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def test_flash_decode_tensor_core_shape_matches_its_mirror(cuda):
    lib = load_library("flash_decode")
    assert lib.flash_decode_tc_rows() == flash_attention.ops.TC_ROWS
    for q_dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for Hg in (1, 8, 9, 16):
            for D in flash_attention.ops.TC_HEAD_DIMS:
                assert lib.flash_decode_tc_smem(code, Hg, D) == \
                    flash_attention.ops.tc_smem_bytes(q_dtype, Hg, D)
                assert lib.flash_decode_tc_regs(code, Hg, D) > 0


def test_flash_decode_refuses_what_it_cannot_launch(cuda):
    q = torch.zeros((1, 2, 48), device=cuda)
    kv = torch.zeros((1, 64, 1, 48), device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.decode_attention(q, kv, kv, lens, chunk=64)
    q, kv = torch.zeros((1, 16, 256), device=cuda), torch.zeros((1, 64, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="heads a group"):
        flash_attention.decode_attention(q, kv, kv, lens, chunk=64)
    with pytest.raises(TypeError, match="bfloat16 cache"):
        flash_attention.decode_attention(q[:, :8].bfloat16(), kv, kv, lens, chunk=64)
    with pytest.raises(TypeError, match="int32"):
        flash_attention.decode_attention(q[:, :8], kv, kv, lens.long(), chunk=64)
    with pytest.raises(ValueError, match="one device"):
        flash_attention.decode_attention(q[:, :8], kv.cpu(), kv.cpu(), lens, chunk=64)


# -- the serving path's async ingest and self-healing ladder on the card -------


def test_readiness_probe_polls_a_cuda_event(cuda):
    """The async-ingest probe is a ``torch.cuda.Event``: pending while the
    stream still spins, ready after, and ``wait`` blocks on it alone."""
    from repro_torch.core.ingest import ReadinessProbe

    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)   # ~0.1 s of spinning on the stream
    probe = ReadinessProbe(cuda)
    assert probe.on_device and not probe.ready()
    assert not probe.wait(timeout=0.0)
    assert probe.wait(timeout=60.0) and probe.ready()


def test_async_ingest_reuses_pinned_canvases_bitwise(cuda):
    """Async ingest on the card: pinned canvases and pinned output
    buffers, two of each per shape.  After a warm-up flush (settings banks
    built), flush 1 runs behind a spin while flush 2 packs and dispatches
    without waiting for it; flush 3 reuses flush 1's canvas and output
    buffer, so the pool first copies flush 1's unread outputs out; every
    output equals the sync fleet's."""
    from repro_torch.runtime.fleet import FleetRequest, LazyOutput, PixieFleet

    rng = np.random.default_rng(31)
    traces = [[FleetRequest(app=a, image=rng.integers(0, 256, (300, 500)).astype(np.int32))
               for a in SOBEL_APPS[:3]] for _ in range(3)]
    sync = PixieFleet()
    fleet = PixieFleet(ingest="async")
    assert fleet.stats.ingest_readiness == "cuda-event"
    np.asarray(fleet.run_many(traces[0])[0])
    torch.cuda._sleep(400_000_000)
    held = [fleet.run_many(trace) for trace in traces[:2]]
    assert not held[0][0].ready()
    assert fleet.stats.ingest_overlap_s > 0.0
    held.append(fleet.run_many(traces[2]))
    assert held[0][0].ready()
    assert fleet.stats.canvas_pool_hits == 2
    for cache in (fleet._canvas_pool, fleet._output_pool):
        (pool,) = cache._d.values()
        assert len(pool) == 2 and all(e.buf.is_pinned() for e in pool)
    for trace, outs in zip(traces, held):
        for got, want in zip(outs, sync.run_many(trace)):
            assert isinstance(got, LazyOutput)
            np.testing.assert_array_equal(np.asarray(got), want)
    assert fleet.stats.fallback_dispatches == fleet.stats.retries == 0


def test_wide_grid_is_refused_at_submit_on_the_card(cuda):
    """A 65-value-wide grid is wider than B1 holds: the hopper fleet on the
    card refuses it at submit, nothing launches and nothing degrades; the
    torch fleet serves it."""
    from repro_torch.runtime.fleet import FleetRequest, PixieFleet

    grid = custom("wide-65", 65, [65, 11, 7, 5, 3, 3, 2], 1)
    image = np.random.default_rng(32).integers(0, 256, (64, 80)).astype(np.int32)
    fleet = PixieFleet(default_grid=grid)
    LAUNCHES["vcgra_fused_batched"] = 0
    with pytest.raises(ValueError, match="65-wide value vector"):
        fleet.submit(FleetRequest(app="sobel_x", image=image))
    assert fleet.flush() == {} and LAUNCHES["vcgra_fused_batched"] == 0
    assert fleet.stats.fallback_dispatches == 0 and fleet.stats.dispatch_plans == {}
    (got,) = PixieFleet(default_grid=grid, backend="torch").run_many(
        [FleetRequest(app="sobel_x", image=image)])
    assert got.shape == image.shape


def test_train_step_on_the_card_equals_the_cpu(cuda):
    """Two ``train_step``s of reduced gemma-2b (float32 compute, TF32 off)
    on the card against the CPU port's, from the same parameters and batch
    (the card's ``chip_smoke.py`` phase 15 (a) tolerance): losses relative
    1e-5; ``m`` and ``v`` within the grads' 1e-4 of their largest element G,
    carried through two steps (|dm| <= 1e-4 (1 - b1^2) G, |dv| <= 2e-4 (1 -
    b2^2) G^2, with G^2 <= max v / ((1 - b2) b2)); the params within 1e-4 of
    their largest element plus 5% of the learning rate (Adam's update
    divides two moments that both vanish with the grad, so a near-zero
    grad's float32 noise moves its update by a share of one step)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import train_step
    from repro_torch.tree import leaves, tree_map

    lr = 3e-3
    lm = LM(reduced(ARCHS["gemma-2b"]), chunk_q=16, loss_chunk=20, compute_dtype=None)
    cpu = lm.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda", copy=True), cpu)
    o_cpu, o_card = init_opt_state(cpu), init_opt_state(card)
    tokens = np.random.default_rng(21).integers(0, 256, (2, 48))
    ocfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=4)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(2):
            _, _, mc = train_step(lm, ocfg, cpu, o_cpu, torch.as_tensor(tokens))
            _, _, md = train_step(lm, ocfg, card, o_card, torch.as_tensor(tokens, device="cuda"))
            np.testing.assert_allclose(float(md["loss"]), float(mc["loss"]), rtol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    b1, b2 = ocfg.b1, ocfg.b2
    for p_cpu, p_card, m_cpu, m_card, v_cpu, v_card in zip(
            leaves(cpu), leaves(card), leaves(o_cpu["m"]), leaves(o_card["m"]),
            leaves(o_cpu["v"]), leaves(o_card["v"])):
        g2 = float(v_cpu.max()) / ((1 - b2) * b2)
        for kind, got, want, tol in (
                ("params", p_card, p_cpu, 1e-4 * float(p_cpu.abs().max()) + 0.05 * lr),
                ("m", m_card, m_cpu, 1e-4 * (1 - b1 ** 2) * g2 ** 0.5),
                ("v", v_card, v_cpu, 2e-4 * (1 - b2 ** 2) * g2)):
            assert float((got.cpu() - want).abs().max()) <= tol, kind
    assert int(o_card["count"]) == 2


@pytest.mark.parametrize("dtype_name", ["int32", "float32"])
def test_kernel_census_reads_b4_and_b5_on_the_card(cuda, dtype_name):
    """The card's census of B4 on the Sobel grid and of B5 for sobel_x:
    registers, shared memory and SASS instructions read from the built
    kernels (cuobjdump / nvdisasm), every count positive, B5 holding its
    values in registers (no shared memory) and B4 its value columns in
    dynamic shared memory."""
    from repro_torch.core.analysis import kernel_census

    bits, float_pe = DTYPES[dtype_name]
    grid = dataclasses.replace(sobel_grid(), data_bits=bits, float_pe=float_pe)
    cfg = map_app(apps.sobel_x(), grid)
    b4 = kernel_census("vcgra_conventional", grid)
    b5 = kernel_census(SpecializedKernel(grid, cfg, False, "cuda"))
    assert b4["kernel"] == "vcgra_conventional" and b5["kernel"] == "vcgra_specialized"
    assert b4["dynamic_smem_bytes"] == conventional_launch(
        bits // 8, grid.num_inputs, grid.pes_per_level, grid.num_outputs, 1024)[1] > 0
    assert b4["registers_per_thread"] > 0 and b5["registers_per_thread"] > 0
    assert b4["sass_instructions"] > 0 and b4["settings_pack_sass_instructions"] > 0
    assert b5["sass_instructions"] > 0
    assert b5["static_smem_bytes"] == 0 and b5["dynamic_smem_bytes"] == 0
