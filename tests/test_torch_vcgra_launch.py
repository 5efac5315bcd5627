"""The launch shapes of the vectorised VCGRA kernels (B1, B2, B3 and B4),
decided in Python before a launch: the block each wrapper asks for, the
radius path B1 takes, where each kernel keeps its value banks at a given
width (shared memory, or device memory past a 64-thread block), B3's
segments of a chain, and the headers every kernel library is rebuilt
from.  No JAX, no card: the C side's twins of these mirrors are checked on
the card by ``tests/test_torch_kernels_cuda.py``.
"""

import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.vcgra import ops

SOBEL = (18, [9] * 5)
ALL_APPS = (27, [19, 11, 7, 5, 3, 3, 2])
WIDEST = (64, [64] * 4)
#: ``for_dfg(conv7, shape="exact")``: a 7 x 7 convolution with a coefficient
#: a tap, 98 values wide.
CONV7 = (98, [49, 25, 13, 7, 4, 2, 1])
#: A 150-value grid, whose banks a 32-thread block would hold but a
#: 64-thread block does not.
WIDE_150 = (150, [150, 11, 7, 5, 3, 3, 2])
#: A 600-value grid, past what even a 32-thread block holds in shared memory.
WIDE_600 = (600, [600, 11, 7, 5, 3, 3, 2])


@pytest.mark.parametrize("itemsize", [4, 2])
def test_fused_block_fits_and_takes_the_window_up_to_its_radius(itemsize):
    """B1's block fits the card with its value banks in shared memory up to
    64 values: with one window buffer up to ``WINDOW_MAX_RADIUS``, reading
    taps from device memory past it; a 65-value grid is a block like any
    other."""
    for C, widths in (SOBEL, ALL_APPS, WIDEST, (1, [1])):
        for radius in range(ops.WINDOW_MAX_RADIUS + 1):
            threads, smem, window, banks = ops.fused_launch(itemsize, radius, C, widths, K=2)
            assert window and not banks
            assert threads in (64, 128) and smem <= ops.MAX_SMEM_BYTES
        for radius in (ops.WINDOW_MAX_RADIUS + 1, 100, ops.FUSED_MAX_RADIUS):
            threads, smem, window, banks = ops.fused_launch(itemsize, radius, C, widths, K=2)
            assert not window and not banks
            assert threads in (64, 128) and smem <= ops.MAX_SMEM_BYTES
            assert smem == ops.batched_launch(itemsize, C, widths, K=2)[1]
    with pytest.raises(ValueError, match="int32 tap_sel"):
        ops.fused_launch(itemsize, ops.FUSED_MAX_RADIUS + 1, *SOBEL, K=1)
    threads, smem, window, banks = ops.fused_launch(itemsize, 1, 65, [9], K=1)
    assert (threads, window, banks) == (128, True, False) and smem <= ops.MAX_SMEM_BYTES


def test_fused_and_batched_blocks_at_the_main_path_shape():
    """int32 ``sobel-5x9``, K = 1: 128 threads, the window (34 x 144 int32),
    27 value slots a thread, 18 consts and a 264-int record (45 PEs of four
    ints); B2 the same without the window."""
    assert ops.value_slots(*SOBEL) == (18, 9)
    assert ops.record_ints(*SOBEL, K=1) == 264
    slots_record = 27 * 128 * 16 + 80 + 4 * 264
    assert ops.fused_launch(4, 1, *SOBEL, K=1) == \
        (128, 34 * 144 * 4 + slots_record, True, False)
    assert ops.batched_launch(4, *SOBEL, K=1) == (128, slots_record, False)
    # 64 + 64 slots of 16 bytes do not fit 128 threads: 64 do.
    assert ops.batched_launch(4, *WIDEST, K=1)[::2] == (64, False)


def _geometry(kernel, itemsize, C, widths):
    """``(threads, smem, device_banks)`` of ``kernel``'s block at radius 1
    (B1, and B3 over a depth-1 segment), block_n 1024 (B4)."""
    if kernel == "vcgra_fused_batched":
        threads, smem, _, banks = ops.fused_launch(itemsize, 1, C, widths, K=1)
    elif kernel == "vcgra_pipeline_batched":
        threads, smem, _, banks = ops.pipeline_launch(itemsize, 1, C, widths, K=1)
    elif kernel == "vcgra_conventional":
        threads, smem, _, banks = ops.conventional_launch(itemsize, C, widths, 1, 1024)
    else:
        threads, smem, banks = ops.batched_launch(itemsize, C, widths, K=1)
    return threads, smem, banks


#: Window buffers of each kernel at radius 1: (32 + 2) rows of (32P + 2P +
#: 2P) columns, 16-byte aligned.
_BUFFERS = {"vcgra_fused_batched": 1, "vcgra_pipeline_batched": 2, "vcgra_batched": 0,
            "vcgra_conventional": 0}


@pytest.mark.parametrize("kernel", sorted(_BUFFERS))
def test_each_kernel_holds_its_own_value_width(kernel):
    """The block each kernel takes at 64, 98, 150 and 600 values (int32):
    the value banks in shared memory while 128 or 64 threads hold them (64
    values and the 98-wide ``conv7-exact`` grid: 64 threads, which B3's two
    window buffers leave room for too), then in device memory with
    :data:`ops.DEVICE_BANK_THREADS` threads and only the window buffers in
    shared memory (150 values, which a one-warp block would hold, and
    600)."""
    window = _BUFFERS[kernel] * 34 * 144 * 4
    for C, widths in (WIDEST, CONV7):
        threads = 64
        slots = sum(ops.value_slots(C, widths))
        smem = (window + slots * threads * 16 + -(-C * 4 // 16) * 16
                + 4 * ops.record_ints(C, widths, 1))
        assert _geometry(kernel, 4, C, widths) == (threads, smem, False)
        # Twice the threads would not fit.
        assert smem <= ops.MAX_SMEM_BYTES < smem + slots * threads * 16
    assert ops.value_slots(*CONV7) == (98, 49)
    assert ops.value_slots(*WIDE_600) == (600, 600)
    assert ops.value_slots(*WIDE_150) == (150, 150)
    for C, widths in (WIDE_150, WIDE_600):
        assert _geometry(kernel, 4, C, widths) == (ops.DEVICE_BANK_THREADS, window, True)
    # A 32-thread block of the 150-value grid would fit; of the 600-value
    # grid it would need 614 KB of banks.
    assert window + 300 * 32 * 16 + 608 + 4 * ops.record_ints(*WIDE_150, 1) <= \
        ops.MAX_SMEM_BYTES < 1200 * 32 * 16
    loaded = dict(build._libs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops._launch_target(kernel, 1, torch.device("cpu"))
    assert build._libs == loaded


SOBEL_MAG = (27, [18, 10, 6, 4, 2, 2, 1])


def test_conventional_block_at_the_single_app_shape():
    """B4 is B2's block over one app: at the ``sobel_mag`` exact grid in
    int32 (value slots (27, 18), a 624-int record) 128 threads and 94,768
    bytes; ``block_n`` sets its passes of 128 x 4 pixels, at least one."""
    assert ops.value_slots(*SOBEL_MAG) == (27, 18)
    assert ops.record_ints(*SOBEL_MAG, K=1) == 624
    smem = 45 * 128 * 16 + 112 + 4 * 624
    assert smem == 94_768
    for block_n, passes in ((128, 1), (256, 1), (512, 1), (1024, 2), (1152, 3), (4096, 8)):
        assert ops.conventional_launch(4, *SOBEL_MAG, 1, block_n) == (128, smem, passes, False)
    threads, smem, passes, banks = ops.conventional_launch(4, *SOBEL_MAG, 1, 1024)
    assert (threads, smem, banks) == ops.batched_launch(4, *SOBEL_MAG, K=1)
    # Eight pixels a thread in 2-byte dtypes.
    assert ops.conventional_launch(2, *SOBEL_MAG, 1, 1024)[2] == 1
    assert ops.conventional_launch(2, *SOBEL_MAG, 1, 2048)[2] == 2
    # Past 64 values B4 keeps its banks in shared memory at fewer threads.
    assert ops.conventional_launch(4, 65, [9], 1, 1024)[::3] == (128, False)


def test_every_included_header_is_in_the_library_digest():
    """A header missing from ``build.HEADERS`` would leave a stale library
    in ``build/`` after an edit to it."""
    headers = {h.resolve() for h in build.HEADERS}
    sources = sorted(build.KERNELS.glob("*/csrc/*.cu")) + sorted(build.KERNELS.glob("*/csrc/*.cuh"))
    included = set()
    for src in sources:
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(), re.M):
            included.add((src.parent / name).resolve())
    assert included, "no local include found"
    assert included <= headers, sorted(str(p) for p in included - headers)
    assert all(h.exists() for h in headers)


#: Chains of stage radii -> B3's segments (start, stop): within the window
#: (R <= 16) one launch; past it filled greedily; a stage past 16 alone.
SEGMENTS = {
    (0,): ((0, 1),),
    (1, 0, 1, 1): ((0, 4),),
    (1,) * 16: ((0, 16),),
    (16,): ((0, 1),),
    (0,) * 40: ((0, 40),),
    (1,) * 17: ((0, 16), (16, 17)),
    (1,) * 33: ((0, 16), (16, 32), (32, 33)),
    (1, 15, 1, 16): ((0, 2), (2, 3), (3, 4)),
    (1, 1, 20, 1, 1): ((0, 2), (2, 3), (3, 5)),
    (20,): ((0, 1),),
    (0, 20, 0): ((0, 1), (1, 2), (2, 3)),
}


@pytest.mark.parametrize("itemsize", [4, 2])
def test_chain_segments_fit_their_window_and_lone_stages_run_alone(itemsize):
    """B3's segment planner at R = 0, 16, 17 and 33 and with a lone
    radius-20 stage: each segment's block fits the card (two window
    buffers up to R = 16; none for a lone stage past it, its taps read from
    device memory); at the depth-3 chain's shape 128 threads."""
    for radii, segments in SEGMENTS.items():
        assert ops.chain_segments(radii) == segments
        assert [i for a, b in segments for i in range(a, b)] == list(range(len(radii)))
        for a, b in segments:
            R = sum(radii[a:b])
            assert R <= ops.WINDOW_MAX_RADIUS or b - a == 1
            for C, widths in (([19, [11, 7, 5, 4, 3, 2]]), WIDEST, CONV7, (1, [1])):
                threads, smem, window, banks = ops.pipeline_launch(itemsize, R, C, widths, K=2)
                assert window == (R <= ops.WINDOW_MAX_RADIUS)
                # Only conv7-exact's two window buffers from R = 13 (int32)
                # or 15 (16-bit) leave no room for a 64-thread block.
                assert banks == (C == 98 and window and R >= {4: 13, 2: 15}[itemsize])
                assert threads == ops.DEVICE_BANK_THREADS if banks else threads in (64, 128)
                assert smem <= ops.MAX_SMEM_BYTES
                if not window:
                    assert smem == ops.batched_launch(itemsize, C, widths, K=2)[1]
    assert ops.pipeline_launch(4, 3, 19, [11, 7, 5, 4, 3, 2], K=1)[::3] == (128, False)
