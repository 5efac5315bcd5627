"""The launch shapes and limits of the vectorised VCGRA kernels (B1, B2 and
B4; B3's are in ``test_torch_flash_numerics.py``), decided in Python before a
launch: the block each wrapper asks for, the radius path B1 takes, the
value-vector width each kernel holds, and the headers every kernel
library is rebuilt from.  No JAX, no card: the C side's twins of these
mirrors are checked on the card by ``tests/test_torch_kernels_cuda.py``.
"""

import re

import pytest
import torch

from repro_torch.core.grid import custom
from repro_torch.kernels import build
from repro_torch.kernels.vcgra import ops

SOBEL = (18, [9] * 5)
ALL_APPS = (27, [19, 11, 7, 5, 3, 3, 2])
WIDEST = (64, [64] * 4)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_fused_block_fits_and_takes_the_window_up_to_its_radius(itemsize):
    """B1's block fits the card up to 64 values: with one window buffer up
    to ``WINDOW_MAX_RADIUS``, reading taps from device memory past it."""
    for C, widths in (SOBEL, ALL_APPS, WIDEST, (1, [1])):
        for radius in range(ops.WINDOW_MAX_RADIUS + 1):
            threads, smem, window = ops.fused_launch(itemsize, radius, C, widths, K=2)
            assert window and threads in (32, 64, 128) and smem <= ops.MAX_SMEM_BYTES
        for radius in (ops.WINDOW_MAX_RADIUS + 1, 100, ops.FUSED_MAX_RADIUS):
            threads, smem, window = ops.fused_launch(itemsize, radius, C, widths, K=2)
            assert not window and threads in (32, 64, 128) and smem <= ops.MAX_SMEM_BYTES
            assert smem == ops.batched_launch(itemsize, C, widths, K=2)[1]
    with pytest.raises(ValueError, match="int32 tap_sel"):
        ops.fused_launch(itemsize, ops.FUSED_MAX_RADIUS + 1, *SOBEL, K=1)
    with pytest.raises(ValueError, match="vcgra_fused_batched takes at most 64"):
        ops.fused_launch(itemsize, 1, 65, [9], K=1)


def test_fused_and_batched_blocks_at_the_main_path_shape():
    """int32 ``sobel-5x9``, K = 1: 128 threads, the window (34 x 144 int32),
    27 value slots a thread, 18 consts and a 172-int record; B2 the same
    without the window."""
    assert ops.value_slots(*SOBEL) == (18, 9)
    assert ops.record_ints(*SOBEL, K=1) == 172
    slots_record = 27 * 128 * 16 + 80 + 4 * 172
    assert ops.fused_launch(4, 1, *SOBEL, K=1) == (128, 34 * 144 * 4 + slots_record, True)
    assert ops.batched_launch(4, *SOBEL, K=1) == (128, slots_record)
    # 64 + 64 slots of 16 bytes do not fit 128 threads: 64 do.
    assert ops.batched_launch(4, *WIDEST, K=1)[0] == 64


@pytest.mark.parametrize("kernel", sorted(ops.MAX_VALS))
def test_each_kernel_holds_its_own_value_width(kernel):
    """64 values for B1, B2, B3 and B4, checked before a library is loaded;
    the message names the kernel."""
    limit = ops.MAX_VALS[kernel]
    assert limit == 64
    ops.check_value_width(kernel, custom("at-limit", limit, [limit, 3], 1))
    ops.check_value_width(kernel, custom("wide-40", 40, [40, 3], 1))
    for grid in (custom("too-many-inputs", limit + 1, [3], 1),
                 custom("too-wide-level", 3, [3, limit + 1], 1)):
        with pytest.raises(ValueError, match=f"{kernel} holds at most {limit}"):
            ops.check_value_width(kernel, grid)
    loaded = dict(build._libs)
    with pytest.raises(ValueError, match=f"{kernel} holds at most 64"):
        ops._launch_target(kernel, custom("wide-65", 65, [65, 3], 1), 1, torch.device("cuda"))
    assert build._libs == loaded


SOBEL_MAG = (27, [18, 10, 6, 4, 2, 2, 1])


def test_conventional_block_at_the_single_app_shape():
    """B4 is B2's block over one app: at the ``sobel_mag`` exact grid in
    int32 (value slots (27, 18), a 372-int record) 128 threads and 93,760
    bytes; ``block_n`` sets its passes of 128 x 4 pixels, at least one."""
    assert ops.value_slots(*SOBEL_MAG) == (27, 18)
    assert ops.record_ints(*SOBEL_MAG, K=1) == 372
    smem = 45 * 128 * 16 + 112 + 4 * 372
    assert smem == 93_760
    for block_n, passes in ((128, 1), (256, 1), (512, 1), (1024, 2), (1152, 3), (4096, 8)):
        assert ops.conventional_launch(4, *SOBEL_MAG, 1, block_n) == (128, smem, passes)
    assert ops.conventional_launch(4, *SOBEL_MAG, 1, 1024)[:2] == \
        ops.batched_launch(4, *SOBEL_MAG, K=1)
    # Eight pixels a thread in 2-byte dtypes.
    assert ops.conventional_launch(2, *SOBEL_MAG, 1, 1024)[2] == 1
    assert ops.conventional_launch(2, *SOBEL_MAG, 1, 2048)[2] == 2
    with pytest.raises(ValueError, match="vcgra_conventional takes at most 64"):
        ops.conventional_launch(4, 65, [9], 1, 1024)


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
