"""B7 held against its plain version: the one case table and tolerance
that ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` share.

Both sides compute in float32 from the same input values and differ only
in the order of their float32 sums, so:

* a float32 output (float32 q, over a float32 or a bf16 cache) is held to
  the reference flash suite's float32 tolerance, 2e-5 relative and
  absolute;
* a bf16 output (bf16 q over a bf16 cache) may differ by the one rounding
  to bf16 on each side: at most one bf16 unit of the value, ``2**-7 |ref|``,
  plus ``1e-3 max |ref|`` for the float32 sums' own difference near zero.

A sequence of length 0 must give exactly 0.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

#: (B, H, G, D, S, chunk): the reference's flash suite
#: (tests/test_kernels_flash.py: MHA, GQA 4:1, MQA, the ragged 25/5 heads,
#: the chunk sweep, one chunk), gemma-2b's MQA head (H 8, G 1, D 256) at
#: the engine's cache length and at a cache length that is no power of two,
#: glm4-9b's and starcoder2-7b's groups (16 and 9 heads, D 128), the
#: reduced LM's D 16, a cache of 200 rows (no multiple of the tensor-core
#: body's 64-row tiles, so its lengths end inside a tile) and one head a
#: group at D 256; then the rest of the zoo's head layouts at their cache
#: lengths: gemma3-12b's global layers (Hg 2, D 256), deepseek-moe-16b's
#: and qwen2-moe's (Hg 1, D 128), hymba-1.5b's global layers (Hg 5, D 64)
#: and musicgen-medium's (Hg 1, D 64).
CASES: List[Tuple[int, int, int, int, int, int]] = [
    (2, 8, 8, 64, 512, 256), (2, 8, 2, 64, 512, 256), (1, 8, 1, 128, 1024, 256),
    (3, 25, 5, 64, 512, 256), (2, 4, 2, 64, 1024, 128), (2, 4, 2, 64, 1024, 256),
    (2, 4, 2, 64, 1024, 512), (1, 2, 2, 32, 128, 128), (8, 8, 1, 256, 4096, 512),
    (5, 8, 1, 256, 1000, 8), (2, 32, 2, 128, 512, 256), (2, 36, 4, 128, 512, 256),
    (3, 4, 2, 16, 64, 64), (3, 16, 2, 128, 200, 8), (2, 4, 4, 256, 320, 64),
    (2, 16, 8, 256, 4096, 512), (3, 16, 16, 128, 4096, 512), (3, 25, 5, 64, 1152, 128),
    (2, 24, 24, 64, 512, 256),
]
#: (B, H, G, D, W, chunk): ring caches of W rows, read with the lengths of
#: :func:`ring_lengths` -- gemma3-12b's local layers at the engine's batch
#: (Hg 2, D 256) and hymba-1.5b's (Hg 5, D 64), both W = 1024.
RING_CASES: List[Tuple[int, int, int, int, int, int]] = [
    (8, 16, 8, 256, 1024, 512), (3, 25, 5, 64, 1024, 512),
]
#: (B, H, G, D, S, Dv): the sequence-split entry over a column block of v --
#: gemma3-12b's global layers at a batch of one (Hg 2, D 256), one rank's
#: 1,024 rows, Dv 16 (16 'data' ranks) and 128 (2); columns of 1 and 4,
#: fewer than a lane's 8 elements (loaded one by one); MQA at D 16, GQA at
#: D 64, each over a cache of 200 rows.
COLUMN_CASES: List[Tuple[int, int, int, int, int, int]] = [
    (1, 16, 8, 256, 1024, 16), (1, 16, 8, 256, 1024, 128), (2, 16, 8, 256, 320, 1),
    (2, 16, 8, 256, 320, 4), (3, 4, 1, 16, 200, 4), (3, 8, 2, 64, 200, 8),
]
#: (q dtype, cache dtype) pairs the kernel takes.
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)]
#: float32 outputs: the reference suite's tolerance.
F32_TOL = 2e-5
#: bf16 outputs: one bf16 unit relative, plus this share of max |ref|.
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 1e-3


def lengths(rng, B: int, S: int) -> List[int]:
    """Lengths 0, 1, S and two ragged values, cycled over the batch."""
    picks = [0, 1, S, int(rng.integers(2, S)), int(rng.integers(1, S + 1))]
    return [picks[(i + B) % len(picks)] for i in range(B)]


def ring_lengths(rng, B: int, W: int) -> List[int]:
    """What the ring decode hands B7, ``min(position + 1, W)``, for
    positions below the ring's end (a ragged one and W - 2), at it (W - 1)
    and past it (W, and a later one): lengths below, at and capped at W,
    cycled over the batch (three sequences hold all three)."""
    positions = [int(rng.integers(0, W - 2)), W - 1, int(rng.integers(W, 4 * W)), W - 2, W]
    return [min(positions[i % len(positions)] + 1, W) for i in range(B)]


def tolerance(want: torch.Tensor) -> Tuple[float, float]:
    """(rtol, atol) for an output of ``want``'s dtype and values."""
    if want.dtype == torch.bfloat16:
        return BF16_RTOL, BF16_ATOL_SHARE * float(want.float().abs().max())
    return F32_TOL, F32_TOL


def check(got: torch.Tensor, want: torch.Tensor, lens: List[int], what: str = "B7"):
    """Raise unless ``got`` is ``want`` within :func:`tolerance` and exactly
    0 where the length is 0; return the largest absolute error and its
    largest share of the elementwise tolerance."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}, the plain version "
                             f"{want.dtype} {tuple(want.shape)}")
    rtol, atol = tolerance(want)
    g, w = got.float(), want.float()
    d = (g - w).abs()
    limit = atol + rtol * w.abs()
    share = float((d / limit).nan_to_num(0.0, posinf=float("inf")).max()) if d.numel() else 0.0
    if not bool((d <= limit).all()):
        raise AssertionError(f"{what}: max abs err {float(d.max())}, {share:.3g} x the "
                             f"tolerance (rtol {rtol}, atol {atol})")
    empty = [b for b, n in enumerate(lens) if n == 0]
    if empty and bool(got[empty].any()):
        raise AssertionError(f"{what}: a sequence of length 0 must give exactly 0")
    return (float(d.max()) if d.numel() else 0.0), share
