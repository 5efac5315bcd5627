"""B7's tensor-core arithmetic, emulated in PyTorch on the CPU and held to
the plain version (``decode_ref``) at ``flash_attention.parity``'s
tolerances, and the wrapper's pure functions (the route between the two
bodies, split and tile sizes, shared memory of B7's block).

The emulation repeats what ``flash_decode_tc`` computes, step by step:

* bf16 operands, exact products, float32 sums: a float32 q is split into
  three bf16 parts (hi, mid, lo), each softmax weight P likewise, and
  every product of a part with a bf16 k or v value is exact in float32;
* each split of S (:func:`ops.split_length`) is cut into ring tiles of
  :data:`ops.TC_ROWS` rows, 16 for each of 4 warps; a warp keeps its own
  online softmax (float32, ``exp``) over its 16-row pieces, rows past the
  length masked;
* the warps merge into one partial per split, and the splits merge as
  ``flash_decode_combine`` merges them, ``acc / max(l, 1e-30)`` cast once.

The kernel on the card is held to the same plain version by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import decode_ref, ops, parity

NEG_INF = -1e30
#: The H100's SMs and the most splits a launch takes (``split_length``'s
#: inputs on the card).
SM_COUNT, MAX_SPLITS = 132, 8192
#: The ``decode_32k`` head shape (one gemma-2b layer) at a reduced S.
DECODE_32K_REDUCED = (4, 8, 1, 256, 4096, 512)
#: Every config with attention layers (all but xlstm-1.3b): B7 runs in each.
ATTENTION_ARCHS = ("deepseek-moe-16b", "gemma-2b", "gemma3-12b", "glm4-9b", "hymba-1.5b",
                   "musicgen-medium", "paligemma-3b", "qwen2-moe-a2.7b", "starcoder2-7b")


def bf16_parts(x: torch.Tensor, n: int):
    """x (float32) as n bf16 parts, each the float32 remainder rounded."""
    parts = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        parts.append(p)
        x = x - p
    return parts


def emulate_tc(q, k, v, lengths, split=None, p_parts=3):
    """``flash_decode_tc`` then ``flash_decode_combine``, in float32 on the
    CPU: q ``[B, H, D]`` (float32 or bf16), k/v ``[B, S, G, D]`` bf16."""
    B, H, D = q.shape
    _, S, G, _ = k.shape
    Hg = H // G
    if split is None:
        split = ops.split_length(B, S, G, SM_COUNT, MAX_SPLITS)
    n_splits = -(-S // split)
    rows = n_splits * split
    qf = q.reshape(B, G, Hg, D).float()
    q_parts = bf16_parts(qf, 3 if q.dtype == torch.float32 else 1)
    pad = rows - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    # [B, G, split index, tile, warp, 16 rows, D]
    tiles = split // ops.TC_ROWS
    shape = (B, n_splits, tiles, 4, 16, G, D)
    kf = kf.reshape(shape).permute(0, 5, 1, 2, 3, 4, 6)
    vf = vf.reshape(shape).permute(0, 5, 1, 2, 3, 4, 6)
    pos = torch.arange(rows).reshape(n_splits, tiles, 4, 16)
    valid = pos[None] < lengths.long().clamp(0, S)[:, None, None, None, None]
    valid = valid[:, None]                                  # [B, 1, NS, T, 4, 16]
    scale = D ** -0.5
    m = torch.full((B, G, n_splits, 4, Hg), NEG_INF)
    l = torch.zeros((B, G, n_splits, 4, Hg))
    acc = torch.zeros((B, G, n_splits, 4, Hg, D))
    for t in range(tiles):
        kt, vt, ok = kf[:, :, :, t], vf[:, :, :, t], valid[:, :, :, t]   # [B,G,NS,4,16,(D)]
        s = sum(torch.einsum("bgnwrd,bghd->bgnwrh", kt, qp) for qp in q_parts)
        a = torch.where(ok[..., None], s * scale, torch.tensor(NEG_INF))
        mx = torch.maximum(m, a.amax(dim=4))
        alpha = torch.exp(m - mx)
        p = torch.where(ok[..., None], torch.exp(a - mx[:, :, :, :, None]), torch.tensor(0.0))
        l = l * alpha + p.sum(dim=4)
        acc = acc * alpha[..., None] + sum(
            torch.einsum("bgnwrh,bgnwrd->bgnwhd", pp, vt) for pp in bf16_parts(p, p_parts))
        m = mx
    # the warps' merge into one partial per split
    pm = m.amax(dim=3)
    w = torch.exp(m - pm[:, :, :, None])
    pl = (l * w).sum(dim=3)
    pacc = (acc * w[..., None]).sum(dim=3)
    # the combine: splits with l = 0 carry no weight
    cm = pm.amax(dim=2)
    cw = torch.where(pl > 0, torch.exp(pm - cm[:, :, None]), torch.tensor(0.0))
    num = (pacc * cw[..., None]).sum(dim=2)
    den = (pl * cw).sum(dim=2).clamp_min(1e-30)
    return (num / den[..., None]).reshape(B, H, D).to(q.dtype)


def _inputs(rng, B, H, G, D, S, q_dtype, kv_dtype):
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(q_dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, G, D)).astype(np.float32)).to(kv_dtype)
            for _ in range(2))
    return q, k, v


TC_CASES = [(case, dt) for case in parity.CASES for dt in parity.DTYPES
            if ops.tensor_core_route(dt[1], case[1] // case[2], case[3])]


@pytest.mark.parametrize("case,dtypes", TC_CASES,
                         ids=[f"{c}-{str(d[0])[6:]}-{str(d[1])[6:]}" for c, d in TC_CASES])
def test_tensor_core_arithmetic_holds_the_parity_tolerance(case, dtypes):
    B, H, G, D, S, _ = case
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    q, k, v = _inputs(rng, B, H, G, D, S, *dtypes)
    for lens in (parity.lengths(rng, B, S), [S] * B):
        lengths = torch.tensor(lens, dtype=torch.int32)
        parity.check(emulate_tc(q, k, v, lengths), decode_ref(q, k, v, lengths), lens,
                     f"emulated B7 {case} {dtypes}")


RING_TC_CASES = [(case, dt) for case in parity.RING_CASES for dt in parity.DTYPES
                 if dt[1] == torch.bfloat16]


@pytest.mark.parametrize("case,dtypes", RING_TC_CASES,
                         ids=[f"{c}-{str(d[0])[6:]}" for c, d in RING_TC_CASES])
def test_tensor_core_arithmetic_over_a_ring(case, dtypes):
    """The ring caches' lengths, below, at and capped at W."""
    B, H, G, D, W, _ = case
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    q, k, v = _inputs(rng, B, H, G, D, W, *dtypes)
    lens = parity.ring_lengths(rng, B, W)
    assert min(lens) < W and lens.count(W) >= 2
    lengths = torch.tensor(lens, dtype=torch.int32)
    parity.check(emulate_tc(q, k, v, lengths), decode_ref(q, k, v, lengths), lens,
                 f"emulated B7 over a ring {case} {dtypes}")


def test_every_parity_case_on_a_bf16_cache_takes_the_tensor_cores():
    routed = {(c, d) for c, d in TC_CASES}
    for case in parity.CASES:
        for dt in parity.DTYPES:
            assert ((case, dt) in routed) == (dt[1] == torch.bfloat16), (case, dt)
    for case in parity.RING_CASES:
        assert ops.tensor_core_route(torch.bfloat16, case[1] // case[2], case[3]), case


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_tensor_core_arithmetic_at_the_decode_32k_head_shape(q_dtype):
    B, H, G, D, S, _ = DECODE_32K_REDUCED
    rng = np.random.default_rng(41)
    q, k, v = _inputs(rng, B, H, G, D, S, q_dtype, torch.bfloat16)
    lens = [S, S - 1, 1000, 4001]
    lengths = torch.tensor(lens, dtype=torch.int32)
    for split in (None, 512):  # the card's split, and several splits a sequence
        parity.check(emulate_tc(q, k, v, lengths, split), decode_ref(q, k, v, lengths), lens,
                     f"emulated B7 at the decode_32k head shape, split {split}")


def test_a_single_bf16_part_of_p_misses_the_float32_tolerance():
    """P rounded once to bf16 loses ~2^-9 of each weight: over a float32 q
    that exceeds the 2e-5 tolerance, which is why the kernel splits P."""
    rng = np.random.default_rng(42)
    q, k, v = _inputs(rng, 2, 8, 1, 128, 1024, torch.float32, torch.bfloat16)
    lens = [1024, 700]
    lengths = torch.tensor(lens, dtype=torch.int32)
    want = decode_ref(q, k, v, lengths)
    parity.check(emulate_tc(q, k, v, lengths), want, lens)
    with pytest.raises(AssertionError, match="tolerance"):
        parity.check(emulate_tc(q, k, v, lengths, p_parts=1), want, lens)


def _shapes():
    """(label, Hg, D, B, S, G) of every parity case, decode_32k and every
    config with attention at the engine's batch and cache (and, for the
    window kinds, their 1,024-row ring)."""
    out = [(f"parity{c}", c[1] // c[2], c[3], c[0], c[4], c[2])
           for c in parity.CASES + parity.RING_CASES]
    out.append(("decode_32k", 8, 256, 128, 32768, 1))
    for name in ATTENTION_ARCHS:
        cfg = get_arch(name)
        Hg, D, G = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, cfg.num_kv_heads
        out.append((name, Hg, D, 8, 4096, G))
        if cfg.window:
            out.append((f"{name}-ring", Hg, D, 8, min(4096, cfg.window), G))
    return out


@pytest.mark.parametrize("label,Hg,D,B,S,G", _shapes(), ids=[s[0] for s in _shapes()])
def test_route_split_and_shared_memory_of_every_shape(label, Hg, D, B, S, G):
    for kv_dtype in (torch.bfloat16, torch.float32):
        assert ops.tensor_core_route(kv_dtype, Hg, D) == (
            kv_dtype == torch.bfloat16 and D in ops.TC_HEAD_DIMS and Hg <= ops.TC_MAX_HEADS)
    if label.removesuffix("-ring") in ATTENTION_ARCHS or label == "decode_32k":
        assert ops.tensor_core_route(torch.bfloat16, Hg, D)
    for q_dtype in (torch.bfloat16, torch.float32):
        if ops.tensor_core_route(torch.bfloat16, Hg, D):
            assert ops.tc_smem_bytes(q_dtype, Hg, D) <= ops.MAX_SMEM_BYTES
    split = ops.split_length(B, S, G, SM_COUNT, MAX_SPLITS)
    assert split % ops.TC_ROWS == 0 and split >= ops.MIN_SPLIT
    assert -(-S // split) <= MAX_SPLITS


def test_shared_memory_of_the_tensor_core_block():
    assert ops.tc_smem_bytes(torch.bfloat16, 8, 256) == 200_704       # gemma-2b
    assert ops.tc_smem_bytes(torch.float32, 16, 256) == 221_184       # the largest
    assert ops.tc_smem_bytes(torch.float32, 16, 256) <= ops.MAX_SMEM_BYTES
    assert not ops.tensor_core_route(torch.bfloat16, 17, 128)
    assert not ops.tensor_core_route(torch.bfloat16, 8, 48)
