"""B7's sequence-split entry on the CPU: the plain partial
(``ref.decode_partial_ref``, what ``ops.decode_attention_split`` computes
on CPU tensors) over 1, 2, 3 and 16 row blocks of a cache, merged by
``ref.merge_ref``, equals ``decode_ref`` on the whole cache at
``flash_attention.parity``'s float32 tolerance (2e-5: the reference flash
suite's), a block with no valid row and a sequence of length 0 included;
``ops.merge_splits``' collective merge on a one-process group equals the
plain merge; the torch ops' fake implementations give the kernel's shapes
and dtypes on ``meta`` and the census counts them by B7's formula."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import LAUNCHES, decode_ref, ops, parity, ref

#: (B, H, G, D, S): MHA, GQA 4:1, MQA at gemma-2b's head (H 8, G 1, D 256),
#: the ragged 25/5 heads.
SHAPES = [(3, 4, 4, 16, 64), (4, 8, 2, 32, 96), (3, 8, 1, 256, 128), (2, 25, 5, 64, 80)]
BLOCKS = (1, 2, 3, 16)


def _inputs(B, H, G, D, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g)
    k = torch.randn(B, S, G, D, generator=g)
    v = torch.randn(B, S, G, D, generator=g)
    rng = np.random.default_rng(seed)
    # 0 (no row anywhere), a few rows (later blocks empty), S, ragged
    picks = [0, 3, S, int(rng.integers(1, S))]
    lengths = torch.tensor([picks[i % len(picks)] for i in range(B)], dtype=torch.int32)
    return q, k, v, lengths


def _bounds(S, n):
    return [round(i * S / n) for i in range(n + 1)]


@pytest.mark.parametrize("n", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_partials_merged_equal_the_whole_cache(shape, n):
    q, k, v, lengths = _inputs(*shape)
    S = shape[4]
    want = decode_ref(q, k, v, lengths)
    outs, lses, empty_blocks = [], [], 0
    before = LAUNCHES["flash_decode"]
    for a, b in zip(_bounds(S, n), _bounds(S, n)[1:]):
        out, lse = ops.decode_attention_split(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                                              lengths, a, chunk=1)
        assert out.dtype == torch.float32 and lse.dtype == torch.float32
        assert out.shape == q.shape and lse.shape == q.shape[:2]
        # a sequence with no valid row in the block: lse -inf, output 0
        none = (lengths - a).clamp(0, b - a) == 0
        assert torch.isneginf(lse[none]).all() and not out[none].any()
        empty_blocks += int(none.any())
        outs.append(out)
        lses.append(lse)
    assert LAUNCHES["flash_decode"] == before, "the CPU path launches no kernel"
    got = ref.merge_ref(outs, lses, q.dtype)
    parity.check(got, want, lengths.tolist(), f"split into {n}")
    if n > 1:
        assert empty_blocks, "the case table must hold a block with no valid row"


def test_partial_lse_is_the_log_sum_exp_of_the_scores():
    q, k, v, lengths = _inputs(2, 4, 2, 16, 32, seed=3)
    out, lse = ref.decode_partial_ref(q, k, v, lengths, 0)
    qg = q.reshape(2, 2, 2, 16)
    for b in range(2):
        n = int(lengths[b])
        for h in range(4):
            s = (k[b, :n, h // 2] @ qg[b, h // 2, h % 2]) * 16 ** -0.5
            want = torch.logsumexp(s, 0) if n else torch.tensor(float("-inf"))
            torch.testing.assert_close(lse[b, h], want, rtol=1e-6, atol=1e-6)


def test_merge_splits_on_one_rank_is_the_plain_merge():
    """The collective merge on a one-process gloo group (the all-gather and
    the all-reduce see one rank) returns the block itself, normalised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        q, k, v, lengths = _inputs(3, 8, 1, 256, 128, seed=5)
        out, lse = ops.decode_attention_split(q, k, v, lengths, 0, chunk=128)
        merged = ops.merge_splits(out, lse, (mesh, 0))
        parity.check(merged, ref.merge_ref([out], [lse], torch.float32), lengths.tolist())
        parity.check(merged, decode_ref(q, k, v, lengths), lengths.tolist())
    finally:
        if started:
            dist.destroy_process_group()


def test_fake_implementations_give_the_shapes_on_meta():
    q = torch.empty(8, 8, 256, dtype=torch.bfloat16, device="meta")
    k = torch.empty(8, 2048, 1, 256, dtype=torch.bfloat16, device="meta")
    lengths = torch.empty(8, dtype=torch.int32, device="meta")
    out = ops.decode_attention(q, k, k, lengths)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    out, lse = ops.decode_attention_split(q, k, k, lengths, 2048)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == torch.float32
    assert lse.shape == (8, 8) and lse.dtype == torch.float32


def test_the_census_counts_b7_by_its_formula():
    from repro_torch.roofline.hlo_analysis import analyze

    B, H, G, D, S = 8, 8, 1, 256, 2048
    q = torch.empty(B, H, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, G, D, dtype=torch.bfloat16, device="meta")
    lengths = torch.empty(B, dtype=torch.int32, device="meta")
    whole = analyze(ops.decode_attention, q, k, k, lengths)
    assert whole.op_counts == {"repro_torch::flash_decode": 1}
    # flash_bound's bytes over every row: q and out, k and v, the lengths
    assert whole.hbm_bytes == 2 * B * H * D * 2 + 2 * B * S * G * D * 2 + 4 * B
    assert whole.flops_by_dtype == {"float32": 4.0 * D * H * B * S}
    split = analyze(ops.decode_attention_split, q, k, k, lengths, 0)
    assert split.hbm_bytes == whole.hbm_bytes + 4 * B * H
    assert split.flops == whole.flops
