"""B7's sequence-split entry on the CPU: the plain partial
(``ref.decode_partial_ref``, what ``ops.decode_attention_split`` computes
on CPU tensors) over 1, 2, 3 and 16 row blocks of a cache, merged by
``ref.merge_ref``, equals ``decode_ref`` on the whole cache at
``flash_attention.parity``'s float32 tolerance (2e-5: the reference flash
suite's), a block with no valid row and a sequence of length 0 included;
``ops.merge_splits``' collective merge on a one-process group equals the
plain merge; the torch ops' fake implementations give the kernel's shapes
and dtypes on ``meta`` and the census counts them by B7's formula.  The
split entry over a column block of v (``Dv`` of the head dim's ``D``
columns, a view strided as k): the blocks' partials merged equal those
columns of ``decode_ref``, at the same tolerance; its fake gives ``[B, H,
Dv]`` and the census counts the scores over ``D`` and the weighted sum
and v's bytes over ``Dv``."""

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


#: (B, H, G, D, S, Dv): gemma3-12b's global layers cut (Hg 2) at a column of
#: one, 16 and 128 of D 256 (16 and 32 'data' ranks, and 2), MQA at D 16
#: split in 16 and 4, GQA 4:1 at D 64 in 8.
COLUMN_SHAPES = [(1, 4, 2, 256, 64, 1), (1, 4, 2, 256, 64, 16), (1, 4, 2, 256, 64, 128),
                 (2, 4, 1, 16, 48, 1), (2, 4, 1, 16, 48, 4), (3, 8, 2, 64, 40, 8)]


@pytest.mark.parametrize("n", (1, 3))
@pytest.mark.parametrize("shape", COLUMN_SHAPES, ids=[str(s) for s in COLUMN_SHAPES])
def test_a_column_block_of_v_merged_equals_those_columns(shape, n):
    """Every column block of v, each over ``n`` row blocks merged, equals
    its columns of the whole cache's output; the blocks put side by side
    equal all of it."""
    B, H, G, D, S, Dv = shape
    q, k, v, lengths = _inputs(B, H, G, D, S, seed=Dv)
    want = decode_ref(q, k, v, lengths)
    cols = []
    for c0 in range(0, D, Dv):
        outs, lses = [], []
        for a, b in zip(_bounds(S, n), _bounds(S, n)[1:]):
            kb, vb = k[:, a:b].contiguous(), v[:, a:b].contiguous()
            block = vb[..., c0:c0 + Dv]
            assert not block.is_contiguous() or Dv == D
            out, lse = ops.decode_attention_split(q, kb, block, lengths, a, chunk=1)
            assert out.shape == (B, H, Dv) and out.dtype == torch.float32
            whole_out, whole_lse = ref.decode_partial_ref(q, kb, vb, lengths, a)
            torch.testing.assert_close(lse, whole_lse, rtol=0, atol=0)
            outs.append(out)
            lses.append(lse)
        got = ref.merge_ref(outs, lses, q.dtype)
        parity.check(got, want[..., c0:c0 + Dv].contiguous(), lengths.tolist(),
                     f"columns {c0}..{c0 + Dv} of {D}, {n} row blocks")
        cols.append(got)
    parity.check(torch.cat(cols, dim=-1), want, lengths.tolist(), "the column blocks")


def test_a_column_block_must_divide_the_head_dim():
    q, k, v, lengths = _inputs(1, 4, 2, 64, 16)
    with pytest.raises(ValueError, match="Dv dividing D"):
        ops.decode_attention_split(q, k, v[..., :24], lengths, 0, chunk=1)
    with pytest.raises(ValueError, match="v \\[B, S, G, D\\]"):
        ops.decode_attention(q, k, v[..., :16], lengths, chunk=1)


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
    out, lse = ops.decode_attention_split(q, k, k[..., 32:48], lengths, 0)
    assert out.device.type == "meta" and out.shape == (8, 8, 16)
    assert out.dtype == torch.float32 and lse.shape == (8, 8)


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
    # a column block: the scores over D, the weighted sum over Dv
    Dv = 16
    cols = analyze(ops.decode_attention_split, q, k, k[..., :Dv], lengths, 0)
    assert cols.flops_by_dtype == {"float32": 2.0 * D * H * B * S + 2.0 * Dv * H * B * S}
    assert cols.hbm_bytes == (B * H * (D + Dv) * 2 + B * S * G * (D + Dv) * 2 + 4 * B
                              + 4 * B * H)


def _smoke():
    """``chip_smoke.py`` as a module."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke          # its dataclasses look their module up
    try:
        spec.loader.exec_module(smoke)
    finally:
        del sys.modules[spec.name]
    return smoke


@pytest.mark.parametrize("Dv", [None, 16, 128])
def test_the_smoke_bound_counts_what_the_census_counts(Dv):
    """``chip_smoke.flash_bound`` keeps its own formula for B7's bound; it
    reads the census's operations and bytes, a column block of v included."""
    smoke = _smoke()
    B, H, G, D, lengths = 1, 16, 8, 256, [1024]
    flops, nbytes = ops.census_cost(B, H, G, D, sum(lengths), 2, Dv)
    assert smoke.flash_bound(B, H, G, D, lengths, 2, Dv) == (*smoke.bound(nbytes, flops), nbytes)


@pytest.mark.parametrize("batch_share", [False, True])
def test_the_smoke_planted_ring_is_the_ring_decode_with_no_fault(batch_share):
    """The card's zoo phase swaps ``attention_decode_ring`` for
    ``chip_smoke.planted_ring``: with no fault planted it takes the ring
    decode's arguments and gives its output and cache bit for bit."""
    from repro_torch.models import attention

    g = torch.Generator().manual_seed(27)
    params = attention.init_attention(g, 32, 4, 2, 8)
    x = torch.randn(2, 1, 32, generator=g)
    lengths = torch.tensor([3, 11], dtype=torch.int32)
    kv = [torch.randn(2, 8, 2, 8, generator=g).to(torch.bfloat16) for _ in range(2)]
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=10000.0,
              batch_share=batch_share)
    want, want_kv = attention.attention_decode_ring(params, x, [t.clone() for t in kv],
                                                    lengths, **kw)
    got, got_kv = _smoke().planted_ring()(params, x, [t.clone() for t in kv], lengths, **kw)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_kv, want_kv))
