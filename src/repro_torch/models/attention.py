"""GQA/MQA attention: query-chunked training/prefill path + cached decode.

Twin of the reference's ``models/attention.py``.  The prefill path never
materialises the full [S, S] score matrix: queries are processed in
``chunk_q`` blocks by a Python loop (the reference's ``lax.scan``; the
last block ragged, where the reference shrinks the block to a divisor of
S), so scores peak at [B, G, Hg, chunk_q, S] f32; under autograd each
chunk is recomputed in backward (``torch.utils.checkpoint``, the
reference's per-chunk remat), so training keeps none of them.  Decode
writes the new token's k/v into the cache in place and attends through
the flash decode kernel (``kernels/flash_attention``, B7), which computes
the same function as the reference's einsum decode apart from one
rounding: the reference rounds the softmax weights to the cache dtype
before the weighted sum, B7 keeps them in float32.

Masking supports: causal, sliding-window (``window > 0``), and
bidirectional-prefix (PaliGemma-style prefix-LM over ``prefix_len``
leading positions) on the prefill path.  Decode takes full attention, a
window over the full cache (the window's rows gathered into a buffer of
``window`` rows that B7 reads), or the window kinds' ring cache
(``attention_decode_ring``), which B7 reads as it stands.  On an LM mesh
``seq_shard`` shards the queries along the sequence over 'model'
(sequence-parallel attention, the plan's 'seq' mode); off-mesh it is the
identity.

Decode on a mesh (a DTensor cache laid out by ``ShardingPlan.cache_specs``)
works rank by rank and never gathers the cache: each projection runs on
the rank's block of its weight, q and the new k/v rows (one token) are
then gathered to whole heads, each rank writes the new rows that fall in
its block of the cache and B7 reads that block.  Where the cache's
sequence dim is split over 'model', each rank runs B7's sequence-split
entry on its rows and the ranks merge their outputs by their
log-sum-exps (``ops.merge_splits``: an all-gather of ``[B, H]`` float32
and an all-reduce of the weighted outputs).  Where the cache's batch is
then whole over the other mesh dims (the data axes: a batch of one, or
one they do not divide), those ranks split v's head dim instead, as XLA's
partitioner does: each takes
the weighted sum over its own column block of v (a local slice; the
scores stay whole) and the merged outputs are gathered over the data axes.
The output projection runs on the rank's block of ``wo``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import decode_attention
from repro_torch.kernels.flash_attention.ops import decode_attention_split, merge_splits
from repro_torch.models.layers import Params, f32_matmul, rope, truncated_normal
from repro_torch.parallel.axes import (
    constrain, from_block, local_block, model_block, ragged_share, whole_local,
)

NEG_INF = -2.0e38


def pick_chunk(S: int, chunk: int) -> int:
    """Largest divisor of S that is <= chunk (handles meta-token-extended
    sequence lengths that are not powers of two)."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def init_attention(generator: torch.Generator, d: int, num_heads: int, num_kv_heads: int,
                   head_dim: int) -> Params:
    """3D weight layout with explicit (heads, head_dim) axes, as the
    reference keeps it."""
    s = d ** -0.5
    so = (num_heads * head_dim) ** -0.5
    G = num_kv_heads
    Hg = num_heads // G
    return {
        "wq": truncated_normal(generator, (d, G, Hg, head_dim), s),
        "wk": truncated_normal(generator, (d, G, head_dim), s),
        "wv": truncated_normal(generator, (d, G, head_dim), s),
        "wo": truncated_normal(generator, (G, Hg, head_dim, d), so),
    }


def _project_qkv(params, x, G, Hg, head_dim, positions, rope_theta):
    """x: [B, S, D] -> q [B,S,G,Hg,hd] (roped), k, v [B,S,G,hd] (k roped)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dghk->bsghk", x, params["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, params["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, params["wv"])
    q = rope(q.reshape(B, S, G * Hg, head_dim), positions, rope_theta).reshape(
        B, S, G, Hg, head_dim)
    k = rope(k, positions, rope_theta)
    return q, k, v


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, window: int,
          prefix_len: int) -> torch.Tensor:
    """[Sq, Sk] boolean allowed-attention mask."""
    causal = pos_k[None, :] <= pos_q[:, None]
    allowed = causal
    if prefix_len > 0:
        both_prefix = (pos_q[:, None] < prefix_len) & (pos_k[None, :] < prefix_len)
        allowed = allowed | both_prefix
    if window > 0:
        in_window = pos_q[:, None] - pos_k[None, :] < window
        if prefix_len > 0:
            both_prefix = (pos_q[:, None] < prefix_len) & (pos_k[None, :] < prefix_len)
            allowed = allowed & (in_window | both_prefix)
        else:
            allowed = allowed & in_window
    return allowed


def _sdpa(q, k, v, mask):
    """q: [B,Sq,G,Hg,D]  k,v: [B,Sk,G,D]  mask: [Sq,Sk] -> [B,Sq,G,Hg,D].
    Scores in float32 from the operands' exact products, as the
    reference's ``preferred_element_type=float32``."""
    D = q.shape[-1]
    B, Sq, G, Hg, _ = q.shape
    Sk = k.shape[1]
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, G, Hg * Sq, D)     # [B,G,Hg*Sq,D]
    kh = k.permute(0, 2, 3, 1)                                    # [B,G,D,Sk]
    scores = f32_matmul(qh, kh).reshape(B, G, Hg, Sq, Sk) * (D ** -0.5)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bghqk,bkgd->bqghd", p.to(v.dtype), v)


def _attend(q, k, v, q0: int, window: int, prefix_len: int, chunk_q: int):
    """Causal (windowed, prefix-LM) attention of the queries ``q`` ``[B,
    Sq, G, Hg, hd]`` at positions ``q0 .. q0 + Sq - 1`` over the keys and
    values ``[B, Sk, G, hd]`` at positions ``0 .. Sk - 1``; with grad
    enabled and more than one chunk, each chunk is rematerialised."""
    Sq, Sk = q.shape[1], k.shape[1]
    pos_q = q0 + torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)
    # Query chunks of chunk_q rows, the last one ragged.  The reference
    # takes the largest divisor of S (pick_chunk), which is 1 for a prime S:
    # a query's scores never depend on its chunk, so the function is the
    # same, without S chunks a layer for a prime-length prompt.
    cq = min(chunk_q, Sq)
    n_chunks = -(-Sq // cq)
    # banded K/V: a sliding-window chunk only sees the last (window + cq)
    # keys, as in the reference.
    band = window + cq
    use_band = window > 0 and prefix_len == 0 and band < Sk and n_chunks > 1

    if n_chunks == 1:
        return _sdpa(q, k, v, _mask(pos_q, pos_k, window, prefix_len))
    outs = []
    for i in range(0, Sq, cq):
        qb = q[:, i:i + cq]
        if use_band:
            start = min(max(q0 + i - window, 0), Sk - band)
            kb, vb = k[:, start:start + band], v[:, start:start + band]
            kpos = pos_k[start:start + band]
        else:
            kb, vb, kpos = k, v, pos_k
        mask = _mask(pos_q[i:i + cq], kpos, window, prefix_len)
        if torch.is_grad_enabled():
            # remat, as the reference's: backward recomputes the chunk's
            # scores and softmax instead of keeping [B, Hq, cq, S] float32
            # residuals a chunk
            outs.append(checkpoint(_sdpa, qb, kb, vb, mask, use_reentrant=False))
        else:
            outs.append(_sdpa(qb, kb, vb, mask))
    return torch.cat(outs, dim=1)


def attention_train(
    params: Params,
    x: torch.Tensor,             # [B, S, D]
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    prefix_len: int = 0,
    chunk_q: int = 512,
    return_kv: bool = False,
    seq_shard: bool = False,
):
    """Full-sequence attention (training / prefill), query-chunked; with
    grad enabled and more than one chunk, each chunk is rematerialised.

    ``seq_shard``: sequence-parallel attention for archs whose head counts
    don't divide the model axis -- keys and values gathered (small: G*hd a
    token), queries sharded along the sequence over 'model', so the
    scores are sharded on Sq with no score collectives.  On a mesh it runs
    on each rank's block (:func:`_seq_parallel`); off-mesh it changes
    nothing.  In the other modes a mesh gathers the sequence before the
    projections (Megatron's sequence parallelism)."""
    B, S, _ = x.shape
    G = num_kv_heads
    Hg = num_heads // G
    if isinstance(x, DTensor):
        if seq_shard:
            return _seq_parallel(params, x, G, Hg, head_dim, rope_theta, window, prefix_len,
                                 chunk_q, return_kv)
        x = constrain(x, "batch", None, None)
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, G, Hg, head_dim, positions[None], rope_theta)
    out = _attend(q, k, v, 0, window, prefix_len, chunk_q)
    y = torch.einsum("bsghk,ghkd->bsd", out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def _seq_parallel(params, x: DTensor, G, Hg, head_dim, rope_theta, window, prefix_len,
                  chunk_q, return_kv):
    """Sequence-parallel attention on a mesh, rank by rank: this rank's
    rows of the sequence (split over 'model' where it divides) project its
    queries, keys and values with the whole (replicated) weights; the keys
    and values are gathered along the sequence over 'model' (a functional
    all-gather, differentiable); the queries attend; the output projection
    stays on the rank's rows.  No collective touches the scores, and no
    DTensor reshape meets a split sequence."""
    import torch.distributed._functional_collectives as funcol

    mesh = x.device_mesh
    B, S, _ = x.shape
    model = mesh.mesh_dim_names.index("model")
    x = constrain(x, "batch", "model" if S % mesh.shape[model] == 0 else None, None)
    layout = tuple(x.placements)
    (_, ns, _), (_, s0, _) = local_block(x.shape, mesh, layout)
    w = {name: whole_local(params[name], x) for name in ("wq", "wk", "wv", "wo")}
    xl = x.to_local()
    positions = s0 + torch.arange(ns, device=xl.device)
    q, k, v = _project_qkv(w, xl, G, Hg, head_dim, positions[None], rope_theta)
    if layout[model] != Replicate():
        k = funcol.all_gather_tensor_autograd(k, gather_dim=1, group=(mesh, model))
        v = funcol.all_gather_tensor_autograd(v, gather_dim=1, group=(mesh, model))
    out = _attend(q, k, v, s0, window, prefix_len, chunk_q)
    y = torch.einsum("bsghk,ghkd->bsd", out, w["wo"])
    y = from_block(y, mesh, layout, (B, S, y.shape[-1]))
    if not return_kv:
        return y
    kv_layout = tuple(Replicate() if i == model else p for i, p in enumerate(layout))
    shape = (B, S, G, head_dim)
    return y, (from_block(k, mesh, kv_layout, shape), from_block(v, mesh, kv_layout, shape))


#: Each projection weight's dims -> the dims of its product (None: the
#: contracted d_model).
_Q_DIMS, _KV_DIMS = (None, 2, 3, 4), (None, 2, 3)


def _project(eq: str, x, w, dims, shape):
    """``einsum(eq, x, w)`` for one decode token.  On a mesh, rank by rank:
    x's rows (laid out by its batch split, whole elsewhere) times this
    rank's block of ``w``, the product laid out as x (a split of w's heads
    or head dim over 'model' gathered, a split of its contracted dim
    summed): no weight is gathered along 'model' and no DTensor reshape
    meets a split dim."""
    block, split, model = model_block(w)
    if not isinstance(x, DTensor):
        return torch.einsum(eq, x, block)
    rows = tuple(x.placements)
    y = torch.einsum(eq, x.to_local(), block.to_local())
    out = Replicate() if split == Replicate() else (
        Partial() if dims[split.dim] is None else Shard(dims[split.dim]))
    layout = tuple(out if i == model else p for i, p in enumerate(rows))
    y = from_block(y, x.device_mesh, layout, shape)
    return y if layout == rows else y.redistribute(x.device_mesh, rows)


def _decode_qkv(params, x, G, Hg, head_dim, positions, rope_theta):
    """:func:`_project_qkv` for one decode token (each projection by
    :func:`_project`); on a mesh q, k and v come out whole per sequence
    (tiny: one token), laid out by x's batch split."""
    B, S, _ = x.shape
    if isinstance(x, DTensor):
        rows = _batch_rows(x.placements)
        if tuple(x.placements) != rows:
            x = x.redistribute(x.device_mesh, rows)
    q = _project("bsd,dghk->bsghk", x, params["wq"], _Q_DIMS, (B, S, G, Hg, head_dim))
    k = _project("bsd,dgk->bsgk", x, params["wk"], _KV_DIMS, (B, S, G, head_dim))
    v = _project("bsd,dgk->bsgk", x, params["wv"], _KV_DIMS, (B, S, G, head_dim))
    q = rope(q.reshape(B, S, G * Hg, head_dim), positions, rope_theta).reshape(
        B, S, G, Hg, head_dim)
    return q, rope(k, positions, rope_theta), v


def _decode_project_out(params, out, out_dtype):
    """The output projection of one token's attention ``[B, 1, G, Hg, hd]``:
    on a mesh this rank's heads (or head dims) through its block of ``wo``,
    the product a partial sum over 'model' where ``wo`` is split there.
    bf16 attention into float32 weights (compute_dtype=None) promotes, as
    in JAX; torch.einsum takes one dtype."""
    wo, split, model = model_block(params["wo"])
    if not isinstance(out, DTensor):
        o = out.to(out_dtype)
        dtype = torch.promote_types(o.dtype, wo.dtype)
        return torch.einsum("bsghk,ghkd->bsd", o.to(dtype), wo.to(dtype))
    mesh = out.device_mesh
    block = wo.to_local()
    o = out.to_local().to(out_dtype)
    if isinstance(split, Shard) and split.dim < 3:
        off = local_block(wo.shape, mesh, wo.placements)[1][split.dim]
        o = o.narrow(split.dim + 2, off, block.shape[split.dim])
    dtype = torch.promote_types(o.dtype, block.dtype)
    y = torch.einsum("bsghk,ghkd->bsd", o.to(dtype), block.to(dtype))
    p = (Replicate() if split == Replicate()
         else Shard(2) if split.dim == 3 else Partial())
    layout = tuple(p if i == model else q for i, q in enumerate(out.placements))
    return from_block(y, mesh, layout, (*out.shape[:2], y.shape[-1]))


def _batch_rows(layout) -> tuple:
    """``layout`` with its batch split kept and every other split whole."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in layout)


def _column_layout(layout, mesh, hd: int):
    """The layout of a decode output ``[B, 1, G, Hg, hd]`` whose head dim
    the data axes split, for a cache laid out by ``layout`` whose sequence
    is split and whose batch is whole over them (every mesh dim that does
    not split the sequence): over the innermost of them whose sizes'
    product divides ``hd`` ('data', then 'pod'); None where the batch is
    split or none of them divides."""
    if any(isinstance(p, Shard) and p.dim == 0 for p in layout):
        return None
    data, n = [], 1
    for i in reversed(range(len(layout))):
        size = mesh.shape[i]
        if not isinstance(layout[i], Shard) and size > 1 and hd % (n * size) == 0:
            data.append(i)
            n *= size
    if not data:
        return None
    return tuple(Shard(4) if i in data else Replicate() for i in range(len(layout)))


def _decode_attend(q, k_new, v_new, k_cache, v_cache, slots, n_rows, batch_share=False):
    """One token's attention over the cache ``[B, S, G, hd]``, its new k/v
    rows written in place first.  ``q`` is ``[B, 1, G, Hg, hd]``,
    ``k_new``/``v_new`` ``[B, 1, G, hd]``, ``slots`` each sequence's cache
    row, ``n_rows`` its valid rows.  Returns the attention output ``[B, 1,
    G, Hg, hd]`` in q's dtype.

    On a mesh (a DTensor cache) each rank works on its block of the cache,
    which is never gathered: it writes the new rows whose slots its block
    holds and runs B7 on its rows; where the cache's sequence is split, B7's
    sequence-split entry runs on them and the ranks merge by their
    log-sum-exps, and where its batch is whole over the data axes each of
    their ranks takes its own column block of v (:func:`_column_layout`)
    and the outputs are gathered over them, or, with ``batch_share``, its
    own ragged share of the sequences (``axes.ragged_share``; a rank whose
    share is empty runs no B7) and the outputs are summed over them.  The
    output is laid out by the cache's batch split.  A plain cache is the
    one-block, one-column-block case."""
    mesh = None
    k_loc, v_loc, q_loc = k_cache, v_cache, q
    nb, ns = k_cache.shape[:2]
    r0, seq = 0, []
    if isinstance(k_cache, DTensor):
        mesh, layout = k_cache.device_mesh, tuple(k_cache.placements)
        if any(isinstance(p, Shard) and p.dim > 1 for p in layout):
            raise ValueError(f"a decode cache split on its heads or head dim ({layout}); the "
                             "plan splits its batch and sequence dims only")
        (nb, ns, _, _), (b0, r0, _, _) = local_block(k_cache.shape, mesh, layout)
        seq = [i for i, p in enumerate(layout) if isinstance(p, Shard) and p.dim == 1]
        if len(seq) > 1:
            raise ValueError(f"the cache's sequence split over {len(seq)} mesh dims; one at most")
        rows_layout = _batch_rows(layout)
        k_loc, v_loc = k_cache.to_local(), v_cache.to_local()

    def mine(t):
        """This rank's sequences of a per-sequence tensor (leading dim B)."""
        if mesh is None:
            return t
        if isinstance(t, DTensor):
            return (t if tuple(t.placements) == rows_layout
                    else t.redistribute(mesh, rows_layout)).to_local()
        return t[b0:b0 + nb]

    q_loc = mine(q)
    rows = torch.arange(nb, device=k_loc.device)
    local = mine(slots).long() - r0
    for block, new in ((k_loc, k_new), (v_loc, v_new)):
        new = mine(new)[:, 0].to(block.dtype)
        if seq:
            # only the rank whose rows hold a sequence's slot writes it
            inside = ((local >= 0) & (local < ns))[:, None, None]
            idx = local.clamp(0, ns - 1)
            block[rows, idx] = torch.where(inside, new, block[rows, idx])
        else:
            block[rows, local] = new

    lengths = mine(n_rows).to(torch.int32)
    shared = []
    if batch_share and seq and nb == q.shape[0]:
        # the ragged shares of the sequences over the mesh dims that hold
        # the whole batch; the same on every rank of the sequence split, so
        # a merge's ranks all run it or all skip it
        shared = [i for i in range(mesh.ndim) if i != seq[0] and mesh.shape[i] > 1]
        b0, nb, _ = ragged_share(nb, mesh, shared)
        q_loc, lengths = q_loc[b0:b0 + nb], lengths[b0:b0 + nb]
        k_loc, v_loc = k_loc[b0:b0 + nb], v_loc[b0:b0 + nb]
    nq, _, G, Hg, hd = q_loc.shape
    qh = q_loc.reshape(nq, G * Hg, hd)
    cols = _column_layout(layout, mesh, hd) if seq and not shared else None
    c0, dv = 0, hd
    if cols is not None:
        (*_, dv), (*_, c0) = local_block(q.shape, mesh, cols)
    if seq and not nq:
        out = qh.new_zeros((0, G * Hg, hd))
    elif seq:
        out, lse = decode_attention_split(qh, k_loc, v_loc[..., c0:c0 + dv], lengths, r0,
                                          chunk=pick_chunk(ns, 512))
        out = merge_splits(out, lse, (mesh, seq[0]))
    else:
        out = decode_attention(qh, k_loc, v_loc, lengths, chunk=pick_chunk(ns, 512))
    out = out.to(q_loc.dtype).reshape(nq, 1, G, Hg, dv)
    if mesh is None:
        return out
    if shared:
        out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, 0, b0, q.shape[0] - b0 - nq))
        part = tuple(Partial() if i in shared else Replicate() for i in range(mesh.ndim))
        return from_block(out, mesh, part, q.shape).redistribute(mesh, rows_layout)
    if cols is None:
        return from_block(out, mesh, rows_layout, q.shape)
    return from_block(out, mesh, cols, q.shape).redistribute(mesh, rows_layout)


def attention_decode(
    params: Params,
    x: torch.Tensor,                         # [B, 1, D] current-token activations
    cache: Tuple[torch.Tensor, torch.Tensor],  # k,v: [B, S, G, hd]
    lengths: torch.Tensor,                   # [B] int32 current cache fill (== position)
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    batch_share: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode over a KV cache; returns (y, cache).  The cache
    tensors are updated in place and returned.  ``batch_share``: see
    :func:`_decode_attend`.

    With ``window > 0`` a sequence attends to its rows ``lengths - window
    + 1 .. lengths`` only, as the reference masks them; B7 takes no start
    row, so those rows are gathered into a ``[B, window, G, hd]`` buffer
    first (keys are stored post-RoPE, so their order is free)."""
    B = x.shape[0]
    G = num_kv_heads
    Hg = num_heads // G
    k_cache, v_cache = cache
    S = k_cache.shape[1]

    q, k_new, v_new = _decode_qkv(params, x, G, Hg, head_dim, lengths[:, None], rope_theta)
    # In place: row lengths[b] of sequence b.  The reference's
    # dynamic_update_slice clamps a start past the end to S - 1; so does this.
    slots = lengths.long().clamp(0, S - 1)
    if window > 0:
        if isinstance(k_cache, DTensor):
            raise NotImplementedError("a window over a full cache on a mesh; the window kinds "
                                      "keep a ring cache (attention_decode_ring)")
        rows = torch.arange(B, device=x.device)
        k_cache[rows, slots] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, slots] = v_new[:, 0].to(v_cache.dtype)
        # rows max(0, lengths + 1 - window) .. min(lengths, S - 1)
        first = (lengths.long() + 1 - window).clamp_min(0)
        n_rows = torch.minimum(lengths.long(), torch.full_like(first, S - 1)) - first + 1
        idx = (first[:, None] + torch.arange(window, device=x.device)).clamp_max(S - 1)
        out = decode_attention(q.reshape(B, G * Hg, head_dim), k_cache[rows[:, None], idx],
                               v_cache[rows[:, None], idx], n_rows.to(torch.int32),
                               chunk=pick_chunk(window, 512)).to(q.dtype).reshape(q.shape)
    else:
        # The reference masks keys at pos <= lengths, B7 at pos < lengths: + 1.
        out = _decode_attend(q, k_new, v_new, k_cache, v_cache, slots, lengths + 1, batch_share)
    return _decode_project_out(params, out, v_cache.dtype), (k_cache, v_cache)


def attention_decode_ring(
    params: Params,
    x: torch.Tensor,                         # [B, 1, D]
    cache: Tuple[torch.Tensor, torch.Tensor],  # k,v: [B, W, G, hd] ring buffers
    lengths: torch.Tensor,                   # [B] int32 absolute position
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    rope_theta: float,
    batch_share: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Sliding-window decode over an O(window) ring-buffer cache, updated
    in place.  ``batch_share``: see :func:`_decode_attend`.

    The new k/v goes to slot ``lengths % W``.  Keys are stored post-RoPE at
    absolute positions, so slot order is irrelevant to the attention math,
    and eviction enforces the window.  The reference masks slots ``<=
    lengths`` (all of them once wrapped); B7 reads rows ``< min(lengths +
    1, W)``, the same set."""
    G = num_kv_heads
    Hg = num_heads // G
    k_cache, v_cache = cache
    W = k_cache.shape[1]

    q, k_new, v_new = _decode_qkv(params, x, G, Hg, head_dim, lengths[:, None], rope_theta)
    out = _decode_attend(q, k_new, v_new, k_cache, v_cache, lengths.long() % W,
                         (lengths + 1).clamp_max(W), batch_share)
    return _decode_project_out(params, out, v_cache.dtype), (k_cache, v_cache)
