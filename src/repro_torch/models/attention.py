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
(``attention_decode_ring``), which B7 reads as it stands.  The mesh
constraints of the reference (``seq_shard``) are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import decode_attention
from repro_torch.models.layers import Params, f32_matmul, rope, truncated_normal

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
):
    """Full-sequence attention (training / prefill), query-chunked; with
    grad enabled and more than one chunk, each chunk is rematerialised."""
    B, S, _ = x.shape
    G = num_kv_heads
    Hg = num_heads // G
    positions = torch.arange(S, device=x.device)

    q, k, v = _project_qkv(params, x, G, Hg, head_dim, positions[None], rope_theta)

    # Query chunks of chunk_q rows, the last one ragged.  The reference
    # takes the largest divisor of S (pick_chunk), which is 1 for a prime S:
    # a query's scores never depend on its chunk, so the function is the
    # same, without S chunks a layer for a prime-length prompt.
    cq = min(chunk_q, S)
    n_chunks = -(-S // cq)
    # banded K/V: a sliding-window chunk only sees the last (window + cq)
    # keys, as in the reference.
    band = window + cq
    use_band = window > 0 and prefix_len == 0 and band < S and n_chunks > 1

    if n_chunks == 1:
        out = _sdpa(q, k, v, _mask(positions, positions, window, prefix_len))
    else:
        outs = []
        for i in range(0, S, cq):
            qb = q[:, i:i + cq]
            pos_q = positions[i:i + cq]
            if use_band:
                start = min(max(i - window, 0), S - band)
                kb, vb = k[:, start:start + band], v[:, start:start + band]
                pos_k = positions[start:start + band]
            else:
                kb, vb, pos_k = k, v, positions
            mask = _mask(pos_q, pos_k, window, prefix_len)
            if torch.is_grad_enabled():
                # remat, as the reference's: backward recomputes the chunk's
                # scores and softmax instead of keeping [B, Hq, cq, S] float32
                # residuals a chunk
                outs.append(checkpoint(_sdpa, qb, kb, vb, mask, use_reentrant=False))
            else:
                outs.append(_sdpa(qb, kb, vb, mask))
        out = torch.cat(outs, dim=1)

    y = torch.einsum("bsghk,ghkd->bsd", out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def _decode_out(params, q, k_rows, v_rows, n_rows, G, Hg, head_dim, out_dtype):
    """B7 over ``k_rows``/``v_rows`` ``[B, R, G, hd]`` masked to each
    sequence's first ``n_rows`` rows, then the output projection."""
    B = q.shape[0]
    R = k_rows.shape[1]
    out = decode_attention(q.reshape(B, G * Hg, head_dim), k_rows, v_rows,
                           n_rows.to(torch.int32), chunk=pick_chunk(R, 512))
    out = out.to(out_dtype).reshape(B, 1, G, Hg, head_dim)
    # bf16 attention into float32 weights (compute_dtype=None) promotes, as
    # in JAX; torch.einsum takes one dtype.
    wo = params["wo"]
    dtype = torch.promote_types(out.dtype, wo.dtype)
    return torch.einsum("bsghk,ghkd->bsd", out.to(dtype), wo.to(dtype))


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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode over a KV cache; returns (y, cache).  The cache
    tensors are updated in place and returned.

    With ``window > 0`` a sequence attends to its rows ``lengths - window
    + 1 .. lengths`` only, as the reference masks them; B7 takes no start
    row, so those rows are gathered into a ``[B, window, G, hd]`` buffer
    first (keys are stored post-RoPE, so their order is free)."""
    B = x.shape[0]
    G = num_kv_heads
    Hg = num_heads // G
    k_cache, v_cache = cache
    S = k_cache.shape[1]

    q, k_new, v_new = _project_qkv(params, x, G, Hg, head_dim, lengths[:, None], rope_theta)

    # In place: row lengths[b] of sequence b.  The reference's
    # dynamic_update_slice clamps a start past the end to S - 1; so does this.
    rows = torch.arange(B, device=x.device)
    slots = lengths.long().clamp(0, S - 1)
    k_cache[rows, slots] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slots] = v_new[:, 0].to(v_cache.dtype)

    if window > 0:
        # rows max(0, lengths + 1 - window) .. min(lengths, S - 1)
        first = (lengths.long() + 1 - window).clamp_min(0)
        n_rows = torch.minimum(lengths.long(), torch.full_like(first, S - 1)) - first + 1
        idx = (first[:, None] + torch.arange(window, device=x.device)).clamp_max(S - 1)
        k_rows, v_rows = k_cache[rows[:, None], idx], v_cache[rows[:, None], idx]
    else:
        # The reference masks keys at pos <= lengths, B7 at pos < lengths: + 1.
        k_rows, v_rows, n_rows = k_cache, v_cache, lengths + 1
    y = _decode_out(params, q, k_rows, v_rows, n_rows, G, Hg, head_dim, v_cache.dtype)
    return y, (k_cache, v_cache)


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
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Sliding-window decode over an O(window) ring-buffer cache, updated
    in place.

    The new k/v goes to slot ``lengths % W``.  Keys are stored post-RoPE at
    absolute positions, so slot order is irrelevant to the attention math,
    and eviction enforces the window.  The reference masks slots ``<=
    lengths`` (all of them once wrapped); B7 reads rows ``< min(lengths +
    1, W)``, the same set."""
    B = x.shape[0]
    G = num_kv_heads
    Hg = num_heads // G
    k_cache, v_cache = cache
    W = k_cache.shape[1]

    q, k_new, v_new = _project_qkv(params, x, G, Hg, head_dim, lengths[:, None], rope_theta)

    rows = torch.arange(B, device=x.device)
    slots = lengths.long() % W
    k_cache[rows, slots] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slots] = v_new[:, 0].to(v_cache.dtype)

    n_rows = (lengths + 1).clamp_max(W)
    y = _decode_out(params, q, k_cache, v_cache, n_rows, G, Hg, head_dim, v_cache.dtype)
    return y, (k_cache, v_cache)
