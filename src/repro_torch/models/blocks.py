"""Per-kind transformer blocks: init / prefill / decode / cache.

Twin of the reference's ``models/blocks.py`` for the ``"dense"`` kind (GQA
attention + MLP), the kind of every layer of gemma-2b, glm4-9b and
starcoder2-7b:

    init_block(generator, cfg, kind)                   -> params dict
    block_prefill(params, cfg, kind, x, cache_len)     -> (x', cache)
    block_decode(params, cfg, kind, x, cache, l)       -> (x', cache)
    init_block_cache(cfg, kind, batch, seq, device)    -> zeroed cache dict

Every other kind (local and hymba ring caches, moe, mlstm, slstm) raises
``NotImplementedError``: ROADMAP Queue A item 14 ports them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, init_mlp, init_rmsnorm, mlp, rmsnorm

KINDS = ("dense",)


def check_kind(kind: str) -> str:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (the port runs {KINDS}): "
            "ROADMAP Queue A item 14")
    return kind


def init_block(generator: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    check_kind(kind)
    D = cfg.d_model
    return {
        "ln_attn": init_rmsnorm(D, generator.device),
        "attn": attn.init_attention(
            generator, D, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        ),
        "ln_mlp": init_rmsnorm(D, generator.device),
        "mlp": init_mlp(generator, D, cfg.d_ff, cfg.mlp_type),
    }


def _store_kv(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Pack prefill keys/values left-aligned into a [B, cache_len, ...]
    bf16 decode cache buffer (the reference's full-attention branch)."""
    B, S, G, hd = k.shape
    if S > cache_len:
        raise ValueError(f"a {S}-token prefill does not fit a cache of {cache_len}")
    buf = torch.zeros((B, cache_len, G, hd), dtype=torch.bfloat16, device=k.device)
    buf[:, :S] = k.to(torch.bfloat16)
    return buf


def block_prefill(
    params: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    cache_len: int,
    chunk_q: int = 512,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence application that also emits the decode cache."""
    check_kind(kind)
    h = rmsnorm(params["ln_attn"], x)
    h, (k, v) = attn.attention_train(
        params["attn"], h,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        chunk_q=chunk_q, return_kv=True,
    )
    x = x + h
    h = mlp(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return x + h, {"k": _store_kv(k, cache_len), "v": _store_kv(v, cache_len)}


def block_decode(
    params: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,              # [B, 1, D]
    cache: Dict[str, torch.Tensor],
    lengths: torch.Tensor,        # [B]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through the block; the cache is updated in place."""
    check_kind(kind)
    h = rmsnorm(params["ln_attn"], x)
    h, kv = _attn_decode(params["attn"], cfg, h, cache, lengths)
    x = x + h
    h = mlp(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return x + h, kv


def _attn_decode(aparams, cfg: ArchConfig, h, cache, lengths):
    y, (k, v) = attn.attention_decode(
        aparams, h, (cache["k"], cache["v"]), lengths,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
    )
    return y, {"k": k, "v": v}


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, seq: int, device=None):
    """Zeroed decode cache for one layer of `kind` (dtype bf16 for KV)."""
    check_kind(kind)
    shape = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }
