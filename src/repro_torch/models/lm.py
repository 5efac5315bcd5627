"""The language-model stack for serving: prefill and decode.

Twin of the reference's ``models/lm.py``.  Parameters live in a plain dict
of tensors with the reference's layout, so the tests compare like with
like and ``models/convert.py`` copies the reference's pytree leaf by leaf:

    params = {
      "embed":      embedding table (+ optional unembed),
      "meta":       learned meta tokens [M, D] (hymba), optional,
      "prefix":     tuple of per-layer params for cfg.prefix_pattern (unrolled),
      "blocks":     {f"{j}:{kind}": stacked [n_superblocks, ...] leaves},
      "final_norm": RMSNorm,
    }

The reference scans the superblocks (``lax.scan``); here a Python loop
walks the prefix layers, then the superblocks, indexing the stacked
leaves, and decode writes each layer's new k/v and recurrent state into
the cache in place.  ``forward`` and ``loss`` come with the training
slice (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    embed, init_embedding, init_rmsnorm, rmsnorm, truncated_normal, unembed,
)


def _block_keys(cfg: ArchConfig):
    return [f"{j}:{kind}" for j, kind in enumerate(cfg.pattern)]


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _cast_params(params, dtype):
    """Matmul weights -> compute dtype; 1D scales/biases stay f32, as in the
    reference.  Leaves already in ``dtype`` pass through untouched, so
    params cast once (the serving engine does) cost nothing here."""
    if dtype is None:
        return params
    return tree_map(
        lambda p: p.to(dtype) if (p.dtype == torch.float32 and p.dim() >= 2) else p,
        params,
    )


def _stacked(make, n: int, dtype=None) -> Dict:
    """``n`` calls of ``make()`` stacked leaf by leaf along a new axis 0,
    written into preallocated leaves (no second full-size copy).  With a
    ``dtype``, each stacked leaf is allocated as :func:`_cast_params` would
    cast it (a float32 leaf stacks to 2 or more dims, so into ``dtype``)
    and each call's leaves are cast as they are written: only one call's
    float32 leaves exist at a time."""
    def alloc(leaf):
        out_dtype = leaf.dtype if dtype is None or leaf.dtype != torch.float32 else dtype
        return leaf.new_empty((n, *leaf.shape), dtype=out_dtype)

    first = make()
    out = tree_map(alloc, first)

    def write(dst, src, i):
        if isinstance(dst, dict):
            for key in dst:
                write(dst[key], src[key], i)
        else:
            dst[i] = src

    write(out, first, 0)
    del first
    for i in range(1, n):
        write(out, make(), i)
    return out


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig
    chunk_q: int = 512                       # attention query chunk (prefill)
    compute_dtype: Optional[torch.dtype] = torch.bfloat16  # None => keep f32

    def __post_init__(self):
        cfg = self.cfg
        for kind in (*cfg.prefix_pattern, *cfg.pattern):
            blk.check_kind(kind)
        if cfg.modality not in ("text", "vision_stub", "audio_stub"):
            raise ValueError(f"{cfg.name}: unknown modality {cfg.modality!r}")

    # -- init -------------------------------------------------------------

    def init(self, generator: torch.Generator, cast: bool = False) -> Dict:
        """Random parameters on the generator's device: the float32 master
        copy, or with ``cast`` the served copy, equal bitwise to
        ``cast_params(init(generator))`` drawn from the same generator
        state.  The cast copy is built leaf by leaf and superblock by
        superblock, so the float32 copy of a whole model never exists (a
        16 B model's is 65 GB)."""
        cfg = self.cfg
        dtype = self.compute_dtype if cast else None
        params: Dict = {
            "embed": _cast_params(init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                                 cfg.tie_embeddings), dtype),
            "final_norm": init_rmsnorm(cfg.d_model, generator.device),
        }
        if cfg.meta_tokens:
            params["meta"] = _cast_params(truncated_normal(
                generator, (cfg.meta_tokens, cfg.d_model), 0.02), dtype)
        if cfg.prefix_pattern:
            params["prefix"] = tuple(_cast_params(blk.init_block(generator, cfg, kind), dtype)
                                     for kind in cfg.prefix_pattern)
        params["blocks"] = {
            key: _stacked(lambda kind=kind: blk.init_block(generator, cfg, kind),
                          cfg.n_superblocks, dtype)
            for key, kind in zip(_block_keys(cfg), cfg.pattern)
        }
        return params

    def cast_params(self, params: Dict) -> Dict:
        return _cast_params(params, self.compute_dtype)

    # -- embedding frontend --------------------------------------------------

    def _embed_inputs(
        self,
        params: Dict,
        tokens: torch.Tensor,                      # [B, S_tok]
        prefix_embeds: Optional[torch.Tensor],     # [B, P, D] modality stub
    ) -> Tuple[torch.Tensor, int]:
        """Meta tokens first, then the precomputed ``prefix_embeds``, then
        the token embeddings; returns them with the number of leading
        positions that are not tokens."""
        cfg = self.cfg
        h = embed(params["embed"], tokens, cfg.scale_embed, cfg.d_model)
        n_prefix = 0
        if prefix_embeds is not None:
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
            n_prefix += prefix_embeds.shape[1]
        if cfg.meta_tokens:
            B = tokens.shape[0]
            meta = params["meta"][None].expand(B, cfg.meta_tokens, cfg.d_model).to(h.dtype)
            h = torch.cat([meta, h], dim=1)
            n_prefix += cfg.meta_tokens
        return h, n_prefix

    # -- serving -----------------------------------------------------------------

    def init_cache(self, batch: int, seq: int, device=None) -> Dict:
        cfg = self.cfg
        cache: Dict = {}
        if cfg.prefix_pattern:
            cache["prefix"] = tuple(blk.init_block_cache(cfg, kind, batch, seq, device)
                                    for kind in cfg.prefix_pattern)
        n_sb = cfg.n_superblocks
        cache["blocks"] = {
            key: tree_map(
                lambda leaf: leaf[None].expand(n_sb, *leaf.shape).clone(),
                blk.init_block_cache(cfg, kind, batch, seq, device),
            )
            for key, kind in zip(_block_keys(cfg), cfg.pattern)
        }
        return cache

    def prefill(
        self,
        params: Dict,
        tokens: torch.Tensor,
        cache_len: int,
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Run the prompt, build the cache.  Returns (last-token logits,
        cache, lengths).  A ``vision_stub`` model attends bidirectionally
        over its leading non-token positions (the prefix-LM mask)."""
        cfg = self.cfg
        params = self.cast_params(params)
        h, n_prefix = self._embed_inputs(params, tokens, prefix_embeds)
        prefix_len = n_prefix if cfg.modality == "vision_stub" else 0
        B, S, _ = h.shape
        cache: Dict = {}

        if cfg.prefix_pattern:
            pcs = []
            for p, kind in zip(params["prefix"], cfg.prefix_pattern):
                h, c = blk.block_prefill(p, cfg, kind, h, cache_len, prefix_len,
                                         chunk_q=self.chunk_q)
                pcs.append(c)
            cache["prefix"] = tuple(pcs)

        per_layer = {key: [] for key in _block_keys(cfg)}
        for i in range(cfg.n_superblocks):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                sb = tree_map(lambda leaf: leaf[i], params["blocks"][key])
                h, c = blk.block_prefill(sb, cfg, kind, h, cache_len, prefix_len,
                                         chunk_q=self.chunk_q)
                per_layer[key].append(c)
        cache["blocks"] = {
            key: {name: torch.stack([c[name] for c in cs]) for name in cs[0]}
            for key, cs in per_layer.items()
        }
        h = rmsnorm(params["final_norm"], h[:, -1:])
        logits = unembed(params["embed"], h)
        lengths = torch.full((B,), S, dtype=torch.int32, device=h.device)
        return logits[:, 0], cache, lengths

    def decode_step(
        self,
        params: Dict,
        tokens: torch.Tensor,      # [B, 1]
        cache: Dict,
        lengths: torch.Tensor,     # [B] int32 (position of the incoming token)
    ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """One token for every sequence.  Writes the new k/v and states into
        ``cache`` in place and returns it with the logits and ``lengths + 1``."""
        cfg = self.cfg
        params = self.cast_params(params)
        h = embed(params["embed"], tokens, cfg.scale_embed, cfg.d_model)
        for p, kind, c in zip(params.get("prefix", ()), cfg.prefix_pattern,
                              cache.get("prefix", ())):
            h, _ = blk.block_decode(p, cfg, kind, h, c, lengths)
        for i in range(cfg.n_superblocks):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                sb = tree_map(lambda leaf: leaf[i], params["blocks"][key])
                layer_cache = tree_map(lambda leaf: leaf[i], cache["blocks"][key])
                h, _ = blk.block_decode(sb, cfg, kind, h, layer_cache, lengths)
        h = rmsnorm(params["final_norm"], h)
        logits = unembed(params["embed"], h)
        return logits[:, 0], cache, lengths + 1
