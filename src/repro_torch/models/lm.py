"""The language-model stack for serving: prefill and decode.

Twin of the reference's ``models/lm.py``.  Parameters live in a plain dict
of tensors with the reference's layout, so the tests compare like with
like and ``models/convert.py`` copies the reference's pytree leaf by leaf:

    params = {
      "embed":      embedding table (+ optional unembed),
      "blocks":     {f"{j}:{kind}": stacked [n_superblocks, ...] leaves},
      "final_norm": RMSNorm,
    }

The reference scans the superblocks (``lax.scan``); here a Python loop
walks them and indexes the stacked leaves, and decode writes each layer's
new k/v into the stacked cache in place.  ``forward`` and ``loss`` come
with the training slice.  A config whose pattern holds a kind other than
``"dense"``, a prefix pattern, meta tokens or a modality stub raises at
construction (ROADMAP Queue A item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    embed, init_embedding, init_rmsnorm, rmsnorm, unembed,
)


def _block_keys(cfg: ArchConfig):
    return [f"{j}:{kind}" for j, kind in enumerate(cfg.pattern)]


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
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


def _stacked(make, n: int) -> Dict:
    """``n`` calls of ``make()`` stacked leaf by leaf along a new axis 0,
    written into preallocated leaves (no second full-size copy)."""
    first = make()
    out = tree_map(lambda leaf: leaf.new_empty((n, *leaf.shape)), first)

    def write(dst, src, i):
        if isinstance(dst, dict):
            for key in dst:
                write(dst[key], src[key], i)
        else:
            dst[i] = src

    write(out, first, 0)
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
        for kind in cfg.pattern:
            blk.check_kind(kind)
        unported = {
            "a prefix pattern": bool(cfg.prefix_pattern),
            "meta tokens": bool(cfg.meta_tokens),
            f"the {cfg.modality} modality": cfg.modality != "text",
        }
        for what, present in unported.items():
            if present:
                raise NotImplementedError(
                    f"{cfg.name}: {what} is not ported yet: ROADMAP Queue A item 14")

    # -- init -------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Dict:
        """Random parameters (f32 master copy) on the generator's device."""
        cfg = self.cfg
        params: Dict = {
            "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings),
            "final_norm": init_rmsnorm(cfg.d_model, generator.device),
        }
        params["blocks"] = {
            key: _stacked(lambda kind=kind: blk.init_block(generator, cfg, kind),
                          cfg.n_superblocks)
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
        prefix_embeds: Optional[torch.Tensor],     # [B, P, D]
    ) -> torch.Tensor:
        """Token embeddings, after the precomputed ``prefix_embeds`` if any
        (for a text model they are plain leading positions)."""
        cfg = self.cfg
        h = embed(params["embed"], tokens, cfg.scale_embed, cfg.d_model)
        if prefix_embeds is None:
            return h
        return torch.cat([prefix_embeds.to(h.dtype), h], dim=1)

    # -- serving -----------------------------------------------------------------

    def init_cache(self, batch: int, seq: int, device=None) -> Dict:
        cfg = self.cfg
        n_sb = cfg.n_superblocks
        return {
            "blocks": {
                key: tree_map(
                    lambda leaf: leaf[None].expand(n_sb, *leaf.shape).clone(),
                    blk.init_block_cache(cfg, kind, batch, seq, device),
                )
                for key, kind in zip(_block_keys(cfg), cfg.pattern)
            }
        }

    def prefill(
        self,
        params: Dict,
        tokens: torch.Tensor,
        cache_len: int,
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Run the prompt, build the cache.  Returns (last-token logits,
        cache, lengths)."""
        cfg = self.cfg
        params = self.cast_params(params)
        h = self._embed_inputs(params, tokens, prefix_embeds)
        B, S, _ = h.shape
        per_layer = {key: [] for key in _block_keys(cfg)}
        for i in range(cfg.n_superblocks):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                sb = tree_map(lambda leaf: leaf[i], params["blocks"][key])
                h, c = blk.block_prefill(sb, cfg, kind, h, cache_len, chunk_q=self.chunk_q)
                per_layer[key].append(c)
        cache = {"blocks": {
            key: {name: torch.stack([c[name] for c in cs]) for name in cs[0]}
            for key, cs in per_layer.items()
        }}
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
        """One token for every sequence.  Writes the new k/v into ``cache``
        in place and returns it with the logits and ``lengths + 1``."""
        cfg = self.cfg
        params = self.cast_params(params)
        h = embed(params["embed"], tokens, cfg.scale_embed, cfg.d_model)
        for i in range(cfg.n_superblocks):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                sb = tree_map(lambda leaf: leaf[i], params["blocks"][key])
                layer_cache = tree_map(lambda leaf: leaf[i], cache["blocks"][key])
                h, _ = blk.block_decode(sb, cfg, kind, h, layer_cache, lengths)
        h = rmsnorm(params["final_norm"], h)
        logits = unembed(params["embed"], h)
        return logits[:, 0], cache, lengths + 1
