"""The language-model stack: training forward and loss, prefill, decode.

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
walks the prefix layers, then the superblocks.  Training takes each
stacked leaf apart once (``unbind``, so backward stacks its grads once)
and, with ``remat="full"``, recomputes each superblock in backward (and
each layer of a multi-layer superblock), as the reference's
``jax.checkpoint`` does.  The cross-entropy is evaluated in sequence
chunks, each recomputed in backward, so no ``[B, chunk, V]`` float32
logits are kept.  Decode writes each layer's new k/v and recurrent state
into the cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    embed, init_embedding, init_rmsnorm, rmsnorm, truncated_normal, unembed,
)
from repro_torch.tree import tree_map

#: What the mesh-only options wait for.
MESH_ITEM = "the multi-GPU mesh (ROADMAP Queue A item 6)"


def _block_keys(cfg: ArchConfig):
    return [f"{j}:{kind}" for j, kind in enumerate(cfg.pattern)]


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


def _unstack(tree, n: int) -> List[Dict]:
    """Stacked ``[n, ...]`` leaves as ``n`` trees of views, one ``unbind``
    a leaf."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _remat(fn):
    """``fn`` recomputed in backward instead of keeping its residuals."""
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig
    remat: str = "full"          # none | full
    chunk_q: int = 512           # attention query chunk
    loss_chunk: int = 512        # CE chunking along the sequence
    zloss: float = 0.0
    compute_dtype: Optional[torch.dtype] = torch.bfloat16  # None => keep f32
    attn_seq_shard: bool = False  # mesh-only in the reference
    seq_parallel: bool = False    # mesh-only in the reference (its default True)

    def __post_init__(self):
        cfg = self.cfg
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', not {self.remat!r}")
        for name in ("attn_seq_shard", "seq_parallel"):
            if getattr(self, name):
                raise ValueError(f"{name} shards over a mesh: it waits for {MESH_ITEM}")
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

    # -- full-sequence forward -------------------------------------------------

    def forward(
        self,
        params: Dict,
        tokens: torch.Tensor,
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Returns (hidden [B, S_total, D], aux_loss, n_prefix)."""
        cfg = self.cfg
        params = self.cast_params(params)
        h, n_prefix = self._embed_inputs(params, tokens, prefix_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        prefix_len = n_prefix if cfg.modality == "vision_stub" else 0

        def one_block(hh, p, kind):
            return blk.block_train(p, cfg, kind, hh, prefix_len, self.chunk_q)

        for p, kind in zip(params.get("prefix", ()), cfg.prefix_pattern):
            h, a = one_block(h, p, kind)
            aux = aux + a

        layer = one_block
        if self.remat == "full" and len(cfg.pattern) > 1:
            # per-layer remat inside the superblock, as the reference's:
            # without it backward keeps a whole multi-layer body's residuals
            layer = _remat(one_block)

        def sb_body(hh, ax, sb_params):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                hh, a = layer(hh, sb_params[key], kind)
                ax = ax + a
            return hh, ax

        body = _remat(sb_body) if self.remat == "full" else sb_body
        for sb_params in _unstack(params["blocks"], cfg.n_superblocks):
            h, aux = body(h, aux, sb_params)
        h = rmsnorm(params["final_norm"], h)
        return h, aux, n_prefix

    # -- training loss -----------------------------------------------------------

    def loss(
        self,
        params: Dict,
        tokens: torch.Tensor,                     # [B, S_tok]
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE over the token region (prefix/meta positions
        skipped), plus the ``zloss`` term and the summed aux losses.

        The logits come from the float32 master ``embed`` leaves, as the
        reference's do (its ``unembed`` promotes the bf16 hidden state), in
        ``loss_chunk`` positions at a time, the last chunk ragged."""
        h, aux, n_prefix = self.forward(params, tokens, prefix_embeds)
        h_tok = h[:, n_prefix:]                    # align with `tokens`
        B, S, _ = h_tok.shape
        h_in = h_tok[:, :-1]
        labels = tokens[:, 1:].long()

        def ce_chunk(hc, lc):
            logits = unembed(params["embed"], hc)           # f32 [B, c, V]
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lc[..., None])[..., 0]
            return (lse - gold).sum() + lse.square().sum() * self.zloss

        # remat: backward recomputes each chunk's [B, c, V] logits instead of
        # keeping them (V up to 262k: ~4 GB a chunk at batch 4 x 1024)
        chunk_fn = _remat(ce_chunk) if torch.is_grad_enabled() else ce_chunk
        c = min(self.loss_chunk, S - 1)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, S - 1, c):
            total = total + chunk_fn(h_in[:, i:i + c], labels[:, i:i + c])

        n_tokens = B * (S - 1)
        ce = total / n_tokens
        return ce + aux, {"ce": ce, "aux": aux}

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
