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

:func:`make_serve_steps` runs prefill and decode under a
``ShardingPlan`` (the twin of the reference dry run's jitted serving
steps): parameters, tokens and the cache laid out by the plan as DTensors,
each layer's emitted cache put straight into the plan's cache layout, the
decode cache updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    embed, f32_matmul, init_embedding, init_rmsnorm, rmsnorm, truncated_normal, unembed,
)
from repro_torch.parallel.axes import (
    batch_divides, batch_only, constrain, from_block, local_block, model_block, ragged_share,
)
from repro_torch.tree import tree_map

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


def chunk_ce(embed_params: Dict, hc: torch.Tensor, lc: torch.Tensor,
             zloss: float) -> torch.Tensor:
    """One chunk's summed next-token CE plus ``zloss`` times its summed
    squared log-sum-exps: hidden states ``hc`` ``[B, c, D]``, labels ``lc``
    ``[B, c]``, the float32 logits from ``embed_params`` (the tied table or
    the unembedding).  On a mesh (a DTensor ``hc``) rank by rank
    (:func:`_vocab_parallel_ce`)."""
    if isinstance(hc, DTensor):
        return _vocab_parallel_ce(embed_params, hc, lc, zloss)
    logits = unembed(embed_params, hc)                  # f32 [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None])[..., 0]
    return (lse - gold).sum() + lse.square().sum() * zloss


def _vocab_parallel_ce(embed_params: Dict, hc: DTensor, lc, zloss: float) -> torch.Tensor:
    """:func:`chunk_ce` on a mesh, rank by rank (Megatron's vocab-parallel
    cross-entropy): each rank takes its sequences' hidden states (``hc``
    whole but along its batch split) against its block of the vocabulary
    (the weight's split over 'model', whole over every other mesh dim), so
    its logits are the ``[B_local, c, V / m]`` block; each rank's own
    log-sum-exp combines over the vocab split (the max, then the sum of
    exponentials) and the gold logit is picked on the rank that holds it,
    a partial sum.  Backward writes each rank's logits block only; DTensor's
    own rules for a pick over a split vocab copy the whole logits' grad.
    Where the plan leaves the vocabulary whole the combine is exact (exp(0)
    is 1 and log(1) is 0), so a one-card mesh's loss and grads are the plain
    ones, bit for bit."""
    table = embed_params.get("unembed")
    tied = table is None
    w = embed_params["table"] if tied else table
    vdim = 0 if tied else 1
    V = w.shape[vdim]
    mesh = hc.device_mesh
    names = mesh.mesh_dim_names
    split = tuple(i for i, p in enumerate(getattr(w, "placements", ()))
                  if isinstance(p, Shard) and p.dim == vdim and names[i] == "model")
    hc = batch_only(hc)
    rows = tuple(hc.placements)
    if isinstance(w, DTensor):
        layout = tuple(Shard(vdim) if i in split else Replicate() for i in range(mesh.ndim))
        if tuple(w.placements) != layout:
            w = w.redistribute(mesh, layout)
        w = w.to_local(grad_placements=tuple(
            Shard(vdim) if i in split else Partial() if isinstance(p, Shard) else Replicate()
            for i, p in enumerate(rows)))
    (nv,), (v0,) = local_block((V,), mesh, tuple(Shard(0) if i in split else Replicate()
                                                 for i in range(mesh.ndim)))
    B, c = hc.shape[:2]
    h = hc.to_local(grad_placements=tuple(
        p if isinstance(p, Shard) else Partial() if i in split else Replicate()
        for i, p in enumerate(rows)))
    if isinstance(lc, DTensor):
        if tuple(lc.placements) != rows:
            lc = lc.redistribute(mesh, rows)
        lc = lc.to_local()
    else:
        (nb, _), (b0, _) = local_block((B, c), mesh, rows)
        lc = lc[b0:b0 + nb]
    logits = f32_matmul(h, w.t() if tied else w)      # f32 [b, c, nv]

    def across(t, op: str) -> DTensor:
        """A per-token value of this rank's vocab block reduced over the
        vocab split: ``[B, c]`` laid out as ``hc``'s rows."""
        part = tuple(Partial(op) if i in split else p for i, p in enumerate(rows))
        return from_block(t, mesh, part, (B, c)).redistribute(mesh, rows)

    lse_loc = torch.logsumexp(logits, dim=-1)
    top = across(lse_loc.detach(), "max")
    lse = top + torch.log(across(torch.exp(lse_loc - top.to_local()), "sum"))
    local = lc.long() - v0
    inside = (local >= 0) & (local < nv)
    gold = logits.gather(-1, local.clamp(0, nv - 1)[..., None])[..., 0]
    gold = across(torch.where(inside, gold, 0.0), "sum")
    return (lse - gold).sum() + lse.square().sum() * zloss


def _unembed_shares(embed_params: Dict, h: DTensor) -> DTensor:
    """The logits ``[B, V]`` of one decode token ``h`` ``[B, 1, D]`` whose
    batch the data axes do not split, rank by rank: each data rank's ragged
    share of the sequences (``axes.ragged_share``) through its 'model'
    block of the unembedding, the logits laid out so (the batch split
    unevenly over the data axes, the vocabulary as the unembedding splits
    it).  An MoE arch's, as the reference lays them out: its MoE constrains
    the tokens over the data axes, and XLA's partitioner carries that split
    to the logits."""
    mesh = h.device_mesh
    B = h.shape[0]
    data = [i for i, a in enumerate(mesh.mesh_dim_names)
            if a in ("pod", "data") and mesh.shape[i] > 1]
    tied = "unembed" not in embed_params
    w = embed_params["table"].t() if tied else embed_params["unembed"]   # [D, V]
    block, split, model = model_block(w)
    block = block.to_local() if isinstance(block, DTensor) else block
    h = h.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    b0, nb, _ = ragged_share(B, mesh, data)
    logits = f32_matmul(h[b0:b0 + nb, 0], block)
    vocab = Shard(1) if isinstance(split, Shard) else Replicate()
    layout = tuple(Shard(0) if i in data else vocab if i == model else Replicate()
                   for i in range(mesh.ndim))
    return from_block(logits, mesh, layout, (B, w.shape[1]))


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
    attn_seq_shard: bool = False  # sequence-parallel attention (plan 'seq')
    seq_parallel: bool = True     # Megatron-SP residual stream: between
    # layers the [B, S, D] stream is sharded along S over 'model' (the
    # dominant train-memory term); both options are the identity off-mesh

    def __post_init__(self):
        cfg = self.cfg
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', not {self.remat!r}")
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

    def abstract_params(self, seed: int = 0) -> Dict:
        """The parameter tree's shapes and dtypes on ``meta``: nothing
        allocated, nothing drawn (what a sharding plan reads)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            fake = self.init(torch.Generator().manual_seed(seed))
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)

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
        h = constrain(h, "batch", None, None)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        prefix_len = n_prefix if cfg.modality == "vision_stub" else 0

        def one_block(hh, p, kind):
            return blk.block_train(p, cfg, kind, hh, prefix_len, self.chunk_q,
                                   self.attn_seq_shard)

        for p, kind in zip(params.get("prefix", ()), cfg.prefix_pattern):
            h, a = one_block(h, p, kind)
            aux = aux + a

        def sb_layer(hh, p, kind):
            hh, a = one_block(hh, p, kind)
            if self.seq_parallel:
                hh = constrain(hh, "batch", "model", None)
            return hh, a

        layer = sb_layer
        if self.remat == "full" and len(cfg.pattern) > 1:
            # per-layer remat inside the superblock, as the reference's:
            # without it backward keeps a whole multi-layer body's residuals
            layer = _remat(sb_layer)

        def sb_body(hh, ax, sb_params):
            if self.seq_parallel:
                hh = constrain(hh, "batch", "model", None)
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                hh, a = layer(hh, sb_params[key], kind)
                ax = ax + a
            return hh, ax

        body = _remat(sb_body) if self.remat == "full" else sb_body
        for sb_params in _unstack(params["blocks"], cfg.n_superblocks):
            h, aux = body(h, aux, sb_params)
        h = constrain(h, "batch", None, None)
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
            return chunk_ce(params["embed"], hc, lc, self.zloss)

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

    def abstract_cache(self, batch: int, seq: int) -> Dict:
        """The decode cache's shapes and dtypes on ``meta``."""
        return self.init_cache(batch, seq, device="meta")

    def prefill(
        self,
        params: Dict,
        tokens: torch.Tensor,
        cache_len: int,
        prefix_embeds: Optional[torch.Tensor] = None,
        cache_layout=None,
    ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Run the prompt, build the cache.  Returns (last-token logits,
        cache, lengths).  A ``vision_stub`` model attends bidirectionally
        over its leading non-token positions (the prefix-LM mask).
        ``cache_layout``, where given, takes each layer's emitted cache dict
        and returns it laid out for serving (a plan's cache layout)."""
        cfg = self.cfg
        params = self.cast_params(params)
        h, n_prefix = self._embed_inputs(params, tokens, prefix_embeds)
        batch = "batch" if batch_divides(h.shape[0]) else None
        h = constrain(h, batch, None, None)
        prefix_len = n_prefix if cfg.modality == "vision_stub" else 0
        B, S, _ = h.shape
        cache: Dict = {}

        if cfg.prefix_pattern:
            pcs = []
            for p, kind in zip(params["prefix"], cfg.prefix_pattern):
                h, c = blk.block_prefill(p, cfg, kind, h, cache_len, prefix_len,
                                         self.chunk_q, self.attn_seq_shard)
                pcs.append(cache_layout(c) if cache_layout else c)
            cache["prefix"] = tuple(pcs)

        per_layer = {key: [] for key in _block_keys(cfg)}
        for i in range(cfg.n_superblocks):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                sb = tree_map(lambda leaf: leaf[i], params["blocks"][key])
                h, c = blk.block_prefill(sb, cfg, kind, h, cache_len, prefix_len,
                                         self.chunk_q, self.attn_seq_shard)
                per_layer[key].append(cache_layout(c) if cache_layout else c)
        cache["blocks"] = {
            key: {name: torch.stack([c[name] for c in cs]) for name in cs[0]}
            for key, cs in per_layer.items()
        }
        h = rmsnorm(params["final_norm"], h[:, -1:])
        # on a mesh: the vocab split over 'model', as the training loss keeps it
        logits = constrain(unembed(params["embed"], h), batch, None, "model")
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
        # on a mesh: the batch split as the cache's where it divides (the
        # reference's tokens are replicated and GSPMD propagates the cache's
        # batch split)
        batch = "batch" if batch_divides(h.shape[0]) else None
        h = constrain(h, batch, None, None)
        for p, kind, c in zip(params.get("prefix", ()), cfg.prefix_pattern,
                              cache.get("prefix", ())):
            h, _ = blk.block_decode(p, cfg, kind, h, c, lengths)
            h = constrain(h, batch, None, None)   # a mesh's partial sums reduced
        for i in range(cfg.n_superblocks):
            for key, kind in zip(_block_keys(cfg), cfg.pattern):
                sb = tree_map(lambda leaf: leaf[i], params["blocks"][key])
                layer_cache = tree_map(lambda leaf: leaf[i], cache["blocks"][key])
                h, _ = blk.block_decode(sb, cfg, kind, h, layer_cache, lengths)
                h = constrain(h, batch, None, None)
        h = rmsnorm(params["final_norm"], h)
        if cfg.moe is not None and batch is None and isinstance(h, DTensor):
            return _unembed_shares(params["embed"], h), cache, lengths + 1
        logits = unembed(params["embed"], h)
        return logits[:, 0], cache, lengths + 1


def make_serve_steps(lm: LM, plan, seq_shard_min: int = 8192):
    """``(prefill, decode_step)``: :meth:`LM.prefill` and
    :meth:`LM.decode_step` under ``plan`` (a ``ShardingPlan`` over a
    ``DeviceMesh``), as the reference's dry run lowers them.  Each places
    its inputs (a plain tensor is the full value, the same on every rank):
    params by ``plan.param_specs``, prompt tokens by ``plan.batch_spec(2)``
    and prefix embeddings by ``batch_spec(3)``, decode tokens ``[B, 1]`` and
    lengths replicated, the cache by ``plan.cache_specs`` (its sequence dims
    split over 'model' from ``seq_shard_min`` rows); then runs on the plan's
    mesh.  Prefill lays each layer's emitted cache out by the cache specs as
    it goes (the reference pins its output to them); decode writes the new
    rows and states into the placed cache in place and returns it (the
    reference donates it).  Call them under ``torch.no_grad()``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel.axes import lm_mesh
    from repro_torch.parallel.sharding import NamedSharding, P, place, place_tree

    mesh = plan.mesh

    def layout(tree):
        return place_tree(tree, plan.cache_shardings(tree, seq_shard_min))

    def prefill(params, tokens, cache_len: int, prefix_embeds=None):
        params = place_tree(params, plan.param_shardings(params))
        tokens = place(tokens, NamedSharding(mesh, plan.batch_spec(2)))
        if prefix_embeds is not None:
            prefix_embeds = place(prefix_embeds, NamedSharding(mesh, plan.batch_spec(3)))
        with lm_mesh(mesh), implicit_replication():
            logits, cache, lengths = lm.prefill(params, tokens, cache_len, prefix_embeds,
                                                cache_layout=layout)
            return logits, layout(cache), lengths

    def decode_step(params, tokens, cache, lengths):
        params = place_tree(params, plan.param_shardings(params))
        cache = layout(cache)
        tokens = place(tokens, NamedSharding(mesh, P(None, None)))
        lengths = place(lengths, NamedSharding(mesh, P(None)))
        with lm_mesh(mesh), implicit_replication():
            return lm.decode_step(params, tokens, cache, lengths)

    return prefill, decode_step
