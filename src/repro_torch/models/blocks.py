"""Per-kind transformer blocks: init / train / prefill / decode / cache.

Twin of the reference's ``models/blocks.py``.  One module owns the
layer-kind dispatch so the LM stack (``models/lm.py``) can walk a pattern
of heterogeneous kinds (dense, local, global, moe, mlstm, slstm, hymba,
hymba_g) with uniform plumbing:

    init_block(generator, cfg, kind)                          -> params dict
    block_train(params, cfg, kind, x, prefix_len)              -> (x', aux_loss)
    block_prefill(params, cfg, kind, x, cache_len, prefix_len) -> (x', cache)
    block_decode(params, cfg, kind, x, cache, l)              -> (x', cache)
    init_block_cache(cfg, kind, batch, seq, device)           -> zeroed cache dict

Window ("local"/"hymba") kinds keep a ring-buffer KV cache of
``min(window, seq)`` slots; the recurrent kinds keep float32 states.
Decode updates every cache tensor in place and returns the same dict.
On an LM mesh the recurrent mixers take their input batch-split over every
divisible mesh axis (``constrain_time_mixer``: a time scan cannot use
'model'); off-mesh that is the identity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import linear_rnn as lrnn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Params, init_mlp, init_rmsnorm, log_sigmoid, mlp, promoted, rmsnorm, sigmoid, softplus,
    truncated_normal,
)
from repro_torch.parallel.axes import (
    batch_only, constrain, constrain_time_mixer, from_block, local_block, map_block,
    model_block, redistribute_like, whole_local,
)

ATTN_KINDS = ("dense", "local", "global", "moe")
KINDS = ATTN_KINDS + ("mlstm", "slstm", "hymba", "hymba_g")
CONV_K = 4


def check_kind(kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; the kinds are {KINDS}")
    return kind


def _window_for(cfg: ArchConfig, kind: str) -> int:
    if kind in ("local", "hymba"):
        return cfg.window
    return 0  # dense / global / moe / hymba_g: full attention


def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    inner = 2 * cfg.d_model                 # projection factor 2
    heads = cfg.num_heads
    return inner, heads, inner // heads


def _slstm_ff(cfg: ArchConfig) -> int:
    return ((int(cfg.d_model * 4 / 3) + 63) // 64) * 64


def _hymba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    return s.num_heads * s.head_dim, s.num_heads, s.head_dim  # inner, H, P


# -- init -----------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    check_kind(kind)
    D = cfg.d_model
    dev = generator.device
    if kind in ATTN_KINDS:
        p: Params = {
            "ln_attn": init_rmsnorm(D, dev),
            "attn": attn.init_attention(
                generator, D, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            ),
            "ln_mlp": init_rmsnorm(D, dev),
        }
        if kind == "moe":
            p["moe"] = moe_lib.init_moe(generator, D, cfg.d_ff, cfg.moe, cfg.mlp_type)
        else:
            p["mlp"] = init_mlp(generator, D, cfg.d_ff, cfg.mlp_type)
        return p

    if kind == "mlstm":
        inner, H, dh = _mlstm_dims(cfg)
        return {
            "ln": init_rmsnorm(D, dev),
            "w_up": truncated_normal(generator, (D, 2 * inner), D ** -0.5),
            "conv_w": truncated_normal(generator, (CONV_K, inner), 0.1),
            "w_q": truncated_normal(generator, (H, dh, dh), dh ** -0.5),
            "w_k": truncated_normal(generator, (H, dh, dh), dh ** -0.5),
            "w_gates": truncated_normal(generator, (inner, 2 * H), inner ** -0.5),
            "b_gates": torch.cat([torch.full((H,), 2.0, device=dev),   # forget-gate bias +2
                                  torch.zeros((H,), device=dev)]),
            "w_down": truncated_normal(generator, (inner, D), inner ** -0.5),
        }

    if kind == "slstm":
        return {
            "ln": init_rmsnorm(D, dev),
            "slstm": lrnn.init_slstm(generator, D, cfg.num_heads),
            "ln_mlp": init_rmsnorm(D, dev),
            "mlp": init_mlp(generator, D, _slstm_ff(cfg), "swiglu"),
        }

    # hymba / hymba_g
    inner, H, P = _hymba_dims(cfg)
    N = cfg.ssm.state_dim
    return {
        "ln": init_rmsnorm(D, dev),
        "attn": attn.init_attention(
            generator, D, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        ),
        "ssm_in": truncated_normal(generator, (D, 2 * inner), D ** -0.5),
        "ssm_bc": truncated_normal(generator, (D, 2 * H * N), D ** -0.5),
        "ssm_dt": truncated_normal(generator, (D, H), D ** -0.5),
        "ssm_dt_bias": torch.zeros((H,), device=dev),
        "ssm_a_log": torch.zeros((H,), device=dev),
        "ssm_out": truncated_normal(generator, (inner, D), inner ** -0.5),
        "norm_attn_out": init_rmsnorm(D, dev),
        "norm_ssm_out": init_rmsnorm(inner, dev),
        "mix_beta": torch.zeros((2,), device=dev),            # learned branch scales
        "ln_mlp": init_rmsnorm(D, dev),
        "mlp": init_mlp(generator, D, cfg.d_ff, cfg.mlp_type),
    }


# -- sequence mixers ---------------------------------------------------------------


def _channel_split(u: DTensor, H: int, dh: int):
    """How 'model' splits the ``inner = H dh`` channels of a mixer whose
    input ``u`` (``[B, L, inner]``) is whole but along its batch split, as
    XLA's partitioner splits these heads: where 'model' holds the whole
    batch (m ranks) each rank takes a block of ``inner / m`` channels,
    whole heads or a column block of one.  Returns ``(layout, mi, m,
    channels, heads, cols)``: ``u``'s placements, the 'model' mesh dim (or
    None) and its split (1: none), the placements of a tensor split along
    its last dim there, and this rank's head and column slices.  ``u``'s
    placements count only for its batch split."""
    mesh = u.device_mesh
    inner = H * dh
    layout = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in u.placements)
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    m = mesh.shape[mi] if mi is not None and layout[mi] == Replicate() else 1
    blk = inner // m
    if inner % m or (dh % blk and blk % dh):
        m, blk = 1, inner
    channels = tuple(Shard(2) if m > 1 and i == mi else p for i, p in enumerate(layout))
    (*_, off) = local_block((u.shape[0], u.shape[1], inner), mesh, channels)[1]
    nh, nc = max(blk // dh, 1), min(blk, dh)
    return (layout, mi, m, channels, slice(off // dh, off // dh + nh),
            slice(off % dh, off % dh + nc))


def _gla_on_mesh(q, k, v, log_f, i_gate, split, normalize: bool, chunk: int,
                 return_state: bool):
    """:func:`lrnn.gla_chunked` over a full sequence on a mesh, rank by rank
    (DTensor sees no op of the scan, whose cumsum's backward torch 2.11's
    DTensor has no rule for): ``q``, ``k`` ``[B, L, H, dk]`` and the gates
    ``[B, L, H]`` whole but along the batch split, ``v`` ``[B, L, H dv]``
    likewise, ``split`` from :func:`_channel_split`.  Each rank runs its
    heads over its columns of v (the recurrence's value columns are
    independent of each other; the normaliser reads q and k only).  Returns
    ``y`` ``[B, L, H dv]`` split over 'model' along its channels and, with
    ``return_state``, the final state ``(S, n)`` whole over 'model' (a
    prefill's, gathered), else None."""
    layout, mi, m, channels, heads, cols = split
    mesh = v.device_mesh
    B, L, H, dk = q.shape
    dv = v.shape[-1] // H
    nh, nc = heads.stop - heads.start, cols.stop - cols.start
    # an operand every rank of the split reads whole: its grad there is a
    # partial sum over 'model' (each rank's share)
    whole = tuple(p if isinstance(p, Shard) else Partial() if m > 1 and i == mi
                  else Replicate() for i, p in enumerate(layout))
    q, k, f, ig = (batch_only(t).to_local(grad_placements=whole)[:, :, heads]
                   for t in (q, k, log_f, i_gate))
    v = batch_only(v)
    v = (v.redistribute(mesh, channels) if m > 1 else v).to_local()
    b = v.shape[0]
    y, (S, n) = lrnn.gla_chunked(q, k, v.reshape(b, L, nh, nc), f, ig, normalize=normalize,
                                 chunk=chunk)
    y = from_block(y.reshape(b, L, nh * nc), mesh, channels, (B, L, H * dv))
    if not return_state:
        return y, None
    if m > 1:
        # every rank's block of the state, assembled whole: S [b, nh, dk,
        # nc] a block of heads x columns, n [b, nh, dk] the same on each
        # rank of a head's block
        import torch.distributed._functional_collectives as funcol

        mh, mv = H // nh, dv // nc
        S = funcol.all_gather_tensor(S, gather_dim=0, group=(mesh, mi)).reshape(
            mh, mv, b, nh, dk, nc).permute(2, 0, 3, 4, 1, 5).reshape(b, H, dk, dv)
        n = funcol.all_gather_tensor(n, gather_dim=0, group=(mesh, mi)).reshape(
            mh, mv, b, nh, dk)[:, 0].permute(1, 0, 2, 3).reshape(b, H, dk)
    return y, (from_block(S, mesh, layout, (B, H, dk, dv)),
               from_block(n, mesh, layout, (B, H, dk)))


def _mlstm_heads_on_mesh(params, ch, u, log_f, i_gate, chunk: int, return_state: bool):
    """The mLSTM's per-head products and chunked GLA over a full sequence on
    a mesh, rank by rank: ``ch`` ``[B, L, H, dh]`` and ``u`` ``[B, L,
    inner]`` DTensors whole but along their batch split.  Where 'model'
    splits the channels (:func:`_channel_split`) the q/k products split
    their output columns over it (each rank's block of ``w_q``/``w_k`` a
    local slice) and q and k are gathered whole for :func:`_gla_on_mesh`."""
    mesh = u.device_mesh
    B, L, H, dh = ch.shape
    split = _channel_split(u, H, dh)
    layout, mi, m = split[:3]
    e_split = m > 1 and dh % m == 0 and isinstance(params["w_q"], DTensor)
    cols = tuple(Shard(3) if e_split and i == mi else p for i, p in enumerate(layout))

    def weight_block(w):
        """This rank's output columns of a ``[H, dh, dh]`` weight where
        they split, whole elsewhere; its grad split as they are and
        partial over the batch split."""
        if not isinstance(w, DTensor):
            return w
        want = tuple(Shard(2) if e_split and i == mi else Replicate() for i in range(mesh.ndim))
        if tuple(w.placements) != want:
            w = w.redistribute(mesh, want)
        return w.to_local(grad_placements=tuple(
            Shard(2) if e_split and i == mi else Partial() if isinstance(p, Shard)
            else Replicate() for i, p in enumerate(layout)))

    ch_loc = ch.to_local(grad_placements=tuple(
        Partial() if e_split and i == mi else p for i, p in enumerate(layout)))
    q, k = (batch_only(from_block(
        torch.einsum("blhd,hde->blhe", *promoted(ch_loc, weight_block(params[w]))),
        mesh, cols, (B, L, H, dh))) for w in ("w_q", "w_k"))
    return _gla_on_mesh(q, k * (dh ** -0.5), u, log_f, i_gate, split, True, chunk,
                        return_state)


def _mlstm_seq(params, cfg: ArchConfig, h, state, return_state: bool = False):
    """mLSTM inner: up-proj, causal conv, per-head qk, chunked GLA, gate.
    On a mesh a full sequence's heads run rank by rank
    (:func:`_mlstm_heads_on_mesh`)."""
    inner, H, dh = _mlstm_dims(cfg)
    B, L, _ = h.shape
    if L > 1:
        # recurrent chunk scan: keep S local, absorb idle axes into batch
        h = constrain_time_mixer(h)
    # on a mesh: whole channels, which the head reshapes below need (DTensor
    # may split the product's columns over 'model')
    up = batch_only(h @ params["w_up"])
    u, z = torch.chunk(up, 2, dim=-1)
    if state is None:
        # on a mesh, rank by rank: u is whole but along its batch split
        w = params["conv_w"]
        c = map_block(lambda ul: lrnn.causal_conv1d(ul, whole_local(w, u)), u, u.shape)
        conv_buf = None
    else:
        (gla_state, conv_buf) = state
        c, conv_buf = lrnn.causal_conv1d_step(u[:, 0], params["conv_w"], conv_buf)
        c = c[:, None]
    c = F.silu(c)
    ch = c.reshape(B, L, H, dh)
    gates = u @ params["w_gates"] + params["b_gates"]          # [B,L,2H]
    f_raw, i_raw = torch.chunk(gates, 2, dim=-1)
    log_f = log_sigmoid(f_raw)
    i_gate = sigmoid(i_raw)
    chunk = min(cfg.ssm.chunk if cfg.ssm else 256, L)
    if state is None and isinstance(u, DTensor):
        y, gla_final = _mlstm_heads_on_mesh(params, ch, u, log_f, i_gate, chunk, return_state)
        new_state = None
        if return_state:
            # on a mesh, rank by rank (the conv's window of the last tokens)
            new_state = (gla_final, map_block(lambda ul: _conv_tail(ul).float(), u,
                                              (B, CONV_K - 1, inner)))
        return (batch_only(y) * F.silu(z)) @ params["w_down"], new_state
    # on a mesh (one token a sequence here): the per-head products split
    # over 'model' along their output dim (the weights are whole on every
    # rank, so the split is a local slice), q and k then gathered whole
    w_q, w_k = (constrain(params[w], None, None, "model") for w in ("w_q", "w_k"))
    q = batch_only(torch.einsum("blhd,hde->blhe", *promoted(ch, w_q)))
    k = batch_only(torch.einsum("blhd,hde->blhe", *promoted(ch, w_k))) * (dh ** -0.5)
    v = u.reshape(B, L, H, dh)
    if state is None:
        y, gla_final = lrnn.gla_chunked(q, k, v, log_f, i_gate, normalize=True, chunk=chunk)
        new_state = None
        if return_state:
            new_state = (gla_final, _conv_tail(u).float())
    else:
        y1, new_gla = lrnn.gla_step(
            q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], i_gate[:, 0],
            gla_state, normalize=True,
        )
        # on a mesh: whole heads (the state's split of dv gathered)
        y = batch_only(y1[:, None])
        new_state = (new_gla, conv_buf)
    y = y.reshape(B, L, inner) * F.silu(z)
    out = y @ params["w_down"]
    return out, new_state


def _conv_tail(u: torch.Tensor) -> torch.Tensor:
    """The causal conv's state after a sequence: its last ``CONV_K - 1``
    inputs ``[B, CONV_K - 1, C]``, zeros in front of a shorter one."""
    pad = max(0, (CONV_K - 1) - u.shape[1])
    return F.pad(u, (0, 0, pad, 0))[:, -(CONV_K - 1):]


def _hymba_ssm_seq(params, cfg: ArchConfig, h, state, return_state: bool = False):
    """Mamba2-style scalar-decay SSM branch (chunked GLA core)."""
    inner, H, P = _hymba_dims(cfg)
    N = cfg.ssm.state_dim
    B, L, _ = h.shape
    if L > 1:
        h = constrain_time_mixer(h)  # chunk scan: keep S local
    xz = h @ params["ssm_in"]
    xs, z = torch.chunk(xz, 2, dim=-1)                          # [B,L,inner]
    bc = h @ params["ssm_bc"]
    bmat, cmat = torch.chunk(bc.reshape(B, L, H, 2 * N), 2, dim=-1)
    dt = softplus(h @ params["ssm_dt"] + params["ssm_dt_bias"])   # [B,L,H]
    a = -torch.exp(params["ssm_a_log"])                         # [H] (< 0)
    log_f = dt * a
    i_gate = dt
    k = bmat * (N ** -0.5)
    q = cmat
    if state is None and isinstance(xs, DTensor):
        # on a mesh, rank by rank
        y, final = _gla_on_mesh(q, k, xs, log_f, i_gate, _channel_split(xs, H, P), False,
                                min(cfg.ssm.chunk, L), return_state)
        return batch_only(y) * F.silu(z), final
    v = xs.reshape(B, L, H, P)
    if state is None:
        y, final = lrnn.gla_chunked(
            q, k, v, log_f, i_gate, normalize=False, chunk=min(cfg.ssm.chunk, L)
        )
        new_state = final if return_state else None
    else:
        y1, new_state = lrnn.gla_step(
            q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], i_gate[:, 0],
            state, normalize=False,
        )
        y = batch_only(y1[:, None])
    y = y.reshape(B, L, inner) * F.silu(z)
    return y, new_state


def _hymba_mix(params, a, s):
    """Normalized, learned-scale fusion of attention and SSM branches, cast
    back to the branch dtype (the float32 beta scalars would otherwise
    promote the residual stream), as in the reference."""
    beta = sigmoid(params["mix_beta"]) * 2.0
    an = rmsnorm(params["norm_attn_out"], a)
    sn = rmsnorm(params["norm_ssm_out"], s) @ params["ssm_out"]
    if an.shape[1] > 1:
        # on a mesh, over a sequence: the SSM branch into the attention
        # branch's layout by a redistribution autograd sees, so its
        # gradient comes back in its own layout (an implicit one in the sum
        # would hand the product's backward a sequence split to flatten,
        # which torch 2.11's DTensor refuses)
        sn = redistribute_like(sn, an)
    return (0.5 * (beta[0] * an + beta[1] * sn)).to(a.dtype)


# -- prefill -----------------------------------------------------------------------


def _store_kv(k: torch.Tensor, cache_len: int, window: int) -> torch.Tensor:
    """Pack prefill keys/values into a bf16 decode cache buffer.

    Full-attention kinds: left-aligned into a [B, cache_len, ...] buffer.
    Window kinds: ring layout -- the last min(W, S) positions at slot
    pos % W with W = min(cache_len, window), matching
    ``attention_decode_ring``'s indexing.  On a mesh each rank packs its
    own block, laid out as k is (``attention_train`` returns k whole along
    the sequence)."""
    B, S, G, hd = k.shape
    rows = min(cache_len, window) if window > 0 else cache_len
    return map_block(lambda kk: _pack_kv(kk, cache_len, window), k, (B, rows, G, hd))


def _pack_kv(k: torch.Tensor, cache_len: int, window: int) -> torch.Tensor:
    B, S, G, hd = k.shape
    k = k.to(torch.bfloat16)
    if window > 0:
        W = min(cache_len, window)
        Wv = min(W, S)
        slots = torch.arange(S - Wv, S, device=k.device) % W
        buf = torch.zeros((B, W, G, hd), dtype=torch.bfloat16, device=k.device)
        buf[:, slots] = k[:, S - Wv:]
        return buf
    if S > cache_len:
        raise ValueError(f"a {S}-token prefill does not fit a cache of {cache_len}")
    buf = torch.zeros((B, cache_len, G, hd), dtype=torch.bfloat16, device=k.device)
    buf[:, :S] = k
    return buf


def _block_seq(params: Params, cfg: ArchConfig, kind: str, x: torch.Tensor, prefix_len: int,
               chunk_q: int, cache_len=None, seq_shard: bool = False):
    """The full-sequence body shared by training and prefill: ``(x', aux,
    cache)``.  ``aux`` is the MoE load-balance loss (None for the other
    kinds); the decode cache is built only when ``cache_len`` is given;
    ``seq_shard`` is sequence-parallel attention on a mesh."""
    check_kind(kind)
    window = _window_for(cfg, kind)
    want_cache = cache_len is not None
    aux = cache = None
    if kind in ATTN_KINDS or kind in ("hymba", "hymba_g"):
        ln = "ln_attn" if kind in ATTN_KINDS else "ln"
        h = rmsnorm(params[ln], x)
        a, (k, v) = attn.attention_train(
            params["attn"], h,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=window, prefix_len=prefix_len, chunk_q=chunk_q, return_kv=True,
            seq_shard=seq_shard,
        )
        if want_cache:
            cache = {"k": _store_kv(k, cache_len, window), "v": _store_kv(v, cache_len, window)}
        if kind in ATTN_KINDS:
            # on a mesh: each branch's output reduced into the residual's
            # layout, the whole sequence into the MLP (Megatron's sequence
            # parallelism)
            x = x + redistribute_like(a, x)
            h = constrain(rmsnorm(params["ln_mlp"], x), "batch", None, None)
            if kind == "moe":
                h, aux = moe_lib.moe_ffn_ep(params["moe"], h, cfg.moe, cfg.mlp_type)
            else:
                h = mlp(params["mlp"], h, cfg.mlp_type)
            return x + redistribute_like(h, x), aux, cache
        # hymba / hymba_g
        s, state = _hymba_ssm_seq(params, cfg, h, state=None, return_state=want_cache)
        x = x + redistribute_like(_hymba_mix(params, a, s), x)
        h2 = mlp(params["mlp"], constrain(rmsnorm(params["ln_mlp"], x), "batch", None, None),
                 cfg.mlp_type)
        if want_cache:
            cache["S"], cache["n"] = state
        return x + redistribute_like(h2, x), aux, cache

    if kind == "mlstm":
        y, state = _mlstm_seq(params, cfg, rmsnorm(params["ln"], x), state=None,
                              return_state=want_cache)
        if want_cache:
            (S, n), conv = state
            cache = {"S": S, "n": n, "conv": conv}
        return x + redistribute_like(y, x), aux, cache

    # slstm
    h = rmsnorm(params["ln"], x)
    if x.shape[1] > 1:
        h = constrain_time_mixer(h)  # time scan: keep S local
    h, (c, n, hs) = lrnn.slstm_scan(params["slstm"], h, cfg.num_heads)
    x = x + redistribute_like(h, x)
    h2 = mlp(params["mlp"], constrain(rmsnorm(params["ln_mlp"], x), "batch", None, None),
             "swiglu")
    if want_cache:
        cache = {"c": c, "n": n, "h": hs}
    return x + redistribute_like(h2, x), aux, cache


def block_train(
    params: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    prefix_len: int = 0,
    chunk_q: int = 512,
    seq_shard: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block application.  Returns (x', aux_loss): the MoE
    kind's float32 load-balance loss, 0 for every other kind."""
    x, aux, _ = _block_seq(params, cfg, kind, x, prefix_len, chunk_q, seq_shard=seq_shard)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def block_prefill(
    params: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    cache_len: int,
    prefix_len: int = 0,
    chunk_q: int = 512,
    seq_shard: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence application that also emits the decode cache (the MoE
    aux loss is dropped, as in the reference)."""
    x, _, cache = _block_seq(params, cfg, kind, x, prefix_len, chunk_q, cache_len, seq_shard)
    return x, cache


# -- decode -----------------------------------------------------------------------


def _write(cache: Dict[str, torch.Tensor], **new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The new recurrent states into the cache tensors, in place."""
    for name, value in new.items():
        cache[name].copy_(redistribute_like(value, cache[name]))
    return cache


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
    if kind in ATTN_KINDS:
        h = rmsnorm(params["ln_attn"], x)
        h = _attn_decode(params["attn"], cfg, kind, h, cache, lengths)
        # on a mesh: each branch's partial sums reduced into the residual's layout
        x = x + redistribute_like(h, x)
        h = rmsnorm(params["ln_mlp"], x)
        if kind == "moe":
            h, _ = moe_lib.moe_ffn_ep(params["moe"], h, cfg.moe, cfg.mlp_type, dropless=True)
        else:
            h = mlp(params["mlp"], h, cfg.mlp_type)
        return x + redistribute_like(h, x), cache

    if kind == "mlstm":
        state = ((cache["S"], cache["n"]), cache["conv"])
        y, ((S, n), conv) = _mlstm_seq(params, cfg, rmsnorm(params["ln"], x), state)
        return x + y, _write(cache, S=S, n=n, conv=conv)

    if kind == "slstm":
        h = rmsnorm(params["ln"], x)
        y, (c, n, hs) = lrnn.slstm_step(
            params["slstm"], h[:, 0], cfg.num_heads, (cache["c"], cache["n"], cache["h"]),
        )
        x = x + y[:, None]
        h2 = mlp(params["mlp"], rmsnorm(params["ln_mlp"], x), "swiglu")
        return x + h2, _write(cache, c=c, n=n, h=hs)

    # hymba / hymba_g
    h = rmsnorm(params["ln"], x)
    a = _attn_decode(params["attn"], cfg, kind, h, cache, lengths)
    s, (S, n) = _hymba_ssm_seq(params, cfg, h, (cache["S"], cache["n"]))
    x = x + _hymba_mix(params, a, s)
    h2 = _mlp_decode(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return x + redistribute_like(h2, x), _write(cache, S=S, n=n)


def _mlp_decode(params, h, mlp_type: str):
    """The MLP of one decode token.  On a mesh, rank by rank: h's rows
    (laid out by its batch split, whole over 'model') through this rank's
    'model' block of the weights, the ``w_gate``/``w_up`` columns and
    ``w_down`` rows of its share of d_ff, the product a partial sum over
    'model'.  The split is the plan's, pinned here, not left to DTensor's
    propagation; where the plan leaves d_ff whole on 'model' every rank
    runs the whole MLP on its rows.  A plain h is the plain ``mlp``."""
    if not isinstance(h, DTensor):
        return mlp(params, h, mlp_type)
    mesh = h.device_mesh
    model = mesh.mesh_dim_names.index("model") if "model" in mesh.mesh_dim_names else None
    blocks = {name: model_block(w) for name, w in params.items()}
    cols = all(split == (Shard(0) if name == "w_down" else Shard(1))
               for name, (_, split, _) in blocks.items())
    local = {}
    for name, (w, split, _) in blocks.items():
        if isinstance(w, DTensor):
            if not cols and split != Replicate():
                w = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
            w = w.to_local()
        local[name] = w
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 and i != model else Replicate()
                 for i, p in enumerate(h.placements))
    if tuple(h.placements) != rows:
        h = h.redistribute(mesh, rows)
    y = mlp(local, h.to_local(), mlp_type)
    layout = tuple(Partial() if cols and i == model else p for i, p in enumerate(rows))
    return from_block(y, mesh, layout, (*h.shape[:-1], y.shape[-1]))


def _attn_decode(aparams, cfg: ArchConfig, kind: str, h, cache, lengths):
    """Attention of one token, its k/v written into ``cache`` in place: a
    ring cache of ``min(seq, window)`` slots for the window kinds (eviction
    is the mask), the full cache for the others.  On a mesh whose data
    ranks do not split the batch, every layer of an MoE arch attends over
    each data rank's share of the sequences, as ``moe_ffn_ep`` routes its
    share of the tokens (the reference's MoE constrains its tokens over
    the data axes, and XLA's partitioner carries that split back through
    the step); a dense arch keeps them whole there, as the reference does."""
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              batch_share=cfg.moe is not None)
    if _window_for(cfg, kind) > 0:
        y, _ = attn.attention_decode_ring(aparams, h, (cache["k"], cache["v"]), lengths, **kw)
    else:
        y, _ = attn.attention_decode(aparams, h, (cache["k"], cache["v"]), lengths, **kw)
    return y


# -- cache specs -------------------------------------------------------------------


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, seq: int, device=None):
    """Zeroed decode cache for one layer of ``kind`` (bf16 k/v, float32
    recurrent states)."""
    check_kind(kind)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    G, hd = cfg.num_kv_heads, cfg.head_dim
    w = _window_for(cfg, kind)
    kv_len = min(seq, w) if w > 0 else seq
    if kind in ATTN_KINDS:
        return {"k": zeros(batch, kv_len, G, hd, dtype=torch.bfloat16),
                "v": zeros(batch, kv_len, G, hd, dtype=torch.bfloat16)}
    if kind == "mlstm":
        inner, H, dh = _mlstm_dims(cfg)
        return {"S": zeros(batch, H, dh, dh), "n": zeros(batch, H, dh),
                "conv": zeros(batch, CONV_K - 1, inner)}
    if kind == "slstm":
        H = cfg.num_heads
        dh = cfg.d_model // H
        return {"c": zeros(batch, H, dh), "n": zeros(batch, H, dh), "h": zeros(batch, H, dh)}
    inner, H, P = _hymba_dims(cfg)
    N = cfg.ssm.state_dim
    return {"k": zeros(batch, kv_len, G, hd, dtype=torch.bfloat16),
            "v": zeros(batch, kv_len, G, hd, dtype=torch.bfloat16),
            "S": zeros(batch, H, N, P), "n": zeros(batch, H, N)}
