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
The reference's mesh constraints (``constrain``,
``constrain_time_mixer``) do nothing without a mesh and are not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import linear_rnn as lrnn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Params, init_mlp, init_rmsnorm, log_sigmoid, mlp, promoted, rmsnorm, sigmoid, softplus,
    truncated_normal,
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


def _mlstm_seq(params, cfg: ArchConfig, h, state, return_state: bool = False):
    """mLSTM inner: up-proj, causal conv, per-head qk, chunked GLA, gate."""
    inner, H, dh = _mlstm_dims(cfg)
    B, L, _ = h.shape
    up = h @ params["w_up"]
    u, z = torch.chunk(up, 2, dim=-1)
    if state is None:
        c = lrnn.causal_conv1d(u, params["conv_w"])
        conv_buf = None
    else:
        (gla_state, conv_buf) = state
        c, conv_buf = lrnn.causal_conv1d_step(u[:, 0], params["conv_w"], conv_buf)
        c = c[:, None]
    c = F.silu(c)
    ch = c.reshape(B, L, H, dh)
    q = torch.einsum("blhd,hde->blhe", *promoted(ch, params["w_q"]))
    k = torch.einsum("blhd,hde->blhe", *promoted(ch, params["w_k"])) * (dh ** -0.5)
    v = u.reshape(B, L, H, dh)
    gates = u @ params["w_gates"] + params["b_gates"]          # [B,L,2H]
    f_raw, i_raw = torch.chunk(gates, 2, dim=-1)
    log_f = log_sigmoid(f_raw)
    i_gate = sigmoid(i_raw)
    if state is None:
        y, gla_final = lrnn.gla_chunked(
            q, k, v, log_f, i_gate, normalize=True,
            chunk=min(cfg.ssm.chunk if cfg.ssm else 256, L),
        )
        new_state = None
        if return_state:
            pad = max(0, (CONV_K - 1) - L)
            tail = F.pad(u, (0, 0, pad, 0))[:, -(CONV_K - 1):]
            new_state = (gla_final, tail.float())
    else:
        y1, new_gla = lrnn.gla_step(
            q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], i_gate[:, 0],
            gla_state, normalize=True,
        )
        y = y1[:, None]
        new_state = (new_gla, conv_buf)
    y = y.reshape(B, L, inner) * F.silu(z)
    out = y @ params["w_down"]
    return out, new_state


def _hymba_ssm_seq(params, cfg: ArchConfig, h, state, return_state: bool = False):
    """Mamba2-style scalar-decay SSM branch (chunked GLA core)."""
    inner, H, P = _hymba_dims(cfg)
    N = cfg.ssm.state_dim
    B, L, _ = h.shape
    xz = h @ params["ssm_in"]
    xs, z = torch.chunk(xz, 2, dim=-1)                          # [B,L,inner]
    bc = h @ params["ssm_bc"]
    bmat, cmat = torch.chunk(bc.reshape(B, L, H, 2 * N), 2, dim=-1)
    dt = softplus(h @ params["ssm_dt"] + params["ssm_dt_bias"])   # [B,L,H]
    a = -torch.exp(params["ssm_a_log"])                         # [H] (< 0)
    log_f = dt * a
    i_gate = dt
    v = xs.reshape(B, L, H, P)
    k = bmat * (N ** -0.5)
    q = cmat
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
        y = y1[:, None]
    y = y.reshape(B, L, inner) * F.silu(z)
    return y, new_state


def _hymba_mix(params, a, s):
    """Normalized, learned-scale fusion of attention and SSM branches, cast
    back to the branch dtype (the float32 beta scalars would otherwise
    promote the residual stream), as in the reference."""
    beta = sigmoid(params["mix_beta"]) * 2.0
    an = rmsnorm(params["norm_attn_out"], a)
    sn = rmsnorm(params["norm_ssm_out"], s) @ params["ssm_out"]
    return (0.5 * (beta[0] * an + beta[1] * sn)).to(a.dtype)


# -- prefill -----------------------------------------------------------------------


def _store_kv(k: torch.Tensor, cache_len: int, window: int) -> torch.Tensor:
    """Pack prefill keys/values into a bf16 decode cache buffer.

    Full-attention kinds: left-aligned into a [B, cache_len, ...] buffer.
    Window kinds: ring layout -- the last min(W, S) positions at slot
    pos % W with W = min(cache_len, window), matching
    ``attention_decode_ring``'s indexing."""
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
               chunk_q: int, cache_len=None):
    """The full-sequence body shared by training and prefill: ``(x', aux,
    cache)``.  ``aux`` is the MoE load-balance loss (None for the other
    kinds); the decode cache is built only when ``cache_len`` is given."""
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
        )
        if want_cache:
            cache = {"k": _store_kv(k, cache_len, window), "v": _store_kv(v, cache_len, window)}
        if kind in ATTN_KINDS:
            x = x + a
            h = rmsnorm(params["ln_mlp"], x)
            if kind == "moe":
                h, aux = moe_lib.moe_ffn_ep(params["moe"], h, cfg.moe, cfg.mlp_type)
            else:
                h = mlp(params["mlp"], h, cfg.mlp_type)
            return x + h, aux, cache
        # hymba / hymba_g
        s, state = _hymba_ssm_seq(params, cfg, h, state=None, return_state=want_cache)
        x = x + _hymba_mix(params, a, s)
        h2 = mlp(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
        if want_cache:
            cache["S"], cache["n"] = state
        return x + h2, aux, cache

    if kind == "mlstm":
        y, state = _mlstm_seq(params, cfg, rmsnorm(params["ln"], x), state=None,
                              return_state=want_cache)
        if want_cache:
            (S, n), conv = state
            cache = {"S": S, "n": n, "conv": conv}
        return x + y, aux, cache

    # slstm
    h = rmsnorm(params["ln"], x)
    h, (c, n, hs) = lrnn.slstm_scan(params["slstm"], h, cfg.num_heads)
    x = x + h
    h2 = mlp(params["mlp"], rmsnorm(params["ln_mlp"], x), "swiglu")
    if want_cache:
        cache = {"c": c, "n": n, "h": hs}
    return x + h2, aux, cache


def block_train(
    params: Params,
    cfg: ArchConfig,
    kind: str,
    x: torch.Tensor,
    prefix_len: int = 0,
    chunk_q: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block application.  Returns (x', aux_loss): the MoE
    kind's float32 load-balance loss, 0 for every other kind."""
    x, aux, _ = _block_seq(params, cfg, kind, x, prefix_len, chunk_q)
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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence application that also emits the decode cache (the MoE
    aux loss is dropped, as in the reference)."""
    x, _, cache = _block_seq(params, cfg, kind, x, prefix_len, chunk_q, cache_len)
    return x, cache


# -- decode -----------------------------------------------------------------------


def _write(cache: Dict[str, torch.Tensor], **new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The new recurrent states into the cache tensors, in place."""
    for name, value in new.items():
        cache[name].copy_(value)
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
        x = x + h
        h = rmsnorm(params["ln_mlp"], x)
        if kind == "moe":
            h, _ = moe_lib.moe_ffn_ep(params["moe"], h, cfg.moe, cfg.mlp_type, dropless=True)
        else:
            h = mlp(params["mlp"], h, cfg.mlp_type)
        return x + h, cache

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
    h2 = mlp(params["mlp"], rmsnorm(params["ln_mlp"], x), cfg.mlp_type)
    return x + h2, _write(cache, S=S, n=n)


def _attn_decode(aparams, cfg: ArchConfig, kind: str, h, cache, lengths):
    """Attention of one token, its k/v written into ``cache`` in place: a
    ring cache of ``min(seq, window)`` slots for the window kinds (eviction
    is the mask), the full cache for the others."""
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
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
