"""Shared primitive layers: RMSNorm, RoPE, MLP variants, embeddings.

Twin of the reference's ``models/layers.py`` in the same plain-function
style: every layer is an ``init_*(generator, ...) -> params`` factory (a
dict of tensors on the generator's device) plus a pure apply function.
The reference draws from ``jax.random`` keys, the port from a
``torch.Generator``: the same distributions, other numbers.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.parallel.axes import from_block, local_block

Params = Dict[str, torch.Tensor]

# Standard normal CDF at -2 and 2: the truncation interval, in uniform space.
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def truncated_normal(generator: torch.Generator, shape, stddev: float,
                     dtype=torch.float32) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn by
    inverting the CDF of a uniform sample, as ``jax.random.truncated_normal``
    does; on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (_LO + u * (_HI - _LO)) - 1.0)
    return (stddev * x.clamp(-2.0, 2.0)).to(dtype)


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result whatever the operands' dtype: the
    twin of the reference's ``preferred_element_type=float32``.  The
    operands are widened first, which is exact for bf16, so only the order
    of the float32 sums differs (a bf16 ``torch.matmul`` would round the
    result to bf16)."""
    return torch.matmul(a.float(), b.float())


def promoted(*tensors: torch.Tensor):
    """The tensors in their promoted dtype: JAX's products promote mixed
    operands (a float32 state times bf16 weights), torch's refuse them."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


# -- gate activations -------------------------------------------------------------
# The recurrent kinds' gates as the reference evaluates them: one rounding
# to the input's dtype after every primitive (XLA's bf16 arithmetic),
# where torch's fused sigmoid and softplus round once.  In bf16 the fused
# forms differ by an ulp on a sixth to a third of the inputs, and the
# gates' log-decays are summed over a chunk and exponentiated, which
# multiplies that ulp into several per cent of a state.


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


# -- RMSNorm -------------------------------------------------------------------


def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(dtype)


# -- RoPE ----------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (int).  Rotates pairs (d, d+D/2).
    The frequencies are ``exp(-log(theta) * i / half)`` in float32, as the
    reference computes them."""
    D = x.shape[-1]
    half = D // 2
    # log(theta) in float32 on the host, filled on the device (a scalar
    # copied to the card would wait for the stream at every call).
    neg_log_theta = torch.full((), -np.log(np.float32(theta)), dtype=torch.float32,
                               device=x.device)
    freq = torch.exp(neg_log_theta * torch.arange(0, half, dtype=torch.float32,
                                                  device=x.device) / half)
    ang = positions[..., None].float() * freq              # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP variants ---------------------------------------------------------------


def init_mlp(generator: torch.Generator, d: int, f: int, mlp_type: str) -> Params:
    s_in = d ** -0.5
    s_out = f ** -0.5
    if mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": truncated_normal(generator, (d, f), s_in),
            "w_up": truncated_normal(generator, (d, f), s_in),
            "w_down": truncated_normal(generator, (f, d), s_out),
        }
    if mlp_type == "gelu":  # non-gated (starcoder2, musicgen)
        return {
            "w_up": truncated_normal(generator, (d, f), s_in),
            "w_down": truncated_normal(generator, (f, d), s_out),
        }
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def mlp(params: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "gelu":
        h = _gelu(x @ params["w_up"])
        return h @ params["w_down"]
    act = F.silu if mlp_type == "swiglu" else _gelu
    g = act(x @ params["w_gate"])
    u = x @ params["w_up"]
    return (g * u) @ params["w_down"]


# -- Embedding -------------------------------------------------------------------


def init_embedding(generator: torch.Generator, vocab: int, d: int, tie: bool) -> Params:
    p = {"table": truncated_normal(generator, (vocab, d), 0.02)}
    if not tie:
        p["unembed"] = truncated_normal(generator, (d, vocab), d ** -0.5)
    return p


def embed(params: Params, tokens: torch.Tensor, scale: bool, d: int) -> torch.Tensor:
    table = params["table"]
    if isinstance(table, DTensor):
        x = _vocab_parallel_embed(table, tokens)
    else:
        x = table[tokens]
    if scale:
        # sqrt(d) rounded to the table's dtype first, as the reference does
        # (bf16 at d = 2048: 45.25, not 45.2548); the product of two bf16
        # values is exact in float32, so rounding it once gives the bf16 product.
        x = x * float(torch.tensor(d ** 0.5, dtype=x.dtype))
    return x


def _vocab_parallel_embed(table: DTensor, tokens) -> DTensor:
    """The embedding of ``tokens`` on a mesh, rank by rank (Megatron's
    vocab-parallel embedding): the table whole over every mesh dim but
    'model' (gathered where FSDP splits it), its rows split over 'model'
    where the plan splits them; each rank gathers the rows it holds, zero
    for the others' tokens, and the result is a partial sum over 'model'
    (a replica where the rows are whole).  Its backward writes each rank's
    rows only; DTensor's own rules for an indexed gather's backward differ
    between torch versions, so none is asked for."""
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    rows_split = tuple(i for i, p in enumerate(table.placements)
                       if isinstance(p, Shard) and p.dim == 0 and names[i] == "model")
    layout = tuple(Shard(0) if i in rows_split else Replicate() for i in range(mesh.ndim))
    if tuple(table.placements) != layout:
        table = table.redistribute(mesh, layout)
    block = table.to_local(grad_placements=tuple(
        Shard(0) if i in rows_split else Partial() for i in range(mesh.ndim)))
    (nv, _), (v0, _) = local_block(table.shape, mesh, layout)
    if isinstance(tokens, DTensor):
        keep = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in tokens.placements)
        if tuple(tokens.placements) != keep:
            tokens = tokens.redistribute(mesh, keep)
        tok, tok_layout, shape = tokens.to_local(), keep, tuple(tokens.shape)
    else:
        tok, tok_layout, shape = tokens, (Replicate(),) * mesh.ndim, tuple(tokens.shape)
    local = tok.long() - v0
    inside = (local >= 0) & (local < nv)
    x = F.embedding(local.clamp(0, nv - 1), block)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    out_layout = tuple(Partial() if i in rows_split else p for i, p in enumerate(tok_layout))
    return from_block(x, mesh, out_layout, (*shape, block.shape[1]))


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 regardless of compute dtype (CE numerics)."""
    w = params.get("unembed")
    if w is not None:
        return f32_matmul(x, w)
    return f32_matmul(x, params["table"].t())
