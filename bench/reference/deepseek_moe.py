"""Plain reference of a DeepSeekMoE decoder (arXiv:2401.06066), in torch.

The forward pass over token histories, written from the published model
and independent of the program: embed; ``first_k_dense_replace`` dense
layers (attention + SwiGLU MLP), then MoE layers (attention + a softmax
router over ``n_routed_experts``, the top ``num_experts_per_tok`` experts,
dropless, plus ``n_shared_experts`` always-on experts); pre-norm RMSNorm
everywhere and a final RMSNorm; RoPE on q and k; causal multi-head (or
grouped) attention; an untied unembedding.  Where the configuration's
``departures`` lists a difference from the published model, this follows
the configuration (``model``), which states what is run:
``norm_topk_prob`` (the top-k gates renormalised to sum 1) and
``dense_intermediate_size`` (the dense layers' MLP width).

Computed in ``dtype``: ``torch.float32`` (TF32 off for both backends while
it runs) or ``torch.bfloat16`` (the reference's own rounding, for the
check's scale): activations and matrix products in ``dtype``; norms,
softmaxes and RoPE's angles in float32 and rounded back; attention scores
and the logits in float32.  It runs layer by layer over all the histories
at once, each layer's weights widened to ``dtype`` only while that layer
runs, so it fits beside the served copy.

Weights: the program's parameter tree, which the benchmark makes from the
seed (``benchlib/weights.py``) and this module only reads.  The names:

    embed.table [V, D]           token embeddings (rows gathered)
    embed.unembed [D, V]         the unembedding
    final_norm.scale [D]         final RMSNorm, multiplier 1 + scale
    layer i < first_k_dense_replace:  prefix[i].<leaf>
    layer i >= first_k_dense_replace: blocks["0:moe"].<leaf>[i - first_k]
                                      (blocks["0:dense"] for a dense model)
    <leaf>: ln_attn.scale, ln_mlp.scale [D]       the two pre-norms
            attn.wq [D, G, H/G, hd], attn.wk, attn.wv [D, G, hd],
            attn.wo [G, H/G, hd, D]               q/k/v/o projections
            mlp.w_gate, mlp.w_up [D, F], mlp.w_down [F, D]   (dense)
            moe.router [D, E]; moe.w_gate, moe.w_up [E, D, F];
            moe.w_down [E, F, D]; moe.shared.w_gate, moe.shared.w_up
            [D, S F], moe.shared.w_down [S F, D]  (S shared experts
            side by side as one MLP of width S F, the published form)

RoPE rotates the pairs (d, d + hd/2) at frequencies theta^(-2i/hd).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())
    return y.to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[S, heads, hd]`` at positions 0 .. S - 1."""
    S, _, hd = x.shape
    half = hd // 2
    freq = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                     device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attention(p: Dict, h: torch.Tensor, model: dict, dtype) -> torch.Tensor:
    """Causal attention of one history ``h`` ``[S, D]``."""
    S, D = h.shape
    wq, wk, wv, wo = (p[k].to(dtype) for k in ("wq", "wk", "wv", "wo"))
    G, Hg, hd = wq.shape[1:]
    q = _rope((h @ wq.reshape(D, -1)).reshape(S, G * Hg, hd), model["rope_theta"])
    k = _rope((h @ wk.reshape(D, -1)).reshape(S, G, hd), model["rope_theta"])
    v = (h @ wv.reshape(D, -1)).reshape(S, G, hd)
    q = q.reshape(S, G, Hg, hd).permute(1, 2, 0, 3).float()         # [G, Hg, S, hd]
    scores = torch.einsum("ghsd,gtd->ghst", q, k.permute(1, 0, 2).float()) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("ghst,gtd->sghd", probs.to(dtype), v.permute(1, 0, 2))
    return out.reshape(S, -1) @ wo.reshape(-1, D)


def _swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _moe(p: Dict, x: torch.Tensor, model: dict, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts (dropless) plus the shared ones over tokens ``x``
    ``[T, D]``; returns the output and, per token, the gap between its
    k-th and (k+1)-th router probabilities in units of the k-th's bf16
    spacing."""
    k = int(model["num_experts_per_tok"])
    probs = torch.softmax((x @ p["router"].to(dtype)).float(), dim=-1)       # [T, E]
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    ulp = torch.exp2(torch.floor(torch.log2(top[:, k - 1])) - 7)
    margin = (top[:, k - 1] - top[:, k]) / ulp
    gates, ids = top[:, :k], ids[:, :k]
    if model["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(probs.shape[1]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(x[tok], p["w_gate"][e].to(dtype), p["w_up"][e].to(dtype),
                    p["w_down"][e].to(dtype))
        out.index_add_(0, tok, (y * gates[tok, slot, None].to(dtype)).to(out.dtype))
    if "shared" in p:
        s = p["shared"]
        out = out + _swiglu(x, s["w_gate"].to(dtype), s["w_up"].to(dtype), s["w_down"].to(dtype))
    return out, margin


def _layer(weights: Dict, model: dict, i: int) -> Tuple[Dict, bool]:
    """Layer ``i``'s parameter tree, and whether it is an MoE layer."""
    first = int(model.get("first_k_dense_replace", 0))
    if i < first:
        return weights["prefix"][i], False
    moe = int(model.get("n_routed_experts", 0)) > 0
    stacked = weights["blocks"]["0:moe" if moe else "0:dense"]

    def pick(node):
        return {n: pick(v) for n, v in node.items()} if isinstance(node, dict) else node[i - first]

    return pick(stacked), moe


def hidden(weights: Dict, model: dict, histories: Sequence[torch.Tensor],
           wanted: Sequence[torch.Tensor], dtype=torch.float32
           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The final normed hidden states of each history (``[S_i]`` token
    ids) at its ``wanted`` positions (``[n_i]``), in ``dtype``, and at
    those positions the smallest router margin over the MoE layers (see
    :func:`_moe`; ``inf`` for a model without experts)."""
    backends = torch.backends
    tf32 = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _hidden(weights, model, histories, wanted, dtype)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = tf32


def _hidden(weights, model, histories, wanted, dtype):
    eps = float(model["rms_norm_eps"])
    table = weights["embed"]["table"]
    sizes = [int(t.numel()) for t in histories]
    h = torch.cat([table[t.to(table.device)] for t in histories]).to(dtype)     # [T, D]
    margin = torch.full((h.shape[0],), float("inf"), device=h.device)
    for i in range(int(model["num_hidden_layers"])):
        p, moe = _layer(weights, model, i)
        a = _norm(h, p["ln_attn"]["scale"], eps)
        h = h + torch.cat([_attention(p["attn"], part, model, dtype)
                           for part in a.split(sizes)])
        m = _norm(h, p["ln_mlp"]["scale"], eps)
        if moe:
            y, gap = _moe(p["moe"], m, model, dtype)
            margin = torch.minimum(margin, gap)
        else:
            mlp = p["mlp"]
            y = _swiglu(m, mlp["w_gate"].to(dtype), mlp["w_up"].to(dtype),
                        mlp["w_down"].to(dtype))
        h = h + y
    h = _norm(h, weights["final_norm"]["scale"], eps)
    outs, margins = [], []
    for part, gap, want in zip(h.split(sizes), margin.split(sizes), wanted):
        idx = want.to(h.device)
        outs.append(part[idx])
        margins.append(gap[idx])
    return outs, margins


def logits(weights: Dict, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``[n, V]`` of hidden states ``h`` ``[n, D]``."""
    backends = torch.backends
    tf32 = backends.cuda.matmul.allow_tf32
    backends.cuda.matmul.allow_tf32 = False
    try:
        return h.float() @ weights["embed"]["unembed"].float()
    finally:
        backends.cuda.matmul.allow_tf32 = tf32
