"""Mixture-of-Experts FFN: shared experts + routed top-k with capacity.

Twin of the reference's ``models/moe.py``.  DeepSeek-MoE / Qwen2-MoE
style: ``num_shared`` always-active experts (fused into one wide FFN) plus
``num_experts`` routed experts with top-k token-choice routing.

Dispatch is scatter-based (no [T, E, C] one-hot tensor, no global sort):

  1. router logits -> top-k expert ids + softmaxed weights per token
     (:func:`route`; ties go to the lower expert id, as ``jax.lax.top_k``
     breaks them);
  2. position-in-expert via a cumsum over the flattened (token, k) choices,
     and the capacity drop (:func:`dispatch`: over-capacity choices are
     dropped in token order, the reference's ``keep`` mask exactly);
  3. tokens scattered into an [E * C, D] expert buffer;
  4. batched expert FFN as ``torch.bmm`` over the [E, C, D] buffer;
  5. gather back + weighted combine; dropped tokens contribute zero.

An auxiliary load-balance loss (Switch-style) is returned beside the
output, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, _gelu, init_mlp, mlp, truncated_normal


def init_moe(generator: torch.Generator, d: int, f: int, moe: MoEConfig,
             mlp_type: str) -> Params:
    E = moe.num_experts
    s_in = d ** -0.5
    s_out = f ** -0.5
    p = {
        "router": truncated_normal(generator, (d, E), s_in),
        "w_gate": truncated_normal(generator, (E, d, f), s_in),
        "w_up": truncated_normal(generator, (E, d, f), s_in),
        "w_down": truncated_normal(generator, (E, f, d), s_out),
    }
    if moe.num_shared:
        p["shared"] = init_mlp(generator, d, f * moe.num_shared, mlp_type)
    return p


def route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Float32 router logits ``[T, E]`` -> (softmax probabilities, the top-k
    gate values renormalised to sum 1, the top-k expert ids), each
    ``[T, k]`` but the first.  A stable descending sort puts equal
    probabilities in ascending expert order, so ties pick the lower id
    first, as ``jax.lax.top_k`` does."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = gate_vals[:, :k], expert_ids[:, :k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_ids


def capacity(T: int, moe: MoEConfig, dropless: bool) -> int:
    """Slots per expert: ``T`` when dropless (no choice can be dropped, as
    each token picks an expert at most once), else ``round(T k / E cf)``."""
    if dropless:
        return T
    return int(max(1, round(T * moe.top_k / moe.num_experts * moe.capacity_factor)))


def dispatch(expert_ids: torch.Tensor, E: int, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened choices ``[T * k]`` -> (each choice's position in its
    expert, in token order; whether it fits the capacity ``C``)."""
    flat_ids = expert_ids.reshape(-1)
    onehot = F.one_hot(flat_ids, E).to(torch.int32)            # [T*k, E]
    pos_all = torch.cumsum(onehot, dim=0) - 1                  # exclusive count
    pos = pos_all.gather(1, flat_ids[:, None])[:, 0]
    return pos, pos < C


def moe_ffn(
    params: Params,
    x: torch.Tensor,          # [B, S, D]
    moe: MoEConfig,
    mlp_type: str,
    dropless: bool = False,   # decode: capacity = T (no order-dependent drops)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,D], aux_loss scalar)."""
    B, S, D = x.shape
    T = B * S
    E, k = moe.num_experts, moe.top_k
    xt = x.reshape(T, D)

    logits = (xt @ params["router"]).float()                   # [T, E]
    probs, gate_vals, expert_ids = route(logits, k)

    # Switch-style aux load-balance loss.
    me = probs.mean(dim=0)                                     # [E]
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce = ce.index_add(0, expert_ids.reshape(-1),
                      torch.ones((T * k,), dtype=torch.float32, device=x.device)) / (T * k)
    aux = moe.router_aux_weight * E * torch.sum(me * ce)

    C = capacity(T, moe, dropless)
    pos, keep = dispatch(expert_ids, E, C)
    flat_ids = expert_ids.reshape(T * k)
    slot = flat_ids * C + torch.where(keep, pos, 0)            # [T*k]
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)

    # Scatter the kept choices' activations into the expert buffer [E*C, D]:
    # each kept slot is written once, so a write is the reference's add; the
    # dropped ones go to one spare row past the buffer (the reference's
    # out-of-range index under mode="drop"), with no host sync.
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, E * C)] = xt[token_idx]
    buf = buf[:E * C].reshape(E, C, D)

    # Batched expert FFN.
    act = F.silu if mlp_type == "swiglu" else _gelu
    g = act(torch.bmm(buf, params["w_gate"]))
    u = torch.bmm(buf, params["w_up"])
    eo = torch.bmm(g * u, params["w_down"])                    # [E, C, D]

    # Gather back and combine the k expert outputs per token.
    out_flat = torch.where(keep[:, None], eo.reshape(E * C, D)[slot], 0.0)   # [T*k, D]
    combined = (out_flat.reshape(T, k, D) * gate_vals[..., None].to(x.dtype)).sum(dim=1)

    if "shared" in params:
        combined = combined + mlp(params["shared"], xt, mlp_type)
    return combined.reshape(B, S, D), aux


def moe_ffn_ep(
    params: Params,
    x: torch.Tensor,
    moe: MoEConfig,
    mlp_type: str,
    dropless: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel MoE (``shard_map`` over a mesh)
    falls back to ``moe_ffn`` when there is no mesh.  The port has no LM
    mesh yet (ROADMAP Queue A item 6b), so this is ``moe_ffn``."""
    return moe_ffn(params, x, moe, mlp_type, dropless=dropless)
