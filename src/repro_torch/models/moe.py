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

On an LM mesh :func:`moe_ffn_ep` is the expert-parallel path, the twin of
the reference's ``shard_map``: each rank dispatches its own data shard's
tokens locally (no collective), computes its experts (or its slice of
every expert's hidden dim), and one all-reduce over 'model' sums the
partial outputs (:func:`_moe_local`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, _gelu, init_mlp, mlp, truncated_normal
from repro_torch.parallel.axes import (
    ambient_mesh, axis_sizes, constrain, placements, ragged_share,
)


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
    onehot = constrain(onehot, "batch", None)                  # rows ~ tokens
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
    buf[torch.where(keep, slot, E * C)] = constrain(xt[token_idx], "batch", None)
    buf = buf[:E * C].reshape(E, C, D)

    # Shard the dispatch buffer: experts over 'model' (EP) when divisible,
    # capacity over 'data' always, as the reference constrains it.
    mesh = ambient_mesh()
    if mesh is not None:
        m = axis_sizes(mesh).get("model")
        buf = constrain(buf, "model" if m and E % m == 0 else None, "batch", None)

    # Batched expert FFN.
    act = F.silu if mlp_type == "swiglu" else _gelu
    g = act(torch.bmm(buf, params["w_gate"]))
    u = torch.bmm(buf, params["w_up"])
    eo = torch.bmm(g * u, params["w_down"])                    # [E, C, D]

    # Gather back and combine the k expert outputs per token.
    out_flat = torch.where(keep[:, None], eo.reshape(E * C, D)[slot], 0.0)   # [T*k, D]
    out_flat = constrain(out_flat, "batch", None)
    combined = (out_flat.reshape(T, k, D) * gate_vals[..., None].to(x.dtype)).sum(dim=1)

    if "shared" in params:
        combined = combined + mlp(params["shared"], xt, mlp_type)
    return combined.reshape(B, S, D), aux


# -- expert parallelism on an LM mesh -----------------------------------------------
#
# A scatter has no sharding rule worth having (the reference measured GSPMD
# replicating the [E, C, D] buffer), so the mesh path dispatches *locally
# per data shard*, as the reference's shard_map does:
#
#   * routing + scatter run on each rank's data shard of the tokens,
#     replicated over 'model' (identical cheap compute, no collective);
#   * expert FFN: experts sharded over 'model' when E % |model| == 0 (each
#     rank owns E/|model| experts and masks the rest), otherwise the FFN
#     hidden dim is sharded (F-parallel fallback);
#   * one all-reduce over 'model' sums the partial token outputs, and the
#     aux loss's two means are averaged over the data axes;
#   * a batch the data axes do not split (where the reference falls back
#     to moe_ffn) is split into ragged token shares instead, one a data
#     rank, whose outputs and aux sums add up over the data axes.


def _moe_local(
    xt: torch.Tensor,            # [T_loc, D] this rank's tokens
    router: torch.Tensor,        # [D, E] replicated
    wg: torch.Tensor,            # [E_loc, D, F] or [E, D, F_loc]
    wu: torch.Tensor,
    wd: torch.Tensor,            # [E_loc, F, D] or [E, F_loc, D]
    moe: MoEConfig,
    mlp_type: str,
    m_idx: int,                  # this rank's index on 'model' (EP only)
    ep: bool,                    # True: experts sharded over 'model'
    C: int,                      # slots per expert
    earlier=None,                # bucket counts [buckets + 1] -> the earlier ranks' counts
):
    """One rank's share: ``(partial output [T_loc, D], probs [T_loc, E],
    expert ids [T_loc, k])``, the output a partial sum over 'model'.  A
    choice's position in its expert counts the earlier tokens' choices of
    that expert; where these tokens are a share of a batch whose capacity
    ``C`` counts the whole batch, ``earlier`` returns the earlier ranks'
    counts (a collective), else the share is a batch of its own."""
    T, D = xt.shape
    E, k = moe.num_experts, moe.top_k

    logits = (xt @ router).float()
    probs, gate_vals, expert_ids = route(logits, k)

    if ep:
        E_loc = wg.shape[0]
        local = (expert_ids // E_loc) == m_idx                  # my experts only
        eff_ids = torch.where(local, expert_ids % E_loc, E_loc)  # E_loc = drop
        n_buckets = E_loc
    else:
        local = torch.ones_like(expert_ids, dtype=torch.bool)
        eff_ids = expert_ids
        n_buckets = E

    # a token picks an expert at most once, so no slot past T_loc fills
    depth = min(T, C)
    flat_ids = eff_ids.reshape(T * k)
    pos, fits = dispatch(eff_ids, n_buckets + 1, depth)         # + the drop bucket
    if earlier is not None:
        counts = torch.zeros((n_buckets + 1,), dtype=torch.int64, device=xt.device).index_add(
            0, flat_ids, torch.ones_like(flat_ids))
        fits = pos + earlier(counts)[flat_ids] < C
    keep = fits & local.reshape(T * k)

    slot = torch.where(keep, flat_ids * depth + pos, n_buckets * depth)
    token_idx = torch.arange(T, device=xt.device).repeat_interleave(k)
    # each kept slot is written once; the dropped ones go to the spare row
    buf = torch.zeros((n_buckets * depth + 1, D), dtype=xt.dtype, device=xt.device)
    buf[slot] = xt[token_idx]
    buf = buf[:n_buckets * depth].reshape(n_buckets, depth, D)

    act = F.silu if mlp_type == "swiglu" else _gelu
    g = act(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    eo = torch.bmm(g * u, wd)                                   # [buckets, depth, D]

    out_flat = torch.where(keep[:, None], eo.reshape(-1, D)[torch.clamp_max(
        slot, max(n_buckets * depth - 1, 0))], 0.0)
    combined = (out_flat.reshape(T, k, D) * gate_vals[..., None].to(xt.dtype)).sum(dim=1)
    return combined, probs, expert_ids


def _expert_counts(expert_ids: torch.Tensor, E: int) -> torch.Tensor:
    """Float32 choices per expert ``[E]``."""
    flat = expert_ids.reshape(-1)
    return torch.zeros((E,), dtype=torch.float32, device=flat.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))


def _local(t, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's block of ``t`` laid out as ``spec`` (a plain tensor is
    every rank's same full value).  Its grad is a partial sum over every
    mesh dim the block is replicated on: the ranks there compute with
    other tokens (over 'data') or other experts or hidden units (over
    'model')."""
    want = placements(tuple(spec), mesh)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local(grad_placements=[Partial() if isinstance(p, Replicate) else p
                                       for p in want])


def moe_ffn_ep(
    params: Params,
    x: torch.Tensor,
    moe: MoEConfig,
    mlp_type: str,
    dropless: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on the ambient LM mesh; ``moe_ffn`` where the
    reference falls back: no mesh or no 'model' axis, or neither the
    experts nor the hidden dim splitting over 'model'.  A batch that does
    not split over the data axes arrives whole on every data rank, where
    the reference runs ``moe_ffn``: each data rank routes its share of the
    ``B S`` tokens (``axes.ragged_share``, so a share may be empty), each
    choice placed by its position in the whole batch (the capacity counts
    the whole batch), and the shares' outputs and the aux loss's sums add
    up over the data axes: ``moe_ffn``'s numbers, with each token's work
    done once and its grads added up once."""
    mesh = ambient_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return moe_ffn(params, x, moe, mlp_type, dropless=dropless)
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    m = sizes["model"]
    daxes = tuple(a for a in ("pod", "data") if a in names)
    B, S, D = x.shape
    E, k = moe.num_experts, moe.top_k
    n_data = math.prod(sizes[a] for a in daxes)
    split = B % n_data == 0
    ep = E % m == 0
    F_ = params["w_gate"].shape[-1]
    if not ep and F_ % m != 0:
        return moe_ffn(params, x, moe, mlp_type, dropless=dropless)

    lead = (daxes if len(daxes) > 1 else daxes[0]) if daxes and split else None
    w_spec = ("model", None, None) if ep else (None, None, "model")
    wd_spec = ("model", None, None) if ep else (None, "model", None)
    xb = _local(x, mesh, (lead, None, None))
    xt = xb.reshape(-1, D)
    T = xt.shape[0]
    C = capacity(T, moe, dropless)
    earlier = None
    if not split:
        # this data rank's share of the whole batch's tokens
        T_all, ddims = T, [names.index(a) for a in daxes]
        lo, T, r = ragged_share(T_all, mesh, ddims)
        xt = xt[lo:lo + T]
        if not dropless:
            def earlier(counts):
                """The earlier data ranks' choices per bucket (an all-gather
                over the data axes, which every rank joins)."""
                over = [Shard(0) if i in ddims else Replicate() for i in range(mesh.ndim)]
                every = DTensor.from_local(counts[None], mesh, over, run_check=False)
                return every.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()[:r].sum(0)
    y_loc, probs, expert_ids = _moe_local(
        xt, _local(params["router"], mesh, (None, None)),
        _local(params["w_gate"], mesh, w_spec), _local(params["w_up"], mesh, w_spec),
        _local(params["w_down"], mesh, wd_spec), moe, mlp_type,
        mesh.get_local_rank("model"), ep, C, earlier)

    # the psum over 'model' (partial outputs), and the sums over the data axes
    def on_mesh(local, dims):
        placed = [Replicate()] * mesh.ndim
        for a, p in dims.items():
            placed[names.index(a)] = p
        t = DTensor.from_local(local, mesh, placed, run_check=False)
        return t.redistribute(mesh, [Shard(0) if isinstance(p, Shard) else Replicate()
                                     for p in placed])

    # every 'model' rank holds the same me: each adds its 1/|model| share,
    # so the grad reaching the router counts the aux loss once
    every = {a: Partial() for a in (*daxes, "model")}
    shared = params.get("shared")
    if split:
        y = on_mesh(y_loc.reshape(xb.shape), {**{a: Shard(0) for a in daxes}, "model": Partial()})
        me = on_mesh(probs.mean(dim=0) / (n_data * m), every)
        ce = on_mesh(_expert_counts(expert_ids, E) / (T * k) / n_data,
                     {a: Partial() for a in daxes})
    else:
        if shared is not None and shared["w_up"].shape[-1] % m == 0:
            # the shared experts on the share too, over this rank's 'model'
            # block of their hidden dim: a partial sum over 'model' as well
            y_loc = y_loc + mlp({name: _local(w, mesh, ("model", None) if name == "w_down"
                                              else (None, "model"))
                                 for name, w in shared.items()}, xt, mlp_type)
            shared = None
        y = on_mesh(F.pad(y_loc, (0, 0, lo, T_all - lo - T)).reshape(xb.shape),
                    {**{a: Partial() for a in daxes}, "model": Partial()})
        me = on_mesh(probs.sum(dim=0) / (T_all * m), every)
        ce = on_mesh(_expert_counts(expert_ids, E) / (T_all * k), {a: Partial() for a in daxes})
    aux = moe.router_aux_weight * E * torch.sum(me * ce)
    if shared is not None:
        shared = mlp(shared, x, mlp_type)
        if not isinstance(shared, DTensor):     # plain operands: every rank's same value
            shared = DTensor.from_local(shared, mesh, [Replicate()] * mesh.ndim, run_check=False)
        y = y + shared
    return y, aux
