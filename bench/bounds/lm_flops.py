"""A served decoder's model operations, from the configuration's ``model``
numbers alone: 2 operations (a multiply-add) for each parameter a token
meets -- attention's four projections, the dense layers' MLP, in an MoE
layer the router, the top-k routed experts of the n and the shared
experts -- and for the unembedding where logits are made (every decode
token, a prompt's last token); plus attention's 4 x layers x heads x
head_dim for each position a token attends (its scores and its weighted
sum).  Embedding lookups and norms count nothing.
"""


def _mlp(model: dict, width: int) -> int:
    return 3 * int(model["hidden_size"]) * width


def layer_params(model: dict) -> int:
    """Parameters one token meets in all the layers."""
    D = int(model["hidden_size"])
    H, G, hd = (int(model[k]) for k in ("num_attention_heads", "num_key_value_heads", "head_dim"))
    attn = 2 * D * H * hd + 2 * D * G * hd
    layers = int(model["num_hidden_layers"])
    dense = int(model.get("first_k_dense_replace", 0))
    experts = int(model.get("n_routed_experts", 0))
    if not experts:
        return layers * (attn + _mlp(model, int(model["dense_intermediate_size"])))
    F = int(model["moe_intermediate_size"])
    moe = (D * experts + int(model["num_experts_per_tok"]) * _mlp(model, F)
           + _mlp(model, F * int(model["n_shared_experts"])))
    return (dense * (attn + _mlp(model, int(model["dense_intermediate_size"])))
            + (layers - dense) * (attn + moe))


def attention_per_position(model: dict) -> int:
    return 4 * int(model["num_hidden_layers"]) * int(model["num_attention_heads"]) \
        * int(model["head_dim"])


def unembed(model: dict) -> int:
    return 2 * int(model["hidden_size"]) * int(model["vocab_size"])


def decode_flops(model: dict, active: int, kv_rows: int) -> float:
    """One tick: ``active`` tokens attending over ``kv_rows`` positions in all."""
    return float(active * (2 * layer_params(model) + unembed(model))
                 + attention_per_position(model) * kv_rows)


def prefill_flops(model: dict, tokens: int) -> float:
    """One prompt of ``tokens``: position ``i`` attends ``i + 1`` positions."""
    return float(tokens * 2 * layer_params(model) + unembed(model)
                 + attention_per_position(model) * tokens * (tokens + 1) // 2)
