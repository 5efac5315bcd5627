"""The reference's parameter, cache and optimizer-state pytrees, as numpy arrays, into the
port's dicts of tensors, leaf by leaf (both packages keep one layout).

Hand it ``jax.tree_util.tree_map(np.asarray, params)``: dicts stay dicts,
tuples and lists stay tuples and lists, every array becomes a tensor on
``device`` (the card unless the caller asks for the CPU, as the port's
entry points do) with its dtype (bfloat16 arrays included, which numpy holds
through the ``ml_dtypes`` extension type and ``torch.from_numpy`` does not
take).
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: JAX hands out read-only buffers
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(v, device) for v in tree)
    return _leaf(tree, device)


def _require(tree, keys, what):
    missing = [k for k in keys if k not in tree]
    if missing:
        raise ValueError(f"not a {what} tree: missing {missing}")


def params_from_numpy(tree, device="cuda"):
    """The reference LM's parameters (``embed``, ``final_norm``, ``blocks``,
    and where the config has them the ``prefix`` tuple of unrolled layers
    and the ``meta`` tokens; every kind's leaves, ``moe`` and the recurrent
    kinds' included) as the port's."""
    _require(tree, ("embed", "final_norm", "blocks"), "parameter")
    return _tree(tree, device)


def cache_from_numpy(tree, device="cuda"):
    """The reference LM's decode cache (``blocks``, and the ``prefix``
    tuple where the config has one: bf16 k/v, ring or full, and the
    float32 recurrent states) as the port's."""
    _require(tree, ("blocks",), "cache")
    return _tree(tree, device)


def opt_state_from_numpy(tree, device="cuda"):
    """The reference's AdamW state (``m`` and ``v``, float32 trees of the
    parameters' layout, and the int32 step ``count``) as the port's."""
    _require(tree, ("m", "v", "count"), "optimizer-state")
    return _tree(tree, device)
