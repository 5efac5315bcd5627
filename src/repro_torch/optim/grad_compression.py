"""Error-feedback int8 gradient compression for the data-parallel axis.

Twin of the reference's ``optim/grad_compression.py``, bitwise: before the
data-parallel all-reduce, gradients are quantised to int8 with a
per-tensor scale; the quantisation error is kept locally and added back
into the next step's gradient (error feedback).  ``torch.round``, like
``jnp.round``, rounds half to even.  On an LM mesh a leaf is a DTensor and
its scale the max over the whole leaf, every shard's.

    comp, new_err = compress(grads, err)      # int8 tree + carried error
    grads2        = decompress(comp)          # dequantised
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _quantise(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(grads, err_state) -> Tuple[Dict[str, Any], Any]:
    """Returns ({'q': int8 tree, 'scale': f32 tree}, new_error_tree)."""
    qs, scales, errs = [], [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        gs = g.float() + e
        q, scale = _quantise(gs)
        qs.append(q)
        scales.append(scale)
        errs.append(gs - q.float() * scale)
    comp = {"q": unflatten_like(grads, qs), "scale": unflatten_like(grads, scales)}
    return comp, unflatten_like(err_state, errs)


def decompress(comp: Dict[str, Any]):
    return unflatten_like(comp["q"], [q.float() * s for q, s in
                                      zip(leaves(comp["q"]), leaves(comp["scale"]))])
