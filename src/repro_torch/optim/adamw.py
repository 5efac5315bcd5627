"""AdamW with global-norm clipping and decay masking, as a plain transform
of trees of tensors.

Twin of the reference's ``optim/adamw.py``.  State layout mirrors the
param tree: ``{"m": tree, "v": tree, "count": int32}``.  The reference
returns new trees and donates the old buffers to XLA; here
:func:`adamw_update` writes the parameters, ``m``, ``v`` and ``count`` in
place under ``torch.no_grad()`` (a new tensor a leaf would add ~30 GB at
gemma-2b's 2.5 B parameters).  The leaves are walked in JAX's flatten
order (``tree.flatten_with_path``): the float32 sum of :func:`global_norm`
and the decay mask's paths follow the reference's.  The step, the
warmup, the cosine and the bias corrections are float32 tensors, as the
reference's are.

On an LM mesh the leaves are DTensors: the norm sums every shard (a
partial sum reduced once), and a ZeRO-1 moment sharded over 'data' where
its parameter is not takes the grad in its own layout, then the update
goes back to the parameter's (``redistribute_like``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel.axes import redistribute_like
from repro_torch.tree import flatten_with_path, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"        # constant | cosine
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _decay_mask(path: Tuple, leaf) -> bool:
    """Weight decay on matrices only (no norms/biases/gates/embedding-scale).

    Kept from the reference as it is: a stacked superblock leaf has an extra
    axis, so a 1-D gate or bias not named as excluded (``ssm_a_log``,
    ``mix_beta``, ``ssm_dt_bias``) decays inside ``blocks`` but not in the
    unrolled ``prefix`` tuple."""
    names = [k if isinstance(k, str) else "" for k in path]
    if any(n.startswith(("ln", "norm", "final_norm", "b_", "scale")) for n in names):
        return False
    return leaf.ndim >= 2


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The float32 learning rate at ``step``: linear warmup, then constant
    or a cosine down to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 moments of the parameters' layout and an int32 count,
    on the parameters' device."""
    device = leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf by leaf in JAX's order."""
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params,
    grads,
    state: Dict[str, Any],
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step, in place.  Returns (params, state, metrics): the
    same ``params`` and ``state`` objects, updated."""
    count = state["count"] + 1
    lr = schedule_lr(cfg, count)

    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)

    countf = count.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, countf)
    b2c = 1.0 - torch.pow(cfg.b2, countf)

    for (path, p), g, m, v in zip(flatten_with_path(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"])):
        # the reference's expressions, one rounding an operation, with at
        # most three leaf-sized temporaries at a time
        gf = redistribute_like(g.float() * scale, m)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        del gf
        upd = torch.sqrt(v / b2c).add_(cfg.eps)
        upd = (m / b1c).div_(upd)
        if cfg.weight_decay and _decay_mask(path, p):
            upd.add_(cfg.weight_decay * redistribute_like(p.float(), upd))
        p.copy_(p.float() - lr * redistribute_like(upd, p))
    state["count"] = count
    return params, state, {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
