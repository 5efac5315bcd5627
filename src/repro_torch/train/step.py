"""The train step: loss -> autograd grads -> optional error-feedback int8
compression -> clip -> AdamW.

Twin of the reference's ``train/step.py``.  The reference jits the step
with the arch's sharding plan (params tensor-parallel, moments ZeRO-1)
and donates the params and moments; here the step runs eagerly on one
device and :func:`repro_torch.optim.adamw_update` writes the params and
moments in place.  A sharding plan waits for the LM mesh over
``torch.distributed`` (ROADMAP Queue A item 6b): a ``plan`` raises, never
a silent single-device run.
"""

from __future__ import annotations

import torch

from repro_torch.core.interpreter import check_device
from repro_torch.models.lm import LM, MESH_ITEM
from repro_torch.optim import AdamWConfig, adamw_update, compress, decompress, init_opt_state
from repro_torch.tree import leaves, unflatten_like


def _no_plan(plan) -> None:
    if plan is not None:
        raise ValueError(f"a sharding plan waits for {MESH_ITEM}; pass plan=None to train "
                         "on one device")


def train_step(
    lm: LM,
    opt_cfg: AdamWConfig,
    params,
    opt_state,
    tokens: torch.Tensor,
    prefix_embeds=None,
    grad_compress: bool = False,
    err_state=None,
):
    """One full training step; ``params`` and ``opt_state`` are updated in
    place and returned.  Returns ``(params, opt_state, metrics)``, with
    ``grad_compress`` ``(params, opt_state, err_state, metrics)``."""
    # Autograd differentiates detached views of the leaves: they share the
    # parameters' storage, and the caller's tensors stay out of autograd.
    diff = [p.detach().requires_grad_() for p in leaves(params)]
    loss, metrics = lm.loss(unflatten_like(params, diff), tokens, prefix_embeds)
    grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    del diff
    grads = unflatten_like(params, grads)

    if grad_compress:
        comp, err_state = compress(grads, err_state)
        grads = decompress(comp)

    params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
    out_metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}
    if grad_compress:
        return params, opt_state, err_state, out_metrics
    return params, opt_state, out_metrics


def make_train_step(lm: LM, plan=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    grad_compress: bool = False):
    """Returns ``(step, None)``: ``step(params, opt_state, tokens,
    prefix_embeds=None, err_state=None)`` is :func:`train_step` bound to
    ``lm`` and ``opt_cfg`` (the reference's second item, the shardings,
    needs a plan)."""
    _no_plan(plan)

    def step(params, opt_state, tokens, prefix_embeds=None, err_state=None):
        return train_step(lm, opt_cfg, params, opt_state, tokens, prefix_embeds,
                          grad_compress=grad_compress, err_state=err_state)

    return step, None


def init_train_state(lm: LM, plan=None, seed: int = 0, device="cuda"):
    """(params, opt_state): float32 parameters drawn from a generator seeded
    with ``seed`` on ``device``, and zero AdamW state."""
    _no_plan(plan)
    device = check_device(device)
    params = lm.init(torch.Generator(device=device).manual_seed(seed))
    return params, init_opt_state(params)
