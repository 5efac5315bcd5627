"""The train step: loss -> autograd grads -> optional error-feedback int8
compression -> clip -> AdamW.

Twin of the reference's ``train/step.py``.  Without a plan the step runs
eagerly on one device and :func:`repro_torch.optim.adamw_update` writes
the params and moments in place.  With a :class:`ShardingPlan` over a
``DeviceMesh`` (one process per card) the params are DTensors laid out
tensor-parallel by the plan, the moments ZeRO-1 (sharded over 'data' as
well), the tokens batch-sharded; the LM's functions run on those
DTensors under the ambient mesh, whose collectives DTensor inserts where
the reference's GSPMD would, and each grad is reduced into its
parameter's layout before the update.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.interpreter import check_device
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, adamw_update, compress, decompress, init_opt_state
from repro_torch.parallel.axes import lm_mesh, redistribute_like
from repro_torch.parallel.sharding import NamedSharding, ShardingPlan, place, place_tree
from repro_torch.tree import leaves, unflatten_like


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


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
    flat = leaves(params)
    diff = [p.detach().requires_grad_() for p in flat]
    loss, metrics = lm.loss(unflatten_like(params, diff), tokens, prefix_embeds)
    grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    del diff
    # on a mesh: each grad (a partial sum over the batch shards) reduced
    # into its parameter's layout
    grads = unflatten_like(params, [redistribute_like(g, p) for g, p in zip(grads, flat)])

    if grad_compress:
        comp, err_state = compress(grads, err_state)
        grads = decompress(comp)

    params, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
    out_metrics = {k: _plain(v.detach()) for k, v in {"loss": loss, **metrics, **om}.items()}
    if grad_compress:
        return params, opt_state, err_state, out_metrics
    return params, opt_state, out_metrics


def _mesh_of(plan: ShardingPlan):
    mesh = plan.mesh
    if not hasattr(mesh, "mesh_dim_names"):
        raise ValueError("a plan over a shape-only mesh has no process group to train on; "
                         "build the mesh with repro_torch.launch.mesh")
    return mesh


def make_train_step(lm: LM, plan=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    grad_compress: bool = False):
    """Returns ``(step, in_shardings)``: ``step(params, opt_state, tokens,
    prefix_embeds=None, err_state=None)`` is :func:`train_step` bound to
    ``lm`` and ``opt_cfg``.

    With a ``plan``, ``in_shardings`` is the reference's tuple (params,
    moments, tokens[, prefix embeds][, error state]), each a tree of
    :class:`NamedSharding`, and the step places every input by it (a plain
    tensor is taken as the full value, the same on every rank) and runs on
    the plan's mesh.  Without one, ``in_shardings`` is None."""
    if plan is None:
        def step(params, opt_state, tokens, prefix_embeds=None, err_state=None):
            return train_step(lm, opt_cfg, params, opt_state, tokens, prefix_embeds,
                              grad_compress=grad_compress, err_state=err_state)

        return step, None

    mesh = _mesh_of(plan)
    abstract = lm.abstract_params()
    in_sh = [plan.param_shardings(abstract), plan.opt_shardings(abstract),
             plan.token_sharding()]
    prefix_sh = NamedSharding(mesh, plan.batch_spec(3))
    if lm.cfg.modality == "vision_stub":
        in_sh.append(prefix_sh)
    if grad_compress:
        in_sh.append(in_sh[0])                        # error tree ~ param specs

    def step(params, opt_state, tokens, prefix_embeds=None, err_state=None):
        params = place_tree(params, in_sh[0])
        opt_state = place_tree(opt_state, in_sh[1])
        tokens = place(tokens, in_sh[2])
        if prefix_embeds is not None:
            prefix_embeds = place(prefix_embeds, prefix_sh)
        if err_state is not None:
            err_state = place_tree(err_state, in_sh[0])
        with lm_mesh(mesh), implicit_replication():
            return train_step(lm, opt_cfg, params, opt_state, tokens, prefix_embeds,
                              grad_compress=grad_compress, err_state=err_state)

    return step, tuple(in_sh)


def init_train_state(lm: LM, plan=None, seed: int = 0, device="cuda"):
    """(params, opt_state): float32 parameters drawn from a generator seeded
    with ``seed`` on ``device``, and zero AdamW state; with a ``plan``,
    every rank draws the same values and keeps its blocks of them, laid
    out by the plan (params tensor-parallel, moments ZeRO-1)."""
    device = check_device(device)
    params = lm.init(torch.Generator(device=device).manual_seed(seed))
    opt_state = init_opt_state(params)
    if plan is None:
        return params, opt_state
    if _mesh_of(plan).device_type != device.type:
        raise ValueError(f"the plan's mesh is on {plan.mesh.device_type}, not {device.type}")
    return (place_tree(params, plan.param_shardings(params)),
            place_tree(opt_state, plan.opt_shardings(params)))
