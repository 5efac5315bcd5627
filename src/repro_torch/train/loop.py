"""The training loop: data -> step -> heartbeat -> checkpoint -> resume.

Twin of the reference's ``train/loop.py``, with the same protocol:

* resumes from the newest committed checkpoint (crash-restart protocol);
* checkpoints asynchronously every ``ckpt_every`` steps, and once more at
  the end if the last step was not saved;
* the heartbeat monitor flags straggler steps and calls the mitigation
  hook;
* deterministic data pipeline keyed by the global step -- no loader state.

Parameters are drawn from a ``torch.Generator`` seeded with
``LoopConfig.seed`` on ``device`` (the card unless the caller asks for the
CPU).  With a ``plan`` every rank of the plan's mesh runs the loop: the
state is laid out by the plan, each step's batch comes from
``TokenPipeline.device_batch_at`` and the step is the plan-based one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.interpreter import check_device
from repro_torch.data import TokenPipeline
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import HeartbeatMonitor, resume_or_init
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    straggler_hook: Optional[Callable[[int, float], None]] = None


def train_loop(
    lm: LM,
    loop_cfg: LoopConfig,
    opt_cfg: AdamWConfig,
    pipeline: TokenPipeline,
    plan=None,
    prefix_embed_fn: Optional[Callable[[int], np.ndarray]] = None,
    device="cuda",
) -> Dict[str, List[float]]:
    """Run `loop_cfg.steps` steps; returns the metric history."""
    step_fn, _ = make_train_step(lm, plan, opt_cfg)
    device = check_device(device)

    def init_fn():
        params, opt = init_train_state(lm, plan, loop_cfg.seed, device)
        return {"params": params, "opt": opt}

    ckpt = Checkpointer(loop_cfg.ckpt_dir) if loop_cfg.ckpt_dir else None
    if ckpt is not None:
        state = resume_or_init(ckpt, init_fn)
        start, tree = state.step, state.tree
    else:
        start, tree = 0, init_fn()
    params, opt_state = tree["params"], tree["opt"]

    monitor = HeartbeatMonitor()
    history: Dict[str, List[float]] = {"loss": [], "step": [], "dt": []}
    tokens_per_step = pipeline.global_batch * pipeline.seq_len
    last_saved = start if ckpt is not None else None

    for step in range(start, loop_cfg.steps):
        if plan is None:
            batch = torch.as_tensor(pipeline.batch_at(step), device=device)
        else:
            batch = pipeline.device_batch_at(step, plan.mesh, plan.token_sharding().placements)
        pe = None
        if prefix_embed_fn is not None:
            pe = torch.as_tensor(prefix_embed_fn(step), device=device)
        monitor.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch, pe)
        loss = float(metrics["loss"])
        dt = monitor.stop(step)
        if monitor.stragglers and monitor.stragglers[-1][0] == step:
            if loop_cfg.straggler_hook:
                loop_cfg.straggler_hook(step, dt)
        history["loss"].append(loss)
        history["step"].append(step)
        history["dt"].append(dt)
        if loop_cfg.log_every and step % loop_cfg.log_every == 0:
            tps = tokens_per_step / max(dt, 1e-9)
            print(
                f"step {step:5d}  loss {loss:.4f}  "
                f"grad_norm {float(metrics['grad_norm']):.3f}  "
                f"{tps:,.0f} tok/s"
            )
        if ckpt is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state}, blocking=False)
            last_saved = step + 1

    if ckpt is not None:
        ckpt.wait()  # drain the async writer before any final write
        if last_saved != loop_cfg.steps:
            ckpt.save(loop_cfg.steps, {"params": params, "opt": opt_state},
                      blocking=True)
    history["throughput_tok_s"] = [monitor.throughput(tokens_per_step)]
    history["_final"] = [float(history["loss"][-1]) if history["loss"] else float("nan")]
    return history
