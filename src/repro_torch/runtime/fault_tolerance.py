"""Crash-restart state and straggler detection.

Twin of the reference package's ``runtime/fault_tolerance.py``:

* ``RunState`` + ``resume_or_init``: crash-restart protocol on top of the
  atomic checkpointer -- a restarted job resumes from the newest committed
  step; torn/partial checkpoints are skipped and garbage-collected.
  ``train/loop.py`` runs it.  On an LM mesh every rank runs it, and
  ``shardings`` places each restored leaf over the mesh.
* ``HeartbeatMonitor``: wall-clock duration tracker with a robust
  (median * k) straggler threshold.  The training loop feeds it every
  step's wall time; ``PixieFleet._settle_flush`` every flush's, and a
  flagged straggler counts as a circuit-breaker failure against the plans
  that flush dispatched (when the fleet is armed for resilience) -- see
  :mod:`repro_torch.runtime.resilience`.
* ``ElasticPlan``: DEPRECATED, as in the reference.  It plans LM-style
  (data, model) meshes that nothing here dispatches.  For degrading a
  *serving* plan, use :func:`repro_torch.core.plan.fallback_chain`.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import Checkpointer


@dataclasses.dataclass
class RunState:
    step: int
    tree: object            # {"params": ..., "opt": ...}
    resumed: bool


def resume_or_init(
    ckpt: Checkpointer,
    init_fn: Callable[[], object],
    like=None,
    shardings=None,
) -> RunState:
    """Restart protocol: newest committed checkpoint wins; otherwise init.
    Without ``like``, ``init_fn()``'s tree is the template the checkpoint
    is restored into; ``shardings`` (``NamedSharding`` trees in the
    template's structure) places the restored leaves over an LM mesh."""
    ckpt.cleanup_tmp()
    template = like
    if template is None:
        template = init_fn()
        step, tree = ckpt.restore_latest(template, shardings)
        if step is None:
            return RunState(step=0, tree=template, resumed=False)
        return RunState(step=step, tree=tree, resumed=True)
    step, tree = ckpt.restore_latest(template, shardings)
    if step is None:
        return RunState(step=0, tree=init_fn(), resumed=False)
    return RunState(step=step, tree=tree, resumed=True)


class HeartbeatMonitor:
    """Step-time heartbeats with straggler detection.

    A step is a straggler when its duration exceeds ``factor`` x the
    rolling median of the last ``window`` samples (at least 8 of them).
    """

    def __init__(self, window: int = 32, factor: float = 3.0):
        self.window = window
        self.factor = factor
        self.durations: List[float] = []
        self.stragglers: List[Tuple[int, float, float]] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.record(step, dt)
        return dt

    def record(self, step: int, duration: float) -> bool:
        """Returns True if `duration` is flagged as a straggler."""
        hist = self.durations[-self.window :]
        self.durations.append(duration)
        if len(hist) >= 8:
            med = float(np.median(hist))
            if duration > self.factor * med:
                self.stragglers.append((step, duration, med))
                return True
        return False

    def throughput(self, tokens_per_step: int) -> float:
        if not self.durations:
            return 0.0
        return tokens_per_step / float(np.median(self.durations))


@dataclasses.dataclass
class ElasticPlan:
    """DEPRECATED re-mesh decision when the healthy device count changes.

    Plans LM-style (data, model) meshes that no longer match anything the
    overlay runtime dispatches.  Use
    :func:`repro_torch.core.plan.fallback_chain` for serving-plan
    degradation.
    """

    old_shape: Tuple[int, ...]
    new_devices: int
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        warnings.warn(
            "ElasticPlan is deprecated: it plans LM-style (data, model) "
            "meshes the overlay runtime never dispatches; use "
            "repro_torch.core.plan.fallback_chain instead",
            DeprecationWarning, stacklevel=2,
        )

    def plan(self) -> Optional[Tuple[int, ...]]:
        """Largest mesh of the same rank that fits `new_devices`, keeping
        the model axis fixed (TP degree is a property of the weights) and
        shrinking data-parallel axes.  None if impossible."""
        model = self.old_shape[-1]
        if self.new_devices < model:
            return None
        data_total = self.new_devices // model
        if len(self.old_shape) == 2:
            return (data_total, model)
        # (pod, data, model): fold pods into data if pods no longer full
        pods = min(self.old_shape[0], max(1, data_total // self.old_shape[1]))
        data = data_total // pods
        return (pods, data, model)

    def can_restore(self) -> bool:
        return self.plan() is not None
