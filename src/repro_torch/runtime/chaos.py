"""Deterministic fault injection for the serving stack.

A :class:`FaultInjector` is installed with ``PixieFleet(faults=...)`` /
``StreamingFrontend(faults=...)`` and fires at five named hook points at
layer boundaries:

========================  ====================================================
hook point                where it fires
========================  ====================================================
``"compile"``             ``PixieFleet.overlay_executable`` on a plan-cache
                          miss, before ``compile_plan`` runs (a cached plan
                          cannot fail to compile, so hits never fire)
``"dispatch"``            inside each ``PixieFleet._dispatch_*``, immediately
                          before the overlay executable is invoked
``"nan_output"``          after a dispatch returns: matched app slots of the
                          output batch are overwritten with NaN (inexact
                          dtypes only -- integer fabrics cannot encode NaN,
                          so the spec is a no-op there)
``"transfer_stall"``      same site as ``"dispatch"``, but sleeps
                          ``delay_s`` instead of raising -- the straggler
                          that ``HeartbeatMonitor`` exists to catch
``"worker_death"``        top of the ``StreamingFrontend`` worker loop --
                          the supervisor must restart the thread and strand
                          no ``JobHandle``
========================  ====================================================

Specs are *deterministic and seedable*: all randomness comes from one
``random.Random(seed)``, so a chaos run replays exactly given the same
dispatch schedule.  ``match=`` restricts a spec to dispatches whose
context tokens contain one of the given substrings; the fleet stamps
tokens ``plan:<OverlayPlan.key()>``, ``<ticket:N>`` and ``<app:name>``
(tickets/apps are bracket-delimited so ``<ticket:1>`` never
substring-matches ``<ticket:12>``).

Zero overhead when absent: callers hold ``faults=None`` and skip every
hook behind a single attribute check; no injector objects exist on the
happy path.

A copy of the reference package's ``runtime/chaos.py`` over the port's
:mod:`repro_torch.runtime.resilience`: the draws come from the same
``random.Random(seed)`` in the same order, so one seed gives one fault
schedule in both packages.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.resilience import TransientError

HOOK_POINTS = (
    "compile", "dispatch", "nan_output", "transfer_stall", "worker_death",
)


class InjectedFault(TransientError):
    """Raised by a firing fault spec.  ``transient`` mirrors the spec:
    the retry policy retries transient injections and fails over
    immediately on persistent ones (exactly like real faults)."""

    def __init__(self, point: str, detail: str = "", transient: bool = True):
        self.point = point
        self.transient = bool(transient)
        kind = "transient" if transient else "persistent"
        super().__init__(
            f"injected {kind} fault at hook point {point!r}"
            + (f": {detail}" if detail else "")
        )


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: fires at ``point`` with probability ``rate`` per
    eligible event, at most ``max_fires`` times, only on events whose
    tokens contain a ``match`` substring (None = every event)."""

    point: str
    rate: float = 1.0
    max_fires: Optional[int] = None
    transient: bool = True
    match: Optional[Tuple[str, ...]] = None
    delay_s: float = 0.05
    detail: str = ""
    fires: int = 0

    def exhausted(self) -> bool:
        return self.max_fires is not None and self.fires >= self.max_fires

    def matches(self, tokens: Sequence[str]) -> bool:
        if self.match is None:
            return True
        return any(m in tok for tok in tokens for m in self.match)


class FaultInjector:
    """A seeded bundle of fault specs; see the module docstring for the
    hook-point map.  Single-owner by design: the streaming worker thread
    (or the caller's flush loop) is the only consumer, so draws stay
    deterministic without locking.

    >>> faults = (FaultInjector(seed=7)
    ...           .inject("dispatch", rate=1.0, max_fires=2)
    ...           .inject("nan_output", match=("<app:threshold>",)))
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(int(seed))
        self._specs: Dict[str, List[FaultSpec]] = {}
        self.fired: Dict[str, int] = {}

    def inject(
        self,
        point: str,
        *,
        rate: float = 1.0,
        max_fires: Optional[int] = None,
        transient: bool = True,
        match: Optional[Sequence[str]] = None,
        delay_s: float = 0.05,
        detail: str = "",
    ) -> "FaultInjector":
        """Arm one fault spec; returns self so specs chain."""
        if point not in HOOK_POINTS:
            raise ValueError(
                f"unknown hook point {point!r}; one of {HOOK_POINTS}"
            )
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self._specs.setdefault(point, []).append(FaultSpec(
            point=point, rate=rate, max_fires=max_fires, transient=transient,
            match=None if match is None else tuple(match),
            delay_s=delay_s, detail=detail,
        ))
        return self

    def _draw(self, spec: FaultSpec) -> bool:
        return spec.rate >= 1.0 or self._rng.random() < spec.rate

    def _count(self, spec: FaultSpec) -> None:
        spec.fires += 1
        self.fired[spec.point] = self.fired.get(spec.point, 0) + 1

    def fire(self, point: str, tokens: Sequence[str] = ()) -> None:
        """Evaluate every armed spec at ``point``.  Stall specs sleep;
        any other firing spec raises :class:`InjectedFault`."""
        for spec in self._specs.get(point, ()):
            if spec.exhausted() or not spec.matches(tokens):
                continue
            if not self._draw(spec):
                continue
            self._count(spec)
            if point == "transfer_stall":
                time.sleep(spec.delay_s)
                continue
            raise InjectedFault(point, spec.detail, transient=spec.transient)

    def corrupt_slots(self, item_tokens: Sequence[Sequence[str]]) -> List[int]:
        """Which app slots of the current dispatch get NaN-poisoned.
        Matched specs poison every matching item; unmatched specs draw
        once per dispatch and poison one seeded-random slot."""
        out: set = set()
        for spec in self._specs.get("nan_output", ()):
            if spec.exhausted():
                continue
            if spec.match is not None:
                hit = [i for i, toks in enumerate(item_tokens)
                       if spec.matches(toks)]
                if hit and self._draw(spec):
                    self._count(spec)
                    out.update(hit)
            elif item_tokens and self._draw(spec):
                self._count(spec)
                out.add(self._rng.randrange(len(item_tokens)))
        return sorted(out)
