"""Self-healing primitives for the serving stack: typed errors, retry
policy, and per-plan circuit breakers.

A copy of the JAX package's module (pure Python; the port may
not import the reference package).  The fleet's plan-cache architecture
(``OverlayPlan`` -> ``compile_plan``, one frozen hashable key per
executable) is what makes *graceful degradation* cheap: when a plan keeps
failing, the fleet re-dispatches the same work on a degraded sibling plan
(``hopper -> torch``, 2-D mesh -> app-only -> one device, tiled ->
untiled; see :func:`repro_torch.core.plan.fallback_chain`) and the
degraded executable is just another cache entry -- every step of the
chain is bitwise-equal to the primary.  This module contributes the three policy pieces the
fleet threads around that chain:

* a typed exception hierarchy (:class:`ServiceError` and friends) shared
  by the runtime and serving layers -- defined HERE, at the bottom of the
  import graph, because ``runtime.fleet`` raises them and
  ``serve.service`` re-exports them as its public surface (serve imports
  runtime, never the reverse);
* :class:`RetryPolicy` -- bounded attempts with a *deterministic*
  exponential backoff schedule, retrying only transient failure classes;
* :class:`CircuitBreaker` / :class:`BreakerBoard` -- per-plan-key
  CLOSED -> OPEN -> HALF_OPEN state machines with an injectable clock,
  recording every transition for ``FleetStats.breaker_events``.

Nothing here imports jax: the policies are pure host-side control flow,
cheap enough to sit on the dispatch path unconditionally.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


# -- typed exception hierarchy ------------------------------------------------
#
# ServiceError is the base every serving-path failure derives from, so a
# caller can catch one class and still tell admission-time rejections
# (AdmissionError, raised before a ticket exists) from post-admission
# losses (DispatchError and subclasses, always routed to the ticket or
# JobHandle that owns them -- never to an unrelated tenant).


class ServiceError(RuntimeError):
    """Base of every typed serving failure (admission, dispatch, timeout)."""


class DispatchError(ServiceError):
    """An admitted request was lost or failed after submit: the batch it
    rode crashed, the worker serving it died mid-dispatch, or the fleet
    exhausted its plans.  Always delivered to the owning ticket/handle."""


class QuarantinedError(DispatchError):
    """A request isolated by bisection quarantine: every plan in the
    fallback chain failed on it (alone, in a batch of one), so the fleet
    fails THIS ticket and serves the survivors.  Carries the quarantined
    ticket and the last underlying cause."""

    def __init__(self, ticket: int, app: str = "", cause: Optional[BaseException] = None):
        self.ticket = int(ticket)
        self.app = app
        self.cause = cause
        detail = f" (app {app!r})" if app else ""
        why = f": {cause!r}" if cause is not None else ""
        super().__init__(
            f"request {ticket}{detail} quarantined after exhausting the "
            f"retry budget on every plan in the fallback chain{why}"
        )


class JobTimeout(ServiceError, TimeoutError):
    """A JobHandle.result(timeout=) expired, or a request blew its
    per-request hard timeout while queued.  Subclasses TimeoutError so
    pre-hierarchy callers catching the stdlib class keep working."""


class TransientError(RuntimeError):
    """Marker base: failures of this class may succeed on retry (the
    retry policy's default transient classification)."""


class PoisonedOutputError(DispatchError, TransientError):
    """The NaN/Inf output guard rejected a dispatch's result for one or
    more requests.  Transient by default: a re-dispatch re-rolls
    rate-based corruption; persistent poison ends in quarantine."""

    transient = True


def _check_positive(name: str, value: float) -> None:
    if value <= 0:
        raise ValueError(f"{name} must be > 0, got {value}")


# -- retry policy -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with a deterministic exponential backoff schedule.

    ``backoff_s(i)`` is a pure function of the retry index ``i`` (0 for
    the first retry): ``min(base * multiplier**i, max)``.  No jitter --
    determinism is a feature here (the chaos suite asserts exact
    schedules), and the fleet's retries are per-flush serialized so
    thundering herds cannot form.

    ``should_retry`` gates WHICH failures burn attempts: only transient
    classes (:class:`TransientError` subclasses, or any exception carrying
    an explicit boolean ``transient`` attribute, e.g. an injected fault).
    Everything else fails over to the next plan in the fallback chain
    immediately -- retrying a deterministic error is pure added latency.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.005
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 0.1

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        _check_positive("backoff_base_s", self.backoff_base_s)
        _check_positive("backoff_multiplier", self.backoff_multiplier)
        _check_positive("backoff_max_s", self.backoff_max_s)

    def backoff_s(self, retry_index: int) -> float:
        return min(
            self.backoff_base_s * self.backoff_multiplier ** retry_index,
            self.backoff_max_s,
        )

    def schedule(self) -> Tuple[float, ...]:
        """The full deterministic backoff schedule (one entry per retry)."""
        return tuple(self.backoff_s(i) for i in range(self.max_attempts - 1))

    def should_retry(self, exc: BaseException) -> bool:
        explicit = getattr(exc, "transient", None)
        if explicit is not None:
            return bool(explicit)
        return isinstance(exc, TransientError)


# -- circuit breaker ----------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One plan key's CLOSED -> OPEN -> HALF_OPEN state machine.

    CLOSED counts *consecutive* failures; at ``failure_threshold`` the
    breaker opens (the fleet stops offering the plan traffic).  After
    ``cooldown_s`` the next :meth:`allow` admits exactly ONE half-open
    probe; its outcome closes the breaker (recovered) or re-opens it for
    another cooldown.  The clock is injectable so transition tests never
    sleep.  Every transition is appended to ``events`` (a list shared
    with the owning :class:`BreakerBoard`, which ``FleetStats`` exposes).
    """

    def __init__(
        self,
        key: str,
        failure_threshold: int = 3,
        cooldown_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
        events: Optional[List[Dict[str, Any]]] = None,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        _check_positive("cooldown_s", cooldown_s)
        self.key = key
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.events = events if events is not None else []
        self.state = CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0

    def _transition(self, state: str, event: str) -> None:
        self.state = state
        self.events.append({
            "plan": self.key,
            "event": event,
            "t": self._clock(),
            "consecutive_failures": self.consecutive_failures,
        })

    def allow(self) -> bool:
        """May this plan take traffic right now?  OPEN breakers admit one
        half-open probe per cooldown window."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN, "half_open")
                return True
            return False
        # HALF_OPEN: the single probe is already in flight this window.
        return False

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self.consecutive_failures = 0
            self._transition(CLOSED, "close")
        else:
            self.consecutive_failures = 0

    def record_failure(self, reason: str = "dispatch") -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self._opened_at = self._clock()
            self._transition(OPEN, f"reopen:{reason}")
        elif self.state == CLOSED and (
            self.consecutive_failures >= self.failure_threshold
        ):
            self._opened_at = self._clock()
            self._transition(OPEN, f"open:{reason}")


class BreakerBoard:
    """Lazily-built registry of per-plan-key breakers sharing one event
    log and one (injectable) clock.  The fleet keys breakers by
    ``OverlayPlan.key()``, so every candidate in a fallback chain trips
    and recovers independently."""

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.events: List[Dict[str, Any]] = []

    def breaker(self, key: str) -> CircuitBreaker:
        br = self._breakers.get(key)
        if br is None:
            br = CircuitBreaker(
                key, self.failure_threshold, self.cooldown_s,
                clock=self._clock, events=self.events,
            )
            self._breakers[key] = br
        return br

    def states(self) -> Dict[str, str]:
        return {key: br.state for key, br in self._breakers.items()}

    def all_closed(self) -> bool:
        return all(br.state == CLOSED for br in self._breakers.values())
