"""What one run recorded, as the metric readers see it.

Every reader in ``bench/metrics/`` gets one run record and returns a
number, or ``None`` where the run holds nothing for it to read (the
harness then leaves that metric out of the result line): a :class:`Run`
of the image service, or an :class:`LMRun` of a served language model.
The fields both share (the window, set-up, the trace) have one name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

#: ``FleetStats`` counters and ``PixieFleet.timings`` the harness snapshots
#: at the edges of the window (read-only, from the driving thread).
#: The self-healing ladder's counters: 0 on a sound run.
LADDER = ("retries", "fallback_dispatches", "quarantined_requests", "guard_failures")
#: ``overlay_builds`` stays 0 over the window: nothing builds inside it.
FLEET_COUNTERS = ("executed", "dispatches", "partial_tile_dispatches", "overlay_builds") + LADDER
FLEET_TIMINGS = ("pack_s",)


def fleet_snapshot(fleet) -> Dict[str, float]:
    snap = {k: getattr(fleet.stats, k) for k in FLEET_COUNTERS}
    snap.update({k: fleet.timings.get(k, 0.0) for k in FLEET_TIMINGS})
    return snap


@dataclasses.dataclass
class Request:
    """One request as its client saw it (host clock, ``perf_counter``)."""

    client: int
    key: str                      # app, or a chain's stages joined by "+"
    hw: Tuple[int, int]
    frame: int                    # index in the size's pool
    t_submit: float
    t_done: float
    queue_s: Optional[float] = None   # the front end's own stamp: submit -> flush start
    flush_s: Optional[float] = None   # the front end's own stamp: the serving flush
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class Trace:
    """The device's activity in the traced window, on the host's clock.

    ``device``: every kernel, copy and set on the card, ``(name, start,
    end)`` in seconds, clipped to the window; ``busy_s``: their union."""

    t_start: float
    t_end: float
    device: List[Tuple[str, float, float]]
    busy_s: float
    breakdown: dict

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def device_s(self, pattern) -> float:
        """Seconds of device work whose name matches ``pattern`` (a
        compiled regular expression)."""
        return sum(end - start for name, start, end in self.device if pattern.search(name))


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    dtype: str
    batch_tile: int
    seconds: float
    setup_seconds: float
    t_start: float
    t_end: float
    requests: List[Request]
    fleet_start: Dict[str, float]
    fleet_end: Dict[str, float]
    trace: Optional[Trace] = None
    #: Seconds of each step of set-up, in order (imports, frames, ...).
    setup_phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: The host's CPU shares over the window (busy, stolen by the hypervisor).
    host_cpu: str = "not read"

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def completed(self) -> List[Request]:
        """Requests answered inside the window."""
        return [r for r in self.requests if r.ok and self.t_start <= r.t_done <= self.t_end]

    def failed(self) -> List[Request]:
        """Requests that raised, timed out or were shed inside the window."""
        return [r for r in self.requests if not r.ok and self.t_start <= r.t_done <= self.t_end]

    def delta(self, counter: str) -> float:
        """A fleet counter's or timing's growth over the window."""
        return self.fleet_end[counter] - self.fleet_start[counter]

    def traced(self) -> List[Request]:
        """Requests whose flush started inside the traced window: the work
        the trace's kernels did, up to one flush at either edge."""
        if self.trace is None:
            return []
        return [r for r in self.requests if r.ok and r.queue_s is not None
                and self.trace.t_start <= r.t_submit + r.queue_s <= self.trace.t_end]


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics), or
    ``None`` for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class Stream:
    """One served language-model request as its client saw it (host
    clock): the times each output token reached the host, the first one
    when ``add_request`` returned."""

    client: int
    index: int                    # the client's request number, from 0
    prompt_len: int
    target: int                   # output tokens the client asked for
    t_submit: float               # the client's request sent: its last one done
    token_times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class Tick:
    """One ``SlotServer.tick``: host span, the slots it decoded for
    requests, and the cache rows those slots attend over (each slot's
    prompt and output so far)."""

    t0: float
    t1: float
    active: int
    kv_rows: int


@dataclasses.dataclass
class Prefill:
    """One ``SlotServer.add_request``: host span and prompt tokens."""

    t0: float
    t1: float
    tokens: int


@dataclasses.dataclass
class LMRun:
    cell: str
    config: dict
    traffic: dict
    seconds: float
    setup_seconds: float
    t_start: float
    t_end: float
    streams: List[Stream]
    ticks: List[Tick]
    prefills: List[Prefill]
    trace: Optional[Trace] = None
    setup_phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    host_cpu: str = "not read"

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def inside(self, t: float) -> bool:
        return self.t_start <= t <= self.t_end

    def window_ticks(self) -> List[Tick]:
        """Ticks that started inside the window."""
        return [k for k in self.ticks if self.inside(k.t0)]

    def window_prefills(self) -> List[Prefill]:
        """Prefills that started inside the window."""
        return [p for p in self.prefills if self.inside(p.t0)]

    def completed(self) -> List[Stream]:
        """Requests whose last token came inside the window."""
        return [s for s in self.streams if s.ok and s.t_done is not None
                and self.inside(s.t_done)]

    def failed(self) -> List[Stream]:
        """Requests that raised: inside the window, or after it before
        the load stopped (a run is never left with a raise uncounted)."""
        return [s for s in self.streams if not s.ok and s.t_done is not None
                and s.t_done >= self.t_start]
