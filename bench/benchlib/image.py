"""The image service as the system under test (a configuration without
``"system"``, or with ``"system": "image"``).

Set-up builds the configuration's grid and the port's streaming front end
(``benchlib.system``), and the frame pool from the seed; the load is the
closed loop of ``benchlib.load``; the check is ``benchlib.check``'s, the
configuration's plain reference on every sampled answer.  The runner
(``benchlib.runner``) calls these steps in this order: ``__init__``,
:meth:`warm`, :meth:`start`, :meth:`host_spans` (a traced run),
:meth:`open_window`, :meth:`close_window`, :meth:`drain`,
:meth:`close`, :meth:`record`, :meth:`check`.
"""

from __future__ import annotations

import time
from typing import List, Optional

from benchlib import check as chk
from benchlib import traffic as tr
from benchlib.load import ClosedLoop, warm
from benchlib.record import LADDER, Run, fleet_snapshot
from benchlib.system import build_frontend, build_grid
from benchlib.trace import BETWEEN_FLUSHES, IN_FLUSH, CallSpans

#: Answers a client keeps for the check, at seeded moments of the window.
CHECK_PER_CLIENT = 8


class System:
    """One run's image service: the front end, its grid, the frames and
    the clients.  ``control``: the grid's element type for the
    lower-precision control (``int16``), else the configuration's."""

    #: The name of an idle gap on the card outside every host span.
    between = BETWEEN_FLUSHES

    def __init__(self, cell, seed: int, seconds: float, device: str, marks: list,
                 control: Optional[str] = None, traffic_overrides: Optional[dict] = None):
        import repro_torch.serve  # noqa: F401 -- the port's import, timed on its own

        marks.append(("port import", time.perf_counter()))
        self.seed, self.seconds = seed, seconds
        self.traffic = {**cell.traffic, **(traffic_overrides or {})}
        self.dtype = control or cell.config["dtype"]
        self.grid = build_grid(cell.config, self.dtype)
        self.pools = tr.frame_pool(self.traffic, seed)
        marks.append(("frames", time.perf_counter()))
        self.mix_keys = sorted({tr.work_key(w) for w in self.traffic["mix"]})
        self.svc = build_frontend(cell.config, device)
        self.device = self.svc.device
        marks.append(("front end", time.perf_counter()))
        self.load = None

    def warm(self, stop) -> None:
        """Serve the cell's own work and sizes, then make the clients."""
        answer_dtype = warm(self.svc, self.grid, self.traffic, self.pools,
                            int(self.traffic["warm_rounds"]))
        self.load = ClosedLoop(self.svc, self.grid, self.traffic, self.seed, self.seconds,
                               self.pools, stop, CHECK_PER_CLIENT, answer_dtype)

    def start(self) -> None:
        self.load.start()

    def host_spans(self) -> CallSpans:
        return CallSpans(self.svc.fleet, "flush", IN_FLUSH)

    def open_window(self, t_start: float) -> None:
        self.load.t_start = t_start
        self.fleet_start = fleet_snapshot(self.svc.fleet)

    def close_window(self) -> None:
        self.fleet_end = fleet_snapshot(self.svc.fleet)

    def drain(self, timeout: float) -> None:
        self.load.join(timeout)
        self.stuck = len(self.load.in_flight) if self.load.is_alive() else 0
        self.batch_tile = self.svc.fleet.batch_tile

    def close(self, timeout: float) -> None:
        self.svc.close(timeout=timeout)

    def record(self, **common) -> Run:
        """The run's records; the front end and the clients are let go."""
        run = Run(dtype=self.dtype, batch_tile=self.batch_tile,
                  requests=list(self.load.records), fleet_start=self.fleet_start,
                  fleet_end=self.fleet_end, **common)
        self.samples = self.load.samples
        self.counters = {k: run.delta(k) for k in LADDER + ("overlay_builds",)}
        del self.svc, self.load
        return run

    def check(self, run: Run):
        unanswered = self.stuck + sum(not r.ok for r in run.requests)
        return chk.check(run.config, self.pools, self.samples, self.mix_keys, unanswered,
                         "cuda" if self.device.type == "cuda" else "cpu",
                         min_checked=int(self.traffic["clients"]))


def tally(run: Run, counters: dict):
    """``(attempted, failed)``: a dispatch served off the hopper plan (a
    ladder fallback) counts every request it could have held as failed."""
    errors = len(run.failed())
    off_plan = min(len(run.completed()), int(counters["fallback_dispatches"]) * run.batch_tile)
    return len(run.completed()) + errors, errors + off_plan


def report(run: Run, counters: dict) -> List[str]:
    """Standard error's lines about the window."""
    lines = [f"grid dtype {run.dtype}",
             "window: " + " ".join(f"{k}={run.delta(k)}" for k in
                                   ("dispatches", "partial_tile_dispatches", "executed"))]
    done = run.completed()
    per_s = [0] * max(1, int(run.window_s))
    for r in done:
        per_s[min(len(per_s) - 1, int(r.t_done - run.t_start))] += 1
    flush_ms = sorted(r.flush_s * 1e3 for r in done if r.flush_s is not None)
    if flush_ms:
        lines.append(f"host CPUs in the window: {run.host_cpu}")
        lines.append(f"answers a second: {per_s}; flush ms p50 {flush_ms[len(flush_ms) // 2]:.2f} "
                     f"max {flush_ms[-1]:.2f}; pack ms a dispatch "
                     f"{1e3 * run.delta('pack_s') / max(1, run.delta('dispatches')):.2f}")
    lines.append("ladder and builds: " + " ".join(f"{k}={v}" for k, v in counters.items()))
    return lines
