"""The closed loop: ``clients`` clients, each waiting for its last answer.

Each client submits a request through the port's serving entry
(``submit(work, frame, grid=...)``), waits for its ``JobHandle`` and reads
the output to a host array (an async fleet's lazy output waits for its copy
there), then sends its next.  One thread drives all the clients, so the
load adds no threads that contend with the front end's worker: it blocks on
the oldest request in flight (the front end serves in arrival order), then
takes every answer that has come, and sends each of those clients' next
request.

Every request is recorded.  For the correctness check each client marks
its first request sent after each of ``sample_k`` seeded moments of the
window, and its answer is copied into a host buffer made (and touched) at
set-up: keeping the answers themselves alive would make the allocator fetch
fresh pages for the answers that follow, and slow the window's first
seconds.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from benchlib import traffic as tr
from benchlib.record import Request

InFlight = collections.namedtuple("InFlight", "client key hw frame t_submit handle keep")


class ClosedLoop(threading.Thread):
    def __init__(self, svc, grid, traffic: dict, seed: int, seconds: float,
                 pools: Dict[Tuple[int, int], np.ndarray], stop: threading.Event,
                 sample_k: int, answer_dtype):
        super().__init__(name="bench-closed-loop", daemon=True)
        self.svc = svc
        self.grid = grid
        self.pools = pools
        self.stop = stop
        self.timeout_s = float(traffic["request_timeout_s"])
        n = int(traffic["clients"])
        self.orders = [tr.client_requests(traffic, seed, c) for c in range(n)]
        self.marks = [collections.deque(tr.sample_times(seed, c, sample_k, seconds))
                      for c in range(n)]
        side = tuple(max(hw[i] for hw in pools) for i in (0, 1))
        self.buffers = np.empty((n * sample_k, *side), dtype=answer_dtype)
        self.buffers.fill(0)
        self.samples: List[tuple] = []
        self.t_start = None                 # set when the window opens
        self.records: List[Request] = []
        self.in_flight: "collections.deque[InFlight]" = collections.deque()

    def send(self, client: int) -> None:
        work, hw, frame = next(self.orders[client])
        key = tr.work_key(work)
        t0 = time.perf_counter()
        keep = False
        marks = self.marks[client]
        if self.t_start is not None and marks and t0 - self.t_start >= marks[0]:
            while marks and t0 - self.t_start >= marks[0]:
                marks.popleft()
            keep = True
        try:
            handle = self.svc.submit(work, self.pools[hw][frame], grid=self.grid)
        except Exception as exc:  # noqa: BLE001 -- a shed or refused request is recorded
            self.records.append(Request(client, key, hw, frame, t0, time.perf_counter(),
                                        error=type(exc).__name__))
            return
        self.in_flight.append(InFlight(client, key, hw, frame, t0, handle, keep))

    def take(self, req: InFlight) -> None:
        """Record one answered (or failed) request."""
        try:
            job = req.handle.job(timeout=0)
            out = np.asarray(job.output)
        except Exception as exc:  # noqa: BLE001 -- a failed request is recorded, not raised
            self.records.append(Request(req.client, req.key, req.hw, req.frame, req.t_submit,
                                        time.perf_counter(), error=type(exc).__name__))
            return
        self.records.append(Request(req.client, req.key, req.hw, req.frame, req.t_submit,
                                    time.perf_counter(), queue_s=job.queue_s,
                                    flush_s=job.flush_s))
        if req.keep:
            kept = self.buffers[len(self.samples)]
            if out.shape == req.hw:
                kept = kept[:out.shape[0], :out.shape[1]]
                np.copyto(kept, out)
            else:   # a wrong shape is the check's to report
                kept = out.copy()
            self.samples.append((req.key, req.hw, req.frame, kept))

    def run(self) -> None:
        for client in range(len(self.orders)):
            self.send(client)
        while self.in_flight:
            head = self.in_flight[0]
            try:
                head.handle.job(timeout=self.timeout_s)
            except Exception:  # noqa: BLE001 -- a failed request is recorded by take()
                pass
            if not head.handle.done():
                self.in_flight.popleft()
                self.records.append(Request(head.client, head.key, head.hw, head.frame,
                                            head.t_submit, time.perf_counter(),
                                            error="JobTimeout"))
                if not self.stop.is_set():
                    self.send(head.client)
                continue
            answered = [r for r in self.in_flight if r.handle.done()]
            for req in answered:
                self.in_flight.remove(req)
                self.take(req)
            if not self.stop.is_set():
                for req in answered:
                    self.send(req.client)


def warm(svc, grid, traffic: dict, pools, rounds: int):
    """Serve ``rounds`` tiles of the cell's own work and sizes before the
    clients start: every executable, kernel library and pooled buffer
    the traffic uses is built here, in set-up.  Returns the answers' dtype."""
    clients = int(traffic["clients"])
    timeout = float(traffic["request_timeout_s"]) * 10
    answers = []
    for _ in range(rounds):
        handles = []
        for c in range(clients):
            work, hw, frame = next(tr.client_requests(traffic, c, c))
            handles.append(svc.submit(work, pools[hw][frame], grid=grid))
        answers += [np.asarray(h.result(timeout=timeout)) for h in handles]
    for work in traffic["mix"]:
        for hw in tr.sizes(traffic):
            answers.append(np.asarray(svc.submit(work, pools[hw][0], grid=grid)
                                      .result(timeout=timeout)))
    return answers[-1].dtype
