"""The port's host spans (``repro_torch.runtime.spans``), and the streaming
scheduler's launch triggers as its flush spans carry them.

Spans record only while a ``torch.profiler`` session is open in the
process, from any thread; each carries its parent on its own thread, and
the serving path names its steps with a fixed set of names: the front
end's worker (``frontend.*``) and, under each ``frontend.flush``, the
fleet's dispatch (``fleet.*``).  No JAX here.

Every blocking call carries its own timeout.
"""

import collections
import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import applications as apps
from repro_torch.core.grid import sobel_grid
from repro_torch.runtime import PixieFleet, spans
from repro_torch.runtime.fleet import FleetRequest
from repro_torch.serve import StreamingFrontend

WAIT = 120.0
CHAIN = ["sharpen", "sobel_x", "threshold"]
FLEET_SPANS = {"fleet.bank", "fleet.canvas", "fleet.embed", "fleet.ship", "fleet.launch",
               "fleet.unpack"}
FRONTEND_SPANS = {"frontend.wait", "frontend.admit", "frontend.flush", "frontend.deliver"}
TRIGGERS = ("full_tile", "deadline", "linger", "drain")


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def fleet(**kw):
    return PixieFleet(default_grid=sobel_grid(), device="cpu", backend="torch", **kw)


def frame(seed, shape=(6, 9)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def names(recorded):
    return {s.name for s in recorded}


def ancestors(span, by_id):
    while span.parent is not None:
        span = by_id[span.parent]
        yield span


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def test_recorded_from_a_second_thread_only_under_the_profiler():
    def work():
        with spans.span("outside", flush=0):
            pass

    t = threading.Thread(target=work)
    t.start()
    t.join(WAIT)
    assert not t.is_alive() and spans.snapshot() == []

    with cpu_profile():
        t_open = time.perf_counter()

        def traced():
            with spans.span("inside", flush=7, trigger="linger"):
                time.sleep(0.01)

        t = threading.Thread(target=traced)
        t.start()
        t.join(WAIT)
        t_close = time.perf_counter()
    assert not t.is_alive()
    [s] = spans.snapshot()
    assert s.name == "inside" and s.ids == {"flush": 7, "trigger": "linger"} and s.parent is None
    assert s.thread == t.ident != threading.get_ident()
    assert t_open <= s.t0 < s.t1 <= t_close and s.seconds >= 0.01
    with spans.span("after"):
        pass
    assert len(spans.snapshot()) == 1


def test_parents_and_self_time():
    with cpu_profile():
        with spans.span("outer"):
            time.sleep(0.02)
            with spans.span("inner"):
                time.sleep(0.01)
                with spans.span("leaf"):
                    time.sleep(0.01)
            with spans.span("inner"):
                time.sleep(0.01)
    got = spans.snapshot()
    by_name = collections.defaultdict(list)
    for s in got:
        by_name[s.name].append(s)
    [outer], inners, [leaf] = (by_name[n] for n in ("outer", "inner", "leaf"))
    assert outer.parent is None
    assert [s.parent for s in inners] == [outer.span_id] * 2
    assert leaf.parent == inners[0].span_id
    assert len({s.span_id for s in got}) == len(got)
    assert spans.self_time(got, "outer") == pytest.approx(
        outer.seconds - sum(s.seconds for s in inners))
    assert spans.self_time(got, "inner") == pytest.approx(
        sum(s.seconds for s in inners) - leaf.seconds)
    assert spans.self_time(got, "leaf") == pytest.approx(leaf.seconds)
    assert spans.self_time(got, "outer") >= 0.02
    assert spans.self_time(got, "absent") == 0.0


def test_the_ring_is_bounded():
    with cpu_profile():
        for i in range(spans.RING + 10):
            with spans.span("s", flush=i):
                pass
    got = spans.snapshot()
    assert len(got) == spans.RING
    assert got[0].ids == {"flush": 10} and got[-1].ids == {"flush": spans.RING + 9}


@pytest.mark.parametrize("ingest", ["sync", "async"])
@pytest.mark.parametrize("kind", ["image", "chain", "channels"])
def test_fleet_flush_spans_in_each_dispatch_path(kind, ingest):
    f = fleet(ingest=ingest)
    for i in range(3):
        image = frame(i)
        if kind == "image":
            f.submit(FleetRequest(app="sobel_x", image=image))
        elif kind == "chain":
            f.submit(FleetRequest(pipeline=CHAIN, image=image))
        else:
            taps = apps.stencil_inputs(torch.as_tensor(image))
            f.submit(FleetRequest(app="sharpen",
                                  inputs={k: v.numpy() for k, v in taps.items()}))
    with cpu_profile():
        with spans.span("caller"):
            outs = f.flush()
    assert len(outs) == 3
    got = spans.snapshot()
    expected = FLEET_SPANS - ({"fleet.canvas", "fleet.ship"} if kind == "channels" else set())
    assert names(got) == expected | {"caller"}
    [caller] = [s for s in got if s.name == "caller"]
    assert all(s.parent == caller.span_id for s in got if s is not caller)
    assert collections.Counter(s.name for s in got if s is not caller) == {
        n: 1 for n in expected}


@pytest.mark.parametrize("traced", [False, True])
def test_streaming_spans(traced):
    """Off without a profiler; under one, exactly the serving path's names,
    each fleet span under its flush, each request's flush among them."""
    reqs = [(CHAIN if i % 3 == 2 else "sobel_x", frame(i, (5 + i, 7))) for i in range(7)]
    with cpu_profile() if traced else contextlib.nullcontext():
        svc = StreamingFrontend(fleet=fleet(), target_batch=3, max_linger_s=0.005)
        try:
            handles = [svc.submit(app, image) for app, image in reqs]
            jobs = [h.job(timeout=WAIT) for h in handles]
        finally:
            svc.close(timeout=WAIT)
    got = spans.snapshot()
    if not traced:
        assert got == []
        return
    assert names(got) == FLEET_SPANS | FRONTEND_SPANS
    worker = {s.thread for s in got}
    assert len(worker) == 1 and worker != {threading.get_ident()}
    by_id = {s.span_id: s for s in got}
    flushes = {s.ids["flush"]: s for s in got if s.name == "frontend.flush"}
    for s in got:
        if s.name.startswith("fleet."):
            assert any(a.name == "frontend.flush" for a in ancestors(s, by_id)), s
    assert {j.flush_seq for j in jobs} == set(flushes)
    for name in ("frontend.admit", "frontend.deliver"):
        assert sorted(s.ids["flush"] for s in got if s.name == name) == sorted(flushes)
    assert {s.ids["trigger"] for s in flushes.values()} <= set(TRIGGERS)


@pytest.mark.parametrize("trigger", TRIGGERS)
def test_trigger_counters(trigger):
    """Each trigger counted from the flush spans' ``trigger=``, by
    construction: two requests fill a tile of two; a lone request lingers
    past a short linger; a lone request with a deadline launches before its
    linger of a minute; a lone request is drained when the front end
    closes."""
    linger = 0.01 if trigger == "linger" else 60.0
    with cpu_profile():
        svc = StreamingFrontend(fleet=fleet(), target_batch=2 if trigger == "full_tile" else 8,
                                max_linger_s=linger, autostart=trigger != "full_tile")
        try:
            n = 2 if trigger == "full_tile" else 1
            deadline = 0.3 if trigger == "deadline" else None
            handles = [svc.submit("sobel_x", frame(i), deadline_s=deadline) for i in range(n)]
            if trigger == "full_tile":
                svc.start()
            if trigger != "drain":
                for h in handles:
                    h.result(timeout=WAIT)
        finally:
            svc.close(timeout=WAIT)
    for h in handles:
        h.result(timeout=WAIT)
    counts = collections.Counter(s.ids["trigger"] for s in spans.snapshot()
                                 if s.name == "frontend.flush")
    assert counts == {trigger: 1}
    assert svc.stats.dispatches == 1
