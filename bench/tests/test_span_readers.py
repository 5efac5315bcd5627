"""The readers of the port's own host spans: each finds its value in a
synthetic recording over a traced window, and nothing where the run has no
trace, the window no flush, or the port no recorder."""

import sys

import pytest

from benchlib.record import Trace
from benchlib.spans import window
from benchlib.spec import load_module
from test_trace import fake_run

from repro_torch.runtime import spans as recorder
from repro_torch.runtime.spans import Span

READERS = ("canvas_ms_per_flush", "embed_ms_per_flush", "admit_ms_per_flush",
           "worker_gap_ms_per_flush", "launch_ms_per_flush")
WORKER, OTHER = 1, 2


def recording():
    """Three flushes start inside the window [10, 20] on the worker, the
    last running past its end; one flush before it and one admit after it;
    another thread's admit in between."""
    out = []

    def add(name, t0, t1, parent=None, thread=WORKER, **ids):
        span_id = len(out) + 1
        out.append(Span(name, t0, t1, thread, span_id, parent, ids))
        return span_id

    add("frontend.flush", 9.0, 9.5, flush=0)
    for seq, (admit, flush, canvas, embed) in enumerate(
            [((10.0, 10.5), (10.5, 11.5), (10.6, 10.8), (10.8, 11.1)),
             ((11.8, 12.0), (12.0, 13.0), (12.1, 12.2), (12.2, 12.4)),
             ((18.8, 19.0), (19.0, 21.5), (19.1, 19.2), (19.2, 19.3))], start=1):
        add("frontend.admit", *admit, flush=seq)
        f = add("frontend.flush", *flush, flush=seq, trigger="full_tile")
        add("fleet.canvas", *canvas, parent=f)
        add("fleet.embed", *embed, parent=f)
        add("fleet.launch", embed[1], embed[1] + 0.1, parent=f)
        add("fleet.unpack", embed[1] + 0.1, flush[1], parent=f)
    add("frontend.admit", 11.6, 11.7, thread=OTHER, flush=99)
    add("frontend.admit", 21.6, 21.8, flush=4)
    return out


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(recorder, "snapshot", recording)


def test_readers_on_a_recording(recorded):
    run = fake_run(Trace(10.0, 20.0, [], 0.0, {}))
    read = {name: load_module("metrics", name).read(run) for name in READERS}
    assert read["canvas_ms_per_flush"] == pytest.approx(1e3 * (0.2 + 0.1 + 0.1) / 3)
    assert read["embed_ms_per_flush"] == pytest.approx(1e3 * (0.3 + 0.2 + 0.1) / 3)
    # Admits of every thread count; the worker's gaps only on its own.
    assert read["admit_ms_per_flush"] == pytest.approx(1e3 * (0.5 + 0.2 + 0.1 + 0.2) / 3)
    # 11.5 -> 11.8, 13.0 -> 18.8; the last flush is cut at the window's end.
    assert read["worker_gap_ms_per_flush"] == pytest.approx(1e3 * (0.3 + 5.8) / 3)
    assert read["launch_ms_per_flush"] == pytest.approx(1e3 * 0.1)
    w = window(run)
    assert w.flushes == 3 and max(s.t1 for s in w.spans) == 20.0
    assert w.recorder.self_time(w.spans, "fleet.unpack") == pytest.approx(0.3 + 0.5 + 0.6)


def test_worker_gap_after_the_last_admit(monkeypatch):
    """A flush that ends inside the window with no later admit recorded
    (the profiler closed first) counts its gap to the window's end."""
    def recording():
        return [Span("frontend.admit", 10.0, 10.5, WORKER, 1, None, {"flush": 1}),
                Span("frontend.flush", 10.5, 11.5, WORKER, 2, None, {"flush": 1}),
                Span("frontend.admit", 12.0, 12.2, WORKER, 3, None, {"flush": 2}),
                Span("frontend.flush", 12.2, 19.0, WORKER, 4, None, {"flush": 2})]

    monkeypatch.setattr(recorder, "snapshot", recording)
    run = fake_run(Trace(10.0, 20.0, [], 0.0, {}))
    reader = load_module("metrics", "worker_gap_ms_per_flush")
    assert reader.read(run) == pytest.approx(1e3 * (0.5 + 1.0) / 2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name, recorded, monkeypatch):
    reader = load_module("metrics", name)
    assert reader.read(fake_run()) is None
    assert reader.read(fake_run(Trace(30.0, 40.0, [], 0.0, {}))) is None
    # A port without the recorder (the parent of the change that adds it).
    monkeypatch.delattr(sys.modules["repro_torch.runtime"], "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert reader.read(fake_run(Trace(10.0, 20.0, [], 0.0, {}))) is None
