"""``canvas_fit_pct``: the fleet's canvas and bucket pixel counters, read
from the ``fleet.launch`` spans of the traced window, and nothing where the
port keeps no such counters."""

import pytest

from benchlib.record import Trace
from benchlib.spec import load_module
from test_trace import fake_run

from repro_torch.runtime import spans as recorder
from repro_torch.runtime.spans import Span

READER = load_module("metrics", "canvas_fit_pct")
#: One 8 x 1080 x 1920 canvas a dispatch, in its 8 x 2048 x 2048 bucket.
CANVAS, BUCKET = 8 * 1080 * 1920, 8 * 2048 * 2048


def recording(counters=True):
    """Four flushes, the first before the window [10, 20]: a launch each,
    with the counters as they stood before it when ``counters``."""
    out = []
    for k, t in enumerate((9.0, 11.0, 13.0, 15.0)):
        ids = {"canvas_px": k * CANVAS, "bucket_px": k * BUCKET} if counters else {}
        out.append(Span("frontend.flush", t, t + 1.0, 1, 2 * k + 1, None, {"flush": k}))
        out.append(Span("fleet.launch", t + 0.5, t + 0.6, 1, 2 * k + 2, 2 * k + 1, ids))
    return out


def test_fit_from_two_snapshots(monkeypatch):
    monkeypatch.setattr(recorder, "snapshot", recording)
    got = READER.read(fake_run(Trace(10.0, 20.0, [], 0.0, {})))
    assert got == pytest.approx(100.0 * 1080 * 1920 / (2048 * 2048))
    assert 49.0 < got < 50.0


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(recorder, "snapshot", lambda: recording(counters=False))
    # The parent's launches carry no counters.
    assert READER.read(fake_run(Trace(10.0, 20.0, [], 0.0, {}))) is None
    monkeypatch.setattr(recorder, "snapshot", recording)
    # No trace; one launch in the window; no flush in the window.
    assert READER.read(fake_run()) is None
    assert READER.read(fake_run(Trace(14.0, 20.0, [], 0.0, {}))) is None
    assert READER.read(fake_run(Trace(30.0, 40.0, [], 0.0, {}))) is None
