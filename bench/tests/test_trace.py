"""The trace's arithmetic and the readers' answers where there is nothing
to read."""

import re

import pytest

from benchlib.record import Request, Run, Trace, percentile
from benchlib.spec import BENCH, load_module
from benchlib.trace import gaps, idle_names, short, union

#: Every reader of the image service's run under ``bench/metrics/``, listed
#: in ``BENCHMARK.json`` or not (a served model's reader says ``SYSTEM =
#: "lm"``; ``test_lm_readers.py`` reads those).
READERS = sorted(p.name[:-3] for p in (BENCH / "metrics").glob("*.py")
                 if getattr(load_module("metrics", p.name[:-3]), "SYSTEM", "image") == "image")


def test_union_and_gaps():
    busy = union([(1.0, 2.0), (1.5, 3.0), (4.0, 5.0), (4.2, 4.4)])
    assert busy == [(1.0, 3.0), (4.0, 5.0)]
    assert gaps(busy, 0.0, 6.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]


def test_idle_names():
    free = [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]
    runtime = [("cudaMemcpyAsync", 0.1, 0.9)]
    names = idle_names(free, runtime, flushes=[(1.5, 3.5)])
    assert names == ["host in cudaMemcpyAsync", "host in fleet.flush, no CUDA call",
                     "host between flushes"]


def fake_run(trace=None):
    reqs = [Request(0, "sobel_x", (4, 4), 0, t, t + 0.1, queue_s=0.05) for t in (1.0, 1.2, 1.4)]
    snap = {"dispatches": 0, "executed": 0, "pack_s": 0.0}
    return Run(cell="c", config={}, traffic={}, dtype="int32", batch_tile=8, seconds=1.0,
               setup_seconds=2.0, t_start=1.0, t_end=2.0, requests=reqs,
               fleet_start=dict(snap), fleet_end=dict(snap, dispatches=2, executed=3,
                                                      pack_s=0.01), trace=trace)


def test_readers_on_a_run():
    run = fake_run()
    read = {name: load_module("metrics", name).read(run) for name in READERS}
    assert read["frames_per_s"] == pytest.approx(3.0)
    assert read["request_p95_ms"] == pytest.approx(100.0)
    assert read["tile_fill_pct"] == pytest.approx(100 * 3 / 16)
    assert read["pack_ms_per_flush"] == pytest.approx(5.0)
    assert read["queue_wait_p50_ms"] == pytest.approx(50.0)
    # Without a trace the device's readers find nothing, and say so.
    for name in ("copy_ms_per_flush", "b1_roofline", "b3_roofline", "device_idle_pct"):
        assert read[name] is None


def test_readers_on_a_trace():
    trace = Trace(1.0, 2.0, [("void vcgra_tile_kernel<int, false, true, false>()", 1.0, 1.5),
                             ("Memcpy HtoD (Pinned -> Device)", 1.5, 1.6)], 0.6, {})
    run = fake_run(trace)
    assert load_module("metrics", "device_idle_pct").read(run) == pytest.approx(40.0)
    assert load_module("metrics", "copy_ms_per_flush").read(run) == pytest.approx(50.0)
    share = load_module("metrics", "b1_roofline").read(run)
    assert share == pytest.approx(100 * (3 * 2 * 16 * 4 / 3.35e12) / 0.5)
    assert load_module("metrics", "b3_roofline").read(run) is None
    assert trace.device_s(re.compile("Memcpy")) == pytest.approx(0.1)


def test_percentile():
    assert percentile([], 95) is None
    assert percentile([1.0, 2.0, 3.0], 50) == 2.0


def test_short_names():
    assert short("void (anonymous namespace)::vcgra_tile_kernel<int, true, true, false>"
                 "(int const*, int*, bool)") == "vcgra_tile_kernel<int, true, true, false>"
    assert short("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH (Device -> Pageable)"
