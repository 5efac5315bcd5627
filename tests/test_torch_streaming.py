"""Port parity, the streaming serving path: ``repro_torch.serve.
StreamingFrontend`` and the port's synchronous front-end's service
surface, against the reference's.

Twin of ``tests/test_streaming.py`` (minus its mesh cases, with the
port's event-based readiness probe in place of the reference's JAX one)
and of the streaming cases of ``tests/test_resilience.py``: the supervised
worker, ``worker_death`` injection, per-request hard timeouts, surrender
after ``max_worker_restarts`` and the close/submit race.  Streamed outputs
on ragged traces, under both ingest modes, are bitwise equal to the port's
sync front-end and to the reference's ``backend="xla"``.

Every blocking call carries its own timeout: a scheduler bug must fail a
test, not hang the suite.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from repro.core import sobel_grid as r_sobel_grid
from repro.runtime.fleet import PixieFleet as RFleet
from repro.serve import FleetFrontend as RFrontend

from repro_torch.core import applications as apps
from repro_torch.core.grid import custom, sobel_grid
from repro_torch.core.ingest import ReadinessProbe, check_ingest
from repro_torch.runtime import FaultInjector, PixieFleet
from repro_torch.runtime.fleet import FleetRequest, LazyOutput
from repro_torch.serve import (
    AdmissionError, DispatchError, FleetFrontend, JobHandle, JobTimeout,
    QuarantinedError, StreamingFrontend,
)
from repro_torch.serve.streaming import _PendingRequest

WAIT = 120.0
MIX = ["sobel_x", "sobel_y", "sharpen", "laplace", "threshold", "identity"]
CHAIN = ["sharpen", "sobel_x", "threshold"]


def fleet(**kw):
    kw.setdefault("backend", "torch")
    return PixieFleet(default_grid=sobel_grid(), device="cpu", **kw)


def img(rng, shape=(8, 8)):
    return rng.integers(0, 256, shape).astype(np.int32)


def ragged_trace(rng, n=6, sizes=((6, 9), (11, 5), (3, 8), (8, 8))):
    """Mixed apps on ragged frames; every fourth request is a depth-3
    chain."""
    return [
        (CHAIN if i % 4 == 3 else MIX[i % len(MIX)], img(rng, sizes[i % len(sizes)]))
        for i in range(n)
    ]


def reference_outputs(trace):
    svc = RFrontend(fleet=RFleet(default_grid=r_sobel_grid(), backend="xla"))
    return [np.asarray(y) for y in svc.process_batch(trace)]


# -- futures API on the synchronous front-end ---------------------------------


def test_handle_result_drives_sync_flush(rng):
    image = img(rng, (4, 6))
    svc = FleetFrontend(fleet=fleet())
    h = svc.submit("laplace", image)
    assert isinstance(h, JobHandle) and not h.done()
    np.testing.assert_array_equal(h.result(timeout=WAIT),
                                  apps.conv2d_reference(image, apps.LAPLACE))
    assert h.done()
    np.testing.assert_array_equal(h.result(), h.result())


def test_sync_latency_split_queue_vs_flush(rng):
    image = img(rng, (4, 6))
    svc = FleetFrontend(fleet=fleet())
    h1 = svc.submit("sobel_x", image)
    time.sleep(0.05)
    h2 = svc.submit("sobel_y", image)
    jobs = {j.ticket: j for j in svc.flush()}
    j1, j2 = jobs[h1.ticket], jobs[h2.ticket]
    assert j1.flush_s == j2.flush_s > 0
    assert j1.queue_s >= j2.queue_s + 0.04
    for j in (j1, j2):
        assert j.latency_s == pytest.approx(j.queue_s + j.flush_s)
    s = svc.latency.summary()
    assert s["completed"] == 2 and s["deadline_misses"] == 0


def test_process_batch_on_handles_single_dispatch(rng):
    image = img(rng)
    svc = FleetFrontend(fleet=fleet())
    names = ["sobel_y", "identity", "sobel_x"]
    outs = svc.process_batch([(n, image) for n in names])
    assert svc.stats.dispatches == 1
    for n, y in zip(names, outs):
        np.testing.assert_array_equal(y, svc.process(n, image))


def test_tick_take_shims_warn_and_match(rng):
    image = img(rng, (4, 6))
    svc = FleetFrontend(fleet=fleet())
    h = svc.submit("laplace", image)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jobs = svc.tick()
        y = svc.take(h)
    assert {x.category for x in w} == {DeprecationWarning}
    assert [j.ticket for j in jobs] == [h.ticket]
    np.testing.assert_array_equal(y, h.result(timeout=WAIT))
    h2 = svc.submit("identity", image)
    with pytest.warns(DeprecationWarning):
        svc.tick()
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(svc.take(h2.ticket), image)


def test_sync_submit_rejects_streaming_options(rng):
    svc = FleetFrontend(fleet=fleet())
    with pytest.raises(TypeError, match="streaming front-end"):
        svc.submit("laplace", img(rng), deadline_s=0.1)
    with pytest.raises(ValueError, match="ingest"):
        check_ingest("eager")
    with pytest.raises(ValueError, match="conflicts"):
        FleetFrontend(fleet=fleet(), ingest="async")


def test_default_streaming_frontend_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingFrontend(autostart=False)
    svc = StreamingFrontend(device="cpu", autostart=False)
    assert (svc.backend, svc.device.type, svc.ingest) == ("hopper", "cpu", "sync")
    svc.close(timeout=WAIT)


# -- streaming scheduler ------------------------------------------------------


def _warmed(svc, image):
    """One served request first (its deadline launches it at once, even
    under a long linger), so timing checks see flushes, not set-up."""
    svc.process("sobel_x", image, deadline_s=0.5)
    svc.latency.reset()
    return svc


def test_streaming_deadline_triggers_partial_tile(rng):
    image = img(rng)
    f = fleet(batch_tile=8)
    with StreamingFrontend(fleet=f, max_linger_s=30.0) as svc:
        _warmed(svc, image)
        partial0 = f.stats.partial_tile_dispatches
        t0 = time.perf_counter()
        hs = [svc.submit(n, image, deadline_s=0.25) for n in ["sobel_x", "sobel_y", "sharpen"]]
        jobs = [h.job(timeout=WAIT) for h in hs]
        waited = time.perf_counter() - t0
    assert f.stats.partial_tile_dispatches > partial0
    assert waited < 5.0
    for h, j in zip(hs, jobs):
        np.testing.assert_array_equal(np.asarray(j.output), np.asarray(h.result()))
    assert {j.deadline_s for j in jobs} == {0.25}


def test_streaming_priority_under_contention(rng):
    image = img(rng)
    svc = StreamingFrontend(fleet=fleet(), target_batch=2, autostart=False)
    low = [svc.submit(n, image, priority=0) for n in ["sobel_x", "sobel_y"]]
    high = [svc.submit(n, image, priority=5) for n in ["sharpen", "laplace"]]
    svc.start()
    jobs_high = [h.job(timeout=WAIT) for h in high]
    jobs_low = [h.job(timeout=WAIT) for h in low]
    svc.close(timeout=WAIT)
    assert {j.flush_seq for j in jobs_high} == {0}
    assert {j.flush_seq for j in jobs_low} == {1}
    assert all(j.priority == 5 for j in jobs_high)


def test_streaming_admission_control_sheds(rng):
    image = img(rng)
    svc = StreamingFrontend(fleet=fleet(), max_queue=2, autostart=False)
    hs = [svc.submit("sobel_x", image) for _ in range(2)]
    with pytest.raises(AdmissionError, match="max_queue=2"):
        svc.submit("sobel_y", image)
    assert svc.latency.shed == 1
    svc.start()
    for h in hs:
        assert h.result(timeout=WAIT).shape == image.shape
    svc.close(timeout=WAIT)
    assert svc.latency.summary()["shed"] == 1


def test_handle_result_timeout_semantics(rng):
    image = img(rng)
    svc = StreamingFrontend(fleet=fleet(), autostart=False)
    h = svc.submit("sobel_x", image)
    with pytest.raises(TimeoutError, match="sobel_x"):
        h.result(timeout=0.05)
    svc.start()
    assert h.result(timeout=WAIT).shape == image.shape
    h.result(timeout=0)
    svc.close(timeout=WAIT)


def test_streaming_linger_serves_deadline_less_traffic(rng):
    image = img(rng)
    with StreamingFrontend(fleet=fleet(batch_tile=8), max_linger_s=0.01) as svc:
        _warmed(svc, image)
        h = svc.submit("laplace", image)
        np.testing.assert_array_equal(h.result(timeout=WAIT),
                                      apps.conv2d_reference(image, apps.LAPLACE))
        assert svc.latency.summary()["completed"] == 1


def test_streaming_bad_request_fails_only_its_handle(rng):
    image = img(rng)
    with StreamingFrontend(fleet=fleet()) as svc:
        with pytest.raises(KeyError, match="unknown app"):
            svc.submit("not_an_app", image)
        with pytest.raises(ValueError, match=r"\[H, W\]"):
            svc.submit("sobel_x", np.zeros((2, 3, 4)))
        with pytest.raises(ValueError, match="deadline_s"):
            svc.submit("sobel_x", image, deadline_s=0.0)
        bad = svc.submit("sobel_x", image, grid=custom("tiny", 2, [1], 1))
        good = svc.submit("identity", image)
        with pytest.raises(Exception):
            bad.result(timeout=WAIT)
        np.testing.assert_array_equal(good.result(timeout=WAIT), image)


def test_streaming_close_drains_and_rejects(rng):
    image = img(rng)
    svc = StreamingFrontend(fleet=fleet())
    hs = [svc.submit(n, image) for n in MIX]
    svc.close(timeout=WAIT)
    for h in hs:
        assert h.done() or h.result(timeout=WAIT) is not None
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("sobel_x", image)
    svc.close(timeout=WAIT)


def test_per_bucket_flush_estimates_isolated():
    svc = StreamingFrontend(fleet=fleet(), est_flush_s=0.05, autostart=False)

    def pending(shape):
        return _PendingRequest(
            seq=0, name="sobel_x", work="sobel_x", image=np.zeros(shape, np.int32),
            grid=None, priority=0, t_arrival=0.0, deadline_at=None, deadline_s=None,
            handle=JobHandle(0, "sobel_x"))

    small, big = pending((8, 8)), pending((256, 256))
    assert svc._flush_key(small) != svc._flush_key(big)
    assert svc._flush_key(pending((17, 30))) == svc._flush_key(pending((30, 17)))
    assert svc._estimate(small) == svc._estimate(big) == 0.05
    svc._est_flush[svc._flush_key(big)] = 0.5
    assert svc._estimate(big) == 0.5 and svc._estimate(small) == 0.05
    assert svc.est_flush_s == 0.5
    small.deadline_at = big.deadline_at = 0.1 + svc.deadline_margin_s
    assert svc._deadline_urgent([big], now=0.0)
    assert not svc._deadline_urgent([small], now=0.0)
    svc.close(timeout=WAIT)


def test_streaming_learns_estimates_per_bucket(rng):
    svc = StreamingFrontend(fleet=fleet())
    image = img(rng)
    hs = [svc.submit(n, image) for n in MIX]
    for h in hs:
        h.result(timeout=WAIT)
    svc.close(timeout=WAIT)
    assert len(svc._est_flush) == 1
    ((_, Hb, Wb), est), = svc._est_flush.items()
    assert (Hb, Wb) == (16, 16) and est > 0.0


def test_urgent_request_preempts_staged_batch(rng):
    image = img(rng)
    f = fleet(batch_tile=2)
    svc = StreamingFrontend(fleet=f, target_batch=2, autostart=False, est_flush_s=5.0,
                            max_linger_s=0.01)
    high = [svc.submit(n, image, priority=10) for n in ["sobel_x", "sharpen"]]
    urgent = svc.submit("laplace", image, priority=0, deadline_s=0.001)
    time.sleep(0.01)
    svc.start()
    j_urgent = urgent.job(timeout=WAIT)
    jobs_high = [h.job(timeout=WAIT) for h in high]
    svc.close(timeout=WAIT)
    assert f.stats.preempted_batches >= 1
    assert j_urgent.flush_seq == 0
    assert max(j.flush_seq for j in jobs_high) >= 1


# -- streaming == synchronous == the reference, bitwise -----------------------


@pytest.mark.parametrize("ingest", ["sync", "async"])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_streaming_matches_sync_and_reference_ragged(backend, ingest, rng):
    """Ragged mixed-app traces with depth-3 chains, streamed in partial
    flushes under both ingest modes: bitwise the port's sync front-end and
    the reference's."""
    trace = ragged_trace(rng, n=8)
    ref = reference_outputs(trace)
    sync = FleetFrontend(fleet=fleet(backend=backend)).process_batch(trace)
    with StreamingFrontend(fleet=fleet(backend=backend, ingest=ingest),
                           target_batch=3) as svc:
        hs = [svc.submit(n, im, deadline_s=10.0, priority=i % 3)
              for i, (n, im) in enumerate(trace)]
        outs = [h.result(timeout=WAIT) for h in hs]
        assert svc.stats.dispatches >= 3
        assert svc.stats.pipeline_dispatches >= 1
        assert svc.stats.fallback_dispatches == svc.stats.retries == 0
    for want, got_sync, got in zip(ref, sync, outs):
        assert isinstance(got, LazyOutput) == (ingest == "async")
        np.testing.assert_array_equal(got_sync, want)
        np.testing.assert_array_equal(np.asarray(got), want)


# -- readiness probe and async ingest accounting ------------------------------


def test_cpu_readiness_probe_is_always_ready():
    p = ReadinessProbe("cpu")
    assert not p.on_device and p.ready() and p.wait(timeout=0.0) and p.wait()
    p.block(None)   # a no-op off the card


def test_probe_overlap_accounting_async_fleet(rng):
    image = img(rng, (16, 16))
    f = fleet(ingest="async")
    reqs = [FleetRequest(app=n, image=image) for n in ["sobel_x", "sharpen"]]
    for _ in range(4):
        f.run_many(reqs)
    assert f.stats.ingest_overlap_s >= 0.0 and np.isfinite(f.stats.ingest_overlap_s)
    assert f.stats.canvas_pool_hits >= 1
    assert f.stats.as_dict()["ingest_readiness"] == "always-ready"


# -- streaming: supervised worker (twins of test_resilience.py) ---------------


class Boom(BaseException):
    """A worker-killing failure below Exception: only the supervisor may
    catch it."""


def test_streaming_worker_crash_strands_no_handle(rng):
    svc = StreamingFrontend(fleet=fleet(), autostart=False)
    orig_flush = svc.fleet.flush
    calls = {"n": 0}

    def crashing_flush(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise Boom("simulated hard crash mid-dispatch")
        return orig_flush(*a, **kw)

    svc.fleet.flush = crashing_flush
    svc.start()
    h1 = svc.submit("sobel_x", img(rng, (8, 10)))
    with pytest.raises(DispatchError, match="crashed"):
        h1.result(timeout=WAIT)
    h2 = svc.submit("sobel_x", img(rng, (8, 10)))
    assert np.asarray(h2.result(timeout=WAIT)).shape == (8, 10)
    assert svc.worker_restarts == 1 and svc.latency.failed == 1
    svc.close(timeout=WAIT)


def test_streaming_worker_death_injection_restarts_and_serves(rng):
    image = img(rng, (8, 10))
    with StreamingFrontend(fleet=fleet()) as oracle_svc:
        want = oracle_svc.submit("sobel_x", image).result(timeout=WAIT)
    faults = FaultInjector(seed=3).inject("worker_death", max_fires=1)
    with StreamingFrontend(fleet=fleet(), faults=faults) as svc:
        out = svc.submit("sobel_x", image).result(timeout=WAIT)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
        assert svc.worker_restarts == 1
        assert faults.fired.get("worker_death") == 1


def test_streaming_supervisor_surrenders_after_max_restarts(rng):
    svc = StreamingFrontend(fleet=fleet(), autostart=False, max_worker_restarts=0)

    def always_boom(*a, **kw):
        raise Boom("persistent crash")

    svc.fleet.flush = always_boom
    handles = [svc.submit("sobel_x", img(rng)) for _ in range(3)]
    svc.start()
    for h in handles:
        with pytest.raises(DispatchError):
            h.result(timeout=WAIT)
    svc.close(timeout=WAIT)
    assert svc.worker_restarts == 1
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("sobel_x", img(rng))


@pytest.mark.parametrize("ingest", ["sync", "async"])
def test_streaming_quarantine_fails_only_its_handle(rng, ingest):
    image = img(rng, (8, 10))
    want = reference_outputs([("sobel_x", image)])[0]
    faults = FaultInjector(seed=5).inject("dispatch", transient=False,
                                          match=("<app:threshold>",))
    with StreamingFrontend(fleet=fleet(ingest=ingest), faults=faults) as svc:
        h_ok = svc.submit("sobel_x", image)
        h_bad = svc.submit("threshold", image)
        np.testing.assert_array_equal(np.asarray(h_ok.result(timeout=WAIT)), want)
        with pytest.raises(QuarantinedError):
            h_bad.result(timeout=WAIT)
        assert svc.stats.quarantined_requests == 1
        assert svc.latency.failed == 1


def test_streaming_request_hard_timeout_expires_queued_work(rng):
    svc = StreamingFrontend(fleet=fleet(), autostart=False, request_timeout_s=0.05)
    h = svc.submit("sobel_x", img(rng, (8, 10)))
    time.sleep(0.1)
    svc.start()
    with pytest.raises(JobTimeout):
        h.result(timeout=WAIT)
    h2 = svc.submit("sobel_x", img(rng, (8, 10)))
    assert np.asarray(h2.result(timeout=WAIT)).shape == (8, 10)
    assert svc.latency.failed == 1
    svc.close(timeout=WAIT)
    with pytest.raises(ValueError, match="request_timeout_s"):
        StreamingFrontend(fleet=fleet(), autostart=False, request_timeout_s=0)


def test_submit_close_race_strands_no_handle(rng):
    image = img(rng, (4, 6))
    for _ in range(5):
        svc = StreamingFrontend(fleet=fleet(), max_linger_s=1e-4)
        svc.submit("sobel_x", image).result(timeout=WAIT)
        accepted, rejected = [], []
        barrier = threading.Barrier(2)

        def submitter():
            barrier.wait()
            for _ in range(50):
                try:
                    accepted.append(svc.submit("sobel_x", image))
                except RuntimeError:
                    rejected.append(1)
                    break

        th = threading.Thread(target=submitter)
        th.start()
        barrier.wait()
        svc.close(timeout=WAIT)
        th.join(WAIT)
        assert not th.is_alive()
        for h in accepted:
            assert np.asarray(h.result(timeout=WAIT)).shape == image.shape
