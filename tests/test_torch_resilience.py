"""Port parity, the self-healing serving path: the port's ladder
(``repro_torch.runtime.fleet``), fault injector, retry policy, circuit
breakers, heartbeat and ``fallback_chain`` against the reference's.

Twins of ``tests/test_resilience.py`` (its fleet and sync front-end cases;
the streaming ones are in ``test_torch_streaming.py``) and of the
heartbeat and ``ElasticPlan`` cases of ``tests/test_fault_tolerance.py``.
Each fleet case drives BOTH packages with the same seeded
``FaultInjector`` schedule on the same numpy frames: the reference with
``backend="xla"`` (or its interpret-mode ``"pallas"``), the port on the
CPU with ``"torch"`` (or ``"hopper"``, the kernels' plain versions).
The ladder counters, the quarantined tickets and the breaker event
sequence must be equal, and every surviving output bitwise equal.
"""

import numpy as np
import pytest
import torch

from repro.core import sobel_grid as r_sobel_grid
from repro.core.plan import OverlayPlan as ROverlayPlan
from repro.core.plan import PipelineSpec as RPipelineSpec
from repro.core.plan import fallback_chain as r_fallback_chain
from repro.core.pixie import map_app as r_map_app
from repro.core import applications as r_apps
from repro.runtime.chaos import FaultInjector as RFaultInjector
from repro.runtime.fault_tolerance import ElasticPlan as RElasticPlan
from repro.runtime.fault_tolerance import HeartbeatMonitor as RHeartbeatMonitor
from repro.runtime.fleet import FleetRequest as RRequest, PixieFleet as RFleet
from repro.runtime.resilience import BreakerBoard as RBreakerBoard
from repro.runtime.resilience import RetryPolicy as RRetryPolicy
from repro.serve import FleetFrontend as RFrontend

from repro_torch.core import applications as t_apps
from repro_torch.core.grid import sobel_grid
from repro_torch.core.pixie import map_app
from repro_torch.core.plan import OverlayPlan, PipelineSpec, fallback_chain
from repro_torch.kernels import build
from repro_torch.kernels.build import KernelBuildError
from repro_torch.kernels.vcgra import ops as vcgra_ops
from repro_torch.runtime import (
    BreakerBoard, CircuitBreaker, ElasticPlan, FaultInjector, HeartbeatMonitor,
    InjectedFault, RetryPolicy, TransientError,
)
from repro_torch.runtime.fleet import FleetRequest, LazyOutput, PixieFleet
from repro_torch.serve import FleetFrontend, QuarantinedError

from test_torch_core import port_grid

WAIT = 120.0
#: (reference backend, port backend) pairs.
PAIRS = [("xla", "torch"), ("pallas", "hopper")]
NAMES = ["sobel_x", "sobel_y", "laplace", "sharpen", "identity", "threshold"]
#: Counters of the ladder both fleets keep under the same names.
LADDER = ("retries", "quarantined_requests", "fallback_dispatches", "guard_failures",
          "straggler_flushes", "dispatches", "fused_dispatches", "padded_app_slots",
          "partial_tile_dispatches", "executed", "overlay_builds")


def images(seed, n=len(NAMES), float_pe=False, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or [(5 + i, 7) for i in range(n)]
    out = [rng.integers(0, 256, hw) for hw in shapes]
    return [a.astype(np.float32 if float_pe else np.int32) for a in out]


def fleets(pair, float_pe=False, r_kw=None, t_kw=None):
    """The reference and port fleets of one backend pair on the Sobel
    grid, each with its own keyword arguments (injectors, boards).
    Unless a case brings its own, both get a breaker board on a frozen
    clock: the default wall clock would let a breaker half-open whenever
    one package's flush ran slower than the other's."""
    r_backend, t_backend = pair
    r_kw, t_kw = dict(r_kw or {}), dict(t_kw or {})
    r_kw.setdefault("breakers", RBreakerBoard(clock=lambda: 0.0))
    t_kw.setdefault("breakers", BreakerBoard(clock=lambda: 0.0))
    r = RFleet(default_grid=r_sobel_grid(float_pe=float_pe), backend=r_backend, **r_kw)
    t = PixieFleet(default_grid=sobel_grid(float_pe=float_pe), backend=t_backend,
                   device="cpu", **t_kw)
    return r, t


def port_match(match, pair):
    """A reference ``match=`` tuple in the port's backend names."""
    return None if match is None else tuple(m.replace(f"|{pair[0]}|", f"|{pair[1]}|")
                                            for m in match)


def injectors(pair, seed, specs):
    """The same seeded schedule for both packages: ``specs`` is a list of
    ``(point, kwargs)`` with reference-named ``match`` tokens."""
    r, t = RFaultInjector(seed=seed), FaultInjector(seed=seed)
    for point, kw in specs:
        r.inject(point, **kw)
        t.inject(point, **{**kw, "match": port_match(kw.get("match"), pair)})
    return r, t


def serve_both(r_fleet, t_fleet, names, imgs, flushes=1):
    """Submit the same requests to both fleets and flush; returns the
    tickets and, per fleet, {ticket: output or the failure's class}."""
    results = []
    for fleet, Request in ((r_fleet, RRequest), (t_fleet, FleetRequest)):
        got = {}
        for _ in range(flushes):
            tickets = [fleet.submit(Request(app=n, image=im)) for n, im in zip(names, imgs)]
            fleet.flush()
            for t in tickets:
                try:
                    got[t] = np.asarray(fleet.result(t))
                except QuarantinedError as exc:
                    got[t] = ("quarantined", exc.ticket, exc.app)
                except Exception as exc:  # the reference's QuarantinedError
                    got[t] = ("quarantined", exc.ticket, exc.app)
        results.append(got)
    return results


def assert_same_ladder(r_fleet, t_fleet, r_got, t_got):
    assert sorted(r_got) == sorted(t_got)
    for ticket in r_got:
        want, got = r_got[ticket], t_got[ticket]
        if isinstance(want, tuple):
            assert got == want, ticket
        else:
            assert not isinstance(got, tuple), ticket
            np.testing.assert_array_equal(got, want)
    for name in LADDER:
        assert getattr(t_fleet.stats, name) == getattr(r_fleet.stats, name), name
    assert ([e["event"] for e in t_fleet.stats.breaker_events]
            == [e["event"] for e in r_fleet.stats.breaker_events])
    assert t_fleet.faults.fired == r_fleet.faults.fired


# -- retry policy, breakers, injector (pure Python, copied) -------------------


def test_backoff_schedule_matches_reference():
    kw = dict(max_attempts=5, backoff_base_s=0.01, backoff_multiplier=2.0, backoff_max_s=0.05)
    assert RetryPolicy(**kw).schedule() == RRetryPolicy(**kw).schedule() == (
        0.01, 0.02, 0.04, 0.05)
    assert RetryPolicy(**kw).backoff_s(10) == 0.05
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_base_s=-1.0)


def test_retry_policy_transient_classification():
    r = RetryPolicy()

    class Flaky(Exception):
        transient = True

    assert r.should_retry(TransientError("x")) and r.should_retry(Flaky())
    assert r.should_retry(InjectedFault("dispatch", transient=True))
    assert not r.should_retry(InjectedFault("dispatch", transient=False))
    assert not r.should_retry(ValueError("deterministic"))
    assert not r.should_retry(KernelBuildError("no nvcc"))


def test_breaker_transitions_match_reference():
    """The reference's open -> half-open -> close and re-open sequences on
    a fake clock, event for event."""
    from repro.runtime.resilience import CircuitBreaker as RCircuitBreaker

    logs = []
    for Breaker in (CircuitBreaker, RCircuitBreaker):
        t = [0.0]
        br = Breaker("plan-a", failure_threshold=2, cooldown_s=1.0, clock=lambda: t[0])
        trace = []
        for step in ("f", "s", "f", "f", "allow", "t1", "allow", "allow", "f", "t2",
                     "allow", "s"):
            if step == "f":
                br.record_failure("boom")
            elif step == "s":
                br.record_success()
            elif step == "allow":
                trace.append(br.allow())
            else:
                t[0] = float(step[1:])
            trace.append(br.state)
        logs.append((trace, [(e["event"], e["t"]) for e in br.events]))
    assert logs[0] == logs[1]
    assert [e for e, _ in logs[0][1]] == ["open:boom", "half_open", "reopen:boom",
                                          "half_open", "close"]


def test_breaker_board_shares_one_event_log():
    board = BreakerBoard(failure_threshold=1, cooldown_s=1.0, clock=lambda: 0.0)
    board.breaker("a").record_failure()
    board.breaker("b").record_failure()
    assert board.states() == {"a": "open", "b": "open"} and not board.all_closed()
    assert [e["plan"] for e in board.events] == ["a", "b"]
    assert board.breaker("a") is board.breaker("a")


def test_injector_draws_match_reference():
    """One seed, one schedule: rate-limited specs fire on the same events
    in both packages (the same ``random.Random`` draw order)."""
    tokens = [[f"<ticket:{i}>", f"<app:{NAMES[i % 6]}>"] for i in range(7)]
    logs = []
    for Injector in (FaultInjector, RFaultInjector):
        inj = (Injector(seed=7).inject("dispatch", rate=0.4, transient=False)
               .inject("nan_output", rate=0.5)
               .inject("nan_output", rate=0.7, match=("<app:laplace>",), max_fires=3))
        log = []
        for k in range(40):
            try:
                inj.fire("dispatch", tokens[k % 7])
                log.append("ok")
            except Exception as exc:  # InjectedFault of either package
                log.append((type(exc).__name__, exc.transient))
            log.append(tuple(inj.corrupt_slots(tokens[: 1 + k % 7])))
        logs.append((log, dict(inj.fired)))
    assert logs[0] == logs[1]
    with pytest.raises(ValueError, match="unknown hook point"):
        FaultInjector().inject("nowhere")
    with pytest.raises(ValueError, match="rate"):
        FaultInjector().inject("dispatch", rate=2.0)


# -- fallback chain -----------------------------------------------------------


def _chain_steps(chain, backend_names):
    return [(backend_names.get(p.backend, p.backend), p.tile_rows, p.fused, p.radius)
            for p in chain]


@pytest.mark.parametrize("kind", ["fused", "channels", "pipeline"])
@pytest.mark.parametrize("tile_rows", [8, "auto", None])
@pytest.mark.parametrize("ingest", ["sync", "async"])
def test_fallback_chain_matches_reference(kind, tile_rows, ingest):
    """Step for step the reference's chain of the twin plan, with
    ``hopper``<->``pallas`` and ``torch``<->``xla`` (the reference's mesh
    steps do not arise on one device).  The port's ingest mode is the
    fleet's, not a plan axis: its plans and keys are the reference's sync
    ones whichever mode the reference plan names."""
    r_grid = r_sobel_grid()
    t_grid = port_grid(r_grid)
    if kind == "channels":
        tile_rows = None
        r_kw = t_kw = dict(batched=True, fused=False)
    elif kind == "fused":
        r_kw = t_kw = dict(batched=True, fused=True, radius=1)
    else:
        r_cfgs = [r_map_app(r_apps.ALL_APPS[n](), r_grid) for n in ("sobel_x", "threshold")]
        t_cfgs = [map_app(t_apps.ALL_APPS[n](), t_grid) for n in ("sobel_x", "threshold")]
        r_kw = dict(batched=True, pipeline=(RPipelineSpec.chain(r_cfgs),))
        t_kw = dict(batched=True, pipeline=(PipelineSpec.chain(t_cfgs),))
    for r_backend, t_backend in PAIRS:
        r_plan = ROverlayPlan(grid=r_grid, backend=r_backend, tile_rows=tile_rows,
                              ingest=ingest, **r_kw)
        t_plan = OverlayPlan(grid=t_grid, backend=t_backend, tile_rows=tile_rows, **t_kw)
        want = _chain_steps(r_fallback_chain(r_plan), {"xla": "torch", "pallas": "hopper"})
        assert _chain_steps(fallback_chain(t_plan), {}) == want
        assert all(step.ingest == ingest for step in r_fallback_chain(r_plan))

        def sync_key(plan):
            return plan.key().removesuffix("|async")

        assert t_plan.key() == sync_key(r_plan).replace(f"|{r_backend}|", f"|{t_backend}|")
        for r_step, t_step in zip(r_fallback_chain(r_plan), fallback_chain(t_plan)):
            assert t_step.key() == sync_key(r_step).replace("|xla|", "|torch|")
    degraded = OverlayPlan(grid=t_grid, batched=True, fused=True, radius=1, backend="torch")
    assert fallback_chain(degraded) == ()


# -- the fleet ladder against the reference's ---------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[1])
def test_transient_dispatch_faults_are_retried_bitwise(pair):
    imgs = images(0, 2, shapes=[(8, 10), (6, 7)])
    names = ["sobel_x", "laplace"]
    r_inj, t_inj = injectors(pair, 11, [("dispatch", dict(max_fires=2))])
    r, t = fleets(pair, r_kw=dict(faults=r_inj, retry=RRetryPolicy(backoff_base_s=1e-4)),
                  t_kw=dict(faults=t_inj, retry=RetryPolicy(backoff_base_s=1e-4)))
    assert_same_ladder(r, t, *serve_both(r, t, names, imgs))
    assert t.stats.retries == 2 and t.stats.quarantined_requests == 0


def test_nontransient_fault_skips_retries_and_uses_fallback():
    """A persistent fault on the hopper plan: no retry burned, straight to
    the torch sibling, bitwise, stamped with the torch plan's key."""
    pair = PAIRS[1]
    imgs = images(1, 1, shapes=[(8, 10)])
    spec = [("dispatch", dict(transient=False, match=("|pallas|",)))]
    r_inj, t_inj = injectors(pair, 0, spec)
    r, t = fleets(pair, r_kw=dict(faults=r_inj), t_kw=dict(faults=t_inj))
    assert_same_ladder(r, t, *serve_both(r, t, ["sobel_x"], imgs))
    assert (t.stats.retries, t.stats.fallback_dispatches) == (0, 1)
    assert [k.split("|")[3] for k in t.stats.dispatch_plans] == ["torch"]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[1])
def test_poisoned_tickets_are_exactly_isolated(pair):
    imgs = images(3)
    spec = [("dispatch", dict(transient=False, match=("<ticket:1>", "<ticket:4>")))]
    r_inj, t_inj = injectors(pair, 3, spec)
    r, t = fleets(pair, r_kw=dict(faults=r_inj, retry=RRetryPolicy(max_attempts=1)),
                  t_kw=dict(faults=t_inj, retry=RetryPolicy(max_attempts=1)))
    r_got, t_got = serve_both(r, t, NAMES, imgs)
    assert_same_ladder(r, t, r_got, t_got)
    assert sorted(k for k, v in t_got.items() if isinstance(v, tuple)) == [1, 4]
    assert t_got[1] == ("quarantined", 1, "sobel_y")


def test_quarantined_error_carries_cause():
    spec = [("dispatch", dict(transient=False, match=("<app:threshold>",),
                              detail="poison pill"))]
    _, t_inj = injectors(PAIRS[0], 0, spec)
    fleet = PixieFleet(backend="torch", device="cpu", faults=t_inj,
                       retry=RetryPolicy(max_attempts=1))
    ticket = fleet.submit(FleetRequest(app="threshold", image=images(0, 1)[0]))
    fleet.flush()
    with pytest.raises(QuarantinedError) as ei:
        fleet.result(ticket)
    assert isinstance(ei.value.cause, InjectedFault)
    assert "poison pill" in str(ei.value.cause)
    with pytest.raises(QuarantinedError):
        fleet.run_many([FleetRequest(app="threshold", image=images(0, 1)[0])])


def test_output_guard_retries_transient_nan_bitwise():
    pair = PAIRS[0]
    imgs = images(5, 1, float_pe=True, shapes=[(8, 10)])
    spec = [("nan_output", dict(max_fires=1, match=("<app:sobel_x>",)))]
    r_inj, t_inj = injectors(pair, 5, spec)
    r, t = fleets(pair, float_pe=True,
                  r_kw=dict(faults=r_inj, retry=RRetryPolicy(backoff_base_s=1e-4)),
                  t_kw=dict(faults=t_inj, retry=RetryPolicy(backoff_base_s=1e-4)))
    r_got, t_got = serve_both(r, t, ["sobel_x"], imgs)
    assert_same_ladder(r, t, r_got, t_got)
    assert np.isfinite(t_got[0]).all() and t.stats.guard_failures == 1


def test_output_guard_quarantines_persistent_nan_and_serves_batchmate():
    pair = PAIRS[0]
    imgs = images(6, 2, float_pe=True, shapes=[(8, 10), (6, 7)])
    r_inj, t_inj = injectors(pair, 5, [("nan_output", dict(match=("<app:laplace>",)))])
    r, t = fleets(pair, float_pe=True,
                  r_kw=dict(faults=r_inj, retry=RRetryPolicy(max_attempts=1)),
                  t_kw=dict(faults=t_inj, retry=RetryPolicy(max_attempts=1)))
    r_got, t_got = serve_both(r, t, ["sobel_x", "laplace"], imgs)
    assert_same_ladder(r, t, r_got, t_got)
    assert t_got[1] == ("quarantined", 1, "laplace") and t.stats.quarantined_requests == 1


def test_breaker_opens_then_recovers_through_fallback():
    """A hopper primary that fails 3 flushes opens its breaker; traffic
    then goes straight to the torch fallback; after the (fake-clock)
    cooldown a half-open probe closes it -- event for event the
    reference's pallas/xla sequence."""
    pair = PAIRS[1]
    img = images(7, 1, shapes=[(8, 10)])
    r_clock, t_clock = [0.0], [0.0]
    spec = [("dispatch", dict(transient=False, match=("|pallas|",), max_fires=3))]
    r_inj, t_inj = injectors(pair, 0, spec)
    r, t = fleets(pair,
                  r_kw=dict(faults=r_inj, breakers=RBreakerBoard(
                      failure_threshold=3, cooldown_s=10.0, clock=lambda: r_clock[0])),
                  t_kw=dict(faults=t_inj, breakers=BreakerBoard(
                      failure_threshold=3, cooldown_s=10.0, clock=lambda: t_clock[0])))
    r_got, t_got = serve_both(r, t, ["sobel_x"], img, flushes=4)
    assert_same_ladder(r, t, r_got, t_got)
    assert t.stats.fallback_dispatches == 4
    r_clock[0] = t_clock[0] = 10.0
    r_got, t_got = serve_both(r, t, ["sobel_x"], img)
    assert_same_ladder(r, t, r_got, t_got)
    hopper_key = next(e["plan"] for e in t.stats.breaker_events)
    assert "|hopper|" in hopper_key and t.breakers.states()[hopper_key] == "closed"
    assert [e["event"] for e in t.stats.breaker_events] == ["open:dispatch", "half_open",
                                                           "close"]
    assert t.stats.fallback_dispatches == 4


def test_open_breaker_with_no_fallback_still_serves_as_last_resort():
    pair = PAIRS[0]
    img = images(8, 1, shapes=[(8, 10)])
    r_inj, t_inj = injectors(pair, 0, [("dispatch", dict(max_fires=1))])
    r, t = fleets(pair,
                  r_kw=dict(faults=r_inj, breakers=RBreakerBoard(failure_threshold=1,
                                                                  cooldown_s=1e9),
                            retry=RRetryPolicy(max_attempts=1)),
                  t_kw=dict(faults=t_inj, breakers=BreakerBoard(failure_threshold=1,
                                                                 cooldown_s=1e9),
                            retry=RetryPolicy(max_attempts=1)))
    r_got, t_got = serve_both(r, t, ["sobel_x"], img, flushes=2)
    assert_same_ladder(r, t, r_got, t_got)
    assert not t.breakers.all_closed()
    assert all(not isinstance(v, tuple) for v in t_got.values())


def test_straggler_flush_counts_against_the_breaker():
    pair = PAIRS[0]
    img = images(9, 1, shapes=[(8, 10)])
    mons = [RHeartbeatMonitor(window=16, factor=1.0), HeartbeatMonitor(window=16, factor=1.0)]
    for mon in mons:
        mon.durations.extend([1e-9] * 8)     # any real flush is >> 1x median
    r, t = fleets(pair,
                  r_kw=dict(heartbeat=mons[0], breakers=RBreakerBoard(failure_threshold=1,
                                                                       cooldown_s=1e9)),
                  t_kw=dict(heartbeat=mons[1], breakers=BreakerBoard(failure_threshold=1,
                                                                      cooldown_s=1e9)))
    r.run_many([RRequest(app="sobel_x", image=img[0])])
    t.run_many([FleetRequest(app="sobel_x", image=img[0])])
    assert t.stats.straggler_flushes == r.stats.straggler_flushes == 1
    assert [e["event"] for e in t.stats.breaker_events] == ["open:straggler"]


def test_unarmed_fleet_never_trips_breakers_on_stragglers():
    fleet = PixieFleet(backend="torch", device="cpu")
    fleet.heartbeat.durations.extend([1e-9] * 8)
    fleet.run_many([FleetRequest(app="sobel_x", image=images(10, 1)[0])])
    assert fleet.stats.straggler_flushes == 1
    assert fleet.stats.breaker_events == [] and fleet.breakers.all_closed()


def test_compile_fault_falls_back_and_does_not_cache_failure():
    pair = PAIRS[1]
    img = images(11, 1, shapes=[(8, 10)])
    spec = [("compile", dict(transient=False, match=("|pallas|",), max_fires=1))]
    r_inj, t_inj = injectors(pair, 0, spec)
    r, t = fleets(pair, r_kw=dict(faults=r_inj), t_kw=dict(faults=t_inj))
    r_got, t_got = serve_both(r, t, ["sobel_x"], img, flushes=2)
    assert_same_ladder(r, t, r_got, t_got)
    assert t.stats.fallback_dispatches == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("float_pe", [False, True], ids=["int32", "float32"])
def test_seeded_random_schedule_matches_reference(seed, float_pe):
    """Rate-drawn transient and persistent dispatch faults, NaN outputs
    and stalls over four flushes of a ragged six-app trace: the same
    quarantined tickets, counters, breaker events and survivors."""
    pair = PAIRS[0]
    imgs = images(20 + seed, float_pe=float_pe, shapes=[(5 + i, 9 - i) for i in range(6)])
    spec = [("dispatch", dict(rate=0.5)),
            ("dispatch", dict(rate=0.4, transient=False, match=("<ticket:",))),
            ("nan_output", dict(rate=0.5)),
            ("transfer_stall", dict(rate=0.3, delay_s=1e-4))]
    r_inj, t_inj = injectors(pair, seed, spec)
    retry = dict(max_attempts=2, backoff_base_s=1e-4)
    r, t = fleets(pair, float_pe=float_pe,
                  r_kw=dict(faults=r_inj, retry=RRetryPolicy(**retry)),
                  t_kw=dict(faults=t_inj, retry=RetryPolicy(**retry)))
    r_got, t_got = serve_both(r, t, NAMES, imgs, flushes=4)
    assert_same_ladder(r, t, r_got, t_got)
    assert t.stats.retries + t.stats.quarantined_requests + t.stats.guard_failures > 0


def test_sync_frontend_routes_quarantine_to_the_handle():
    spec = [("dispatch", dict(transient=False, match=("<app:threshold>",)))]
    r_inj, t_inj = injectors(PAIRS[0], 0, spec)
    img = images(12, 1, shapes=[(8, 10)])[0]
    outs = []
    for svc in (RFrontend(fleet=RFleet(backend="xla", faults=r_inj,
                                       retry=RRetryPolicy(max_attempts=1))),
                FleetFrontend(fleet=PixieFleet(backend="torch", device="cpu", faults=t_inj,
                                               retry=RetryPolicy(max_attempts=1)))):
        h_ok = svc.submit("sobel_x", img)
        h_bad = svc.submit("threshold", img)
        outs.append(np.asarray(h_ok.result(timeout=WAIT)))
        with pytest.raises(Exception) as ei:
            h_bad.result(timeout=WAIT)
        assert type(ei.value).__name__ == "QuarantinedError"
        assert svc.latency.failed == 1
    np.testing.assert_array_equal(outs[1], outs[0])


# -- a kernel that cannot be built or launched is never served around ---------


@pytest.mark.parametrize("error", [
    RuntimeError("vcgra_fused_batched launch failed: cudaError 700"),
    ValueError("frames need 9000 bytes of shared memory; the block holds 4096"),
], ids=["launch_failure", "refused_operand"])
def test_dispatch_errors_other_than_injected_faults_raise(monkeypatch, error):
    """Only injected faults (and poisoned outputs) take the ladder: any
    other error of the hopper executor -- a failed launch, an operand the
    kernel refuses -- raises out of ``flush()`` on an armed fleet, with
    nothing retried, degraded or recorded by a breaker."""

    def fails(*args, **kwargs):
        raise error

    monkeypatch.setattr(vcgra_ops, "vcgra_fused_batched", fails)
    fleet = PixieFleet(backend="hopper", device="cpu", faults=FaultInjector(seed=0),
                       breakers=BreakerBoard(failure_threshold=1))
    fleet.submit(FleetRequest(app="sobel_x", image=images(16, 1)[0]))
    with pytest.raises(type(error), match=str(error)[:20]):
        fleet.flush()
    assert (fleet.stats.fallback_dispatches, fleet.stats.retries, fleet.stats.dispatches) == (0, 0, 0)
    assert fleet.breakers.events == [] and fleet.stats.dispatch_plans == {}


@pytest.mark.parametrize("kind", ["image", "channels", "pipeline"])
def test_wide_grid_is_served_as_the_reference_serves_it(kind):
    """A grid 65 values wide, past what B1-B4's value banks once held, is
    served by a hopper fleet (on the CPU, the kernels' plain versions)
    bitwise as the reference's xla fleet serves it, and as the torch fleet
    does: no refusal at submit, nothing degraded."""
    from repro.core.grid import custom as r_custom
    from repro_torch.core.grid import custom

    widths = [65, 11, 7, 5, 3, 3, 2]
    grid, r_grid = custom("wide-65", 65, widths, 1), r_custom("wide-65", 65, widths, 1)
    (image,) = images(17, 1, shapes=[(9, 12)])
    taps = {k: v.numpy() for k, v in t_apps.stencil_inputs(torch.from_numpy(image)).items()}
    request = {"image": dict(app="sobel_x", image=image),
               "channels": dict(app="sobel_x", inputs=taps),
               "pipeline": dict(pipeline=["sobel_x", "threshold"], image=image)}[kind]
    (want,) = RFleet(backend="xla").run_many([RRequest(grid=r_grid, **request)])
    fleet = PixieFleet(backend="hopper", device="cpu")
    (got,) = fleet.run_many([FleetRequest(grid=grid, **request)])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert fleet.stats.submitted == 1 and fleet.stats.dispatches == 1
    assert all(getattr(fleet.stats, k) == 0 for k in LADDER[:4])
    (served,) = PixieFleet(backend="torch", device="cpu").run_many(
        [FleetRequest(grid=grid, **request)])
    np.testing.assert_array_equal(served, got)


def test_kernel_build_error_raises_out_of_flush(monkeypatch, tmp_path):
    """The hopper executor's library cannot be built (no ``nvcc``, no
    cached library): ``KernelBuildError`` raises out of ``flush()`` and no
    request is degraded to ``torch``, even with a fault injector armed."""
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "library_path",
                        lambda name, build_dir=None: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))

    def needs_the_library(*args, **kwargs):
        build.load_library("vcgra")

    monkeypatch.setattr(vcgra_ops, "vcgra_fused_batched", needs_the_library)
    fleet = PixieFleet(backend="hopper", device="cpu", faults=FaultInjector(seed=0))
    fleet.submit(FleetRequest(app="sobel_x", image=images(13, 1)[0]))
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        fleet.flush()
    assert fleet.stats.fallback_dispatches == 0 and fleet.stats.retries == 0
    assert fleet.stats.dispatches == 0 and fleet.breakers.events == []
    with pytest.raises(KernelBuildError):
        build.find_nvcc()


# -- async ingest on the CPU --------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_async_ingest_bitwise_with_lazy_outputs(backend):
    """Async ingest on the CPU runs the pool rotation and the lazy-output
    code with always-ready readiness: a third flush reuses the first
    flush's canvas while that flush's outputs are still unread, and every
    output equals the sync fleet's (fused, chain and channel paths)."""
    imgs = images(14, 3, shapes=[(9, 13), (16, 5), (12, 12)])
    taps = {k: v.numpy() for k, v in t_apps.stencil_inputs(torch.from_numpy(imgs[2])).items()}

    def trace(k):
        return [FleetRequest(app=NAMES[k], image=imgs[0]),
                FleetRequest(pipeline=["sobel_x", "threshold"], image=imgs[1]),
                FleetRequest(app="sharpen", inputs=taps)]

    sync = PixieFleet(backend=backend, device="cpu")
    fleet = PixieFleet(backend=backend, device="cpu", ingest="async")
    assert (fleet.stats.ingest, fleet.stats.ingest_readiness) == ("async", "always-ready")
    assert sync.stats.ingest_readiness == "none"
    held = [fleet.run_many(trace(k)) for k in range(3)]
    for k, outs in enumerate(held):
        for got, want in zip(outs, sync.run_many(trace(k))):
            assert isinstance(got, LazyOutput) and got.shape == want.shape
            np.testing.assert_array_equal(np.asarray(got), want)
    assert fleet.stats.canvas_pool_hits >= 2
    assert fleet.stats.ingest_overlap_s == 0.0
    assert fleet.stats.dispatch_plans == sync.stats.dispatch_plans


def test_async_output_buffers_are_pooled_and_copied_out():
    """Async ingest keeps two host output buffers per size: a third flush
    refills the first flush's buffer while that flush's output is still
    unread, so the pool copies it out first; a read output owns its
    values (no view of a pooled buffer)."""
    imgs = images(15, 3, shapes=[(9, 13)] * 3)
    fleet = PixieFleet(device="cpu", ingest="async")
    held = [fleet.run_many([FleetRequest(app="sobel_x", image=im)])[0] for im in imgs]
    ((key, pool),) = fleet._output_pool._d.items()
    assert len(pool) == 2 and key == ((fleet.batch_tile * 16 * 16,), torch.int32)
    sync = PixieFleet(device="cpu")
    for got, im in zip(held, imgs):
        (want,) = sync.run_many([FleetRequest(app="sobel_x", image=im)])
        arr = np.asarray(got)
        np.testing.assert_array_equal(arr, want)
        assert not any(np.shares_memory(arr, e.buf.numpy()) for e in pool)


# -- heartbeat and ElasticPlan (twins of test_fault_tolerance.py) -------------


def test_straggler_detection_matches_reference():
    durations = [1.0] * 10 + [10.0, 1.1, 0.2, 5.0, 2.9, 3.1]
    flags = []
    for Monitor in (HeartbeatMonitor, RHeartbeatMonitor):
        mon = Monitor(window=16, factor=3.0)
        flags.append(([mon.record(s, d) for s, d in enumerate(durations)], mon.stragglers))
    assert flags[0] == flags[1]
    assert flags[0][0][10] and flags[0][1][0][0] == 10
    assert not HeartbeatMonitor().record(0, 100.0)   # no baseline yet
    mon = HeartbeatMonitor()
    mon.start()
    assert mon.stop(0) >= 0.0 and len(mon.durations) == 1
    assert mon.throughput(8) == pytest.approx(8 / mon.durations[0])


@pytest.mark.parametrize("old,new", [((16, 16), 192), ((2, 16, 16), 384), ((16, 16), 8)])
def test_elastic_plan_matches_reference_and_warns(old, new):
    names = ("data", "model") if len(old) == 2 else ("pod", "data", "model")
    with pytest.warns(DeprecationWarning, match="fallback_chain"):
        ep = ElasticPlan(old_shape=old, new_devices=new, axis_names=names)
    with pytest.warns(DeprecationWarning):
        rp = RElasticPlan(old_shape=old, new_devices=new, axis_names=names)
    assert ep.plan() == rp.plan() and ep.can_restore() == rp.can_restore()
