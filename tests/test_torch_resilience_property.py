"""Property-based twin of ``tests/test_resilience_property.py`` on the
port (hypothesis): for RANDOM poison subsets, bisection quarantine in
``repro_torch``'s fleet isolates EXACTLY the poisoned tickets -- every
survivor bitwise equal to the reference's fault-free ``backend="xla"``
output, every poisoned ticket a typed ``QuarantinedError``, and the same
quarantines as the reference's fleet on the same schedule -- on both port
backends.  The backoff schedule is pinned against the reference's as a
pure function of its policy parameters.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro.core import sobel_grid as r_sobel_grid
from repro.runtime.chaos import FaultInjector as RFaultInjector
from repro.runtime.fleet import FleetRequest as RRequest, PixieFleet as RFleet
from repro.runtime.resilience import RetryPolicy as RRetryPolicy

from repro_torch.core.grid import sobel_grid
from repro_torch.runtime.chaos import FaultInjector
from repro_torch.runtime.fleet import FleetRequest, PixieFleet
from repro_torch.runtime.resilience import QuarantinedError, RetryPolicy

NAMES = ["sobel_x", "sobel_y", "laplace", "sharpen", "identity", "threshold"]
RNG = np.random.default_rng(1234)
IMAGES = [RNG.integers(0, 256, (5 + i, 7)).astype(np.int32) for i in range(len(NAMES))]
ORACLE = []


def _oracle():
    if not ORACLE:
        fleet = RFleet(default_grid=r_sobel_grid(), backend="xla")
        ORACLE.extend(np.asarray(y) for y in fleet.run_many(
            [RRequest(app=n, image=im) for n, im in zip(NAMES, IMAGES)]))
    return ORACLE


def _quarantined(fleet, tickets):
    out = []
    for t in tickets:
        try:
            fleet.result(t)
        except Exception as exc:  # QuarantinedError of either package
            out.append((exc.ticket, exc.app))
    return out


@settings(max_examples=8, deadline=None)
@given(
    poison=st.sets(st.integers(min_value=0, max_value=len(NAMES) - 1),
                   min_size=1, max_size=len(NAMES) - 1),
    backend=st.sampled_from(["torch", "hopper"]),
)
def test_bisection_isolates_exactly_the_poisoned_subset(poison, backend):
    oracle = _oracle()
    match = tuple(f"<ticket:{i}>" for i in sorted(poison))
    fleet = PixieFleet(default_grid=sobel_grid(), backend=backend, device="cpu",
                       faults=FaultInjector(seed=7).inject("dispatch", transient=False,
                                                           match=match),
                       retry=RetryPolicy(max_attempts=1))
    tickets = [fleet.submit(FleetRequest(app=n, image=im)) for n, im in zip(NAMES, IMAGES)]
    fleet.flush()
    ref = RFleet(default_grid=r_sobel_grid(), backend="xla",
                 faults=RFaultInjector(seed=7).inject("dispatch", transient=False, match=match),
                 retry=RRetryPolicy(max_attempts=1))
    r_tickets = [ref.submit(RRequest(app=n, image=im)) for n, im in zip(NAMES, IMAGES)]
    ref.flush()
    for i, t in enumerate(tickets):
        if i in poison:
            with pytest.raises(QuarantinedError) as ei:
                fleet.result(t)
            assert ei.value.ticket == t and ei.value.app == NAMES[i]
        else:
            np.testing.assert_array_equal(np.asarray(fleet.result(t)), oracle[i])
    assert fleet.stats.quarantined_requests == len(poison) == ref.stats.quarantined_requests
    assert _quarantined(ref, r_tickets) == [(r_tickets[i], NAMES[i]) for i in sorted(poison)]
    assert fleet.stats.dispatches == ref.stats.dispatches


@settings(max_examples=50, deadline=None)
@given(
    attempts=st.integers(min_value=1, max_value=8),
    base_ms=st.floats(min_value=0.1, max_value=50.0),
    mult=st.floats(min_value=1.0, max_value=4.0),
    cap_ms=st.floats(min_value=0.1, max_value=200.0),
)
def test_backoff_schedule_is_pure_monotone_capped_and_the_reference(attempts, base_ms,
                                                                    mult, cap_ms):
    kw = dict(max_attempts=attempts, backoff_base_s=base_ms / 1e3,
              backoff_multiplier=mult, backoff_max_s=cap_ms / 1e3)
    r = RetryPolicy(**kw)
    sched = r.schedule()
    assert sched == RRetryPolicy(**kw).schedule()
    assert len(sched) == attempts - 1
    assert sched == r.schedule()                      # pure: no jitter
    assert all(b <= r.backoff_max_s + 1e-12 for b in sched)
    assert all(b2 >= b1 - 1e-12 for b1, b2 in zip(sched, sched[1:]))
    for i, b in enumerate(sched):
        assert b == min(r.backoff_base_s * mult ** i, r.backoff_max_s)
