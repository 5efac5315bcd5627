"""Fleet quickstart on the card: many tenants, one overlay dispatch.

Twin of ``examples/fleet_quickstart.py``.  Where
``examples/torch_quickstart.py`` shows the paper's story for ONE
application at a time, this example shows the multi-tenant extension: a
mixed stream of image-processing requests -- different applications,
different frame sizes -- served by one overlay (B1 on the card) through
the batched fleet runtime, behind the futures service API (``submit``
returns a ``JobHandle``; ``result()`` drives the dispatch).  A streaming
epilogue serves the same mix with per-request deadlines through the
continuous-batching front-end, and a resilience epilogue replays it under
seeded fault injection (transient faults retried, a poisoned tenant
quarantined by bisection).

The reference's fleet is built on a device mesh (``MeshSpec(app=2)``); the
port has no mesh yet (ROADMAP Queue A item 6), so this fleet runs on one
device and says so.

    PYTHONPATH=src python examples/torch_fleet_quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core import applications as apps
from repro_torch.core import sobel_grid
from repro_torch.core.interpreter import check_device
from repro_torch.runtime import FaultInjector, RetryPolicy
from repro_torch.runtime.fleet import PixieFleet
from repro_torch.serve import FleetFrontend, QuarantinedError, StreamingFrontend

KERNELS = {"sobel_x": apps.SOBEL_X, "sobel_y": apps.SOBEL_Y, "laplace": apps.LAPLACE}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    print(f"=== Pixie fleet quickstart: multi-tenant overlay serving, on {device} ===\n")
    rng = np.random.default_rng(0)
    fleet = PixieFleet(default_grid=sobel_grid(), device=device)
    print("mesh: the MeshSpec(app=2) demo waits for the port's device mesh "
          "(ROADMAP Queue A item 6); this fleet serves from one device")
    svc = FleetFrontend(fleet=fleet)
    print(f"service apps: {svc.available_apps()}")

    # A mixed request stream: 12 frames across 4 tenants, ragged sizes.
    tenants = ["sobel_x", "sobel_y", "threshold", "laplace"]
    frames = [
        rng.integers(0, 256, (h, w)).astype(np.int32)
        for h, w in [(64, 64), (48, 80), (32, 32)] * 4
    ]
    handles = [
        svc.submit(tenants[i % len(tenants)], frame)
        for i, frame in enumerate(frames)
    ]

    t0 = time.perf_counter()
    svc.flush()                            # ONE dispatch drains the queue
    dt = time.perf_counter() - t0
    assert all(h.done() for h in handles)
    print(f"\nserved {len(handles)} requests in one flush: {1e3*dt:.1f} ms "
          f"({len(handles)/dt:.0f} apps/s, first flush includes the kernel build)")

    # Spot-check one output against the numpy oracle.
    edge = np.asarray(handles[0].result())
    ref = apps.conv2d_reference(frames[0], apps.SOBEL_X)
    assert np.array_equal(edge, ref), "fleet output mismatch!"
    print("fleet output == numpy oracle  [ok]")

    # A second wave: repeat tenants hit every cache.  No explicit flush --
    # asking any pending handle for its result kicks the dispatch.
    handles = [
        svc.submit(tenants[i % len(tenants)], frame)
        for i, frame in enumerate(frames)
    ]
    t0 = time.perf_counter()
    outs = [h.result() for h in handles]
    dt = time.perf_counter() - t0
    print(f"second wave (all caches warm): {1e3*dt:.1f} ms "
          f"({len(outs)/dt:.0f} apps/s)")
    job = handles[0].job()
    print(f"latency split: queue {1e3*job.queue_s:.2f} ms + "
          f"flush {1e3*job.flush_s:.2f} ms")

    s = svc.stats.as_dict()
    print(f"\nfleet stats: {s}")
    assert s["overlay_builds"] == 1, "overlay must compile once per grid"
    assert s["config_cache_hits"] > 0, "repeat tenants must skip place/route"
    print("compile-once + repeat-tenant fast path  [ok]")

    # Streaming epilogue: the same mix through the continuous-batching
    # front-end, each request carrying a deadline.  The worker thread
    # batches arrivals and launches a partial tile rather than miss.
    print("\n--- streaming front-end (deadlines, worker thread) ---")
    with StreamingFrontend(fleet=PixieFleet(default_grid=sobel_grid(), device=device),
                           target_batch=4) as stream:
        warm = stream.process("sobel_x", frames[0])   # absorb the first build
        assert np.array_equal(np.asarray(warm), ref)
        stream.latency.reset()
        hs = [
            stream.submit(tenants[i % len(tenants)], frame, deadline_s=5.0)
            for i, frame in enumerate(frames)
        ]
        outs = [h.result(timeout=30.0) for h in hs]
    for h, frame in zip(hs, frames):
        kernel = KERNELS.get(h.app)
        if kernel is not None:
            assert np.array_equal(np.asarray(h.result()),
                                  apps.conv2d_reference(frame, kernel))
    lat = stream.latency.summary()
    print(f"streaming p99 total: {1e3*lat['total_s']['p99']:.1f} ms, "
          f"deadline misses: {lat['deadline_misses']}")
    assert lat["deadline_misses"] == 0
    print("streaming serving under deadline  [ok]")

    # Resilience epilogue: the same mix with a seeded fault injector.  A
    # transient dispatch blip is retried invisibly; a permanently
    # poisoned tenant is isolated by bisection and surfaces as a typed
    # QuarantinedError on ITS handles only -- batchmates still get
    # bitwise-correct outputs.
    print("\n--- self-healing serving (seeded fault injection) ---")
    faults = (FaultInjector(seed=0)
              .inject("dispatch", max_fires=2)            # transient blip
              .inject("dispatch", transient=False,
                      match=("<app:threshold>",)))        # poisoned tenant
    chaos_fleet = PixieFleet(default_grid=sobel_grid(), faults=faults,
                             retry=RetryPolicy(backoff_base_s=1e-3), device=device)
    with StreamingFrontend(fleet=chaos_fleet, target_batch=4) as stream:
        hs = [stream.submit(tenants[i % len(tenants)], frame)
              for i, frame in enumerate(frames)]
        served = quarantined = 0
        for h, frame in zip(hs, frames):
            try:
                out = h.result(timeout=30.0)
            except QuarantinedError as e:
                assert e.app == "threshold" and e.ticket is not None
                quarantined += 1
                continue
            served += 1
            kernel = KERNELS.get(h.app)
            if kernel is not None:
                assert np.array_equal(np.asarray(out), apps.conv2d_reference(frame, kernel))
    s = chaos_fleet.stats
    print(f"served {served}, quarantined {quarantined} "
          f"(retries {s.retries}, fallbacks {s.fallback_dispatches})")
    assert quarantined == sum(1 for i in range(len(frames))
                              if tenants[i % len(tenants)] == "threshold")
    assert served == len(frames) - quarantined
    print("poison isolated, batchmates served bitwise  [ok]")
    print("\nfleet quickstart complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
