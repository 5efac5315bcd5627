"""Port parity, the slice as a whole: the port's fleet and front-end
against the reference's on the same mixed trace.

Both port backends (``"torch"``, the eager oracle, and ``"hopper"``, the
kernels' plain versions on the CPU) must give bitwise the reference's
``backend="xla"`` outputs, equal ``FleetStats`` counters, and plan keys
that differ only in the backend segment.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.core import map_app as r_map_app
from repro.core.grid import sobel_grid as r_sobel_grid
from repro.runtime.fleet import FleetRequest as RRequest, PixieFleet as RFleet
from repro.serve.fleet_frontend import FleetFrontend as RFrontend

from repro_torch.core import applications as t_apps
from repro_torch.core.plan import OverlayExecutable
from repro_torch.runtime.fleet import (
    FleetRequest as TRequest, LRUCache, PixieFleet as TFleet,
)
from repro_torch.serve import FleetFrontend as TFrontend

from conftest import shared_app_grid
from test_torch_core import R_SHARED, port_config, port_grid, with_dtype

PORT_BACKENDS = ["torch", "hopper"]

#: Counters both fleets keep under the same names.
COUNTERS = (
    "submitted", "executed", "dispatches", "fused_dispatches",
    "pipeline_dispatches", "partial_tile_dispatches", "padded_app_slots", "map_calls",
    "config_cache_hits", "overlay_builds", "overlay_cache_hits",
    "stack_bank_hits", "canvas_pool_hits",
)


def frames(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw).astype(np.int32) for hw in shapes]


def assert_same_stats(t_stats, r_stats, backend):
    for name in COUNTERS:
        assert getattr(t_stats, name) == getattr(r_stats, name), name
    assert t_stats.dispatch_plans == {
        k.replace("|xla|", f"|{backend}|"): v for k, v in r_stats.dispatch_plans.items()
    }


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_frontend_matches_reference_on_ragged_image_trace(backend):
    """Two flushes of ragged image requests on two grids (the all-apps
    grid exercises DIV through gauss3/box3); the repeat flush hits every
    cache the same way in both packages."""
    apps_a = ["sobel_x", "sobel_y", "sharpen", "laplace", "threshold", "identity",
              "sobel_x", "laplace", "threshold"]
    imgs_a = frames(0, [(9, 13), (16, 16), (5, 20), (7, 7), (12, 3), (1, 1),
                        (17, 9), (4, 30), (8, 8)])
    apps_b = ["gauss3", "box3", "sobel_mag"]
    imgs_b = frames(1, [(10, 11), (6, 19), (13, 5)])
    t_shared = port_grid(R_SHARED)
    r_svc = RFrontend(backend="xla")
    t_svc = TFrontend(backend=backend, device="cpu")
    for _ in range(2):
        r_h = [r_svc.submit(a, im) for a, im in zip(apps_a, imgs_a)]
        r_h += [r_svc.submit(a, im, grid=R_SHARED) for a, im in zip(apps_b, imgs_b)]
        t_h = [t_svc.submit(a, im) for a, im in zip(apps_a, imgs_a)]
        t_h += [t_svc.submit(a, im, grid=t_shared) for a, im in zip(apps_b, imgs_b)]
        for r, t in zip(r_h, t_h):
            np.testing.assert_array_equal(t.result(), r.result())
    assert_same_stats(t_svc.stats, r_svc.stats, backend)
    np.testing.assert_array_equal(
        t_h[-3].result(), t_apps.conv2d_reference(imgs_b[0], t_apps.GAUSS3, 16.0))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_fleet_matches_reference_on_mixed_trace(backend):
    """Image requests, named-channel requests and an image app without an
    ingest plan in ONE flush: a fused and a packed-channel dispatch."""
    r_grid = r_sobel_grid()
    t_grid = port_grid(r_grid)
    rng = np.random.default_rng(2)
    no_ingest = dataclasses.replace(r_map_app(r_apps.sobel_y(), r_grid), ingest=None)
    imgs = frames(3, [(9, 13), (16, 5), (6, 6), (11, 11)])
    taps = {k: np.asarray(v) for k, v in r_apps.stencil_inputs(imgs[2]).items()}
    channels = {k: rng.integers(0, 256, 50).astype(np.int32) for k in taps}
    trace = [
        ("image", "sobel_x", imgs[0]), ("inputs", "sharpen", taps),
        ("image", "laplace", imgs[1]), ("config", no_ingest, imgs[3]),
        ("inputs", "sobel_x", channels), ("image", "threshold", imgs[2]),
    ]

    def requests(Request, to_app):
        out = []
        for kind, app, data in trace:
            if kind == "inputs":
                out.append(Request(app=app, inputs=data))
            else:
                out.append(Request(app=to_app(app), image=data))
        return out

    r_fleet = RFleet(default_grid=r_grid, backend="xla")
    t_fleet = TFleet(default_grid=t_grid, backend=backend, device="cpu")
    want = r_fleet.run_many(requests(RRequest, lambda a: a))
    got = t_fleet.run_many(requests(
        TRequest, lambda a: port_config(a) if not isinstance(a, str) else a))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert_same_stats(t_fleet.stats, r_fleet.stats, backend)
    assert t_fleet.stats.dispatches == 2 and t_fleet.stats.fused_dispatches == 1


@pytest.mark.parametrize("dtype_name", ["int16", "float32", "bfloat16"])
def test_fleet_matches_reference_on_other_grid_dtypes(dtype_name):
    r_grid = with_dtype(r_sobel_grid(), dtype_name)
    names = ["sobel_x", "sharpen", "threshold"]
    imgs = frames(4, [(7, 9), (12, 4), (3, 3)])
    want = RFleet(default_grid=r_grid).run_many(
        [RRequest(app=a, image=im) for a, im in zip(names, imgs)])
    got = TFleet(default_grid=port_grid(r_grid), device="cpu").run_many(
        [TRequest(app=a, image=im) for a, im in zip(names, imgs)])
    for g, w in zip(got, want):
        w = np.asarray(w)
        if dtype_name == "bfloat16":
            np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                       rtol=0.5, atol=0.5)
        else:
            np.testing.assert_array_equal(g, w)


#: Frames whose largest side is no power of two (bucket 32 x 64; canvas: the
#: largest height, the largest width rounded up to 16), and frames that fill
#: their bucket: (frame sizes, bucket, canvas).
RAGGED = ([(20, 40), (13, 9)], (32, 64), (20, 48))
FILLED = ([(16, 32), (8, 16)], (16, 32), (16, 32))
CHAIN = ["gauss3", "sobel_x", "threshold"]


def spy_on_frames(fleet):
    """Record the shape of the frames operand of every executable call."""
    shapes, build = [], fleet.overlay_executable

    def overlay_executable(plan):
        ex = build(plan)

        def run(*args):
            shapes.append(tuple(args[-1].shape))
            return ex(*args)

        return OverlayExecutable(ex.plan, run, mesh=ex.mesh)

    fleet.overlay_executable = overlay_executable
    return shapes


@pytest.mark.parametrize("path,ingest,case", [
    ("fused", "sync", RAGGED), ("fused", "async", RAGGED),
    ("pipeline", "sync", RAGGED), ("pipeline", "async", RAGGED),
    ("fused", "sync", FILLED),
], ids=["fused-sync", "fused-async", "pipeline-sync", "pipeline-async", "filled"])
def test_frame_canvas_fits_the_tiles_frames(path, ingest, case):
    """B1's and B3's dispatches run over a canvas fitted to the tile's
    frames inside their pow-2 bucket, which still keys the pools and the
    dispatch stamp: outputs bitwise the reference's, equal counters and plan
    keys.  The two frames swap slots each flush, so a reused canvas holds
    the other frame's pixels until it is zeroed (the third flush reuses
    the first's buffer under async ingest)."""
    shapes, (Hb, Wb), (Hc, Wc) = case
    imgs = frames(11, shapes)
    if path == "fused":
        r_grid, work = r_sobel_grid(), [dict(app="sobel_x"), dict(app="laplace")]
    else:
        r_grid, work = shared_app_grid(CHAIN, name="pipe-shared"), [dict(pipeline=CHAIN)] * 2
    r_fleet = RFleet(default_grid=r_grid, backend="xla", batch_tile=2, ingest=ingest)
    t_fleet = TFleet(default_grid=port_grid(r_grid), backend="torch", batch_tile=2,
                     device="cpu", ingest=ingest)
    shipped = spy_on_frames(t_fleet)
    for order in ((0, 1), (1, 0), (1, 0)):
        want = r_fleet.run_many([RRequest(image=imgs[i], **work[i]) for i in order])
        got = t_fleet.run_many([TRequest(image=imgs[i], **work[i]) for i in order])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # The reference's plan keys name async ingest; the port's do not.
    r_stats = dataclasses.replace(r_fleet.stats, dispatch_plans={
        k.replace("|async|", "|"): v for k, v in r_fleet.stats.dispatch_plans.items()})
    assert_same_stats(t_fleet.stats, r_stats, "torch")
    assert shipped == [(2, Hc, Wc)] * 3 and Wc % 16 == 0
    assert t_fleet.stats.canvas_px == 3 * 2 * Hc * Wc
    assert t_fleet.stats.bucket_px == 3 * 2 * Hb * Wb
    assert set(t_fleet.stats.dispatch_plans.values()) == {3}
    assert all(k.endswith(f"|n2x{Hb}x{Wb}") for k in t_fleet.stats.dispatch_plans)


def test_flush_limit_and_ticket_redemption():
    fleet = TFleet(device="cpu")
    imgs = frames(5, [(4, 4)] * 3)
    tickets = [fleet.submit(TRequest(app="identity", image=im)) for im in imgs]
    assert fleet.pending_count() == 3
    out = fleet.flush(limit=2)
    assert sorted(out) == tickets[:2] and fleet.pending_count() == 1
    np.testing.assert_array_equal(fleet.result(tickets[0]), imgs[0])
    with pytest.raises(KeyError, match="no retained result"):
        fleet.result(tickets[0])
    fleet.discard(tickets[1])
    fleet.flush()
    np.testing.assert_array_equal(fleet.result(tickets[2]), imgs[2])
    fleet.submit(TRequest(app="identity", image=imgs[0]))
    with pytest.raises(ValueError, match="flush limit"):
        fleet.flush(limit=0)


def test_submit_validation_matches_reference_messages():
    fleet = TFleet(device="cpu")
    with pytest.raises(ValueError, match="app= or pipeline= must be given"):
        fleet.submit(TRequest(image=np.zeros((2, 2))))
    with pytest.raises(ValueError, match="exactly one of inputs= or image="):
        fleet.submit(TRequest(app="sobel_x"))
    with pytest.raises(ValueError, match=r"image must be \[H, W\]"):
        fleet.submit(TRequest(app="sobel_x", image=np.zeros(4)))
    with pytest.raises(KeyError, match="missing input"):
        fleet.submit(TRequest(app="sobel_x", inputs={"p00": np.zeros(4)}))
    with pytest.raises(ValueError, match="unknown backend"):
        TFleet(backend="xla", device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        TFrontend(fleet=fleet, backend="torch")
    with pytest.raises(KeyError, match="unknown app"):
        TFrontend(device="cpu").submit("nope", np.zeros((2, 2)))


def test_default_construction_needs_a_card(monkeypatch):
    """The entry points default to device="cuda" and backend="hopper";
    with no card visible they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFleet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFrontend()
    svc = TFrontend(device="cpu")
    assert svc.backend == "hopper" and svc.device == torch.device("cpu")


def test_lru_cache_counters():
    c = LRUCache(2)
    assert c.get("a") is None
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    assert c.put("c", 3) == ["b"]
    assert (c.hits, c.misses, c.evictions, len(c)) == (1, 1, 1, 2)
    with pytest.raises(ValueError):
        LRUCache(0)
