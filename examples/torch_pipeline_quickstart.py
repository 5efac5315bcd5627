"""Pipeline quickstart on the card: a chained overlay as ONE dispatch.

Twin of ``examples/pipeline_quickstart.py``.  A real image pipeline is a
chain -- blur -> edge detect -> binarize.  Run naively, each stage is its
own dispatch with a HOST HOP between: the intermediate leaves the device,
is re-embedded into a canvas, and its line buffers are re-formed from
scratch.  The pipeline plan folds the whole chain into one executable
(B3 on the card): stage i's selected output channel re-feeds stage i+1's
ingest taps on the device, so intermediates never leave it.  This example
runs the same depth-3 chain three ways -- staged, ``Pixie.run_pipeline``,
and the front-end's chain spelling -- and checks all outputs are bitwise
identical.

    PYTHONPATH=src python examples/torch_pipeline_quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import Pixie, map_app
from repro_torch.core import applications as apps
from repro_torch.core.grid import custom
from repro_torch.core.interpreter import check_device
from repro_torch.core.place import level_demand
from repro_torch.serve import FleetFrontend

CHAIN = ["gauss3", "sobel_x", "threshold"]


def chain_grid():
    """One overlay grid sized for every stage (per-level width = max
    demand across the chain's DFGs + slack), so the whole chain runs on
    one compiled executable."""
    dfgs = [apps.ALL_APPS[n]() for n in CHAIN]
    demands = [level_demand(g) for g in dfgs]
    depth = max(len(d) for d in demands)
    demands = [list(d) + [1] * (depth - len(d)) for d in demands]
    widths = [max(d[lvl] for d in demands) + 1 for lvl in range(depth)]
    return custom("pipe-demo", max(len(g.inputs) for g in dfgs), widths, 1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="a 64x64 frame instead of 256x256")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    side = 64 if args.small else 256
    print(f"=== Pixie pipeline quickstart: device-resident chains, on {device} ===\n")
    rng = np.random.default_rng(0)
    grid = chain_grid()
    img = rng.integers(0, 256, (side, side)).astype(np.int32)
    print(f"chain: {' -> '.join(CHAIN)} on grid {grid.name}, "
          f"{img.shape[0]}x{img.shape[1]} px\n")

    # -- staged: one dispatch per stage, intermediate via the host -------
    pix = Pixie(grid, mode="conventional", device=device)
    cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in CHAIN]

    def staged():
        cur = img
        for cfg in cfgs:
            pix.load(cfg)
            cur = pix.run_image(cur).cpu().numpy()  # host hop
        return cur

    staged_out = staged()  # warm (builds the single-stage kernels)
    t0 = time.perf_counter()
    staged_out = staged()
    t_staged = time.perf_counter() - t0
    print(f"staged   {len(CHAIN)} dispatches, "
          f"{len(CHAIN) - 1} host round trips: {1e3 * t_staged:7.1f} ms")

    # -- fused: the whole chain is ONE executable ------------------------
    fused_out = pix.run_pipeline(CHAIN, img).cpu().numpy()  # warm
    t0 = time.perf_counter()
    fused = pix.run_pipeline(CHAIN, img)
    _sync(device)
    t_fused = time.perf_counter() - t0
    fused_out = fused.cpu().numpy()
    print(f"fused    1 dispatch,  0 host round trips: "
          f"{1e3 * t_fused:7.1f} ms   (x{t_staged / t_fused:.1f})")
    np.testing.assert_array_equal(fused_out, staged_out)
    print("bitwise: fused chain == staged per-stage oracle\n")

    # -- served: a list of stages IS the chain spelling ------------------
    svc = FleetFrontend(fleet=None, backend="hopper", device=device)
    handle = svc.submit(CHAIN, img, grid=grid)
    np.testing.assert_array_equal(np.asarray(handle.result()), staged_out)
    print(f"served:  svc.submit({CHAIN!r}, img) -> "
          f"job {handle.job().app!r}, bitwise identical")
    print(f"         pipeline dispatches: {svc.stats.pipeline_dispatches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
