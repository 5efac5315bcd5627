"""Quickstart on the card: the paper's demonstrator end to end, in PyTorch.

Twin of ``examples/quickstart.py``.  Builds the 45-PE/4-VC Sobel grid
(paper Fig. 5), runs the full VCGRA tool flow (synthesis -> place -> route
-> settings), executes on both the compile-once conventional overlay (the
hand-written kernels B1/B2) and the parameterized path (B5, the app's own
kernel generated and NVRTC-compiled at ``load``), validates against the
numpy convolution oracle, and shows the compile-gap numbers the paper is
about.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions
"""

import argparse
import time

import numpy as np

from repro_torch.core import Pixie, SOBEL_SOURCE, synthesize
from repro_torch.core import applications as apps
from repro_torch.core.grid import rectangular
from repro_torch.core.interpreter import check_device
from repro_torch.core.place import level_demand


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="a 64x64 frame instead of 256x256")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    side = 64 if args.small else 256
    print(f"=== Pixie quickstart: Sobel on the 45-PE VCGRA (paper Sec. IV), on {device} ===\n")

    # 1. the application, synthesized from its textual description
    dfg = synthesize("sobel_mag", SOBEL_SOURCE)
    print(f"synthesized netlist: {dfg.num_ops()} PE ops, depth {dfg.depth()}, "
          f"{len(dfg.inputs)} memory inputs")

    # 2. the overlay grid + tool flow (map < 1 s is the paper's headline).
    #    Size the grid to host every app we'll reconfigure onto it.
    blur_dfg = apps.gaussian_blur()
    d1, d2 = level_demand(dfg), level_demand(blur_dfg)
    grid = rectangular(
        "demo",
        num_inputs=max(len(dfg.inputs), len(blur_dfg.inputs)),
        levels=max(len(d1), len(d2)),
        width=max(max(d1), max(d2)),
        num_outputs=1,
    )
    pix = Pixie(grid, mode="conventional", device=device)
    t0 = time.perf_counter()
    config = pix.map(dfg)
    print(f"map (synth+place+route+settings): {1e3*(time.perf_counter()-t0):.1f} ms "
          f"(paper: < 1 s)")
    print(f"settings: {config.settings_words()} words "
          f"({config.settings_bits(grid)} bits)")

    # 3. compile the overlay ONCE (the '1200 s FPGA compile' analogue: on
    #    the card, building the kernel library at its first use)
    img = np.random.default_rng(0).integers(0, 256, (side, side)).astype(np.int32)
    t = pix.compile_overlay(batch=img.size)
    print(f"overlay compile (once per grid): {t:.2f} s")

    # 4. load + run, check against the oracle
    pix.load(config)
    out = pix.run_image(img).cpu().numpy()
    ref = apps.sobel_magnitude_reference(img)
    assert np.array_equal(out, ref), "overlay output mismatch!"
    print("conventional overlay == numpy oracle  [ok]")

    # 5. reconfigure to a different app WITHOUT recompiling
    blur = pix.map(blur_dfg)
    t_sw = pix.load(blur)
    out2 = pix.run_image(img).cpu().numpy()
    ref2 = apps.conv2d_reference(img, apps.GAUSS3, divisor=16.0)
    assert np.array_equal(out2, ref2)
    print(f"reconfigured to gauss3 in {1e3*t_sw:.2f} ms (settings swap, no rebuild)  [ok]")

    # 6. the parameterized path (paper's TLUT/TCON optimization)
    pixp = Pixie(grid, mode="parameterized", device=device)
    t_r = pixp.load(config)
    out3 = pixp.run_image(img).cpu().numpy()
    assert np.array_equal(out3, ref)
    print(f"parameterized (specialized) path: micro-reconfig {t_r:.2f} s, "
          f"output identical  [ok]")

    print("\nquickstart complete.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
