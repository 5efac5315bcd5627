#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. device and build -- the card, its ``nvidia-smi`` name and power limit,
   the kernels built from ``src/repro_torch/kernels/*/csrc/`` (one ``nvcc``
   per source, all at once: B1/B2/B4, B3, the NVRTC host shim of B5 and
   B6) and one cold NVRTC compile of a generated B5 kernel;
2. kernels vs their plain PyTorch versions on the card -- B1 and B2
   bitwise over every grid dtype (bf16 included), the Sobel grid, the
   all-apps grid and a 40-wide grid; B1 at radius 0, 1, 2 and 17 (past its
   shared-memory window: taps from device memory), ragged N, frames of
   37 x 53, 64 x 17, 1 x 1 and 33 x 2049 and every tile height; B2 at B =
   1, 45, 1000 and 4099; B3 (the chain
   kernel) over every grid dtype, the pipe-shared and all-apps grids (and a
   two-output pipe-shared grid with random output muxes and forwarded
   channels), chains of radii (1,1,1), (1,0), (0,1) and (1,0,1,1), N = 3
   and 11, ragged ``hw`` down to (1, 1) and every tile height, and frames
   of several of the kernel's output tiles (2 x 200 x 331, 3 x 130 x 67),
   ragged in both directions;
2b. wide grids and deep chains (:func:`phase_wide_and_deep`, ~30-60 s) --
   with the counters reset just before, in every grid dtype, the 98-wide
   ``conv7-exact`` grid (a 7 x 7 convolution, radius-3 fused ingest)
   through ``PixieFleet`` (two image requests and one named-channel
   request), ``Pixie`` in both modes and ``vcgra_apply`` conventional, then
   a mixed 1080p flush on pipe-shared holding a 17-stage gauss3 chain (two
   B3 segments), a depth-3 chain and single-stage requests, equal to the
   staged numpy oracle and ``backend="torch"``, the ladder at 0; each conv7
   output bitwise the same entry point on the CPU (the plain versions);
   B1, B2 and B4 bitwise on a 600-value grid (value banks in device
   memory); B3 on chains of R = 17, 33 and a lone radius-20 stage, and on
   the 98- and 600-value grids, one launch a segment; B3's time at the
   17-stage chain and B1's at the 98-wide grid beside their bounds, and
   B1's and B2's on both sides of the switch to device-memory value banks;
3. the main path -- ``FleetFrontend()`` (``device="cuda"``,
   ``backend="hopper"``) serves 8 x 1080p requests, a ragged 4K/720p/480p/
   1080p flush, all nine library apps on the all-apps grid, and one
   named-channel flush through ``PixieFleet.submit``; every output equals
   the numpy oracles and ``backend="torch"`` on the card, and the launch
   counters show which kernels served it;
4. the chain path, driven with the counters reset just before it -- the
   same front-end serves 8 x 1080p ``submit(["gauss3", "sobel_x",
   "threshold"], img, grid=pipe_grid)`` and a mixed flush of two chain
   radii groups and single-stage requests on ``sobel-5x9``; every output
   equals the staged numpy oracle and ``backend="torch"``, and B3's launch
   count equals the fleet's pipeline dispatches;
5. the synthesis case -- ``synthesize("sobel_mag", SOBEL_SOURCE)`` served
   through B1 beside the library ``sobel_mag`` on a 1080p frame, bitwise;
6. the resilience path, each case one flush with the counters reset just
   before it -- at 1080p: a non-transient dispatch fault on the hopper plan
   served by the torch plan, a transient fault retried on B1, a poisoned
   float32 ticket quarantined alone, a 65-wide grid served by B1 and
   a faulted depth-3 chain served by torch -- every output bitwise a sound
   flush's, every degradation stamped;
7. the streaming path -- ``StreamingFrontend()`` serves 48 1080p requests
   with mixed deadlines and priorities plus four depth-3 chains, under
   sync and async ingest, bitwise the sync ``FleetFrontend``; per mode the
   latency percentiles, partial-tile dispatches, ``ingest_overlap_s``, 5
   flushes of 8 x 1080p timed and profiled (the card's busy share).
   Every fleet phase asserts that the ladder moved nothing on a sound
   path: no fallback, retry, quarantine or guard failure, all breakers
   closed;
8. the single-app path, driven with the counters reset just before it --
   ``Pixie(sobel_grid())`` on a 1080p ``sobel_x`` in both modes, ``Pixie``
   on the ``sobel_mag`` exact grid (``run_image``, ``run_raw``,
   ``run_many`` over three ragged apps, ``run_pipeline`` of a depth-3
   chain, the parameterized mode on B5), ``vcgra_apply_image`` in both
   modes (B5, B4), ``sobel_magnitude_fused`` (B6) and a
   ``PixiePreprocessor`` cycling its four filters; every output equals the
   numpy oracles and ``backend="torch"`` on the card;
9. B4, B5 and B6 vs their plain versions -- B4 on every grid dtype, the
   Sobel grid, every library app's exact grid and every library app on
   40- and 64-wide grids, ragged N and three ``block_n``, bitwise (bf16
   too); B5 on the Sobel and exact-grid configs with and without baked
   coefficients (one NVRTC compile each, in parallel threads); B6 for the
   Sobel magnitude and every library filter in int32/float32/bf16 on odd
   non-square frames, widths not a multiple of its V columns a thread or
   below V, one-row frames and 1080p, each from a 16-byte aligned start
   and one element past it, three tile heights;
10. times with CUDA events at the paths' shapes, beside each kernel's bound
   and its plain version's time (B1 also at the all-apps flush's shape, B2
   with its bound over the live channels and over all C; B1's, B2's, B3's
   and B4's blocks: threads, registers, shared memory; B6 and its
   ``conv2d`` yardstick also with the L2 flushed before each run), the
   staged chain (three B1 launches with
   the masked forward between them) beside B3, the end-to-end flush
   times, the paper's four Sobel magnitudes at 1080p int32 (``Pixie``
   conventional and parameterized, ``vcgra_apply_image``, the fused
   stencil) and the single-app ``Pixie.timings`` (map, reconfigure: a
   settings copy, or B5's NVRTC compile and load);
11. B7 (flash decode) vs its plain version -- the case table of
   ``repro_torch.kernels.flash_attention.parity`` (the reference flash
   suite's MHA, GQA 4:1, MQA, ragged 25/5 heads and chunk sweep, and
   gemma-2b's MQA head, H 8, G 1, D 256, a 200-row cache, one head a
   group at D 256, and the zoo's head layouts: gemma3-12b's Hg 2 at D 256,
   deepseek's and qwen2-moe's Hg 1 at D 128, hymba's Hg 5 at D 64,
   musicgen's Hg 1 at D 64; plus 1,024-slot rings read with lengths below,
   at and capped at W), in float32, bf16 and float32 q over a bf16 cache (the
   bf16 caches on the tensor-core body, the float32 ones on the CUDA-core
   body), lengths 0, 1, ragged and S, and a poisoned tail past the
   lengths; float32 outputs at the reference's 2e-5, bf16 outputs within
   one bf16 unit;
12. the LM serving path, driven with the counters reset just before it --
   gemma-2b at full width (2.5 B parameters from a seeded generator on the
   card): ``ServeEngine(max_batch=8, max_seq=4096)`` generates 32 tokens
   from 8 prompts of 128, then a ``SlotServer`` serves 3 requests, one
   arriving mid-decode; B7 must have launched 18 times per decode step and
   nothing else; each ``SlotServer`` token equals the engine's up to a
   tie; then teacher-forced decode-step logits (through B7) are held
   against last-position ``prefill`` logits (plain attention) of the same
   token sequences, from the 128-token prompts and from a 1-token prefix,
   and the same check must fail with B7's lengths planted off by one;
13. B7's times at the engine's shape and at the ``decode_32k`` shape of one
   gemma-2b layer, beside its bound, its plain version and one
   ``scaled_dot_product_attention`` call, with its block's registers and
   shared memory (B3's are in the chain times of phase 7), and the LM's prefill, decode
   step and generate times, with a ``torch.profiler`` view of two decode
   steps (the device's busy time, launches, the costliest kernels);
14. the rest of the LM zoo (:data:`ZOO`), each config built in its served
   dtype from a seeded generator on the card and the launch counters reset
   just before its ``ServeEngine.generate``: gemma3-12b (5:1 local:global
   over 1,024-slot rings, 11.77 B) and deepseek-moe-16b (a dense layer,
   then 64 routed experts top-6 + 2 shared, 16.32 B) at full width and
   depth, batch 8; qwen2-moe-a2.7b, xlstm-1.3b, hymba-1.5b (meta tokens),
   paligemma-3b (stub embeddings, prefix-LM mask) and musicgen-medium at
   full width, batch 2.  B7 must launch once per attention layer per
   decode step and nothing else; teacher-forced decode logits are held
   against prefill logits (gemma3 from 1,000 tokens, its rings wrapping
   during decode, and from 1,100, wrapped in prefill; MoE against a
   dropless prefill, on the rows both routed alike; the recurrent kinds
   with their bf16 prefill's own distance from a float32 one added), and
   two ring faults planted in gemma3's decode must fail the check from a
   1-token prefix.  For gemma3-12b and deepseek-moe-16b: init time, peak
   memory, prefill, decode step, generate, a profile of two steps, the
   prefill's dropped MoE choices, and B7 at their decode shapes beside its
   bound, its plain version and SDPA;
15. the training path (no kernel of its own: training attention is plain
   products, B7 only serves the trained weights) -- (a) the card against
   the CPU port on reduced gemma-2b and deepseek-moe-16b in float32, TF32
   off: loss and every grad leaf, then params and AdamW moments after two
   ``train_step``s; (b) gemma-2b at full width and depth (2.5 B float32
   masters from a seeded generator, ``remat="full"``, batch 4 x 1,024, CE
   chunks of 512): bf16 against float32 compute on the same params and
   batch (loss distance, grad norm ratio, cosine of the flattened grads)
   within limits set from the reference's own gap; (c) 10 ``train_step``s
   on one repeated batch, the loss falling by at least 0.1, with the step
   time, tokens/s, peak memory, model FLOPs and a ``torch.profiler`` step;
   (e) the trained weights, optimizer state dropped, served by
   ``ServeEngine`` at phase 12's shape with the launch counters reset just
   before: B7 18 x 31 launches and nothing else, decode held to prefill and
   the planted faults caught; then ``train_loop`` over ``TokenPipeline``
   for 3 steps; (d) at full width and two layers, a straight run against a
   run checkpointed halfway and resumed by a new ``train_loop``, equal
   losses, and the same check failing with the restored ``count`` planted
   at 0, with a save and a restore timed; (f) deepseek-moe-16b (the dense
   layer and 2 MoE layers at capacity factor 1.25, aux loss in the total,
   ``remat="full"`` equal to ``"none"``), xlstm-1.3b (7 mLSTM + 1 sLSTM,
   256 tokens) and hymba-1.5b (meta tokens, local and global attention) at
   full width, one superblock, a few steps each, finite and falling;
16. the example twins -- each ``examples/torch_*.py`` ``main(["--device",
   "cuda"])`` in-process at its reference's defaults (the training driver
   at 200 of its 300 steps), the launch counters reset just before it: its
   own ``[ok]`` checks pass and the kernels of its path launched;
17. the paper's Table I on the card -- the reference's five components (VC
   8->4, fixed- and floating-point PE, the 4x4 grid on ``reduce8``, the
   Sobel grid of Fig. 5), each: the CPU census of the eager interpreter
   against ``build_specialized_fn`` (``core.analysis.reduction_row``), B4
   against B5 on the card (SASS instructions, registers a thread, shared
   memory, input bytes a pixel; ``core.analysis.kernel_census``) and both
   timed over a 1080p frame's pixels beside the bound, held bitwise to the
   plain version; then one ``resources`` line;
18. the roofline -- gemma-2b's decode step (phase 13's shape) and training
   step (phase 15 (c)'s) censused on ``meta`` tensors
   (``roofline.hlo_analysis``), ``RooflineReport``'s terms at the H100's
   published peaks beside the measured step times; one ``roofline`` line.
   Phase 10 also profiles one single-app 1080p frame per ``Pixie`` mode
   (the card's idle share);
19. the overlay mesh -- (a) ``PixieFleet``, ``FleetFrontend`` and
   ``StreamingFrontend`` on ``MeshSpec(app=2, rows=2)`` serve the 8 x 1080p
   flush, stamped requested (2, 2) and, on fewer than four cards, granted
   (1, 1) and degraded, bitwise a ``MeshSpec()`` fleet; (b) the same flush
   on logical meshes (four shards of the card) at (2, 1), (1, 2), (2, 2) and
   (1, 4), sync and async ingest, the counters reset just before: B1 once
   per shard and dispatch, B2 once per app shard on the named-channel
   flush, the seam halo copies counted, bitwise the single-device run; (c)
   the depth-3 chain at (1, 2) and (2, 2), B1 once per stage and shard,
   bitwise the single-device B3 chain; (d) ``fallback_chain`` of the 2-D
   hopper plan against the reference's ladder, and persistent faults on
   the row-banded and the two-device plans served by the next step; (e)
   real (2, 1) and (1, 2) meshes where there are two or more cards (else a
   line says why not); then one dispatch on a single device and on each
   logical mesh: CUDA-event medians, unshielded and shielded, and a
   ``torch.profiler`` trace of the single-device and the (2, 2) dispatch.

20. the LM mesh (no kernel of its own; a one-process NCCL group the phase
   starts and destroys) -- (a) phase 15 (c)'s gemma-2b training setup on
   ``make_host_mesh("cuda")`` through ``make_plan`` and the plan-based
   ``make_train_step`` (parameters and moments DTensors laid out by the
   plan; on one card every mesh dim is 1 wide, so every placement is
   ``Replicate()``): 3 steps over fresh ``TokenPipeline.device_batch_at``
   batches, each loss within 1e-5 of the no-plan step's from the same
   state and batches, with both steps' times, launches, busy share and
   peak memory; (c) the plan-placed parameters saved, then
   ``restore(shardings=)`` and ``resume_or_init(shardings=)``, bitwise with
   their placements, timed; (b) deepseek-moe-16b's MoE layer at full width
   through ``moe_ffn_ep``'s per-shard (expert-parallel) path against
   ``moe_ffn``; (d) the plan step on two cards where there are two (else a
   line says why not).
21. the dry run and serving under a plan -- (a) B7's sequence-split entry
   over the 16 row blocks of one rank's share of gemma-2b's ``decode_32k``
   cache (8 sequences of 32,768 rows, blocks with no valid row among
   them), merged by the blocks' log-sum-exps, against B7 on the whole
   cache and the plain version at ``parity``'s tolerance, each block
   timed beside its bound, and B7 over a column block of v at gemma3-12b's
   batch-one shape beside its plain partial, its bound and one
   ``scaled_dot_product_attention`` call; (b) gemma-2b at full width served
   under its prefill and decode plans on the one-card host mesh
   (``make_serve_steps``, a one-process NCCL group the phase starts and
   destroys): prefill and 8 greedy decode steps against the no-plan path,
   equal tokens and logits, B7 18 launches a step, both paths'
   decode-step times and busy shares, and the no-plan decode step with B7
   through its torch op against its direct launch; then reduced hymba-1.5b
   and deepseek-moe-16b the same way, 8 forced decode steps, their decode
   logits bit for bit the no-plan path's; (c) ``python -m
   repro_torch.launch.dryrun`` for gemma-2b ``train_4k`` and ``decode_32k``
   on 16 x 16, ``prefill_32k`` and ``train_4k`` on 2 x 16 x 16, hymba-1.5b
   ``decode_32k`` on 16 x 16 and deepseek-moe-16b ``decode_32k`` on 2 x 16
   x 16, each in a subprocess (a fake world, ``meta`` tensors, nothing on
   the card): every report present and without error; (d) the
   live-bytes tracker on ``meta`` against the card: phase 15 (c)'s
   training step without a plan and through the plan step on a one-rank
   (1, 1) mesh, argument bytes equal to the card's params, moments and
   tokens, peaks within 25% of phases 15 (c)'s and 20's
   ``max_memory_allocated``, and where the plan step's extra bytes live.

Then the kernel table line (each kernel also with its bf16 max error, the
image kernels with their launches on phase 2b's path, B1 and B3 with phase
2b's times) and, last, ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --table-times [ROOT]`` times only B1-B7 at the
kernel table's shapes (``PERF.md`` section 6) from the port under ROOT/src
(default: this checkout) and prints one JSON line, so that a parent commit
unpacked beside the checkout can be timed in turns with it in one session.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SOBEL_APPS = ["sobel_x", "sobel_y", "sharpen", "laplace", "threshold", "identity"]
MAIN_APPS = SOBEL_APPS + ["sobel_x", "laplace"]
CHAIN = ["gauss3", "sobel_x", "threshold"]
#: B3's kernel-vs-plain chains as (app, stage radius).
CHAINS = [
    [("gauss3", 1), ("sobel_x", 1), ("threshold", 1)],
    [("gauss3", 1), ("threshold", 0)],
    [("threshold", 0), ("sobel_x", 1)],
    [("gauss3", 1), ("threshold", 0), ("sobel_x", 1), ("threshold", 1)],
]
#: B3's kernel-vs-plain frames that span several of its output tiles.
MULTI_TILE_FRAMES = [(2, 200, 331), (3, 130, 67)]
CSRC = "src/repro_torch/kernels/vcgra/csrc/"
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "vcgra_fused_batched": (CSRC + "vcgra.cu", "src/repro/kernels/vcgra/vcgra_kernel.py:348"),
    "vcgra_batched": (CSRC + "vcgra.cu", "src/repro/kernels/vcgra/vcgra_kernel.py:229"),
    "vcgra_pipeline_batched": (CSRC + "vcgra_pipeline.cu",
                               "src/repro/kernels/vcgra/vcgra_kernel.py:566"),
    "vcgra_conventional": (CSRC + "vcgra.cu", "src/repro/kernels/vcgra/vcgra_kernel.py:178"),
    "vcgra_specialized": ("src/repro_torch/kernels/vcgra/specialized.py",
                          "src/repro/kernels/vcgra/vcgra_kernel.py:87"),
    "stencil_fused": ("src/repro_torch/kernels/stencil/csrc/stencil.cu",
                      "src/repro/kernels/stencil/stencil_kernel.py:55"),
    "flash_decode": ("src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/flash_kernel.py:81"),
}
#: Kernels of the image paths (every one but B7, which the LM path runs).
IMAGE_KERNELS = [k for k in KERNELS if k != "flash_decode"]
DTYPE_NAMES = ("int32", "int16", "float32", "bfloat16")
#: Arithmetic ops per pixel of the fused Sobel magnitude: 12 products and
#: 10 sums over the two filters' nonzero taps, two |.| and the final add.
SOBEL_MAG_OPS = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_launches() -> None:
    from repro_torch.kernels import flash_attention, stencil, vcgra

    vcgra.reset_launch_counts()
    stencil.reset_launch_counts()
    flash_attention.reset_launch_counts()


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_launches`."""
    from repro_torch.kernels import flash_attention, stencil, vcgra

    return {**vcgra.LAUNCHES, **stencil.LAUNCHES, **flash_attention.LAUNCHES}


def no_launches(**counts) -> dict:
    """A launch table with ``counts`` and zero for every other kernel."""
    return {**{name: 0 for name in KERNELS}, **counts}


def shared_grid(names, name="all-apps", num_outputs=1):
    """One grid that fits every named library app (per-level width = max
    demand + 1), built like the test suites' shared grid."""
    from repro_torch.core import applications as apps
    from repro_torch.core.grid import custom
    from repro_torch.core.place import level_demand

    dfgs = [apps.ALL_APPS[n]() for n in names]
    demands = [level_demand(g) for g in dfgs]
    depth = max(len(d) for d in demands)
    demands = [list(d) + [1] * (depth - len(d)) for d in demands]
    widths = [max(d[lvl] for d in demands) + 1 for lvl in range(depth)]
    return custom(name, max(len(g.inputs) for g in dfgs), widths, num_outputs)


def retyped(grid, dtype_name):
    bits, float_pe = {"int32": (32, False), "int16": (16, False),
                      "float32": (32, True), "bfloat16": (16, True)}[dtype_name]
    return dataclasses.replace(grid, data_bits=bits, float_pe=float_pe)


def compare(got, want, dtype_name, exact=False) -> float:
    """Max |got - want|; raises unless bitwise (for bf16 either bitwise,
    with ``exact``, or within 0.5, the reference's own bf16 tolerance,
    relative and absolute)."""
    import torch

    torch.cuda.synchronize()
    g, w = got.double().cpu(), want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if exact and got.dtype == torch.bfloat16:
        if not torch.equal(got.cpu().view(torch.int16), want.cpu().view(torch.int16)):
            raise AssertionError(f"bf16 bits differ, max abs err {err}")
    elif dtype_name == "bfloat16":
        if not bool(((g - w).abs() <= 0.5 + 0.5 * w.abs()).all()):
            raise AssertionError(f"bf16 mismatch, max abs err {err}")
    elif not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{dtype_name} mismatch, max abs err {err}")
    return err


class Tally:
    """Kernel-vs-plain results by kernel: its cases, the max |kernel -
    plain| per dtype and whether every bf16 case was bitwise."""

    def __init__(self):
        self.rows = {}

    def check(self, name, got, want, dtype_name, exact=False) -> float:
        """:func:`compare` one case of kernel ``name`` and record it."""
        import torch

        err = compare(got, want, dtype_name, exact)
        row = self.rows.setdefault(name, {"cases": 0, "max_abs_err": {}})
        row["cases"] += 1
        row["max_abs_err"][dtype_name] = max(row["max_abs_err"].get(dtype_name, 0.0), err)
        if got.dtype == torch.bfloat16:
            same = torch.equal(got.cpu().view(torch.int16), want.cpu().view(torch.int16))
            row["bf16_bitwise"] = row.get("bf16_bitwise", True) and same
        return err

    def max_err(self, name) -> float:
        return max(self.rows[name]["max_abs_err"].values())

    def of(self, *names) -> dict:
        return {name: self.rows[name] for name in names}


def fused_operands(grid, names, images, device, radius=1, rng=None):
    """Dense banks for ``names`` on ``grid`` (library ingest plans, or
    random runtime tap selects and consts when ``rng`` is given)."""
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.core.bitstream import VCGRAConfig
    from repro_torch.core.ingest import IngestPlan
    from repro_torch.core.pixie import map_app
    from repro_torch.kernels.vcgra import pack_settings_batched

    cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in names]
    settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=device))
    if rng is None:
        ingests = IngestPlan.stack([c.ingest for c in cfgs], grid.dtype, device=device)
    else:
        n, c = len(names), grid.num_inputs
        taps = (2 * radius + 1) ** 2
        ingests = (   # taps, the const row, and past it (zero) channels
            torch.as_tensor(rng.integers(-1, taps + 2, (n, c)), dtype=torch.int32, device=device),
            torch.as_tensor(rng.integers(-8, 9, (n, c)), device=device).to(grid.dtype),
        )
    frames = torch.as_tensor(images, device=device).to(grid.dtype)
    return settings, ingests, frames


def phase_device_and_build():
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels import build

    from repro_torch.core import applications as apps
    from repro_torch.core.grid import sobel_grid
    from repro_torch.core.pixie import map_app
    from repro_torch.kernels.vcgra import specialized

    t0 = time.perf_counter()
    paths = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    for name in paths:
        build.load_library(name)
    # One cold NVRTC compile + load + unload of a generated B5 kernel (the
    # bf16 Sobel-grid sobel_y, which no later phase compiles).
    grid = retyped(sobel_grid(), "bfloat16")
    source = specialized.generate_source(grid, map_app(apps.sobel_y(), grid))
    t0 = time.perf_counter()
    handle = specialized.compile_module(source, torch.cuda.current_device())
    nvrtc_s = time.perf_counter() - t0
    if build.load_library("vcgra_specialize").vcgra_spec_free(handle) != 0:
        raise RuntimeError("vcgra_spec_free failed")
    emit({"phase": "device_and_build", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()},
          "build_s": build_s, "nvrtc_compile_load_s": nvrtc_s,
          "nvrtc_options": specialized.nvrtc_options()})
    return card


def wide_grid(width=40):
    """A grid ``width`` values wide (40: past 32; 64: the widest before the
    kernels took any width; 600: value banks in device memory) that every
    library app maps on."""
    from repro_torch.core.grid import custom

    return custom(f"wide-{width}", width, [width, 11, 7, 5, 3, 3, 2], 1)


#: B1's kernel-vs-plain radii: library ingests at 1, random runtime ones
#: at 0, 2 and one past the shared-memory window (taps from device memory).
FUSED_RADII = (0, 1, 2, 17)


def fused_frames(n_apps):
    """B1's kernel-vs-plain frames (n, H, W): odd non-square, every app and
    more, one pixel, and a frame past a tile column edge; none a multiple
    of the 32-row tile or of P."""
    return ((3, 37, 53), (n_apps + 3, 64, 17), (1, 1, 1), (2, 33, 2049))


#: B2's kernel-vs-plain pixel batches: aligned to P and not.
BATCHED_SIZES = (1, 45, 1000, 4099)


def phase_kernels_vs_plain(device, all_grid, tally):
    """Every case: kernel on the card vs its plain version on the same
    inputs, synchronized after each case, bitwise in every dtype."""
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.core.bitstream import VCGRAConfig
    from repro_torch.core.grid import sobel_grid
    from repro_torch.core.pixie import map_app
    from repro_torch.core.tiling import TILE_AUTO
    from repro_torch.kernels.vcgra import (
        pack_settings_batched, vcgra_batched, vcgra_batched_ref,
        vcgra_fused_batched, vcgra_fused_batched_ref,
    )

    rng = np.random.default_rng(0)
    all_names = sorted(apps.ALL_APPS)
    for dtype_name in DTYPE_NAMES:
        for base, names in ((sobel_grid(), SOBEL_APPS), (all_grid, all_names),
                            (wide_grid(), all_names)):
            grid = retyped(base, dtype_name)
            for radius in FUSED_RADII:
                for n, H, W in fused_frames(len(names)):
                    picked = [names[i % len(names)] for i in range(n)]
                    images = rng.integers(0, 256, (n, H, W)).astype(np.int32)
                    settings, ingests, frames = fused_operands(
                        grid, picked, images, device, radius,
                        rng=rng if radius != 1 else None)
                    want = vcgra_fused_batched_ref(grid, radius, settings, ingests, frames)
                    for tr in (None, 1, 3, H + 1, TILE_AUTO) if H == 37 else (None,):
                        got = vcgra_fused_batched(grid, radius, settings, ingests, frames,
                                                  tile_rows=tr)
                        tally.check("vcgra_fused_batched", got, want, dtype_name, True)
            cfgs = [map_app(apps.ALL_APPS[n](), grid) for n in names]
            settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=device))
            for B in BATCHED_SIZES:
                xs = torch.as_tensor(rng.integers(0, 256, (len(names), grid.num_inputs, B)),
                                     device=device).to(grid.dtype)
                got = vcgra_batched(grid, settings, xs)
                tally.check("vcgra_batched", got, vcgra_batched_ref(grid, settings, xs),
                            dtype_name, True)


def chain_operands(grid, chain, hws, Hc, Wc, device, rng, images=None):
    """B3's stage-stacked operands for ``len(hws)`` apps running ``chain``
    (library settings re-planned at each stage's radius) on frames of
    ``hws`` in a ``[Hc, Wc]`` canvas (random, or ``images``).  With K > 1
    the output muxes and forwarded channels are random."""
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.core.bitstream import VCGRAConfig
    from repro_torch.core.ingest import IngestPlan
    from repro_torch.core.pixie import map_app
    from repro_torch.kernels.vcgra import pack_settings_batched

    n, K = len(hws), grid.num_outputs
    stages = []
    for name, radius in chain:
        cfgs = []
        for _ in range(n):
            cfg = map_app(apps.ALL_APPS[name](), grid)
            cfg = dataclasses.replace(cfg, ingest=cfg.ingest.at_radius(radius))
            if K > 1:
                cfg.out_sel = rng.integers(0, grid.pes_per_level[-1], K).astype(np.int32)
            cfgs.append(cfg)
        stages.append((pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=device)),
                       IngestPlan.stack([c.ingest for c in cfgs], grid.dtype, device=device)))
    settings = tuple(torch.stack([st[0][j] for st in stages]) for j in range(3))
    ingests = tuple(torch.stack([st[1][j] for st in stages]) for j in range(2))
    out_chs = torch.as_tensor(rng.integers(0, K, (len(chain), n)), dtype=torch.int32,
                              device=device)
    if images is None:
        images = np.zeros((n, Hc, Wc), np.int32)
        for i, (h, w) in enumerate(hws):
            images[i, :h, :w] = rng.integers(0, 256, (h, w))
    frames = torch.as_tensor(images, device=device).to(grid.dtype)
    hw = torch.as_tensor(np.asarray(hws, np.int32), device=device)
    return settings, ingests, out_chs, hw, frames


def phase_pipeline_vs_plain(device, all_grid, tally):
    """B3 on the card vs its plain version, every case synchronized."""
    from repro_torch.core.tiling import TILE_AUTO
    from repro_torch.kernels.vcgra import vcgra_pipeline_batched, vcgra_pipeline_batched_ref

    rng = np.random.default_rng(3)
    bases = (shared_grid(CHAIN, "pipe-shared"), all_grid,
             shared_grid(CHAIN, "pipe-shared-k2", num_outputs=2))
    for dtype_name in ("int32", "int16", "float32", "bfloat16"):
        for base in bases:
            grid = retyped(base, dtype_name)
            for chain in CHAINS:
                radii = tuple(r for _, r in chain)
                for n, H, W in ((3, 37, 53), (11, 45, 29)):
                    hws = [(1, 1), (H, W)] + [
                        (int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1)))
                        for _ in range(n - 2)]
                    args = chain_operands(grid, chain, hws, H, W, device, rng)
                    want = vcgra_pipeline_batched_ref(grid, radii, *args)
                    for tr in (None, 1, 3, TILE_AUTO):
                        got = vcgra_pipeline_batched(grid, radii, *args, tile_rows=tr)
                        tally.check("vcgra_pipeline_batched", got, want, dtype_name)
        # Frames of several of the kernel's 32 x 32P output tiles, ragged in
        # both directions.
        grid = retyped(bases[2], dtype_name)
        for chain in (CHAINS[0], CHAINS[3]):
            radii = tuple(r for _, r in chain)
            for n, H, W in MULTI_TILE_FRAMES:
                hws = [(H, W), (1, 1)] + [
                    (int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1)))
                    for _ in range(n - 2)]
                args = chain_operands(grid, chain, hws, H, W, device, rng)
                want = vcgra_pipeline_batched_ref(grid, radii, *args)
                got = vcgra_pipeline_batched(grid, radii, *args)
                tally.check("vcgra_pipeline_batched", got, want, dtype_name)


#: The wide-and-deep phase's chains, (app, stage radius): R = 17 (two B3
#: segments), R = 33 and a lone radius-20 stage between window segments.
DEEP_CHAINS = {
    "r17": [("gauss3", 1)] * 17,
    "r33": [("gauss3", 1), ("sobel_x", 15), ("threshold", 1), ("gauss3", 16)],
    "lone_r20": [("gauss3", 1), ("threshold", 0), ("sobel_x", 20), ("gauss3", 1),
                 ("threshold", 1)],
}
#: The chains the wide grids run: one window (R = 3), two segments (R =
#: 17) and a lone radius-20 stage between window segments.
WIDE_CHAINS = {"r3": [(app, 1) for app in CHAIN], "r17": DEEP_CHAINS["r17"],
               "lone_r20": DEEP_CHAINS["lone_r20"]}
#: A grid past what even a 32-thread block of B1-B4 holds in shared memory.
DEVICE_BANK_VALUES = 600
#: Grids on which B1 and B2 are timed on both sides of the switch between
#: value banks in shared memory (64 and 32 threads a block) and in device
#: memory (``ops.SHARED_BANK_THREADS``).
SWITCH_WIDTHS = (80, 150)
#: B2's pixels a channel there.
SWITCH_B2_BATCH = 2 ** 18


def conv7_dfg():
    """A 7 x 7 convolution built as ``applications.conv3x3`` builds its
    3 x 3 (a tap and a coefficient const a product, a left-paired sum
    tree): 98 values wide on its exact grid."""
    from repro_torch.core import applications as apps
    from repro_torch.core.dfg import DFG

    g = DFG("conv7")
    prods = []
    for dj in range(-3, 4):
        for di in range(-3, 4):
            k = g.const(f"k{dj + 3}{di + 3}", float((dj + 4) * (di + 5) % 7 - 3))
            prods.append(g.mul(g.input(apps.tap_name(dj, di)), k))
    g.output(apps._sum_tree(g, prods))
    return g


def conv7_case(dtype_name):
    """The ``conv7-exact`` grid in one dtype and conv7 mapped on it, with the
    fused ingest of a radius-3 tap bank."""
    from repro_torch.core.grid import for_dfg
    from repro_torch.core.ingest import plan_for
    from repro_torch.core.pixie import map_app

    grid = retyped(for_dfg(conv7_dfg(), shape="exact"), dtype_name)
    cfg = map_app(conv7_dfg(), grid)
    cfg.ingest = plan_for(cfg.input_order, cfg.const_values, grid.num_inputs, radius=3)
    return grid, cfg


def live_random_settings(grid, n, device, rng):
    """Dense settings for ``n`` apps with every PE and channel of ``grid``
    live: random selects over each level's whole input, output muxes over
    the last level, opcodes from every code on integer grids and from those
    that keep float values finite (no MUL or DIV) on float grids."""
    import torch

    L, max_w, K = grid.num_levels, max(grid.pes_per_level), grid.num_outputs
    floats = grid.dtype in (torch.float32, torch.bfloat16)
    codes = [1, 2, 5, 6, 7, 8, 9, 10] if floats else list(range(13))
    ops = np.zeros((n, L, max_w), np.int32)
    sel = np.zeros((n, L, max_w, 2), np.int32)
    for lvl, width in enumerate(grid.pes_per_level):
        fan_in = grid.num_inputs if lvl == 0 else grid.pes_per_level[lvl - 1]
        ops[:, lvl, :width] = rng.choice(codes, (n, width))
        sel[:, lvl, :width] = rng.integers(0, fan_in, (n, width, 2))
    out = rng.integers(0, grid.pes_per_level[-1], (n, K))
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=device) for a in (ops, sel, out))


@contextlib.contextmanager
def shared_bank_threads(ladder):
    """B1-B4 blocks keep their value banks in shared memory only at the
    thread counts of ``ladder`` (``ops.SHARED_BANK_THREADS``; ``()``: always
    in device memory), to time both sides of the switch."""
    from repro_torch.kernels.vcgra import ops

    saved, ops.SHARED_BANK_THREADS = ops.SHARED_BANK_THREADS, tuple(ladder)
    try:
        yield
    finally:
        ops.SHARED_BANK_THREADS = saved


def phase_wide_and_deep(device, pipe_grid, tally):
    """Requests past 64 values and past one B3 window (16 px), which the
    port's card path refused before: (a) the path, the launch counters
    reset just before and read just after -- in every dtype, two
    ``conv7-exact`` image requests and one named-channel request through
    ``PixieFleet`` (B1, B2), ``Pixie`` conventional (``run_image`` B1,
    ``run_raw`` B2), ``Pixie`` parameterized (B5) and ``vcgra_apply``
    conventional (B4) on conv7; then a mixed 1080p flush on pipe-shared (a
    17-stage gauss3 chain, a depth-3 chain, single-stage requests), every
    output equal to the staged numpy oracle and ``backend="torch"``, the
    ladder at 0; (b) each served conv7 output bitwise the same entry point
    on the CPU (the kernels' plain versions); (c) B1, B2 and B4 bitwise to
    their plain versions on a 600-value grid (value banks in device
    memory), library settings with random runtime ingests as phase 2 draws
    them and random settings that keep every PE live; (d) B3 on chains of R
    = 17, 33 and a lone radius-20 stage on pipe-shared (one and two
    outputs), and of R = 3, 17 and the lone radius-20 stage on the 98- and
    600-value grids, every dtype, launches equal to segments; (e) times: B3
    at the 17-stage chain (``n8x2048x2048``) and B1 at the 98-wide grid
    (``n8x1080x1920``), each beside its bound (live PEs), and B1 on both
    sides of the switch to device-memory value banks at 98 values
    (conv7) and, with library and dense settings, B1 and B2 at 80 and 150
    values."""
    import torch
    from repro_torch.core import Pixie
    from repro_torch.core import applications as apps
    from repro_torch.core.bitstream import VCGRAConfig
    from repro_torch.core.ingest import IngestPlan
    from repro_torch.core.pixie import map_app
    from repro_torch.core.tiling import itemsize
    from repro_torch.kernels.vcgra import (
        pack_settings_batched, vcgra_apply, vcgra_batched, vcgra_batched_ref,
        vcgra_conventional, vcgra_conventional_ref, vcgra_fused_batched,
        vcgra_fused_batched_ref, vcgra_pipeline_batched, vcgra_pipeline_batched_ref,
    )
    from repro_torch.kernels.vcgra.ops import (
        batched_launch, chain_segments, fused_launch, ingest_image,
    )
    from repro_torch.runtime.fleet import FleetRequest, PixieFleet

    t0 = time.perf_counter()
    rng = np.random.default_rng(26)
    cases = {d: conv7_case(d) for d in DTYPE_NAMES}
    conv7_frames = {d: [rng.integers(0, 256, hw).astype(
        np.float32 if cases[d][0].float_pe else np.int32) for hw in ((270, 480), (97, 301))]
        for d in DTYPE_NAMES}

    def conv7_requests(dtype_name):
        _, cfg = cases[dtype_name]
        imgs = conv7_frames[dtype_name]
        taps = apps.stencil_inputs(torch.from_numpy(imgs[1]), radius=3)
        return [FleetRequest(app=cfg, image=img) for img in imgs] + [FleetRequest(
            app=cfg, inputs={k: v.numpy() for k, v in taps.items() if k in cfg.input_order})]

    def conv7_entries(dtype_name, dev, backend="hopper"):
        """{entry: output} of conv7 through every entry point on ``dev``."""
        grid, cfg = cases[dtype_name]
        fleet = PixieFleet(default_grid=grid, device=dev, backend=backend)
        out = {f"fleet {i}": o for i, o in enumerate(fleet.run_many(conv7_requests(dtype_name)))}
        assert_sound(fleet, f"conv7 {dtype_name} on {dev}")
        img = torch.as_tensor(conv7_frames[dtype_name][0], device=dev)
        x = ingest_image(cfg.ingest, grid.dtype, img)
        if backend == "hopper":
            conv = Pixie(grid, mode="conventional", device=dev)
            conv.load(cfg)
            out["pixie run_image"] = conv.run_image(img)
            out["pixie run_raw"] = conv.run_raw(x)
            par = Pixie(grid, mode="parameterized", device=dev)
            par.load(cfg)
            out["pixie parameterized"] = par.run_raw(x)
            out["vcgra_apply conventional"] = vcgra_apply(grid, cfg, x, mode="conventional")
        return {k: v.cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                for k, v in out.items()}

    # (a) the path.
    deep = ["gauss3"] * 17
    mixed = [(deep, (1080, 1920)), (CHAIN, (1080, 1920)), ("gauss3", (720, 1280)),
             ("threshold", (1080, 1920)), (deep, (900, 1600))]
    mixed_frames = [rng.integers(0, 256, hw).astype(np.int32) for _, hw in mixed]

    def mixed_requests():
        return [FleetRequest(pipeline=app, image=img) if isinstance(app, list)
                else FleetRequest(app=app, image=img) for (app, _), img in zip(mixed, mixed_frames)]

    reset_launches()
    served = {d: conv7_entries(d, device) for d in DTYPE_NAMES}
    fleet = PixieFleet(default_grid=pipe_grid)
    mixed_out = fleet.run_many(mixed_requests())
    torch.cuda.synchronize()
    launches = launch_counts()
    assert_sound(fleet, "wide and deep, mixed flush")
    # Per dtype: B1 for the fleet's image dispatch and run_image, B2 for the
    # channel dispatch, run_raw and the overlay's warm-up on a dummy config;
    # then the mixed flush's single-stage dispatch and its two chain groups.
    want = no_launches(vcgra_fused_batched=2 * len(DTYPE_NAMES) + 1,
                       vcgra_batched=3 * len(DTYPE_NAMES),
                       vcgra_pipeline_batched=len(chain_segments((1,) * 17)) + 1,
                       vcgra_conventional=len(DTYPE_NAMES), vcgra_specialized=len(DTYPE_NAMES))
    if launches != want or fleet.stats.pipeline_dispatches != 2:
        raise AssertionError(f"wide and deep: launches {launches}, expected {want}; "
                             f"{fleet.stats.pipeline_dispatches} chain dispatches")
    for (app, _), img, out in zip(mixed, mixed_frames, mixed_out):
        if not np.array_equal(out, staged_oracle(app, img)):
            raise AssertionError(f"mixed flush: {app} differs from the staged numpy oracle")
    torch_fleet = PixieFleet(default_grid=pipe_grid, backend="torch")
    for got, ref_out in zip(mixed_out, torch_fleet.run_many(mixed_requests())):
        if not np.array_equal(got, ref_out):
            raise AssertionError("mixed flush: hopper differs from backend='torch'")
    assert_sound(torch_fleet, "wide and deep, mixed flush, torch oracle")
    del torch_fleet
    torch.cuda.empty_cache()

    # (b) each conv7 output against the same entry on the CPU (plain versions)
    # and the fleet's against backend="torch" on the card.
    kernel_of = {"fleet 0": "vcgra_fused_batched", "fleet 1": "vcgra_fused_batched",
                 "fleet 2": "vcgra_batched", "pixie run_image": "vcgra_fused_batched",
                 "pixie run_raw": "vcgra_batched", "pixie parameterized": "vcgra_specialized",
                 "vcgra_apply conventional": "vcgra_conventional"}
    for dtype_name in DTYPE_NAMES:
        plain = conv7_entries(dtype_name, torch.device("cpu"))
        eager = conv7_entries(dtype_name, device, backend="torch")
        for entry, got in served[dtype_name].items():
            kernel = kernel_of[entry]
            tally.check(kernel, got, plain[entry], dtype_name, kernel != "vcgra_specialized")
            if entry in eager and not torch.equal(got, eager[entry]) and dtype_name != "bfloat16":
                raise AssertionError(f"conv7 {dtype_name} {entry}: hopper differs from torch")

    # (c) B1, B2 and B4 past what any block holds in shared memory.
    all_names = sorted(apps.ALL_APPS)
    for dtype_name in DTYPE_NAMES:
        grid = retyped(wide_grid(DEVICE_BANK_VALUES), dtype_name)
        if not fused_launch(itemsize(grid.dtype), 1, grid.num_inputs, grid.pes_per_level,
                            grid.num_outputs)[3]:
            raise AssertionError(f"{grid.name}: value banks expected in device memory")
        for radius in (0, 1, 17):
            for n, H, W in ((3, 37, 53), (2, 33, 2049)):
                picked = [all_names[i % len(all_names)] for i in range(n)]
                images = rng.integers(0, 256, (n, H, W)).astype(np.int32)
                settings, ingests, frames = fused_operands(
                    grid, picked, images, device, radius, rng=rng if radius != 1 else None)
                for dense in (settings, live_random_settings(grid, n, device, rng)):
                    tally.check("vcgra_fused_batched",
                                vcgra_fused_batched(grid, radius, dense, ingests, frames),
                                vcgra_fused_batched_ref(grid, radius, dense, ingests, frames),
                                dtype_name, True)
        cfg_settings = pack_settings_batched(grid, VCGRAConfig.stack(
            [map_app(apps.ALL_APPS[name](), grid) for name in all_names], device=device))
        for dense in (cfg_settings, live_random_settings(grid, len(all_names), device, rng)):
            for B in (45, 4099):
                xs = torch.as_tensor(rng.integers(-8, 256, (len(all_names), grid.num_inputs, B)),
                                     device=device).to(grid.dtype)
                tally.check("vcgra_batched", vcgra_batched(grid, dense, xs),
                            vcgra_batched_ref(grid, dense, xs), dtype_name, True)
                for i in (0, len(all_names) - 1):
                    one = tuple(t[i] for t in dense)
                    for block_n in (128, 1024):
                        tally.check("vcgra_conventional",
                                    vcgra_conventional(grid, one, xs[i], block_n=block_n),
                                    vcgra_conventional_ref(grid, one, xs[i]), dtype_name, True)

    # (d) B3 past one window, and on the grids past 64 values (98 and 600:
    # value banks in device memory, with the forward between segments).
    chain_rows = {}
    for dtype_name in DTYPE_NAMES:
        for base, chains in ((pipe_grid, DEEP_CHAINS),
                             (shared_grid(CHAIN, "pipe-shared-k2", num_outputs=2), DEEP_CHAINS),
                             (cases[dtype_name][0], WIDE_CHAINS),
                             (wide_grid(DEVICE_BANK_VALUES), WIDE_CHAINS)):
            grid = retyped(base, dtype_name)
            for label, chain in chains.items():
                radii = tuple(r for _, r in chain)
                segments = chain_segments(radii)
                for n, H, W in ((3, 37, 53), (2, 70, 300)):
                    hws = [(H, W), (1, 1)] + [
                        (int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1)))
                        for _ in range(n - 2)]
                    args = chain_operands(grid, chain, hws, H, W, device, rng)
                    before = launch_counts()["vcgra_pipeline_batched"]
                    got = vcgra_pipeline_batched(grid, radii, *args)
                    ran = launch_counts()["vcgra_pipeline_batched"] - before
                    if ran != len(segments):
                        raise AssertionError(f"B3 {label}: {ran} launches for {segments}")
                    tally.check("vcgra_pipeline_batched", got,
                                vcgra_pipeline_batched_ref(grid, radii, *args), dtype_name)
                row = chain_rows.setdefault(label, {"radii": list(radii), "R": sum(radii),
                                                    "segments": [list(sg) for sg in segments],
                                                    "grids": []})
                if base.name not in row["grids"]:
                    row["grids"].append(base.name)

    # (e) times.
    grid = pipe_grid
    chain = DEEP_CHAINS["r17"]
    radii = tuple(r for _, r in chain)
    canvas = np.zeros((8, 2048, 2048), np.int32)
    for i in range(8):
        canvas[i, :1080, :1920] = rng.integers(0, 256, (1080, 1920))
    args = chain_operands(grid, chain, [(1080, 1920)] * 8, 2048, 2048, device, rng,
                          images=canvas)

    def run_b3():
        return vcgra_pipeline_batched(grid, radii, *args)

    def plain_b3():
        return vcgra_pipeline_batched_ref(grid, radii, *args)

    err = compare(run_b3(), plain_b3(), "int32")
    n, px, K = 8, 2048 * 2048, grid.num_outputs
    byte_ms, _ = bound(n * px * itemsize(grid.dtype) * (1 + K), 0)
    b_ms, b_by = bound(n * px * itemsize(grid.dtype) * (1 + K), n * px * chain_work(grid, chain))
    b3_row = dict(ms=cuda_ms(run_b3, 20, shield=True), plain_ms=cuda_ms(plain_b3, 3),
                  bound_ms=b_ms, bound_by=b_by, byte_bound_ms=byte_ms,
                  shape=f"n8x2048x2048 17 x gauss3 {grid.name}", main_path_err=err,
                  segments=len(chain_segments(radii)), live_pes=chain_work(grid, chain))
    del args
    torch.cuda.empty_cache()
    grid, cfg = cases["int32"]
    frames_np = rng.integers(0, 256, (8, 1080, 1920)).astype(np.int32)
    settings = pack_settings_batched(grid, VCGRAConfig.stack([cfg] * 8, device=device))
    ingests = IngestPlan.stack([cfg.ingest] * 8, grid.dtype, device=device)
    frames = torch.as_tensor(frames_np, device=device)

    def run_b1():
        return vcgra_fused_batched(grid, 3, settings, ingests, frames)

    def plain_b1():
        return vcgra_fused_batched_ref(grid, 3, settings, ingests, frames)

    err = compare(run_b1(), plain_b1(), "int32", True)
    live_pes, _ = config_work(grid, cfg)
    hw = 1080 * 1920
    b_ms, b_by = bound(8 * hw * itemsize(grid.dtype) * (1 + grid.num_outputs),
                       8 * hw * live_pes)
    b1_row = dict(ms=cuda_ms(run_b1, 20, shield=True), plain_ms=cuda_ms(plain_b1, 3),
                  bound_ms=b_ms, bound_by=b_by, shape=f"n8x1080x1920 {grid.name}",
                  main_path_err=err, live_pes=live_pes,
                  block=kernel_block("vcgra_fused_batched", grid, 3))

    def both_banks(block, run, plain):
        """The time of ``run`` with its value banks in shared memory (the
        most threads of 128, 64, 32 that hold them) and in device memory,
        each output bitwise its plain version; ``block()`` -> (threads,
        ..., device_banks) of the launch."""
        want, row = plain(), {}
        for side, ladder in (("shared", (128, 64, 32)), ("device_banks", ())):
            with shared_bank_threads(ladder):
                compare(run(), want, "int32", True)
                row[f"{side}_ms"] = cuda_ms(run, 20, shield=True)
                if side == "shared":
                    row["shared_threads"] = block()[0]
        row["picked"] = "device_banks" if block()[-1] else "shared"
        return row

    switch = {f"B1 {grid.name}": both_banks(
        lambda: fused_launch(itemsize(grid.dtype), 3, grid.num_inputs, grid.pes_per_level,
                             grid.num_outputs), run_b1, plain_b1)}
    del settings, ingests, frames
    for width in SWITCH_WIDTHS:
        grid = wide_grid(width)
        args = (itemsize(grid.dtype), grid.num_inputs, grid.pes_per_level, grid.num_outputs)
        library, ingests, frames = fused_operands(grid, all_names[:8], frames_np, device)
        xs = torch.as_tensor(rng.integers(0, 256, (8, grid.num_inputs, SWITCH_B2_BATCH),
                                          dtype=np.int32), device=device)
        for kind, dense in (("library", library),
                            ("dense", live_random_settings(grid, 8, device, rng))):
            switch[f"B1 {grid.name} {kind}"] = both_banks(
                lambda: fused_launch(args[0], 1, *args[1:]),
                lambda: vcgra_fused_batched(grid, 1, dense, ingests, frames),
                lambda: vcgra_fused_batched_ref(grid, 1, dense, ingests, frames))
            switch[f"B2 {grid.name} {kind}"] = both_banks(
                lambda: batched_launch(*args), lambda: vcgra_batched(grid, dense, xs),
                lambda: vcgra_batched_ref(grid, dense, xs))
        del library, ingests, frames, xs
    b1_row["device_bank_switch"] = switch
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "wide_and_deep", "launches": launches,
          "kernels": tally.of("vcgra_fused_batched", "vcgra_batched", "vcgra_conventional",
                              "vcgra_pipeline_batched", "vcgra_specialized"),
          "chains": chain_rows, "conv7_grid": f"{cases['int32'][0].name} "
          f"{cases['int32'][0].num_inputs} values {list(cases['int32'][0].pes_per_level)}",
          "device_bank_grid": f"wide-{DEVICE_BANK_VALUES}",
          "times": {"vcgra_pipeline_batched": b3_row, "vcgra_fused_batched": b1_row},
          "tolerance": "B1, B2, B4 bitwise in every dtype, bf16 included; B3 and B5 bitwise "
                       "for int32/int16/float32, bf16 |d| <= 0.5 + 0.5|ref|",
          "seconds": seconds})
    return launches, {"vcgra_pipeline_batched": b3_row, "vcgra_fused_batched": b1_row}


def oracle(app, img):
    """The port's numpy oracle of one library app on one frame."""
    from repro_torch.core import applications as apps

    img = img.astype(np.int32)
    kernels = {"sobel_x": (apps.SOBEL_X, 1.0), "sobel_y": (apps.SOBEL_Y, 1.0),
               "sharpen": (apps.SHARPEN, 1.0), "laplace": (apps.LAPLACE, 1.0),
               "gauss3": (apps.GAUSS3, 16.0), "box3": (apps.BOX3, 9.0)}
    if app in kernels:
        return apps.conv2d_reference(img, *kernels[app])
    if app == "sobel_mag":
        return apps.sobel_magnitude_reference(img)
    if app == "threshold":
        return (img > 128).astype(np.int32)
    if app == "identity":
        return img
    raise KeyError(app)


def staged_oracle(apps_, img):
    """A chain's numpy oracle: :func:`oracle` composed stage by stage, each
    stage on the previous stage's [h, w] output."""
    if isinstance(apps_, str):
        return oracle(apps_, img)
    for app in apps_:
        img = oracle(app, img)
    return img


def serve(svc, requests):
    """Submit (app, frame, grid) requests and drain them in one flush."""
    handles = [svc.submit(app, img, grid=grid) for app, img, grid in requests]
    svc.flush()
    return [h.result() for h in handles]


#: The ladder counters a sound fleet keeps at zero.
LADDER_COUNTERS = ("fallback_dispatches", "retries", "quarantined_requests", "guard_failures")


def assert_sound(fleet, label):
    """A fleet that served a sound path degraded nothing: no fallback
    dispatch, retry, quarantine or guard failure, every breaker closed."""
    counts = {k: getattr(fleet.stats, k) for k in LADDER_COUNTERS}
    if any(counts.values()) or not fleet.breakers.all_closed():
        raise AssertionError(f"{label}: the ladder moved on a sound path: {counts}, "
                             f"breakers {fleet.breakers.states()}")


def phase_main_path(device, all_grid):
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.runtime.fleet import PixieFleet
    from repro_torch.serve import FleetFrontend

    rng = np.random.default_rng(1)

    def frame(h, w):
        return rng.integers(0, 256, (h, w)).astype(np.int32)

    flushes = [
        [(a, frame(1080, 1920), None) for a in MAIN_APPS],
        [(a, frame(h, w), None) for a, (h, w) in zip(
            ["sobel_x", "sharpen", "threshold", "laplace"],
            [(2160, 3840), (720, 1280), (480, 640), (1080, 1920)])],
        [(a, frame(1080, 1920), all_grid) for a in sorted(apps.ALL_APPS)],
    ]
    channel_frames = [frame(1080, 1920) for _ in CHANNEL_APPS]

    def channel_requests():
        return channel_requests_of(channel_frames)

    svc = FleetFrontend()
    if (svc.backend, svc.device.type) != ("hopper", "cuda"):
        raise AssertionError(f"FleetFrontend() defaults: {svc.backend}, {svc.device}")
    reset_launches()
    t0 = time.perf_counter()
    served = [serve(svc, reqs) for reqs in flushes]
    served_channels = svc.fleet.run_many(channel_requests())
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = launch_counts()

    stats = svc.stats
    fused, packed = stats.fused_dispatches, stats.dispatches - stats.fused_dispatches
    if launches != no_launches(vcgra_fused_batched=fused, vcgra_batched=packed) \
            or (fused, packed) != (3, 1):
        raise AssertionError(f"launches {launches} vs dispatches fused={fused} packed={packed}")
    plans = {k.rsplit("|", 1)[0] for k in stats.dispatch_plans}
    if stats.overlay_builds != len(plans):
        raise AssertionError(f"{stats.overlay_builds} builds for {len(plans)} plans")
    assert_sound(svc.fleet, "main path")

    for reqs, outs in zip(flushes, served):
        for (app, img, _), out in zip(reqs, outs):
            if not np.array_equal(out, oracle(app, img)):
                raise AssertionError(f"{app} {img.shape} differs from the numpy oracle")
    for app, img, out in zip(CHANNEL_APPS, channel_frames, served_channels):
        if not np.array_equal(out, oracle(app, img).reshape(1, -1)):
            raise AssertionError(f"named-channel {app} differs from the numpy oracle")

    oracle_svc = FleetFrontend(backend="torch")
    for reqs, outs in zip(flushes, served):
        for got, want in zip(outs, serve(oracle_svc, reqs)):
            if not np.array_equal(got, want):
                raise AssertionError("hopper output differs from backend='torch'")
        torch.cuda.empty_cache()
    oracle_fleet = PixieFleet(backend="torch")
    for got, want in zip(served_channels, oracle_fleet.run_many(channel_requests())):
        if not np.array_equal(got, want):
            raise AssertionError("hopper channel output differs from backend='torch'")
    assert_sound(oracle_svc.fleet, "main path, torch oracle")
    assert_sound(oracle_fleet, "main path, torch oracle")
    torch.cuda.empty_cache()
    emit({"phase": "main_path", "flushes": len(flushes) + 1,
          "requests": sum(map(len, flushes)) + len(CHANNEL_APPS),
          "launches": launches, "dispatch_plans": stats.dispatch_plans,
          "overlay_builds": stats.overlay_builds, "main_path_s": main_s,
          "checked_against": ["numpy oracles", "backend='torch' on the card"]})
    return svc, flushes[0], channel_requests, launches


def phase_chain_path(svc, pipe_grid):
    """Chained requests through the same front-end, the launch counters
    reset just before and read just after: 8 x 1080p depth-3 chains on the
    pipe-shared grid, then a mixed flush on ``sobel-5x9`` of two chain
    radii groups and single-stage requests at 720p-1080p."""
    import torch
    from repro_torch.serve import FleetFrontend

    rng = np.random.default_rng(4)

    def frame(h, w):
        return rng.integers(0, 256, (h, w)).astype(np.int32)

    long_chain, short_chain = ["sharpen", "sobel_x", "threshold"], ["sobel_x", "threshold"]
    flushes = [
        [(CHAIN, frame(1080, 1920), pipe_grid) for _ in range(8)],
        [(long_chain, frame(1080, 1920), None), (short_chain, frame(720, 1280), None),
         ("laplace", frame(900, 1600), None), (long_chain, frame(720, 1280), None),
         ("sobel_y", frame(1080, 1920), None), (short_chain, frame(1080, 1440), None)],
    ]
    stats = svc.stats
    before = (stats.dispatches, stats.fused_dispatches, stats.pipeline_dispatches)
    reset_launches()
    t0 = time.perf_counter()
    served = [serve(svc, reqs) for reqs in flushes]
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    launches = launch_counts()

    pipe = stats.pipeline_dispatches - before[2]
    fused = stats.fused_dispatches - before[1] - pipe
    packed = stats.dispatches - before[0] - pipe - fused
    if launches != no_launches(vcgra_fused_batched=fused, vcgra_batched=packed,
                               vcgra_pipeline_batched=pipe) or (pipe, fused, packed) != (3, 1, 0):
        raise AssertionError(
            f"launches {launches} vs dispatches pipeline={pipe} fused={fused} packed={packed}")
    assert_sound(svc.fleet, "chain path")
    for reqs, outs in zip(flushes, served):
        for (app, img, _), out in zip(reqs, outs):
            if not np.array_equal(out, staged_oracle(app, img)):
                raise AssertionError(f"{app} {img.shape} differs from the staged numpy oracle")
    oracle_svc = FleetFrontend(backend="torch")
    for reqs, outs in zip(flushes, served):
        for got, want in zip(outs, serve(oracle_svc, reqs)):
            if not np.array_equal(got, want):
                raise AssertionError("hopper chain output differs from backend='torch'")
        torch.cuda.empty_cache()
    assert_sound(oracle_svc.fleet, "chain path, torch oracle")
    emit({"phase": "chain_path", "flushes": len(flushes),
          "requests": sum(map(len, flushes)), "launches": launches,
          "pipeline_dispatches": pipe,
          "dispatch_plans": {k: v for k, v in stats.dispatch_plans.items() if "|pipe" in k},
          "chain_path_s": chain_s,
          "checked_against": ["staged numpy oracle", "backend='torch' on the card"]})
    return flushes[0], launches


def frames_1080p(rng, n, dtype=np.int32):
    return [rng.integers(0, 256, (1080, 1920)).astype(dtype) for _ in range(n)]


def served_or_failed(handles):
    """Each handle's output as numpy, or the class name of its failure."""
    out = []
    for h in handles:
        try:
            out.append(np.asarray(h.result(timeout=600)))
        except Exception as exc:  # noqa: BLE001 -- recorded; the caller checks which failed
            out.append(type(exc).__name__)
    return out


def phase_resilience_path(svc, main_reqs, chain_reqs, pipe_grid):
    """The self-healing ladder on the card at full size, one flush per
    case, the launch counters reset just before each and read just after:
    (a) a non-transient ``dispatch`` fault on the hopper plan key is served
    by the torch plan; (b) a transient fault that fires once is retried on
    B1; (c) a persistent ``nan_output`` on one ticket of a float32
    8-request flush quarantines that ticket alone; (d) a 65-value-wide
    grid is served by B1 (its value banks at 65 slots), nothing degraded,
    equal to the torch fleet and the numpy oracle; (e) a fault on the
    depth-3 chain's hopper plan
    degrades to the torch chain.  Every served output is bitwise equal to
    a sound flush of the same frames; every degradation shows in
    ``fallback_dispatches``, the breaker events and the torch plan's key
    in ``dispatch_plans``."""
    import torch
    from repro_torch.core.grid import custom, sobel_grid
    from repro_torch.runtime import BreakerBoard, FaultInjector, RetryPolicy
    from repro_torch.runtime.fleet import PixieFleet
    from repro_torch.serve import FleetFrontend

    def case(label, front, reqs, sound, expect_launches, **expect):
        reset_launches()
        t0 = time.perf_counter()
        handles = [front.submit(app, img, grid=grid) for app, img, grid in reqs]
        front.flush()
        outs = served_or_failed(handles)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        st = front.stats
        failed = [i for i, o in enumerate(outs) if isinstance(o, str)]
        row = {"launches": {k: v for k, v in launches.items() if v},
               "quarantined": failed, "failures": sorted({outs[i] for i in failed}),
               "breaker_events": [e["event"] for e in st.breaker_events],
               "plans": sorted({k.split("|")[3] for k in st.dispatch_plans}),
               "flush_s": seconds, **{k: getattr(st, k) for k in LADDER_COUNTERS}}
        if launches != no_launches(**expect_launches):
            raise AssertionError(f"resilience {label}: launches {launches}")
        for key, want in expect.items():
            if row[key] != want:
                raise AssertionError(f"resilience {label}: {key} {row[key]} != {want}")
        for i, (got, want) in enumerate(zip(outs, sound)):
            if i not in failed and not np.array_equal(got, want):
                raise AssertionError(f"resilience {label}: output {i} differs from the sound flush")
        return row

    rng = np.random.default_rng(9)
    sound = serve(svc, main_reqs)
    sound_chain = serve(svc, chain_reqs)
    assert_sound(svc.fleet, "resilience path, sound flushes")
    rows = {}
    rows["a_non_transient"] = case(
        "(a)", FleetFrontend(fleet=PixieFleet(
            faults=FaultInjector(seed=0).inject("dispatch", transient=False,
                                                match=("|hopper|",)),
            breakers=BreakerBoard(failure_threshold=1))),
        main_reqs, sound, {}, fallback_dispatches=1, retries=0, quarantined=[],
        breaker_events=["open:dispatch"], plans=["torch"])
    rows["b_transient"] = case(
        "(b)", FleetFrontend(fleet=PixieFleet(
            faults=FaultInjector(seed=0).inject("dispatch", max_fires=1))),
        main_reqs, sound, {"vcgra_fused_batched": 1}, retries=1, fallback_dispatches=0,
        quarantined=[], plans=["hopper"])
    f32_reqs = [(app, img.astype(np.float32), None) for app, img, _ in main_reqs]
    f32_grid = sobel_grid(float_pe=True)
    f32_sound_svc = FleetFrontend(fleet=PixieFleet(default_grid=f32_grid))
    f32_sound = [np.asarray(o) for o in serve(f32_sound_svc, f32_reqs)]
    assert_sound(f32_sound_svc.fleet, "resilience path, sound float32 flush")
    rows["c_poisoned_float32_ticket"] = case(
        "(c)", FleetFrontend(fleet=PixieFleet(
            default_grid=f32_grid, retry=RetryPolicy(max_attempts=1),
            faults=FaultInjector(seed=0).inject("nan_output", match=("<ticket:3>",)))),
        f32_reqs, f32_sound, {"vcgra_fused_batched": 2}, quarantined=[3],
        failures=["QuarantinedError"], quarantined_requests=1)
    del f32_sound_svc, f32_sound
    wide = custom("wide-65", 65, [65, 11, 7, 5, 3, 3, 2], 1)
    wide_reqs = [(app, img, wide) for app, img in zip(["sobel_x", "laplace"],
                                                      frames_1080p(rng, 2))]
    wide_sound = serve(FleetFrontend(fleet=PixieFleet(backend="torch", batch_tile=2)), wide_reqs)
    for (app, img, _), out in zip(wide_reqs, wide_sound):
        if not np.array_equal(out, oracle(app, img)):
            raise AssertionError(f"wide-65 {app}: backend='torch' differs from the numpy oracle")
    rows["d_wide_grid"] = case(
        "(d)", FleetFrontend(fleet=PixieFleet(batch_tile=2)), wide_reqs, wide_sound,
        {"vcgra_fused_batched": 1}, fallback_dispatches=0, retries=0, quarantined=[],
        plans=["hopper"])
    torch.cuda.empty_cache()
    rows["e_chain_fault"] = case(
        "(e)", FleetFrontend(fleet=PixieFleet(
            faults=FaultInjector(seed=0).inject("dispatch", transient=False,
                                                match=("|hopper|dev1|pipe",)),
            breakers=BreakerBoard(failure_threshold=1))),
        chain_reqs, sound_chain, {}, fallback_dispatches=1, quarantined=[],
        breaker_events=["open:dispatch"], plans=["torch"])
    torch.cuda.empty_cache()
    emit({"phase": "resilience_path", "cases": rows,
          "sizes": "(a)(b) 8 x 1080p int32 sobel-5x9; (c) 8 x 1080p float32 sobel-5x9; "
                   "(d) 2 x 1080p int32 wide-65; (e) 8 x 1080p int32 depth-3 chain "
                   f"{'+'.join(CHAIN)} on {pipe_grid.name}",
          "checked_against": ["sound hopper flush of the same frames, bitwise",
                              "backend='torch' and the numpy oracle for wide-65"]})
    return rows


#: Requests of the streaming phase: 48 image requests over the main
#: flush's apps plus this many depth-3 chains.
STREAM_IMAGES, STREAM_CHAINS = 48, 4


def streaming_trace(pipe_grid):
    """(app, frame, grid, deadline_s, priority) of the streaming phase:
    every other image request has a 0.2 s deadline, priorities alternate
    in pairs, the chains have no deadline."""
    rng = np.random.default_rng(8)
    trace = [(MAIN_APPS[i % len(MAIN_APPS)], img, None, 0.2 if i % 2 == 0 else None,
              (i // 2) % 2) for i, img in enumerate(frames_1080p(rng, STREAM_IMAGES))]
    trace += [(CHAIN, img, pipe_grid, None, 1)
              for img in frames_1080p(rng, STREAM_CHAINS)]
    return trace


def flush_times(mode, reqs, runs=5):
    """``runs`` flushes of ``reqs`` through a fresh ``FleetFrontend`` of
    ingest ``mode``: each flush's median host-clock time with its outputs
    read before the next (``serial``), the time a flush when flush k's
    outputs are read only after flush k+1 was dispatched (``pipelined``),
    and a ``torch.profiler`` trace of the serial flushes (the device's busy
    time a flush and the card's busy share of the traced window)."""
    import torch
    from repro_torch.serve import FleetFrontend

    front = FleetFrontend(ingest=mode)
    host_stats = getattr(torch.cuda, "host_memory_stats", None)

    def one():
        for out in serve(front, reqs):
            np.asarray(out)
        torch.cuda.synchronize()

    def split(before, host_before):
        """The fleet's own per-flush split since ``before``, and the pinned
        host allocations the caching host allocator made meanwhile."""
        out = {f"{k}_ms_per_flush": (front.timings[k] - before[k]) * 1e3 / runs
               for k in ("pack_s", "dispatch_s")}
        if host_before is not None:
            after = host_stats()
            out["pinned_allocations"] = (after.get("num_host_alloc", 0)
                                         - host_before.get("num_host_alloc", 0))
        return out

    one()
    serial = []
    before, host_before = dict(front.timings), host_stats() if host_stats else None
    for _ in range(runs):
        t0 = time.perf_counter()
        one()
        serial.append((time.perf_counter() - t0) * 1e3)
    serial_split = split(before, host_before)
    before, host_before = dict(front.timings), host_stats() if host_stats else None
    t0 = time.perf_counter()
    held = None
    for _ in range(runs):
        handles = [front.submit(app, img, grid=grid) for app, img, grid in reqs]
        front.flush()
        if held is not None:
            for h in held:
                np.asarray(h.result())
        held = handles
    for h in held:
        np.asarray(h.result())
    torch.cuda.synchronize()
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / runs
    pipelined_split = split(before, host_before)
    profiled = profile_steps(one, steps=runs)
    median = statistics.median(serial)
    assert_sound(front.fleet, f"flush times, ingest={mode}")
    return {"median_ms": median, "runs_ms": serial, "serial_split": serial_split,
            "pipelined_ms_per_flush": pipelined_ms, "pipelined_split": pipelined_split,
            "ingest_overlap_s": front.stats.ingest_overlap_s,
            "profile": profiled, "device_busy_share": profiled["device_busy_share"]}


def phase_streaming_path(svc, main_reqs, pipe_grid):
    """``StreamingFrontend()`` with its defaults (hopper, cuda) serves the
    streaming trace -- 48 1080p int32 requests over the main flush's apps
    with mixed deadlines and priorities, plus depth-3 chains -- once with
    ``ingest="sync"`` and once with ``"async"``, the launch counters reset
    just before each run and read just after.  Every output is bitwise
    equal to the sync ``FleetFrontend`` on the same trace, with zero
    fallbacks; B1 and B3 launch once per fused and chain dispatch.  Then
    5 flushes of 8 x 1080p timed and profiled per ingest mode, in the
    order sync, async, async, sync (the host's first flushes of a process
    run slower, so each mode is read twice, once early and once late)."""
    import torch
    from repro_torch.serve import StreamingFrontend

    trace = streaming_trace(pipe_grid)
    want = []
    for k in range(0, len(trace), 8):
        want += [np.asarray(o) for o in serve(svc, [(a, im, g) for a, im, g, _, _ in
                                                     trace[k:k + 8]])]
    assert_sound(svc.fleet, "streaming path, sync front-end")
    rows = {}
    for mode in ("sync", "async"):
        stream = StreamingFrontend(ingest=mode)
        if (stream.backend, stream.device.type, stream.ingest) != ("hopper", "cuda", mode):
            raise AssertionError(f"StreamingFrontend() defaults: {stream.backend}, "
                                 f"{stream.device}, {stream.ingest}")
        reset_launches()
        t0 = time.perf_counter()
        handles = [stream.submit(app, img, grid=grid, deadline_s=d, priority=p)
                   for app, img, grid, d, p in trace]
        outs = served_or_failed(handles)
        stream.close(timeout=600)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        st = stream.stats
        pipe = st.pipeline_dispatches
        if launches != no_launches(vcgra_fused_batched=st.fused_dispatches - pipe,
                                   vcgra_pipeline_batched=pipe) or st.dispatches != st.fused_dispatches:
            raise AssertionError(f"streaming {mode}: launches {launches} vs dispatches "
                                 f"{st.dispatches} (pipeline {pipe})")
        assert_sound(stream.fleet, f"streaming path, ingest={mode}")
        for i, (got, ref) in enumerate(zip(outs, want)):
            if isinstance(got, str) or not np.array_equal(got, ref):
                raise AssertionError(f"streaming {mode}: request {i} differs from the sync "
                                     f"FleetFrontend ({got if isinstance(got, str) else 'values'})")
        del outs, handles
        rows[mode] = {
            "requests": len(trace), "wall_s": wall_s, "launches": launches,
            "latency": stream.latency.summary(), "dispatches": st.dispatches,
            "pipeline_dispatches": pipe, "partial_tile_dispatches": st.partial_tile_dispatches,
            "preempted_batches": st.preempted_batches, "ingest_overlap_s": st.ingest_overlap_s,
            "ingest_readiness": st.ingest_readiness,
        }
        torch.cuda.empty_cache()
    for mode in ("sync", "async", "async", "sync"):
        rows[mode].setdefault("flushes_8x1080p", []).append(flush_times(mode, main_reqs))
        torch.cuda.empty_cache()
    emit({"phase": "streaming_path", "modes": rows,
          "trace": f"{STREAM_IMAGES} x 1080p int32 over {MAIN_APPS} on sobel-5x9 (every other "
                   f"with deadline_s 0.2, priorities 0/1) + {STREAM_CHAINS} x 1080p chains "
                   f"{'+'.join(CHAIN)} on {pipe_grid.name}",
          "checked_against": "the sync FleetFrontend on the same trace, bitwise"})
    for mode, row in rows.items():
        lat, fls = row["latency"], row["flushes_8x1080p"]
        print(f"streaming ingest={mode}: total_s p50/p95/p99 "
              f"{lat['total_s']['p50']:.4f}/{lat['total_s']['p95']:.4f}/"
              f"{lat['total_s']['p99']:.4f} s, partial-tile dispatches "
              f"{row['partial_tile_dispatches']}, ingest_overlap_s {row['ingest_overlap_s']:.6f}, "
              "8 x 1080p flush median (early, late) "
              f"{[round(f['median_ms'], 3) for f in fls]} ms, pipelined "
              f"{[round(f['pipelined_ms_per_flush'], 3) for f in fls]} ms, device busy share "
              f"(one trace: device union / profiled window) "
              f"{[f['device_busy_share'] for f in fls]}", flush=True)
    return rows


def phase_synthesis_case(svc):
    """``synthesize("sobel_mag", SOBEL_SOURCE)`` -- the paper's textual
    front-end -- mapped and served on the card through B1 beside the
    library ``sobel_mag`` on one 1080p frame, the counters reset just
    before: one B1 launch, both outputs bitwise equal to each other and
    to the numpy oracle."""
    import torch
    from repro_torch.core import SOBEL_SOURCE, for_dfg, synthesize
    from repro_torch.core import applications as apps

    grid = for_dfg(apps.sobel_magnitude(), shape="rect")
    frame = frames_1080p(np.random.default_rng(10), 1)[0]
    dfg = synthesize("sobel_mag", SOBEL_SOURCE)
    reset_launches()
    synthesized, library = serve(svc, [(dfg, frame, grid), ("sobel_mag", frame, grid)])
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != no_launches(vcgra_fused_batched=1):
        raise AssertionError(f"synthesis case: launches {launches}")
    if not (np.array_equal(synthesized, library)
            and np.array_equal(library, oracle("sobel_mag", frame))):
        raise AssertionError("synthesized sobel_mag differs from the library sobel_mag")
    assert_sound(svc.fleet, "synthesis case")
    emit({"phase": "synthesis_case", "grid": grid.name, "frame": "1080 x 1920 int32",
          "synthesized_ops": dfg.num_ops(), "synthesized_depth": dfg.depth(),
          "library_ops": apps.sobel_magnitude().num_ops(), "launches": launches,
          "checked_against": ["library sobel_mag", "numpy oracle"]})
    return launches


#: GPU cycles of the spin queued before each shielded timing (~1 ms on an
#: H100): longer than any wrapper's host work, so that work overlaps it.
SHIELD_CYCLES = 2_000_000


def cuda_ms(fn, reps, shield=False, before=None, shield_cycles=SHIELD_CYCLES):
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    return statistics.median(cuda_times(fn, reps, shield, before, shield_cycles))


def cuda_times(fn, reps, shield=False, before=None, shield_cycles=SHIELD_CYCLES):
    """Device times (ms) of ``reps`` runs of ``fn`` after one warm-up, by
    CUDA events.  Unshielded, a run's interval also holds the host's time
    to enqueue its launches whenever the stream is idle meanwhile (what a
    caller waits for).  With ``shield`` a spin is queued on the stream just
    before each start event, the host enqueues ``fn``'s launches while the
    card spins, and the interval is the card's own time for them: a
    kernel's time, without its Python wrapper's, as long as the host's
    enqueue fits in the ``shield_cycles`` of the spin.  ``before``, if
    given, runs ahead of each run, outside its interval (an L2 flush)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        if shield:
            torch.cuda._sleep(shield_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def bound(bytes_moved, ops):
    """The least time (ms) for ``bytes_moved`` bytes and ``ops`` scalar
    operations at the card's memory rate and float32 non-tensor peak
    (``repro_torch.roofline.model``: the H100 SXM data sheet), and which
    side binds.  The data sheet has no int32 row; the float32 peak bounds
    the scalar int32 rate from above, so ops over it stays a lower bound."""
    from repro_torch.roofline.model import F32_FLOPS, HBM_BW

    t_bytes, t_ops = bytes_moved / HBM_BW, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def config_work(grid, cfg):
    """``(live PEs, live input channels)`` of one config on ``grid`` by
    ``specialize._live_slots`` (NONE PEs and the channels no live PE reads
    left out) -- the least work B1, B2 and B4 do for that app."""
    from repro_torch.core.ops import UNARY_OPS, Op
    from repro_torch.core.specialize import _live_slots

    live = _live_slots(grid, cfg)
    pes = [(lvl, slot) for lvl, slots in enumerate(live) for slot in slots
           if Op(int(cfg.opcodes[lvl][slot])) != Op.NONE]
    channels = {int(cfg.selects[0][slot, j]) for lvl, slot in pes if lvl == 0
                for j in ((0,) if Op(int(cfg.opcodes[0][slot])) in UNARY_OPS else (0, 1))}
    return len(pes), len(channels)


def live_work(grid, names):
    """:func:`config_work` per library app of ``names`` on ``grid``."""
    from repro_torch.core import applications as apps
    from repro_torch.core.pixie import map_app

    return [config_work(grid, map_app(apps.ALL_APPS[name](), grid)) for name in names]


def chain_work(grid, chain):
    """Live PEs summed over the stages of ``chain`` ((app, radius) pairs) by
    :func:`config_work`: the least operations a pixel of B3 costs."""
    return sum(pes for pes, _ in live_work(grid, [name for name, _ in chain]))


# The kernel table's shapes (PERF.md section 6), one definition each, used by
# the timing phases and by ``--table-times``: each returns ``(run, plain,
# shape, operands)``.

def canvas_of(imgs, n):
    """``imgs`` top-left in an int32 ``[n, 2048, 2048]`` canvas (zero frames
    past them, as the fleet pads a tile)."""
    canvas = np.zeros((n, 2048, 2048), np.int32)
    for i, img in enumerate(imgs):
        canvas[i, :img.shape[0], :img.shape[1]] = img
    return canvas


def b1_case(device, grid, names, imgs):
    """B1 at the main path's shape: apps ``names`` at radius 1 with
    ``tile_rows="auto"`` on ``imgs`` in a ``[len(names), 2048, 2048]``
    canvas."""
    from repro_torch.kernels.vcgra import vcgra_fused_batched, vcgra_fused_batched_ref

    ops = fused_operands(grid, names, canvas_of(imgs, len(names)), device)
    return (lambda: vcgra_fused_batched(grid, 1, *ops, tile_rows="auto"),
            lambda: vcgra_fused_batched_ref(grid, 1, *ops),
            (len(names), 2048, 2048), ops)


CHANNEL_APPS = ["sobel_x", "sharpen", "laplace", "threshold"]


def channel_requests_of(imgs):
    """Named-channel requests of :data:`CHANNEL_APPS` over the 3 x 3 taps
    of ``imgs``."""
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.runtime.fleet import FleetRequest

    reqs = []
    for app, img in zip(CHANNEL_APPS, imgs):
        taps = apps.stencil_inputs(torch.from_numpy(img))
        reqs.append(FleetRequest(app=app, inputs={k: v.numpy() for k, v in taps.items()}))
    return reqs


def b2_case(device, grid, reqs):
    """B2 at the named-channel flush's shape: the channels of ``reqs``
    packed as the fleet packs them (one pow2 bucket, zero channels and the
    first app's config up to 8 apps); ``operands`` are the padded app
    names and the ``[8, C, B]`` stack."""
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.core.bitstream import VCGRAConfig
    from repro_torch.core.interpreter import pack_inputs
    from repro_torch.core.pixie import map_app
    from repro_torch.core.tiling import pad_batches, pad_channels, pow2_bucket
    from repro_torch.kernels.vcgra import pack_settings_batched, vcgra_batched, vcgra_batched_ref

    names = [r.app for r in reqs]
    cfgs = [map_app(apps.ALL_APPS[name](), grid) for name in names]
    xs = [pad_channels(pack_inputs(c, r.inputs, grid.dtype, device=device), grid.num_inputs)
          for c, r in zip(cfgs, reqs)]
    xs = pad_batches(xs, pow2_bucket(max(x.shape[-1] for x in xs), 256))
    xs += [torch.zeros_like(xs[0])] * (8 - len(xs))
    cfgs += [cfgs[0]] * (8 - len(cfgs))
    names += names[:1] * (8 - len(names))
    xstack = torch.stack(xs)
    settings = pack_settings_batched(grid, VCGRAConfig.stack(cfgs, device=device))
    return (lambda: vcgra_batched(grid, settings, xstack),
            lambda: vcgra_batched_ref(grid, settings, xstack),
            tuple(xstack.shape), (names, xstack))


def b3_case(device, grid, imgs, rng):
    """B3 at the chain path's shape: the depth-3 :data:`CHAIN` at radius 1
    a stage with ``tile_rows="auto"`` on ``imgs`` in an ``[8, 2048, 2048]``
    canvas; ``operands`` are the chain and its stage-stacked operands."""
    from repro_torch.kernels.vcgra import vcgra_pipeline_batched, vcgra_pipeline_batched_ref

    chain = [(app, 1) for app in CHAIN]
    radii = tuple(r for _, r in chain)
    args = chain_operands(grid, chain, [img.shape for img in imgs], 2048, 2048, device, rng,
                          images=canvas_of(imgs, len(imgs)))
    return (lambda: vcgra_pipeline_batched(grid, radii, *args, tile_rows="auto"),
            lambda: vcgra_pipeline_batched_ref(grid, radii, *args),
            (len(imgs), 2048, 2048), (chain, args))


def b4_case(device, frame, cfg=None):
    """B4 at the single-app path's shape: ``sobel_mag`` on its exact grid
    over the ingested ``[27, H*W]`` channels of ``frame``; ``operands`` are
    the grid, the config, its settings and the channels."""
    import torch
    from repro_torch.core import applications as apps
    from repro_torch.core.grid import for_dfg
    from repro_torch.core.pixie import map_app
    from repro_torch.kernels.vcgra import vcgra_conventional, vcgra_conventional_ref
    from repro_torch.kernels.vcgra.ops import _pack_settings, ingest_image

    grid = for_dfg(apps.sobel_magnitude(), shape="exact")
    cfg = map_app(apps.sobel_magnitude(), grid) if cfg is None else cfg
    x = ingest_image(cfg.ingest, grid.dtype, torch.as_tensor(frame, device=device))
    settings = _pack_settings(grid, cfg, device=device)[:3]
    return (lambda: vcgra_conventional(grid, settings, x),
            lambda: vcgra_conventional_ref(grid, settings, x),
            tuple(x.shape), (grid, cfg, settings, x))


def phase_times(device, svc, main_reqs, channel_requests, all_grid):
    """Kernel, plain and bound at the main path's shapes: B1 on the
    8 x 1080p flush's n8x2048x2048 canvas and on the all-apps flush's
    n16x2048x2048 canvas (every library app, the tile padded with the
    first app on zero frames, as the fleet pads it), B2 on the
    named-channel flush's [8, C, 2^21] stack, with each one's block; plus
    the end-to-end flush time.  Bounds count the live PEs' operations and,
    for B2, the live channels' bytes (also given over all C channels)."""
    import torch
    from repro_torch.core.grid import sobel_grid
    from repro_torch.core.tiling import itemsize
    from repro_torch.core import applications as apps
    from repro_torch.roofline.model import F32_FLOPS, HBM_BW

    rng = np.random.default_rng(7)
    all_names = sorted(apps.ALL_APPS)
    # (label, grid, apps, frames): the first and third main-path flushes.
    b1_cases = [("main", sobel_grid(), MAIN_APPS, [img for _, img, _ in main_reqs]),
                ("all_apps", all_grid, all_names + all_names[:1] * 7,
                 [rng.integers(0, 256, (1080, 1920)) for _ in all_names])]
    rows, b1_rows = {}, {}
    for label, grid, names, imgs in b1_cases:
        run_b1, plain_b1, (n, H, W), _ = b1_case(device, grid, names, imgs)
        err = compare(run_b1(), plain_b1(), "int32", True)
        live_pes = sum(pes for pes, _ in live_work(grid, names))
        b_ms, b_by = bound(n * H * W * itemsize(grid.dtype) * (1 + grid.num_outputs),
                           H * W * live_pes)
        b1_rows[label] = dict(
            ms=cuda_ms(run_b1, 20, shield=True), plain_ms=cuda_ms(plain_b1, 3), bound_ms=b_ms,
            bound_by=b_by, shape=f"n{n}x{H}x{W} {grid.name}", main_path_err=err,
            live_pes=live_pes, grid_pes=n * grid.num_pes,
            block=kernel_block("vcgra_fused_batched", grid, 1))
        del run_b1, plain_b1
        torch.cuda.empty_cache()
    rows["vcgra_fused_batched"] = dict(b1_rows["main"], all_apps=b1_rows["all_apps"])

    grid = sobel_grid()
    size, K = itemsize(grid.dtype), grid.num_outputs
    run_b2, plain_b2, (_, C, B), (names, _) = b2_case(device, grid, channel_requests())
    err = compare(run_b2(), plain_b2(), "int32", True)
    work = live_work(grid, names)
    live_channels = sum(ch for _, ch in work)
    b_ms, b_by = bound(B * size * (live_channels + 8 * K), B * sum(pes for pes, _ in work))
    all_ms, all_by = bound(8 * B * size * (C + K), 8 * B * grid.num_pes)
    rows["vcgra_batched"] = dict(
        ms=cuda_ms(run_b2, 20, shield=True), plain_ms=cuda_ms(plain_b2, 3), bound_ms=b_ms,
        bound_by=b_by, shape=f"n8x{C}x{B}", main_path_err=err,
        live_channels=live_channels, all_channels=8 * C,
        bound_all_channels_ms=all_ms, bound_all_channels_by=all_by,
        block=kernel_block("vcgra_batched", grid))
    del run_b2, plain_b2

    e2e = time_flushes(svc, main_reqs, "8 x 1080p int32, sobel-5x9")
    assert_sound(svc.fleet, "main path times")
    emit({"phase": "times", "kernels": rows, "end_to_end": e2e,
          "rates": {"hbm_bytes_per_s": HBM_BW, "scalar_ops_per_s": F32_FLOPS},
          "library_ms": None,
          "library_note": "no single PyTorch call computes a VCGRA overlay"})
    return rows, e2e


def time_flushes(svc, reqs, label, runs=5):
    """Host-clock flush times of ``reqs`` through ``svc``, each ending in a
    synchronize, with the fleet's own split per flush: host packing
    (canvas fill, copy to the card) vs dispatch (kernel launches and the
    outputs' copy back)."""
    import torch

    flush_ms = []
    before = dict(svc.timings)
    for _ in range(runs):
        t0 = time.perf_counter()
        serve(svc, reqs)
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
    split = {f"{k}_ms_per_flush": (svc.timings[k] - before[k]) * 1e3 / runs
             for k in ("pack_s", "dispatch_s")}
    return {"flush": label, "median_ms": statistics.median(flush_ms), "runs_ms": flush_ms,
            **split}


def phase_chain_times(device, svc, chain_reqs, pipe_grid):
    """B3 at the chain path's shape (the 8 x 1080p flush's n8x2048x2048
    canvas, depth-3 chain, int32), its plain version, its bound, the staged
    chain (three B1 launches with the masked forward between them) on the
    same operands, and the chain flush end to end."""
    from repro_torch.core.interpreter import forward_stage_output, valid_pixel_mask
    from repro_torch.core.tiling import itemsize
    from repro_torch.kernels.vcgra import vcgra_fused_batched

    grid = pipe_grid
    run_b3, plain_b3, (n, H, W), (chain, args) = b3_case(
        device, grid, [img for _, img, _ in chain_reqs], np.random.default_rng(5))
    radii = tuple(r for _, r in chain)
    settings, ingests, out_chs, hw, frames = args

    def staged():
        x, valid = frames, valid_pixel_mask(hw, 2048, 2048)
        for si, r in enumerate(radii):
            ys = vcgra_fused_batched(grid, r, tuple(t[si] for t in settings),
                                     (ingests[0][si], ingests[1][si]), x, tile_rows="auto")
            if si < len(radii) - 1:
                x = forward_stage_output(ys, out_chs[si], valid)
        return ys

    got = run_b3()
    err = compare(got, plain_b3(), "int32")
    compare(staged(), got, "int32")
    b_ms, b_by = bound(n * H * W * itemsize(grid.dtype) * (1 + grid.num_outputs),
                       n * H * W * chain_work(grid, chain))
    # 20 runs each, interleaved: staged, kernel, kernel, staged.
    staged_ms = cuda_times(staged, 10, shield=True)
    ms = cuda_times(run_b3, 10, shield=True) + cuda_times(run_b3, 10, shield=True)
    staged_ms += cuda_times(staged, 10, shield=True)
    row = dict(ms=statistics.median(ms), plain_ms=cuda_ms(plain_b3, 3),
               bound_ms=b_ms, bound_by=b_by, shape=f"n{n}x{H}x{W} depth-3 {grid.name}",
               main_path_err=err, staged_ms=statistics.median(staged_ms),
               ms_range=[min(ms), max(ms)], staged_ms_range=[min(staged_ms), max(staged_ms)])
    row["faster"] = "B3" if row["ms"] < row["staged_ms"] else "staged"
    row["block"] = kernel_block("vcgra_pipeline_batched", grid, sum(radii))
    e2e = time_flushes(svc, chain_reqs, f"8 x 1080p int32 chain {'+'.join(CHAIN)}, {grid.name}")
    assert_sound(svc.fleet, "chain path times")
    emit({"phase": "chain_times", "kernel": row, "end_to_end": e2e})
    return row, e2e


def kernel_block(kernel, grid, R=0, block_n=1024):
    """The block of B1 (at radius R), B2, B3 (at total radius R) or B4 (at
    ``block_n``) on this grid: threads, registers a thread (the compiler's,
    read from the built kernel) and dynamic shared memory; for B1 also
    whether its frame window is in shared memory, for B4 its passes."""
    from repro_torch.core.tiling import itemsize
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.vcgra import ops

    args = (itemsize(grid.dtype), grid.num_inputs, grid.pes_per_level, grid.num_outputs)
    code = ops._DTYPE_CODES[grid.dtype]
    if kernel == "vcgra_pipeline_batched":
        threads, smem, window, banks = ops.pipeline_launch(args[0], R, *args[1:])
        which = (0 if window else 1) + 2 * banks
        return {"threads": threads, "smem_bytes": smem, "window": window, "device_banks": banks,
                "registers_per_thread":
                    load_library("vcgra_pipeline").vcgra_pipeline_regs(which, code)}
    if kernel == "vcgra_conventional":
        threads, smem, passes, banks = ops.conventional_launch(*args, block_n)
        return {"threads": threads, "smem_bytes": smem, "passes": passes, "block_n": block_n,
                "device_banks": banks,
                "registers_per_thread": load_library("vcgra").vcgra_kernel_regs(3 + 4 * banks,
                                                                                code)}
    if kernel == "vcgra_fused_batched":
        threads, smem, window, banks = ops.fused_launch(args[0], R, *args[1:])
        which = 0 if window else 1
    else:
        (threads, smem, banks), window, which = ops.batched_launch(*args), None, 2
    return {"threads": threads, "smem_bytes": smem, "window": window, "device_banks": banks,
            "registers_per_thread": load_library("vcgra").vcgra_kernel_regs(which + 4 * banks,
                                                                            code)}


def single_app_cases(dtype_name):
    """(grid, config) of every library app on its exact grid and of the
    Sobel-grid apps on ``sobel_grid()``, in one grid dtype."""
    from repro_torch.core import applications as apps
    from repro_torch.core.grid import for_dfg, sobel_grid
    from repro_torch.core.pixie import map_app

    cases = []
    for name in sorted(apps.ALL_APPS):
        grid = retyped(for_dfg(apps.ALL_APPS[name](), shape="exact"), dtype_name)
        cases.append((grid, map_app(apps.ALL_APPS[name](), grid)))
    grid = retyped(sobel_grid(), dtype_name)
    cases += [(grid, map_app(apps.ALL_APPS[n](), grid)) for n in SOBEL_APPS]
    return cases


def phase_single_app_path(device, frame):
    """The single-app entry points at full width, the launch counters reset
    just before and read just after: the paper's Fig. 5 ``sobel_x`` on
    ``sobel_grid()`` in both modes; ``Pixie`` on the ``sobel_mag`` exact
    grid (27 inputs, 43 PEs) through ``run_image``, ``run_raw``,
    ``run_many`` over three ragged apps, ``run_pipeline`` of a depth-3
    chain and the parameterized mode (B5); ``vcgra_apply_image`` in both
    modes (B5, B4); the fused stencil (B6); and a ``PixiePreprocessor``
    cycling its four filters on a 1080p float32 frame.  Every output is
    checked against the numpy oracles and against ``backend="torch"`` on
    the card."""
    import torch
    from repro_torch.core import Pixie
    from repro_torch.core import applications as apps
    from repro_torch.core.grid import for_dfg, sobel_grid
    from repro_torch.data import PixiePreprocessor, synthetic_images
    from repro_torch.kernels.stencil import sobel_magnitude_fused
    from repro_torch.kernels.vcgra import vcgra_apply_image
    from repro_torch.kernels.vcgra.ops import ingest_image

    rng = np.random.default_rng(7)
    mag_dfg = apps.sobel_magnitude()
    mag_grid = for_dfg(mag_dfg, shape="exact")
    many_apps = [("sobel_x", (720, 1280)), ("gauss3", (480, 640)), ("threshold", (1080, 1920))]
    many_frames = [rng.integers(0, 256, hw).astype(np.int32) for _, hw in many_apps]
    pre_frame = synthetic_images(1, (1080, 1920), seed=7)[0]
    frame_t = torch.as_tensor(frame, device=device)

    def many_requests(pix):
        reqs = []
        for (app, _), img in zip(many_apps, many_frames):
            cfg = pix.map(apps.ALL_APPS[app]())
            taps = apps.stencil_inputs(torch.as_tensor(img, device=device))
            reqs.append((cfg, {k: v for k, v in taps.items() if k in cfg.input_order}))
        return reqs

    def drive(backend):
        """Every entry point of the path on ``backend``; returns
        ``{name: output}``, the Pixies, the ``sobel_mag`` config and the
        paper's Sec. V-E stage times on this grid."""
        out, pixies = {}, {}
        for mode in ("conventional", "parameterized"):
            pix = Pixie(sobel_grid(), mode=mode, backend=backend)
            if mode == "conventional":
                pix.compile_overlay(batch=frame.size)
            pix.load(pix.map(apps.sobel_x()))
            out[f"sobel-5x9 {mode} sobel_x"] = pix.run_image(frame)
            pixies[f"sobel-5x9 {mode}"] = pix
        conv = Pixie(mag_grid, backend=backend)
        conv.compile_overlay(batch=frame.size)
        cfg = conv.map(mag_dfg)
        conv.load(cfg)
        sec = {"map_s": conv.timings["map_s"],
               "reconfig_conventional_s": conv.timings["reconfig_s"],
               "overlay_compile_s": conv.timings["overlay_compile_s"]}
        out["sobel_mag run_image"] = conv.run_image(frame)
        out["sobel_mag run_raw"] = conv.run_raw(ingest_image(cfg.ingest, mag_grid.dtype, frame_t))
        for (app, _), y in zip(many_apps, conv.run_many(many_requests(conv))):
            out[f"run_many {app}"] = y
        out["run_pipeline " + "+".join(CHAIN)] = conv.run_pipeline(CHAIN, frame)
        par = Pixie(mag_grid, mode="parameterized", backend=backend)
        sec["reconfig_parameterized_s"] = par.load(cfg)
        out["sobel_mag parameterized"] = par.run_image(frame)
        pixies.update({"sobel_mag conventional": conv, "sobel_mag parameterized": par})
        pre = PixiePreprocessor(backend=backend)
        for name in pre.filters:
            pre.reconfigure(name)
            out[f"preprocessor {name}"] = pre(pre_frame)
        return out, pixies, cfg, sec

    reset_launches()
    t0 = time.perf_counter()
    served, pixies, cfg, sec_v_e = drive("hopper")
    for mode in ("specialized", "conventional"):
        served[f"vcgra_apply_image {mode}"] = vcgra_apply_image(mag_grid, cfg, frame, mode=mode)
    served["sobel_magnitude_fused"] = sobel_magnitude_fused(frame)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = launch_counts()
    timings = {name: dict(pix.timings) for name, pix in pixies.items()}
    spec_kernel = pixies["sobel_mag parameterized"]._spec_fn.args[0]

    missing = [k for k in IMAGE_KERNELS if launches[k] == 0]
    if missing or launches["flash_decode"]:
        raise AssertionError(f"the single-app path launched {launches}: every image kernel "
                             f"expected (missing {missing}), and no B7")
    mag = oracle("sobel_mag", frame)
    want = {"sobel-5x9 conventional sobel_x": oracle("sobel_x", frame),
            "sobel-5x9 parameterized sobel_x": oracle("sobel_x", frame),
            "sobel_mag run_image": mag, "sobel_mag run_raw": mag.reshape(1, -1),
            "run_pipeline " + "+".join(CHAIN): staged_oracle(CHAIN, frame),
            "sobel_mag parameterized": mag, "vcgra_apply_image specialized": mag,
            "vcgra_apply_image conventional": mag, "sobel_magnitude_fused": mag}
    for (app, _), img in zip(many_apps, many_frames):
        want[f"run_many {app}"] = oracle(app, img).reshape(1, -1)
    for name, w in want.items():
        if not np.array_equal(served[name].cpu().numpy(), w):
            raise AssertionError(f"{name} differs from the numpy oracle")
    pre_oracles = {"sobel_mag": apps.sobel_magnitude_reference(pre_frame),
                   "gauss3": apps.conv2d_reference(pre_frame, apps.GAUSS3, 16.0),
                   "sharpen": apps.conv2d_reference(pre_frame, apps.SHARPEN),
                   "laplace": apps.conv2d_reference(pre_frame, apps.LAPLACE)}
    for name, w in pre_oracles.items():
        # float32 sums of nine terms up to ~2000 against numpy's float32 sums
        # in another order.
        np.testing.assert_allclose(served[f"preprocessor {name}"].cpu().numpy(), w,
                                   rtol=1e-5, atol=1e-2)
    on_torch = drive("torch")[0]
    for name, w in on_torch.items():
        if not torch.equal(served[name], w):
            raise AssertionError(f"{name}: hopper differs from backend='torch' on the card")
    del on_torch
    torch.cuda.empty_cache()
    emit({"phase": "single_app_path", "frame": "1080x1920 int32", "outputs": len(served),
          "launches": launches, "single_app_path_s": path_s, "pixie_timings": timings,
          "sec_v_e_s": sec_v_e, "b5_compile_s": spec_kernel.compile_s,
          "b5_cached": spec_kernel.cached,
          "checked_against": ["numpy oracles", "backend='torch' on the card"]})
    return launches, pixies, cfg, sec_v_e


#: B6's kernel-vs-plain frames (H, W): odd non-square, one pixel, widths
#: that are not a multiple of its V columns a thread (4 or 8) or below V,
#: one row, and 1080p.
STENCIL_FRAMES = ((37, 53), (1, 1), (131, 7), (5, 4097), (3, 6), (1, 3), (2, 9), (1, 1920),
                  (1080, 1920))


def phase_single_vs_plain(device, tally):
    """B4, B5 and B6 on the card vs their plain versions, each case
    synchronized.  The B5 kernels (one per config, dtype and bake_consts)
    are compiled first, in parallel threads.  B4 also runs every library
    app on the 40- and 64-wide grids; B6 every filter form on frames from a
    16-byte aligned start and one element past it."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.core import applications as apps
    from repro_torch.core.pixie import map_app
    from repro_torch.kernels import stencil
    from repro_torch.kernels.vcgra import (
        SpecializedKernel, vcgra_conventional, vcgra_conventional_ref, vcgra_specialized,
        vcgra_specialized_ref,
    )
    from repro_torch.kernels.vcgra.ops import _pack_settings

    rng = np.random.default_rng(8)
    jobs = [(dtype_name, grid, cfg, bake) for dtype_name in DTYPE_NAMES
            for grid, cfg in single_app_cases(dtype_name) for bake in (False, True)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        kernels = list(pool.map(lambda j: SpecializedKernel(j[1], j[2], j[3], device), jobs))
    compile_s = time.perf_counter() - t0

    def conventional(dtype_name, grid, cfg, x):
        settings = _pack_settings(grid, cfg, device=device)[:3]
        want = vcgra_conventional_ref(grid, settings, x)
        for block_n in (128, 256, 1024):
            tally.check("vcgra_conventional",
                        vcgra_conventional(grid, settings, x, block_n=block_n), want,
                        dtype_name, True)

    for (dtype_name, grid, cfg, bake), kernel in zip(jobs, kernels):
        for n in (1, 45, 4099):
            x = torch.as_tensor(rng.integers(-8, 256, (grid.num_inputs, n)),
                                device=device).to(grid.dtype)
            want = vcgra_specialized_ref(grid, cfg, x, bake)
            for block_n in (128, 1024):
                tally.check("vcgra_specialized", vcgra_specialized(kernel, x, block_n=block_n),
                            want, dtype_name)
            if not bake:
                conventional(dtype_name, grid, cfg, x)
    for dtype_name in DTYPE_NAMES:
        for width in (40, 64):
            grid = retyped(wide_grid(width), dtype_name)
            for name in sorted(apps.ALL_APPS):
                cfg = map_app(apps.ALL_APPS[name](), grid)
                for n in (1, 45, 4099):
                    x = torch.as_tensor(rng.integers(-8, 256, (width, n)),
                                        device=device).to(grid.dtype)
                    conventional(dtype_name, grid, cfg, x)
    forms = [(apps.SOBEL_X, apps.SOBEL_Y)] + [(k,) for k in stencil.ops.FILTERS.values()]
    for dtype_name, dtype in (("int32", torch.int32), ("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for H, W in STENCIL_FRAMES:
            flat = torch.as_tensor(rng.integers(0, 256, H * W + 1), device=device).to(dtype)
            for img in (flat[:-1].view(H, W), flat[1:].view(H, W)):
                for kernels_ in forms:
                    want = stencil.stencil_fused_ref(img, kernels_)
                    for block_h in (1, 8, 128):
                        tally.check("stencil_fused",
                                    stencil.stencil_fused(img, kernels_, block_h=block_h), want,
                                    dtype_name)
    return {"b5_kernels": len(jobs), "b5_compile_s": compile_s}


def phase_single_times(device, frame, mag_cfg, pixies):
    """B4, B5 and B6 at the single-app path's shapes (the ``sobel_mag``
    exact grid's ``[27, 1080*1920]`` int32 channels; the 1080p int32 frame),
    beside their bounds (B4 and B5 over the live channels and PEs) and
    plain versions, with B4's block; for B6 also one
    ``torch.nn.functional.conv2d`` call (float32, one filter) as a
    yardstick, beside B6's own float32 one-filter time, and both again
    with the L2 flushed before each run (``cold_ms``: a 64 MB write, outside
    the timed interval; warm, the 8.3 MB frame stays in the 50 MB L2), and
    B6's Sobel magnitude of the same frame in float32 and bf16.  Then the
    paper's four Sobel magnitudes timed end to end on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import applications as apps
    from repro_torch.kernels import stencil
    from repro_torch.kernels.vcgra import (
        SpecializedKernel, vcgra_apply_image, vcgra_specialized, vcgra_specialized_ref,
    )
    from repro_torch.kernels.vcgra.specialized import live_inputs

    run_b4, plain_b4, (C, n), (grid, _, _, x) = b4_case(device, frame, mag_cfg)
    frame_t = torch.as_tensor(frame, device=device)
    K = grid.num_outputs
    kernel = SpecializedKernel(grid, mag_cfg, False, device)
    live = len(live_inputs(grid, mag_cfg))
    live_pes = kernel.source.count(" = pe(")
    [(b4_pes, b4_channels)] = live_work(grid, ["sobel_mag"])
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def flush_l2():
        scratch.fill_(1)

    rows = {}

    def row(name, run, plain, bytes_moved, ops, shape):
        err = compare(run(), plain(), "int32")
        b_ms, b_by = bound(bytes_moved, ops)
        rows[name] = dict(ms=cuda_ms(run, 20, shield=True), plain_ms=cuda_ms(plain, 3),
                          bound_ms=b_ms, bound_by=b_by, shape=shape, main_path_err=err)

    row("vcgra_conventional", run_b4, plain_b4, 4 * n * (b4_channels + K),
        n * b4_pes, f"[{C}, {n}] {grid.name}, {b4_channels} live rows, {b4_pes} live PEs")
    rows["vcgra_conventional"].update(block=kernel_block("vcgra_conventional", grid),
                                      live_channels=b4_channels, live_pes=b4_pes)
    row("vcgra_specialized", lambda: vcgra_specialized(kernel, x),
        lambda: vcgra_specialized_ref(grid, mag_cfg, x), 4 * n * (live + K), n * live_pes,
        f"[{C}, {n}] {grid.name}, {live} live rows, {live_pes} live PEs")
    pair = (apps.SOBEL_X, apps.SOBEL_Y)

    def b6():
        return stencil.stencil_fused(frame_t, pair)

    row("stencil_fused", b6, lambda: stencil.stencil_fused_ref(frame_t, pair), 4 * 2 * n,
        n * SOBEL_MAG_OPS, f"{frame.shape[0]}x{frame.shape[1]} int32 Sobel magnitude")
    frame_f = frame_t.float()
    weight = torch.tensor(apps.SOBEL_X, dtype=torch.float32, device=device)[None, None]
    lib_out = F.conv2d(frame_f[None, None], weight, padding=1)[0, 0]
    # Integer-valued frame: every float32 product and sum is exact, so the
    # library call and B6 agree bitwise whatever their summation order.
    compare(stencil.stencil_fused(frame_f, (apps.SOBEL_X,)), lib_out, "float32")

    def library():
        return F.conv2d(frame_f[None, None], weight, padding=1)

    def single():
        return stencil.stencil_fused(frame_f, (apps.SOBEL_X,))

    rows["stencil_fused"].update(
        cold_ms=cuda_ms(b6, 20, shield=True, before=flush_l2),
        library_ms=cuda_ms(library, 20, shield=True),
        library_cold_ms=cuda_ms(library, 20, shield=True, before=flush_l2),
        library_call="torch.nn.functional.conv2d float32, one 3x3 filter, padding=1",
        single_filter_ms=cuda_ms(single, 20, shield=True),
        single_filter_cold_ms=cuda_ms(single, 20, shield=True, before=flush_l2),
        block_h=8)
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        img = frame_t.to(dtype)
        compare(stencil.stencil_fused(img, pair), stencil.stencil_fused_ref(img, pair),
                str(dtype)[6:], exact=True)
        by_dtype[str(dtype)[6:]] = {
            "ms": cuda_ms(lambda: stencil.stencil_fused(img, pair), 20, shield=True),
            "cold_ms": cuda_ms(lambda: stencil.stencil_fused(img, pair), 20, shield=True,
                               before=flush_l2)}
    rows["stencil_fused"]["sobel_mag_by_dtype"] = by_dtype
    del scratch

    conv, par = pixies["sobel_mag conventional"], pixies["sobel_mag parameterized"]
    four = {
        "pixie_conventional": lambda: conv.run_image(frame_t),
        "pixie_parameterized": lambda: par.run_image(frame_t),
        "vcgra_apply_image": lambda: vcgra_apply_image(grid, mag_cfg, frame_t),
        "sobel_magnitude_fused": lambda: stencil.sobel_magnitude_fused(frame_t),
    }
    outs = {name: fn() for name, fn in four.items()}
    first = outs["sobel_magnitude_fused"]
    for name, y in outs.items():
        if not torch.equal(y, first):
            raise AssertionError(f"sobel four-way: {name} differs from the fused stencil")
    # Unshielded: each way's time includes the host work a caller waits for.
    four_ms = {name: cuda_ms(fn, 10) for name, fn in four.items()}
    # The card's idle share of one single-app 1080p frame in each mode, from
    # one trace of 10 ``run_image`` calls each (:func:`profile_steps`), read
    # two ways: over the profiled window, which the profiler's host cost
    # stretches (an upper reading), and as the traced busy time over the
    # unprofiled frame time of ``four_ms``.
    frame_profile = {name: profile_steps(four[name], steps=10, top=4)
                     for name in ("pixie_conventional", "pixie_parameterized")}
    idle = {name: {
        "profiled_window": (None if p["device_busy_share"] is None
                            else 1.0 - p["device_busy_share"]),
        "unprofiled_frame": (None if p["device_busy_union_ms_per_step"] is None
                             else 1.0 - p["device_busy_union_ms_per_step"] / four_ms[name])}
        for name, p in frame_profile.items()}
    emit({"phase": "single_times", "kernels": rows, "sobel_four_way_ms": four_ms,
          "sobel_four_way": "1080x1920 int32, sobel_mag exact grid, identical outputs",
          "single_frame_profile": frame_profile, "single_frame_idle_share": idle,
          "x_bytes": x.numel() * x.element_size()})
    return rows, four_ms, idle

LM_ARCH = "gemma-2b"
#: The LM path's sizes: the engine's batch and cache, prompts, tokens.
LM_BATCH, LM_MAX_SEQ, LM_PROMPT, LM_GEN = 8, 4096, 128, 32
#: Teacher-forced decode steps held against prefill.
LM_CHECK_STEPS = 8
#: Decode logits (B7, float32 softmax weights) against prefill logits
#: (plain attention, softmax weights rounded to bf16) of the same tokens:
#: the largest |difference| over the largest |logit|.  Set between the two
#: readings that :func:`decode_vs_prefill` prints on the H100 (PERF.md,
#: section 6): the sound runs' largest gap, under 1%, and the planted
#: faults' smallest from a 1-token prefix, over 30%; 2% keeps a factor of
#: two or more from the sound runs and over ten from the faults.
LM_LOGIT_REL_TOL = 0.02
#: Faults planted in B7's lengths to show the check sees them: the current
#: token's own row left out (lengths for lengths + 1), one unwritten row
#: read (lengths + 2).  From 128 prompt tokens one row among 129 moves the
#: logits about as little as rounding does, under any limit the sound runs
#: clear, so the faults are held to the limit from a 1-token prefix, where
#: they are large, and only reported from 128.
LM_PLANTS = {"drops_current_row": -1, "reads_one_row_past": 1}
#: (B, S) of the ``decode_32k`` shape (SHAPES in configs/base.py).
DECODE_32K = (128, 32768)


def flash_inputs(rng, B, H, G, D, S, q_dtype, kv_dtype, device):
    import torch

    q = torch.as_tensor(rng.standard_normal((B, H, D)), dtype=torch.float32, device=device)
    k, v = (torch.as_tensor(rng.standard_normal((B, S, G, D)), dtype=torch.float32,
                            device=device) for _ in range(2))
    return q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)


def phase_flash_vs_plain(device):
    """B7 on the card vs its plain version, each case synchronized: the
    case table of ``flash_attention.parity`` in float32, bf16 and float32
    q over a bf16 cache, lengths 0, 1, ragged and S (and all S), at that
    module's tolerance; plus a tail past the lengths poisoned with 1e9
    that must change nothing.  Returns, per dtype pair, the largest error
    and its largest share of the tolerance."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import parity

    rng = np.random.default_rng(11)
    by_dtype, cases = {}, 0
    for q_dtype, kv_dtype in parity.DTYPES:
        err = share = 0.0
        for B, H, G, D, S, chunk in parity.CASES:
            q, k, v = flash_inputs(rng, B, H, G, D, S, q_dtype, kv_dtype, device)
            for lengths in (parity.lengths(rng, B, S), [S] * B):
                lens = torch.tensor(lengths, dtype=torch.int32, device=device)
                got = flash_attention.decode_attention(q, k, v, lens, chunk=chunk)
                want = flash_attention.decode_ref(q, k, v, lens)
                torch.cuda.synchronize()
                e, s = parity.check(got, want, lengths, f"B7 {(B, H, G, D, S, chunk)} "
                                    f"{q_dtype}/{kv_dtype} lengths {lengths}")
                err, share = max(err, e), max(share, s)
                cases += 1
        if kv_dtype == torch.bfloat16:
            # the rings of the window kinds, read as the ring decode reads them
            for B, H, G, D, W, chunk in parity.RING_CASES:
                q, k, v = flash_inputs(rng, B, H, G, D, W, q_dtype, kv_dtype, device)
                lengths = parity.ring_lengths(rng, B, W)
                lens = torch.tensor(lengths, dtype=torch.int32, device=device)
                got = flash_attention.decode_attention(q, k, v, lens, chunk=chunk)
                want = flash_attention.decode_ref(q, k, v, lens)
                torch.cuda.synchronize()
                e, s = parity.check(got, want, lengths, f"B7 ring {(B, H, G, D, W, chunk)} "
                                    f"{q_dtype}/{kv_dtype} lengths {lengths}")
                err, share = max(err, e), max(share, s)
                cases += 1
        by_dtype[f"{str(q_dtype)[6:]} q / {str(kv_dtype)[6:]} cache"] = {
            "max_abs_err": err, "max_share_of_tolerance": share}
    q, k, v = flash_inputs(rng, 2, 4, 2, 64, 512, torch.float32, torch.float32, device)
    lens = torch.tensor([100, 257], dtype=torch.int32, device=device)
    tail = torch.arange(512, device=device)[None, :, None, None] >= lens[:, None, None, None]
    clean = flash_attention.decode_attention(q, k, v, lens, chunk=128)
    poisoned = flash_attention.decode_attention(q, k.masked_fill(tail, 1e9),
                                                v.masked_fill(tail, 1e9), lens, chunk=128)
    if not torch.equal(clean, poisoned):
        raise AssertionError("B7 read rows past the lengths")
    return by_dtype, cases + 1


def lm_setup(device):
    """gemma-2b at full width, f32 master weights from a seeded generator on
    the card; returns the LM, the engine (bf16 weights) and the prompts."""
    import torch
    from repro_torch.configs import get_arch, param_count
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch(LM_ARCH)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(lm, params, ServeConfig(max_batch=LM_BATCH, max_seq=LM_MAX_SEQ))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    # param_count's closed form leaves out the final norm's d_model scales.
    if n_params != int(param_count(cfg)["total"]) + cfg.d_model:
        raise AssertionError(f"{n_params} parameters, param_count says "
                             f"{param_count(cfg)['total']}")
    del params  # the engine keeps its bf16 copy
    torch.cuda.empty_cache()
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    return cfg, lm, engine, prompts, {"init_and_cast_s": time.perf_counter() - t0,
                                      "parameters": n_params}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (tuple, list, type({}.values()))):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_serve_path(device):
    """The LM serving entry points at full width, the launch counters reset
    just before and read just after: ``ServeEngine.generate`` (8 prompts of
    128 tokens, 32 tokens each) and a ``SlotServer`` serving 3 requests, the
    third arriving mid-decode.  B7 must have launched 18 times (one per
    layer) per decode step, and no other kernel.  Then the decode path is
    held against the prefill path on the same tokens."""
    import torch
    from repro_torch.serve import ServeConfig, SlotServer

    cfg, lm, engine, prompts, setup = lm_setup(device)
    layers = cfg.num_layers
    reset_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_GEN)
    generate_s = time.perf_counter() - t0
    srv = SlotServer(lm, engine.params, ServeConfig(max_batch=LM_BATCH, max_seq=LM_MAX_SEQ))
    srv.add_request(0, prompts[0])
    srv.add_request(1, prompts[1])
    ticks = 0
    for _ in range(4):
        srv.tick()
        ticks += 1
    srv.add_request(2, prompts[2])   # arrives mid-decode
    for _ in range(4):
        srv.tick()
        ticks += 1
    served = [srv.finish(slot) for slot in (0, 1, 2)]
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = launch_counts()
    steps = (LM_GEN - 1) + ticks
    if launches != no_launches(flash_decode=layers * steps):
        raise AssertionError(f"launches {launches}: expected flash_decode = {layers} layers x "
                             f"{steps} decode steps and nothing else")
    if tokens.shape != (LM_BATCH, LM_GEN) or not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generate returned {tokens.shape} / out-of-range tokens")
    if [len(s) for s in served] != [1 + ticks, 1 + ticks, 1 + 4]:
        raise AssertionError(f"slot outputs of lengths {[len(s) for s in served]}")
    slot_equal, slot_compared = slot_tokens_vs_engine(lm, engine.params, prompts, tokens,
                                                      served, device)
    check = decode_vs_prefill(lm, engine.params, prompts, tokens, device)
    del srv
    torch.cuda.empty_cache()
    emit({"phase": "lm_serve_path", "arch": LM_ARCH, **setup,
          "engine": {"max_batch": LM_BATCH, "max_seq": LM_MAX_SEQ, "prompt": LM_PROMPT,
                     "generated": LM_GEN},
          "slot_server": {"requests": 3, "ticks": ticks,
                          "tokens_equal_to_engine": slot_equal,
                          "tokens_compared": slot_compared,
                          "tokens": sum(len(s) for s in served)},
          "decode_steps": steps, "launches": launches, "generate_first_s": generate_s,
          "lm_path_s": path_s, "decode_vs_prefill": check})
    return lm, engine, prompts, launches


def decode_gaps(lm, params, seq, start, steps, shift=0):
    """Teacher-forced: prefill ``seq[:, :start]``, feed ``seq`` one decode
    step at a time (B7), and hold each step's logits against the
    last-position logits of a prefill of the same tokens (plain attention,
    no B7).  ``shift`` plants a fault: B7 is handed the lengths moved by
    ``shift`` rows.  Returns each step's max |decode - prefill| over max
    |prefill logit|, and the greedy tokens that agree."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention

    real = attention.decode_attention
    if shift:
        attention.decode_attention = (lambda q, k, v, lengths, chunk=512:
                                      real(q, k, v, lengths + shift, chunk=chunk))
    try:
        _, cache, lengths = lm.prefill(params, seq[:, :start], cache_len=LM_MAX_SEQ)
        gaps, agree = [], 0
        for j in range(steps):
            before = flash_attention.LAUNCHES["flash_decode"]
            dec, cache, lengths = lm.decode_step(params, seq[:, start + j:start + j + 1],
                                                 cache, lengths)
            if flash_attention.LAUNCHES["flash_decode"] != before + lm.cfg.num_layers:
                raise AssertionError("a decode step did not run B7 in every layer")
            pre, _, _ = lm.prefill(params, seq[:, :start + j + 1], cache_len=start + j + 1)
            if not bool(torch.isfinite(dec).all()) or dec.shape != pre.shape:
                raise AssertionError("decode logits are not finite or not of the prefill's "
                                     "shape")
            gaps.append(float((dec - pre).abs().max()) / float(pre.abs().max()))
            agree += int((dec.argmax(-1) == pre.argmax(-1)).sum())
        del cache
    finally:
        attention.decode_attention = real
    return gaps, agree


def decode_vs_prefill(lm, params, prompts, tokens, device):
    """The decode path against the prefill path on the engine's token
    sequences, from the engine's 128-token prompts and from their first
    token alone, sound and with each fault of :data:`LM_PLANTS` planted.
    Every sound gap must lie within :data:`LM_LOGIT_REL_TOL`, and every
    planted fault must show a gap above it from the 1-token prefix."""
    import torch

    seq = torch.as_tensor(np.concatenate([prompts, tokens], axis=1), device=device)
    out = {}
    for start in (LM_PROMPT, 1):
        gaps, agree = decode_gaps(lm, params, seq, start, LM_CHECK_STEPS)
        if max(gaps) > LM_LOGIT_REL_TOL:
            raise AssertionError(f"decode from {start} tokens: max |decode - prefill| = "
                                 f"{max(gaps)} x max |logit|, over {LM_LOGIT_REL_TOL}")
        planted = {name: max(decode_gaps(lm, params, seq, start, LM_CHECK_STEPS, shift)[0])
                   for name, shift in LM_PLANTS.items()}
        missed = [name for name, gap in planted.items() if gap <= LM_LOGIT_REL_TOL]
        if start == 1 and missed:
            raise AssertionError(f"decode from {start} tokens: planted {missed} stay within "
                                 f"{LM_LOGIT_REL_TOL} ({planted}); the check cannot see them")
        out[f"from_{start}_tokens"] = {
            "steps": LM_CHECK_STEPS, "max_rel_to_max_logit": max(gaps), "per_step": gaps,
            "greedy_agree": agree, "greedy_total": LM_CHECK_STEPS * seq.shape[0],
            "planted_max_rel_to_max_logit": planted}
    return {"tolerance_rel": LM_LOGIT_REL_TOL, **out}


def slot_tokens_vs_engine(lm, params, prompts, tokens, served, device):
    """Each ``SlotServer`` output equals the engine's tokens up to the
    first step where they part; there the engine's two candidates must tie
    within twice the decode tolerance on the prefill logits of that
    sequence, and after it the sequences differ and are not compared.
    Returns (tokens compared and equal, tokens compared)."""
    import torch

    equal = compared = 0
    for slot, got in enumerate(served):
        for t, tok in enumerate(got):
            compared += 1
            want = int(tokens[slot, t])
            if tok == want:
                equal += 1
                continue
            seq = torch.as_tensor(np.concatenate([prompts[slot], tokens[slot, :t]])[None],
                                  device=device)
            logits = lm.prefill(params, seq, cache_len=seq.shape[1])[0][0].float()
            tie = 2 * LM_LOGIT_REL_TOL * float(logits.abs().max())
            if abs(float(logits[tok] - logits[want])) > tie:
                raise AssertionError(f"SlotServer slot {slot} step {t}: token {tok}, the "
                                     f"engine's {want}, and their logits do not tie")
            break
    return equal, compared


def flash_bound(B, H, G, D, lengths, itemsize, Dv=None):
    """B7's least time, by :func:`bound`: q, the k rows up to each length,
    their v columns (``Dv`` of them, ``D`` by default) and the output moved
    once (and the int32 lengths), or 2 D + 2 Dv float32 operations (a
    multiply-add each for the score and the weighted sum) per valid row and
    query head."""
    rows, Dv = sum(lengths), D if Dv is None else Dv
    bytes_moved = B * H * (D + Dv) * itemsize + rows * G * (D + Dv) * itemsize + 4 * B
    return (*bound(bytes_moved, 2 * (D + Dv) * H * rows), bytes_moved)


#: The ``record_function`` range around the profiled steps.
PROFILED_WINDOW = "chip_smoke.profiled_steps"


def busy_union(events):
    """The device's busy time inside the profiled window of one trace (us)
    and the window's length: the union of every device interval (kernels,
    copies, sets) clipped to the wall window of the ``PROFILED_WINDOW``
    range, which ends after a synchronize.  Overlapping intervals (a
    side-stream copy beside a kernel) count once, so the share cannot
    exceed 1."""
    windows = [e for e in events if e.name == PROFILED_WINDOW
               and "CUDA" not in str(getattr(e, "device_type", ""))]
    if not windows:
        return None, None
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in events
                   if "CUDA" in str(getattr(e, "device_type", "")) and e.name != PROFILED_WINDOW)
    busy, end = 0.0, w0
    for start, stop in spans:
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    return busy, w1 - w0


def profile_steps(step, steps=2, top=8):
    """``torch.profiler`` over ``steps`` calls of ``step`` (decode steps,
    flushes): the device's busy time and the kernel launches per step, the
    part of it that copies to or from pageable host memory (staged through
    the host, so its span holds host time too), the kernels that take
    the most device time (ms per step), and from the same trace the card's
    busy share of the profiled window (:func:`busy_union`; the profiler's
    own host cost lengthens the window, so the share reads low, not
    high).  The host's times under the profiler are inflated and not
    reported otherwise."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILED_WINDOW):
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    union_us, window_us = busy_union(prof.events())
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in events if getattr(e, "device_type", None) is not None
               and "CUDA" in str(e.device_type) and device_us(e) > 0
               and e.key != PROFILED_WINDOW]
    busy_us = sum(device_us(e) for e in kernels)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    kernels.sort(key=device_us, reverse=True)
    pageable_us = sum(device_us(e) for e in kernels if "Pageable" in e.key)
    return {
        "device_ms_per_step": busy_us / 1e3 / steps if busy_us else None,
        "device_busy_union_ms_per_step": (None if union_us is None
                                          else union_us / 1e3 / steps),
        "window_ms_per_step": None if window_us is None else window_us / 1e3 / steps,
        "device_busy_share": (None if not window_us else union_us / window_us),
        "pageable_copy_ms_per_step": pageable_us / 1e3 / steps,
        "kernel_launches_per_step": launches / steps,
        "top_kernels_ms_per_step": {e.key[:80]: device_us(e) / 1e3 / steps
                                    for e in kernels[:top]},
    }


def flash_row(label, rng, B, H, G, D, S, n, device):
    """B7 in bf16 over a ``[B, S, G, D]`` cache with ``n`` valid rows a
    sequence: its time (CUDA events, shielded), its block, its plain
    version's time, one ``scaled_dot_product_attention`` call with a
    boolean length mask and ``enable_gqa`` (the yardstick, never called by
    the port), and its bound; held to the plain version at ``parity``'s
    tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import parity

    q, k, v = flash_inputs(rng, B, H, G, D, S, torch.bfloat16, torch.bfloat16, device)
    lens = torch.full((B,), n, dtype=torch.int32, device=device)
    mask = (torch.arange(S, device=device)[None, :] < lens[:, None])[:, None, None, :]

    def run():
        return flash_attention.decode_attention(q, k, v, lens, chunk=512)

    def plain():
        return flash_attention.decode_ref(q, k, v, lens)

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)[:, :, 0, :]

    want = plain()
    got = run()
    lib = library()
    torch.cuda.synchronize()
    err, share = parity.check(got, want, [n] * B, f"B7 at the {label} shape")
    lib_err = float((lib.float() - want.float()).abs().max())
    b_ms, b_by, b_bytes = flash_bound(B, H, G, D, [n] * B, 2)
    ms = cuda_times(run, 20, shield=True)
    route = flash_attention.ops.tensor_core_route(k.dtype, H // G, D)
    lib = load_library("flash_decode")
    block = ({"body": "tensor cores", "threads": 128,
              "registers_per_thread": lib.flash_decode_tc_regs(1, H // G, D),
              "smem_bytes": flash_attention.ops.tc_smem_bytes(q.dtype, H // G, D)}
             if route else {"body": "CUDA cores"})
    row = dict(
        ms=statistics.median(ms), ms_range=[min(ms), max(ms)], block=block,
        plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 20, shield=True),
        bound_ms=b_ms, bound_by=b_by, bytes=b_bytes, main_path_err=err,
        err_share_of_tolerance=share, library_err=lib_err,
        shape=f"q [{B}, {H}, {D}], k/v [{B}, {S}, {G}, {D}] bf16, lengths {n}")
    del q, k, v, want, got, lib
    torch.cuda.empty_cache()
    return row


def host_ms(fn, reps):
    """Host-clock times (ms) of ``reps`` runs of ``fn``, each ended by a
    synchronize: what a caller waits for."""
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serving_times(lm, engine, prompts, gen, cache_len, prefix_embeds=None):
    """Prefill of the engine's batch, a decode step (host clock over 10
    runs, CUDA events, and a ``torch.profiler`` view of two steps: the
    device's busy time, launches, costliest kernels) and ``generate`` of
    ``gen`` tokens, on the card."""
    import torch

    prompts_t = torch.as_tensor(prompts, device=engine.device)
    pe = None if prefix_embeds is None else torch.as_tensor(prefix_embeds, device=engine.device)

    def prefill():
        return lm.prefill(engine.params, prompts_t, cache_len=cache_len, prefix_embeds=pe)

    prefill_ms = host_ms(prefill, 5)
    _, cache, lengths = prefill()
    tok = prompts_t[:, -1:]
    # the same position each time: the step rewrites its cache rows in place

    def step():
        return lm.decode_step(engine.params, tok, cache, lengths)

    decode_ms = host_ms(step, 10)
    decode_event_ms = cuda_times(step, 10)
    profiled = profile_steps(step)
    del cache
    t0 = time.perf_counter()
    engine.generate(prompts, gen, prefix_embeds=prefix_embeds)
    generate_s = time.perf_counter() - t0
    step_ms = statistics.median(decode_ms)
    return {
        "prefill_ms": statistics.median(prefill_ms), "prefill_runs_ms": prefill_ms,
        "decode_step_ms": step_ms, "decode_step_runs_ms": decode_ms,
        "decode_step_event_ms": statistics.median(decode_event_ms),
        "decode_step_profile": profiled,
        "device_idle_share": (None if profiled["device_ms_per_step"] is None
                              else 1.0 - profiled["device_ms_per_step"] / step_ms),
        "generate_s": generate_s,
        "generate_tokens_per_s": len(prompts) * gen / generate_s,
    }


def phase_lm_times(device, lm, engine, prompts):
    """B7 at the engine's shape (8 sequences of a 4096-row cache, 160 valid
    rows each: 128 prompt + 32 generated) and at the ``decode_32k`` shape of
    one gemma-2b layer (B 128, S 32768, all rows valid), bf16
    (:func:`flash_row`).  Then prefill, decode step and generate on the
    card (:func:`serving_times`)."""
    from repro_torch.roofline.model import F32_FLOPS, HBM_BW

    cfg = lm.cfg
    H, G, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(13)
    rows = {label: flash_row(label, rng, B, H, G, D, S, n, device)
            for label, B, S, n in (("engine", LM_BATCH, LM_MAX_SEQ, LM_PROMPT + LM_GEN),
                                   ("decode_32k", *DECODE_32K, DECODE_32K[1]))}
    out = serving_times(lm, engine, prompts, LM_GEN, LM_MAX_SEQ)
    out["b7_share_of_decode_step"] = cfg.num_layers * rows["engine"]["ms"] / out["decode_step_ms"]
    out["shape"] = (f"{LM_ARCH} full width, batch {LM_BATCH}, prompt {LM_PROMPT}, "
                    f"cache {LM_MAX_SEQ}, bf16")
    emit({"phase": "lm_times", "flash_decode": rows, "lm": out,
          "library_call": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True, "
                          "boolean length mask)",
          "rates": {"hbm_bytes_per_s": HBM_BW, "f32_ops_per_s": F32_FLOPS}})
    return rows, out


@dataclasses.dataclass(frozen=True)
class ZooRun:
    """One config of the zoo phase: the engine's batch and cache, the
    prompt length, the tokens ``generate`` makes, and the decode-vs-prefill
    checks ``(label, start, steps, fresh)``: teacher-forced from ``start``
    tokens of the engine's sequences (prompt + generated) or, ``fresh``,
    of a new random sequence of ``start + steps`` tokens."""
    arch: str
    batch: int
    max_seq: int
    prompt: int
    gen: int
    checks: tuple
    timed: bool = False       # serving times, profile and B7 beside its bound
    plants: bool = False      # the ring faults of :data:`RING_PLANTS`


#: The zoo phase, full width.  gemma3-12b and deepseek-moe-16b at full depth
#: too; gemma3's 1,000-token prompts fill 1,000 of its local layers' 1,024
#: ring slots, so the rings wrap during decode (position 1,024 on), and its
#: 1,100-token check starts with the rings wrapped in prefill.
ZOO = (
    ZooRun("gemma3-12b", 8, 4096, 1000, 32,
           (("from_1000_tokens_wraps_in_decode", 1000, 32, False),
            ("from_1100_tokens_wrapped_in_prefill", 1100, 8, True),
            ("from_1_token", 1, 8, False)), timed=True, plants=True),
    ZooRun("deepseek-moe-16b", 8, 4096, 128, 16,
           (("from_128_tokens", 128, 16, False), ("from_1_token", 1, 8, False)), timed=True),
    ZooRun("qwen2-moe-a2.7b", 2, 512, 64, 8, (("from_64_tokens", 64, 8, False),)),
    ZooRun("xlstm-1.3b", 2, 512, 64, 8, (("from_64_tokens", 64, 8, False),)),
    ZooRun("hymba-1.5b", 2, 512, 64, 8, (("from_64_tokens", 64, 8, False),)),
    ZooRun("paligemma-3b", 2, 512, 64, 8, (("from_64_tokens", 64, 8, False),)),
    ZooRun("musicgen-medium", 2, 512, 64, 8, (("from_64_tokens", 64, 8, False),)),
)
#: Sequences of each decode-vs-prefill check (the first of the batch).
ZOO_CHECK_ROWS = 2
#: Faults planted in the ring decode of the window kinds: B7 reads
#: min(lengths + 2, W) rows (one unwritten), or the new k/v lands in slot
#: (lengths + 1) % W (the token's own row left out, an empty one read).
#: Held to the limit from a 1-token prefix, where they are large; reported
#: from the long prompts, where one row among a thousand is not.
RING_PLANTS = {"ring_reads_one_row_past": {"extra_rows": 1},
               "ring_slot_one_ahead": {"slot_shift": 1}}
#: Kinds whose decode runs a recurrence step by step where prefill runs
#: its chunked form: in bf16 the two round at other points (the mLSTM's
#: decode conv and q/k in float32, its prefill's in bf16; the SSM's bf16
#: decays one step at a time).  Their check, and the MoE configs' (bf16
#: router logits, and expert products over buffers of another shape), add
#: the bf16 prefill's own distance from a float32 prefill of the same
#: tokens to the limit: on an H100 the gaps read 2.0-2.9% (xlstm-1.3b) and
#: 3.5-5.4% (hymba-1.5b) against that distance's 2.3-2.8% and 3.7-5.4%.
#: In float32 both forms agree within 1e-6 (tests/test_torch_linear_rnn.py).
RECURRENT_KINDS = ("mlstm", "slstm", "hymba", "hymba_g")
#: B7 timed at the zoo's decode shapes: (arch, B, S, valid rows).
ZOO_FLASH = {"gemma3-12b": (8, 1024, 1024), "deepseek-moe-16b": (8, 4096, 160)}


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` with attention, each one B7 launch a decode
    step."""
    from repro_torch.models.blocks import ATTN_KINDS

    kinds = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.n_superblocks
    return sum(k in ATTN_KINDS or k in ("hymba", "hymba_g") for k in kinds)


def planted_ring(extra_rows=0, slot_shift=0):
    """``attention_decode_ring`` with a fault planted (:data:`RING_PLANTS`)."""
    import torch
    from repro_torch.models import attention

    def ring(params, x, cache, lengths, *, num_heads, num_kv_heads, head_dim, rope_theta,
             batch_share=False):
        G, Hg = num_kv_heads, num_heads // num_kv_heads
        k_cache, v_cache = cache
        W = k_cache.shape[1]
        q, k_new, v_new = attention._decode_qkv(params, x, G, Hg, head_dim,
                                                lengths[:, None], rope_theta)
        slots = (lengths.long() + slot_shift) % W
        n_rows = (lengths + 1 + extra_rows).clamp_max(W)
        out = attention._decode_attend(q, k_new, v_new, k_cache, v_cache, slots, n_rows,
                                       batch_share)
        return attention._decode_project_out(params, out, v_cache.dtype), (k_cache, v_cache)

    return ring


class RouterForce:
    """While active, wraps ``moe.route``.  Recording, it keeps each MoE
    layer's top-k expert ids per sequence and position (a prefill's, then
    each decode step's at its position); forcing, a prefill routes every
    token to the experts recorded for it, its gates renormalised from its
    own probabilities at those experts.  Decode and prefill then make the
    same discrete choices, and what parts them is rounding alone: with
    bf16 router logits a 27-layer, 64-expert model otherwise routes almost
    every token differently somewhere (on an H100, no sequence of
    deepseek-moe-16b from a 1-token prefix routed alike in every layer)."""

    def __init__(self, batch, positions):
        self.batch, self.positions = batch, positions
        self.routes, self.call, self.at, self.force = [], 0, 0, False
        self.overridden = 0

    def begin(self, at=0, force=False):
        """The next calls: one forward pass whose first position is ``at``."""
        self.call, self.at, self.force = 0, at, force

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self.real = real = moe.route

        def route(logits, k):
            probs, gates, ids = real(logits, k)
            n = logits.shape[0] // self.batch
            if self.call == len(self.routes):
                self.routes.append(torch.zeros((self.batch, self.positions, k),
                                               dtype=ids.dtype, device=ids.device))
            table = self.routes[self.call]
            self.call += 1
            if not self.force:
                table[:, self.at:self.at + n] = ids.view(self.batch, n, k)
                return probs, gates, ids
            forced = table[:, self.at:self.at + n].reshape(-1, k)
            self.overridden += int((forced.sort(-1).values != ids.sort(-1).values)
                                   .any(-1).sum())
            gates = probs.gather(1, forced)
            gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
            return probs, gates, forced

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.real


class Widened:
    """While active, every ``block_prefill`` widens its layer's weights and
    input to float32, so an LM with no compute dtype prefills in float32
    from bf16 weights while one layer's float32 copy exists at a time (a
    float32 copy of a 16 B model would not fit beside its bf16 one)."""

    def __enter__(self):
        from repro_torch.models import blocks
        from repro_torch.tree import tree_map

        self.real = real = blocks.block_prefill

        def block_prefill(params, cfg, kind, x, *args, **kwargs):
            return real(tree_map(lambda t: t.float(), params), cfg, kind, x.float(),
                        *args, **kwargs)

        blocks.block_prefill = block_prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks

        blocks.block_prefill = self.real


def zoo_gaps(lm, check_lm, params, seq, start, steps, cache_len, pe, b7_per_step,
             plant=None, noise_lm=None):
    """Teacher-forced: prefill ``seq[:, :start]`` (after the stub
    embeddings ``pe``), feed ``seq`` one decode step at a time, and set
    each step's logits beside the last-position logits of a ``check_lm``
    prefill of the same tokens (plain attention, no B7; for MoE routed as
    the decode routed, :class:`RouterForce`).  ``plant``: a
    :data:`RING_PLANTS` fault in the ring decode.  ``noise_lm``: the
    config with no compute dtype, whose prefill of the same tokens under
    :class:`Widened` is the float32 twin that measures the bf16 prefill's
    own rounding.  Returns, per step, the max |decode - prefill| over max
    |prefill logit| (``gap``) and the bf16 prefill's distance from its
    twin (``noise``); the greedy tokens that agree; and the MoE choices
    the forcing overrode."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    real = attention.attention_decode_ring
    if plant:
        attention.attention_decode_ring = planted_ring(**plant)
    first = pre_len(start, pe, lm.cfg)
    force = RouterForce(seq.shape[0], first + steps) if lm.cfg.moe is not None else None
    try:
        with force if force is not None else contextlib.nullcontext():
            _, cache, lengths = check_lm.prefill(params, seq[:, :start], cache_len=cache_len,
                                                 prefix_embeds=pe)
            out, agree = [], 0
            for j in range(steps):
                before = flash_attention.LAUNCHES["flash_decode"]
                if force is not None:
                    force.begin(at=first + j)
                dec, cache, lengths = lm.decode_step(params, seq[:, start + j:start + j + 1],
                                                     cache, lengths)
                if flash_attention.LAUNCHES["flash_decode"] != before + b7_per_step:
                    raise AssertionError(f"a decode step ran B7 {flash_attention.LAUNCHES} "
                                         f"times since {before}, not once in each of the "
                                         f"{b7_per_step} attention layers")
                if force is not None:
                    force.begin(force=True)
                pre, _, _ = check_lm.prefill(params, seq[:, :start + j + 1],
                                             cache_len=cache_len, prefix_embeds=pe)
                if not bool(torch.isfinite(dec).all()) or dec.shape != pre.shape:
                    raise AssertionError("decode logits are not finite or not of the "
                                         "prefill's shape")
                step = {"gap": rel(dec, pre)}
                if noise_lm is not None:
                    if force is not None:
                        force.begin(force=True)
                    with Widened():
                        pre32 = noise_lm.prefill(params, seq[:, :start + j + 1],
                                                 cache_len=cache_len, prefix_embeds=pe)[0]
                    step["noise"] = rel(pre, pre32)
                out.append(step)
                agree += int((dec.argmax(-1) == pre.argmax(-1)).sum())
            del cache
    finally:
        attention.attention_decode_ring = real
    return out, agree, (force.overridden if force is not None else None)


def pre_len(n_tokens, pe, cfg):
    """Positions of a prefill of ``n_tokens`` tokens: the meta tokens and
    stub embeddings lead them."""
    return n_tokens + cfg.meta_tokens + (0 if pe is None else pe.shape[1])


def zoo_checks(run, lm, check_lm, params, prompts, tokens, pe, device, b7_per_step,
               noise_lm=None):
    """:func:`zoo_gaps` for each check of ``run``.  Each step's gap (every
    row) within :data:`LM_LOGIT_REL_TOL`, plus, with ``noise_lm`` (the MoE and
    recurrent configs), the bf16 prefill's own distance from its float32
    twin on the same tokens; with ``run.plants``, each ring fault planted
    and held above the limit from a 1-token prefix."""
    import torch

    rng = np.random.default_rng(14)
    rows = ZOO_CHECK_ROWS
    engine_seq = torch.as_tensor(np.concatenate([prompts, tokens], axis=1)[:rows], device=device)
    pe_rows = None if pe is None else torch.as_tensor(pe[:rows], device=device)
    out = {}
    for label, start, steps, fresh in run.checks:
        seq = (torch.as_tensor(rng.integers(0, lm.cfg.vocab_size, (rows, start + steps)),
                               device=device) if fresh else engine_seq)
        per_step, agree, overridden = zoo_gaps(lm, check_lm, params, seq, start, steps,
                                               run.max_seq, pe_rows, b7_per_step,
                                               noise_lm=noise_lm)
        held = [(st["gap"], LM_LOGIT_REL_TOL + st.get("noise", 0.0)) for st in per_step]
        if any(g > lim for g, lim in held):
            raise AssertionError(f"{run.arch} {label}: decode vs prefill (gap, limit) "
                                 f"{held}: over the limit")
        entry = {"start": start, "steps": steps, "sequences": rows,
                 "max_rel_to_max_logit": max(g for g, _ in held),
                 "max_limit": max(lim for _, lim in held),
                 "per_step": per_step, "greedy_agree": agree, "greedy_total": steps * rows}
        if overridden is not None:
            entry["moe_choices_overridden_in_prefill"] = overridden
        if run.plants:
            planted = {name: max(st["gap"] for st in zoo_gaps(
                lm, check_lm, params, seq, start, steps, run.max_seq, pe_rows, b7_per_step,
                plant)[0]) for name, plant in RING_PLANTS.items()}
            missed = [name for name, gap in planted.items() if gap <= LM_LOGIT_REL_TOL]
            if start == 1 and missed:
                raise AssertionError(f"{run.arch} {label}: planted {missed} stay within "
                                     f"{LM_LOGIT_REL_TOL} ({planted}); the check cannot "
                                     "see them")
            entry["planted_max_rel_to_max_logit"] = planted
        out[label] = entry
    return out


def moe_drops(lm, params, prompts, cache_len, device):
    """Routed choices a prefill of ``prompts`` drops at the config's own
    capacity factor, counted by wrapping ``moe.dispatch``."""
    import torch
    from repro_torch.models import moe

    real, counts = moe.dispatch, {"choices": 0, "dropped": 0}

    def dispatch(expert_ids, E, C):
        pos, keep = real(expert_ids, E, C)
        counts["choices"] += keep.numel()
        counts["dropped"] += int((~keep).sum())
        return pos, keep

    moe.dispatch = dispatch
    try:
        lm.prefill(params, torch.as_tensor(prompts, device=device), cache_len=cache_len)
    finally:
        moe.dispatch = real
    return {**counts, "capacity_factor": lm.cfg.moe.capacity_factor,
            "share": counts["dropped"] / counts["choices"]}


def phase_lm_zoo(device, run):
    """One config of the zoo at full width (:data:`ZOO`), built from a
    seeded generator on the card in its served dtype (``init(cast=True)``:
    the float32 copy of a whole model never exists), the launch counters
    reset just before ``ServeEngine.generate`` and read just after: B7
    launches equal to the attention layers times the decode steps, and
    nothing else.  Then the decode-vs-prefill checks (MoE against a
    dropless prefill: capacity factor E / top_k, C = T), the prefill's
    drops at the config's own capacity, and for ``run.timed`` the serving
    times and B7 at the config's decode shape beside its bound."""
    import torch
    from repro_torch.configs import get_arch, param_count
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch(run.arch)
    lm = LM(cfg)
    check_lm = lm
    if cfg.moe is not None:
        check_lm = LM(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=device).manual_seed(0), cast=True)
    engine = ServeEngine(lm, params, ServeConfig(max_batch=run.batch, max_seq=run.max_seq))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in _leaves(params))
    rng = np.random.default_rng(15)
    prompts = rng.integers(0, cfg.vocab_size, (run.batch, run.prompt))
    pe = None
    if cfg.modality == "vision_stub":
        pe = (rng.standard_normal((run.batch, cfg.prefix_tokens, cfg.d_model))
              .astype(np.float32) * 0.02)
    layers = attention_layers(cfg)

    reset_launches()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, run.gen, prefix_embeds=pe)
    torch.cuda.synchronize()
    generate_first_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != no_launches(flash_decode=layers * (run.gen - 1)):
        raise AssertionError(f"{run.arch}: launches {launches}: expected flash_decode = "
                             f"{layers} attention layers x {run.gen - 1} decode steps and "
                             "nothing else")
    if tokens.shape != (run.batch, run.gen) or not ((tokens >= 0)
                                                   & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"{run.arch}: generate returned {tokens.shape} / out-of-range "
                             "tokens")
    serve_peak = torch.cuda.max_memory_allocated()
    noise_lm = None
    if cfg.moe is not None or any(k in RECURRENT_KINDS for k in cfg.pattern):
        noise_lm = LM(check_lm.cfg, compute_dtype=None)
    checks = zoo_checks(run, lm, check_lm, engine.params, prompts, tokens, pe, device, layers,
                        noise_lm)
    out = {"phase": "lm_zoo", "arch": run.arch, "parameters": n_params,
           "param_count": param_count(cfg)["total"], "init_and_cast_s": init_s,
           "peak_gb": {"init": init_peak / 1e9, "init_and_generate": serve_peak / 1e9},
           "engine": {"max_batch": run.batch, "max_seq": run.max_seq, "prompt": run.prompt,
                      "generated": run.gen, "prefix_tokens": cfg.prefix_tokens,
                      "meta_tokens": cfg.meta_tokens},
           "attention_layers": layers, "decode_steps": run.gen - 1, "launches": launches,
           "generate_first_s": generate_first_s,
           "decode_vs_prefill": {"tolerance_rel": LM_LOGIT_REL_TOL, **checks}}
    if cfg.moe is not None:
        out["prefill_drops"] = moe_drops(lm, engine.params, prompts, run.max_seq, device)
    if run.timed:
        B, S, n = ZOO_FLASH[run.arch]
        out["flash_decode"] = flash_row(run.arch, np.random.default_rng(16), B, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim, S, n, device)
        out["times"] = serving_times(lm, engine, prompts, run.gen, run.max_seq, pe)
        out["times"]["b7_share_of_decode_step"] = (
            layers * out["flash_decode"]["ms"] / out["times"]["decode_step_ms"])
        out["peak_gb"]["after_times"] = torch.cuda.max_memory_allocated() / 1e9
    emit(out)
    del engine, params
    torch.cuda.empty_cache()
    return out


# -- phase 15: the training path ------------------------------------------------------

TRAIN_ARCH = "gemma-2b"
#: (b)-(e): gemma-2b at full width and depth, batch x sequence, CE chunk.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOSS_CHUNK = 4, 1024, 512
#: (c): steps on one repeated batch, and the fall the loss must show: the
#: reference's own memorisation threshold (tests/test_train_loop.py).
MEMO_STEPS, MEMO_LR, MEMO_DROP = 10, 3e-4, 0.1
#: (a): the card against the CPU port, float32 compute, TF32 off: the same
#: function through other kernels, held as the CPU tests hold the port to
#: the reference (tests/test_torch_train.py): loss relative 1e-5, each grad
#: leaf max |d| <= 1e-4 max |g|.  After two AdamW steps the moments carry
#: that tolerance (:func:`moment_tolerances`), and the params lie within
#: 1e-4 of their largest element plus 5% of the learning rate (Adam's update
#: divides two moments that both vanish with the grad, so a near-zero
#: grad's float32 noise moves its update by a share of one step).
CARD_LOSS_RTOL, CARD_GRAD_REL, CARD_LR_SHARE = 1e-5, 1e-4, 0.05
CARD_ARCHS, CARD_LR = ("gemma-2b", "deepseek-moe-16b"), 3e-3
#: (b): bf16 compute against float32 compute on the same params and batch.
#: The reference's own gap, reduced gemma-2b on the CPU (JAX, 2 x 24 tokens,
#: tests/test_torch_train.py::test_bf16_limits_cover_the_reference_gap,
#: which holds these limits to at least 20x it): loss 9.9e-6 of the loss,
#: grad global norms 1.00013 of each other, 1 - cosine of the flattened
#: grads 1.43e-4.  The limits are 100x, 79x and 35x those readings, for 18
#: layers of 2048 where the reduced model has 2 of 64: wide for bf16 noise,
#: tight for a broken bf16 path (a layer's grads lost moves the cosine by
#: ~1/18).
BF16_LOSS_REL, BF16_NORM_RATIO, BF16_ONE_MINUS_COS = 1e-3, 0.01, 5e-3
#: (d): gemma-2b at full width and two layers, batch x sequence, steps of
#: the straight run (the resumed runs take half and half), and the
#: tolerance of a resumed loss against the straight run's.  The card's
#: embedding backward accumulates with atomics, so two runs are not
#: bitwise equal: each resumed loss within 1e-4 of it; a restored count
#: planted at 0 changes AdamW's bias correction (1.8x the update at step
#: 4) and must move a loss past that.
RESUME_LAYERS, RESUME_BATCH, RESUME_SEQ, RESUME_STEPS, RESUME_RTOL = 2, 2, 256, 6, 1e-4
RESUME_OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant")
#: (f): the other block kinds at full width, one superblock (deepseek: the
#: dense prefix layer and 2 MoE layers at the config's capacity factor):
#: (arch, layers, batch, sequence).
TRAIN_KINDS = (("deepseek-moe-16b", 3, 2, 512), ("xlstm-1.3b", 8, 2, 256),
               ("hymba-1.5b", 8, 2, 1024))
KIND_STEPS, KIND_LR = 4, 1e-3


def loss_and_grads(lm, params, tokens, prefix_embeds=None):
    """(loss, metrics, grads in JAX's leaf order) of ``lm.loss`` by autograd,
    leaving ``params`` out of autograd (detached views, as ``train_step``
    differentiates)."""
    import torch
    from repro_torch.tree import leaves, unflatten_like

    diff = [p.detach().requires_grad_() for p in leaves(params)]
    loss, metrics = lm.loss(unflatten_like(params, diff), tokens, prefix_embeds)
    grads = torch.autograd.grad(loss, diff)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def held(got, want, tol, label) -> float:
    """Every element of ``got`` within ``tol`` of ``want``; returns max |d|."""
    d = (got.detach().float().cpu() - want.detach().float().cpu()).abs()
    worst = float(d.max()) if d.numel() else 0.0
    if worst > tol:
        raise AssertionError(f"{label}: off by up to {worst:.3e} (tolerance {tol:.3e})")
    return worst


def moment_tolerances(v, b1, b2, rel):
    """(tol_m, tol_v) of one leaf after two AdamW steps whose grads each lie
    within ``rel`` G of the other device's, G the leaf's largest grad over
    the two steps: v = (1 - b2)(b2 g1^2 + g2^2) gives G^2 <= max v / ((1 -
    b2) b2), so |dm| <= rel (1 - b1^2) G and |dv| <= 2 rel (1 - b2^2) G^2.
    (A bound on m's own largest element would not do: two steps' grads of
    opposite signs cancel in m, not in its error.)"""
    g2 = float(v.max()) / ((1 - b2) * b2)
    return rel * (1 - b1 ** 2) * g2 ** 0.5, 2 * rel * (1 - b2 ** 2) * g2


def phase_train_card_vs_cpu(device):
    """(a) The chain to the reference: reduced gemma-2b and reduced
    deepseek-moe-16b, float32 compute, the same converted parameters and
    batch on the card and on the CPU: loss and every grad leaf, then
    params, ``m`` and ``v`` after two ``train_step``s (:data:`CARD_LOSS_RTOL`
    and the rest)."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import train_step
    from repro_torch.tree import flatten_with_path, leaves, tree_map

    t0 = time.perf_counter()
    out = {}
    for arch in CARD_ARCHS:
        cfg = reduced(get_arch(arch))
        lm = LM(cfg, chunk_q=16, loss_chunk=20, compute_dtype=None)
        cpu = lm.init(torch.Generator().manual_seed(0))
        card = tree_map(lambda t: t.to(device, copy=True), cpu)
        tokens = np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 48))
        t_cpu, t_card = torch.as_tensor(tokens), torch.as_tensor(tokens, device=device)
        l_cpu, m_cpu, g_cpu = loss_and_grads(lm, cpu, t_cpu)
        l_card, m_card, g_card = loss_and_grads(lm, card, t_card)
        loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        if loss_rel > CARD_LOSS_RTOL:
            raise AssertionError(f"{arch}: card loss {float(l_card)} vs CPU {float(l_cpu)}")
        grad_rel = 0.0
        for (path, _), g, w in zip(flatten_with_path(cpu), g_card, g_cpu):
            scale = float(w.abs().max())
            worst = held(g, w, CARD_GRAD_REL * scale, f"{arch} grad {path}")
            grad_rel = max(grad_rel, worst / max(scale, 1e-30))
        ocfg = AdamWConfig(lr=CARD_LR, warmup_steps=1, total_steps=4)
        o_cpu, o_card = init_opt_state(cpu), init_opt_state(card)
        losses = []
        for _ in range(2):
            _, _, mc = train_step(lm, ocfg, cpu, o_cpu, t_cpu)
            _, _, md = train_step(lm, ocfg, card, o_card, t_card)
            losses.append((float(md["loss"]), float(mc["loss"])))
        state = {"params": 0.0, "m": 0.0, "v": 0.0}
        for (path, p_cpu), p_card, mom_cpu, mom_card, v_cpu, v_card in zip(
                flatten_with_path(cpu), leaves(card), leaves(o_cpu["m"]), leaves(o_card["m"]),
                leaves(o_cpu["v"]), leaves(o_card["v"])):
            tol_m, tol_v = moment_tolerances(v_cpu, ocfg.b1, ocfg.b2, CARD_GRAD_REL)
            tol_p = CARD_GRAD_REL * float(p_cpu.abs().max()) + CARD_LR_SHARE * CARD_LR
            for kind, g, w, tol in (("params", p_card, p_cpu, tol_p),
                                    ("m", mom_card, mom_cpu, tol_m), ("v", v_card, v_cpu, tol_v)):
                worst = held(g, w, tol, f"{arch} {kind} {path}")
                state[kind] = max(state[kind], worst / max(tol, 1e-30))
        out[arch] = {"loss_card": float(l_card), "loss_rel": loss_rel,
                     "aux_card": float(m_card["aux"]), "aux_cpu": float(m_cpu["aux"]),
                     "grad_max_rel": grad_rel, "leaves": len(g_cpu),
                     "train_step_losses_card_cpu": losses,
                     "after_two_steps_max_share_of_tolerance": state}
        if float(m_cpu["aux"]) > 0 and abs(float(m_card["aux"]) - float(m_cpu["aux"])) > \
                CARD_LOSS_RTOL * float(m_cpu["aux"]):
            raise AssertionError(f"{arch}: aux loss {float(m_card['aux'])} vs "
                                 f"{float(m_cpu['aux'])}")
    emit({"phase": "train_card_vs_cpu", "cases": out,
          "tolerance": f"loss rel {CARD_LOSS_RTOL}; grads max|d| <= {CARD_GRAD_REL} max|g| "
                       f"per leaf; m, v that tolerance carried (moment_tolerances); params "
                       f"{CARD_GRAD_REL} max|p| + {CARD_LR_SHARE} lr",
          "seconds": time.perf_counter() - t0})
    return out


def model_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one training step: 6 N T (forward and backward of every
    parameter's product; the tied table counted once, as the unembedding)
    plus attention's 12 L H hd S T (scores and weighted sums, forward and
    backward, no causal halving), PaLM's count."""
    tokens = batch * seq
    return 6.0 * n_params * tokens + 12.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim \
        * seq * tokens


def timed_steps(step_fn, n):
    """Host-clock ms of ``n`` calls of ``step_fn`` (each ends on the loss
    read back: a synchronize), and the losses."""
    import torch

    ms, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step_fn()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, losses


def phase_train_gemma(device):
    """(b) bf16 against float32 compute, (c) memorisation and its times,
    (e) the trained weights served through B7, then ``train_loop`` over
    ``TokenPipeline``: gemma-2b at full width and depth, float32 masters
    from a seeded generator on the card, ``remat="full"``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.roofline.model import PEAK_FLOPS
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import LoopConfig, make_train_step, train_loop
    from repro_torch.tree import leaves

    cfg = get_arch(TRAIN_ARCH)
    lm = LM(cfg, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    tokens = torch.as_tensor(pipe.batch_at(0), device=device)

    # (b) bf16 compute against float32 compute
    t0 = time.perf_counter()
    l_b, _, g_b = loss_and_grads(lm, params, tokens)
    l_f, _, g_f = loss_and_grads(dataclasses.replace(lm, compute_dtype=None), params, tokens)
    dot = nb = nf = 0.0
    for b, f in zip(g_b, g_f):
        if not (bool(torch.isfinite(b).all()) and bool(torch.isfinite(f).all())):
            raise AssertionError("(b): a grad is not finite")
        dot += float(torch.dot(b.reshape(-1), f.reshape(-1)))
        nb += float(torch.dot(b.reshape(-1), b.reshape(-1)))
        nf += float(torch.dot(f.reshape(-1), f.reshape(-1)))
    del g_b, g_f
    bf16 = {"loss_bf16": float(l_b), "loss_f32": float(l_f),
            "loss_rel": abs(float(l_b) - float(l_f)) / abs(float(l_f)),
            "grad_norm_ratio": (nb / nf) ** 0.5, "one_minus_cosine": 1.0 - dot / (nb * nf) ** 0.5,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0,
            "limits": {"loss_rel": BF16_LOSS_REL, "grad_norm_ratio": [1 - BF16_NORM_RATIO,
                                                                      1 + BF16_NORM_RATIO],
                       "one_minus_cosine": BF16_ONE_MINUS_COS}}
    if not (bf16["loss_rel"] <= BF16_LOSS_REL
            and abs(bf16["grad_norm_ratio"] - 1) <= BF16_NORM_RATIO
            and bf16["one_minus_cosine"] <= BF16_ONE_MINUS_COS):
        raise AssertionError(f"(b): bf16 against float32 compute outside its limits: {bf16}")
    emit({"phase": "train_bf16_vs_f32", "arch": TRAIN_ARCH, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, **bf16})

    # (c) memorisation: MEMO_STEPS train_steps on the one batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    opt_init_s = time.perf_counter() - t0
    step_fn, _ = make_train_step(lm, None, AdamWConfig(lr=MEMO_LR, warmup_steps=0,
                                                       schedule="constant"))
    last = {}

    def one_step():
        _, _, last["metrics"] = step_fn(params, opt, tokens)
        return last["metrics"]["loss"]

    ms, losses = timed_steps(one_step, MEMO_STEPS)
    if not np.isfinite(losses).all() or losses[-1] > losses[0] - MEMO_DROP:
        raise AssertionError(f"(c): losses {losses} did not fall by {MEMO_DROP}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled = profile_steps(one_step, steps=1, top=10)
    step_ms = statistics.median(ms[2:])
    flops = model_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    memo = {"phase": "train_memorisation", "arch": TRAIN_ARCH, "parameters": n_params,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "loss_chunk": TRAIN_LOSS_CHUNK,
            "remat": lm.remat, "compute_dtype": "bfloat16", "lr": MEMO_LR,
            "losses": losses, "drop": losses[0] - losses[-1], "required_drop": MEMO_DROP,
            "init_params_s": init_s, "init_opt_state_s": opt_init_s,
            "step_ms": step_ms, "step_runs_ms": ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            "peak_gb": peak, "grad_norm": float(last["metrics"]["grad_norm"]),
            "model_flops_per_step": flops,
            "achieved_tflops": flops / (step_ms / 1e3) / 1e12,
            "share_of_bf16_peak": flops / (step_ms / 1e3) / PEAK_FLOPS,
            "profile_one_step": profiled,
            "device_idle_share": (None if profiled["device_ms_per_step"] is None
                                  else 1.0 - profiled["device_ms_per_step"] / step_ms)}
    emit(memo)

    # (e) the trained weights served: the optimizer state dropped, the
    # params cast, phase 12's engine shape
    del opt, last
    torch.cuda.empty_cache()
    engine = ServeEngine(lm, params, ServeConfig(max_batch=LM_BATCH, max_seq=LM_MAX_SEQ))
    del params
    torch.cuda.empty_cache()
    prompts = np.random.default_rng(22).integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    reset_launches()
    generated = engine.generate(prompts, LM_GEN)
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != no_launches(flash_decode=cfg.num_layers * (LM_GEN - 1)):
        raise AssertionError(f"(e): launches {launches}: expected flash_decode = "
                             f"{cfg.num_layers} layers x {LM_GEN - 1} decode steps and nothing "
                             "else")
    check = decode_vs_prefill(lm, engine.params, prompts, generated, device)
    emit({"phase": "train_serve_trained", "arch": TRAIN_ARCH, "trained_steps": MEMO_STEPS + 2,
          "engine": {"max_batch": LM_BATCH, "max_seq": LM_MAX_SEQ, "prompt": LM_PROMPT,
                     "generated": LM_GEN},
          "launches": launches, "decode_vs_prefill": check})
    del engine
    torch.cuda.empty_cache()

    # train_loop over TokenPipeline, with the heartbeat
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train_loop(lm, LoopConfig(steps=3, log_every=1, seed=1),
                      AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3),
                      TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1),
                      device=device)
    if not np.isfinite(hist["loss"]).all() or hist["step"] != [0, 1, 2]:
        raise AssertionError(f"train_loop: {hist}")
    emit({"phase": "train_loop", "arch": TRAIN_ARCH, "steps": hist["step"],
          "losses": hist["loss"], "step_s": hist["dt"],
          "throughput_tok_s": hist["throughput_tok_s"][0],
          "loop_s": time.perf_counter() - t0,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()
    return memo, launches, bf16


def phase_train_resume(device):
    """(d) Crash and resume: gemma-2b at full width and two layers.  A
    straight ``train_loop`` of :data:`RESUME_STEPS` against half the steps,
    its checkpoint, and a new ``train_loop`` that resumes through
    ``resume_or_init`` for the rest: equal losses within
    :data:`RESUME_RTOL`.  Then the same resume with the restored optimizer
    ``count`` planted at 0 must fail that check.  Also a blocking save and
    a restore of the same state, timed and held bitwise."""
    import shutil
    import torch
    import repro_torch.train.loop as loop_mod
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import LoopConfig, init_train_state, train_loop
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=RESUME_LAYERS)
    lm = LM(cfg, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    pipe = TokenPipeline(cfg.vocab_size, RESUME_SEQ, RESUME_BATCH, seed=3)
    ocfg = AdamWConfig(**RESUME_OPT)
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        # a save and a restore of (d)'s training state, timed
        params, opt = init_train_state(lm, seed=3, device=device)
        tree = {"params": params, "opt": opt}
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(tree))
        ck = Checkpointer(str(root / "timing"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, tree, blocking=True)
        save_s = time.perf_counter() - t0
        like = tree_map(torch.zeros_like, tree)
        t0 = time.perf_counter()
        step, restored = ck.restore_latest(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != 1 or not all(torch.equal(a, b) for a, b in zip(leaves(restored),
                                                                  leaves(tree))):
            raise AssertionError("(d): the restored state differs from the saved one")
        del params, opt, tree, like, restored
        shutil.rmtree(root / "timing")
        torch.cuda.empty_cache()

        half = RESUME_STEPS // 2
        straight = train_loop(lm, LoopConfig(steps=RESUME_STEPS, log_every=0, seed=3), ocfg,
                              pipe, device=device)["loss"]
        d = str(root / "run")
        train_loop(lm, LoopConfig(steps=half, ckpt_every=half, ckpt_dir=d, log_every=0,
                                  seed=3), ocfg, pipe, device=device)
        resumed = train_loop(lm, LoopConfig(steps=RESUME_STEPS, ckpt_every=half, ckpt_dir=d,
                                            log_every=0, seed=3), ocfg, pipe, device=device)

        def gaps(hist):
            if hist["step"] != list(range(half, RESUME_STEPS)):
                raise AssertionError(f"(d): resumed at steps {hist['step']}")
            return [abs(a - b) / abs(b) for a, b in zip(hist["loss"], straight[half:])]

        sound = gaps(resumed)
        if max(sound) > RESUME_RTOL:
            raise AssertionError(f"(d): resumed losses {resumed['loss']} vs straight "
                                 f"{straight[half:]}: {sound} over {RESUME_RTOL}")
        # the planted fault: the restored count set to 0
        shutil.rmtree(Path(d) / f"step_{RESUME_STEPS}")
        real = loop_mod.resume_or_init

        def planted(ckpt, init_fn, like=None):
            state = real(ckpt, init_fn, like)
            state.tree["opt"]["count"].zero_()
            return state

        loop_mod.resume_or_init = planted
        try:
            fault = gaps(train_loop(lm, LoopConfig(steps=RESUME_STEPS, ckpt_every=half,
                                                   ckpt_dir=d, log_every=0, seed=3),
                                    ocfg, pipe, device=device))
        finally:
            loop_mod.resume_or_init = real
        if max(fault) <= RESUME_RTOL:
            raise AssertionError(f"(d): a restored count planted at 0 stays within "
                                 f"{RESUME_RTOL} ({fault}); the check cannot see it")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "train_resume", "arch": TRAIN_ARCH, "layers": RESUME_LAYERS,
           "batch": RESUME_BATCH, "seq": RESUME_SEQ, "steps": RESUME_STEPS, "resumed_at": half,
           "straight_losses": straight, "resumed_losses": resumed["loss"],
           "resumed_rel_gaps": sound, "planted_count_zero_rel_gaps": fault,
           "tolerance_rel": RESUME_RTOL, "checkpoint_bytes": n_bytes,
           "save_s": save_s, "restore_s": restore_s}
    emit(out)
    torch.cuda.empty_cache()
    return out


def phase_train_kinds(device):
    """(f) The other block kinds at full width, one superblock: each trains
    :data:`KIND_STEPS` steps on one repeated batch, finite, its loss
    falling; deepseek's MoE at the config's capacity with the aux loss in
    the total, and ``remat="full"`` against ``"none"`` on it (float32
    compute, (a)'s tolerance)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_path

    rows = {}
    for arch, layers, batch, seq in TRAIN_KINDS:
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        lm = LM(cfg, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt = init_train_state(lm, seed=4, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.as_tensor(np.random.default_rng(23).integers(0, cfg.vocab_size,
                                                                    (batch, seq)),
                                 device=device)
        row = {"layers": layers, "pattern": list(cfg.prefix_pattern) + list(cfg.pattern),
               "batch": batch, "seq": seq, "meta_tokens": cfg.meta_tokens,
               "parameters": sum(p.numel() for _, p in flatten_with_path(params)),
               "init_s": init_s}
        if cfg.moe is not None:
            f32 = [loss_and_grads(dataclasses.replace(lm, remat=remat, compute_dtype=None),
                                  params, tokens) for remat in ("full", "none")]
            (l_full, _, g_full), (l_none, _, g_none) = f32
            if abs(float(l_full) - float(l_none)) > CARD_LOSS_RTOL * abs(float(l_none)):
                raise AssertionError(f"{arch}: remat full loss {float(l_full)} vs none "
                                     f"{float(l_none)}")
            worst = 0.0
            for (path, _), g, w in zip(flatten_with_path(params), g_full, g_none):
                scale = float(w.abs().max())
                e = held(g, w, CARD_GRAD_REL * scale, f"{arch} remat grad {path}")
                worst = max(worst, e / max(scale, 1e-30))
            row["remat_full_vs_none"] = {"loss_full": float(l_full), "loss_none": float(l_none),
                                         "grad_max_rel": worst}
            row["capacity_factor"] = cfg.moe.capacity_factor
            del f32, g_full, g_none
        step_fn, _ = make_train_step(lm, None, AdamWConfig(lr=KIND_LR, warmup_steps=0,
                                                           schedule="constant"))
        aux = []

        def one_step():
            _, _, m = step_fn(params, opt, tokens)
            aux.append(float(m["aux"]))
            return m["loss"]

        ms, losses = timed_steps(one_step, KIND_STEPS)
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: losses {losses} not finite or not falling")
        if cfg.moe is not None and not min(aux) > 0:
            raise AssertionError(f"{arch}: the MoE aux loss is not in the total: {aux}")
        row.update(losses=losses, aux=aux, step_runs_ms=ms, step_ms=statistics.median(ms[2:]),
                   tokens_per_s=batch * seq / (statistics.median(ms[2:]) / 1e3),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows[arch] = row
        del params, opt
    torch.cuda.empty_cache()
    emit({"phase": "train_kinds", "kinds": rows, "steps": KIND_STEPS, "lr": KIND_LR})
    return rows


# -- phases 16-18: the example twins, Table I on the card, the roofline ---------------

#: The ``examples/torch_*.py`` twins driven in-process at the reference's
#: defaults, each with the kernels its path must launch.  The training
#: driver takes 200 of its 300 steps: 300 (three ~1.2 GB checkpoints
#: included) took 35 s on the H100, past this phase's share of the run.
EXAMPLE_TWINS = (
    ("torch_quickstart", (), ("vcgra_fused_batched", "vcgra_specialized")),
    ("torch_pipeline_quickstart", (), ("vcgra_fused_batched", "vcgra_pipeline_batched")),
    ("torch_fleet_quickstart", (), ("vcgra_fused_batched",)),
    ("torch_serve_lm", (), ("flash_decode",)),
    ("torch_image_pipeline", (), ("vcgra_fused_batched",)),
    ("torch_train_lm", ("--steps", "200"), ()),
)
#: Table I's timed batch: a 1080p frame's pixels.
RESOURCE_PIXELS = 1920 * 1080


def phase_examples():
    """Each ``examples/torch_*.py`` twin's ``main(["--device", "cuda"])``
    in-process, the launch counters reset just before it: its own
    ``[ok]`` checks must pass (an example that fails fails the run), and
    the kernels of its path must have launched.  The twins' printing is
    kept out of this output; their ``[ok]`` lines are in the JSON."""
    import importlib.util
    import io

    import torch

    rows = {}
    for name, argv, kernels in EXAMPLE_TWINS:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        argv = ["--device", "cuda", *argv]
        printed = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = module.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        lines = printed.getvalue().splitlines()
        if rc != 0 or any(k not in launches for k in kernels):
            raise AssertionError(f"{name} {argv}: exit {rc}, launches {launches} (expected "
                                 f"{kernels}); its output:\n" + "\n".join(lines[-20:]))
        rows[name] = {"argv": argv, "seconds": seconds, "launches": launches,
                      "checks": [line.strip() for line in lines if "[ok]" in line
                                 or "bitwise" in line or line.startswith("loss:")]}
        emit({"phase": "example", "name": name, **rows[name]})
    return rows


def phase_resources(device, card):
    """The paper's Table I on the card: the five components of the
    reference's ``benchmarks/resource_table.py`` (``core.analysis
    .table_one_components``), each (a) censused on the CPU, the eager
    interpreter against ``build_specialized_fn`` at the reference's batch of
    4096 (``reduction_row``); (b) censused on the card, B4 over the
    component's grid against B5 generated for its app
    (``core.analysis.kernel_census``: SASS instructions, registers a
    thread, shared memory) with the input bytes each reads a pixel; (c)
    timed, B4 and B5 over :data:`RESOURCE_PIXELS` pixels by CUDA events,
    held to the plain version bitwise, beside the bound of the component's
    live work.  One JSON line per component."""
    import torch
    from repro_torch.core.analysis import (
        CENSUS_BATCH, PAPER_LUT_REDUCTION_PCT, census_pair, kernel_census, reduction_pct,
        reduction_row, table_one_components,
    )
    from repro_torch.core.tiling import itemsize
    from repro_torch.kernels.vcgra import (
        SpecializedKernel, vcgra_conventional, vcgra_conventional_ref, vcgra_specialized,
    )
    from repro_torch.kernels.vcgra.ops import _pack_settings
    from repro_torch.kernels.vcgra.specialized import live_inputs

    rng = np.random.default_rng(23)
    rows = []
    for name, grid, cfg in table_one_components():
        program = reduction_row(name, *census_pair(grid, cfg))
        kernel = SpecializedKernel(grid, cfg, False, device)
        b4, b5 = kernel_census("vcgra_conventional", grid), kernel_census(kernel)
        pes, channels = config_work(grid, cfg)
        size = itemsize(grid.dtype)
        b4["input_bytes_per_pixel"] = size * channels
        b5["input_bytes_per_pixel"] = size * len(live_inputs(grid, cfg))
        b4["smem_bytes"] = b4["static_smem_bytes"] + b4["dynamic_smem_bytes"]
        b5["smem_bytes"] = b5["static_smem_bytes"] + b5["dynamic_smem_bytes"]
        n = RESOURCE_PIXELS
        x = torch.as_tensor(rng.integers(0, 256, (grid.num_inputs, n)),
                            device=device).to(grid.dtype)
        settings = _pack_settings(grid, cfg, device=device)[:3]
        dtype_name = str(grid.dtype)[6:]
        want = vcgra_conventional_ref(grid, settings, x)
        err = max(compare(vcgra_conventional(grid, settings, x), want, dtype_name),
                  compare(vcgra_specialized(kernel, x), want, dtype_name))
        b_ms, b_by = bound(size * n * (channels + grid.num_outputs), n * pes)
        row = {
            "component": name, "grid": grid.name, "dtype": dtype_name,
            "paper_lut_reduction_pct": PAPER_LUT_REDUCTION_PCT[name],
            "cpu_census": {"batch": CENSUS_BATCH, **program},
            "card_census": {
                "conventional": b4, "parameterized": b5,
                "reduction_pct": {k: reduction_pct(b4[k], b5[k]) for k in (
                    "sass_instructions", "registers_per_thread", "smem_bytes",
                    "input_bytes_per_pixel")},
                "all_channel_bytes_per_pixel": size * grid.num_inputs},
            "time": {"pixels": n, "live_pes": pes, "live_channels": channels,
                     "conventional_ms": cuda_ms(
                         lambda: vcgra_conventional(grid, settings, x), 20, shield=True),
                     "parameterized_ms": cuda_ms(lambda: vcgra_specialized(kernel, x), 20,
                                                 shield=True),
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err_vs_plain": err},
            "card": card}
        row["time"]["reduction_pct"] = reduction_pct(row["time"]["conventional_ms"],
                                                     row["time"]["parameterized_ms"])
        del x, want
        emit({"phase": "resources", **row})
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def phase_roofline(lm_times, memo, card):
    """Rooflines of gemma-2b at full width from the census of the ATen ops
    one step executes (``roofline.hlo_analysis.analyze``) on ``meta``
    tensors (nothing allocated): the decode step that :func:`phase_lm_times`
    times (batch 8, 4096-row caches filled to 128 rows; B7's calls, which
    cannot run on meta tensors, counted by :func:`flash_bound`'s bytes and
    4 D ops a row and query head) and the training step of phase 15 (c)
    (batch 4 x 1,024, ``remat="full"``, CE chunks of 512), beside the
    measured step times of those phases."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from unittest import mock
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.roofline import (
        F32_FLOPS, HBM_BW, PEAK_FLOPS, RooflineReport, model_flops_estimate,
    )
    from repro_torch.roofline.hlo_analysis import analyze, meta_like
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves

    meta = torch.device("meta")
    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()

    def report(shape, census, extra_f32=0.0, extra_bytes=0.0, model=0.0):
        bf16 = census.flops_by_dtype.get("bfloat16", 0.0) + census.flops_by_dtype.get(
            "float16", 0.0)
        return RooflineReport(
            arch=cfg.name, shape=shape, mesh="1 card", chips=1, flops_per_device=bf16,
            f32_flops_per_device=census.flops - bf16 + census.elementwise_ops + extra_f32,
            bytes_per_device=census.hbm_bytes + extra_bytes,
            coll_bytes_per_device=census.collective_bytes, model_flops=model,
            coll_breakdown=census.coll_breakdown)

    # the decode step
    lm = LM(cfg)
    with FakeTensorMode():
        fake = lm.init(torch.Generator().manual_seed(0))
        served = lm.cast_params(fake)
    n_params = sum(p.numel() for p in leaves(fake))
    rows_read = LM_PROMPT + 1
    b7 = {"calls": 0, "bytes": 0.0, "ops": 0.0}

    def census_b7(q, k, v, lengths, chunk=512):
        B, H, D = q.shape
        G = k.shape[2]
        b7["calls"] += 1
        b7["bytes"] += flash_bound(B, H, G, D, [rows_read] * B, k.element_size())[2]
        b7["ops"] += 4.0 * D * H * B * rows_read
        return torch.empty_like(q)

    with mock.patch("repro_torch.models.attention.decode_attention", census_b7):
        dec = analyze(lm.decode_step, meta_like(served),
                      torch.empty((LM_BATCH, 1), dtype=torch.int64, device=meta),
                      lm.init_cache(LM_BATCH, LM_MAX_SEQ, device=meta),
                      torch.empty((LM_BATCH,), dtype=torch.int32, device=meta))
    if b7["calls"] != cfg.num_layers:
        raise AssertionError(f"the decode census saw {b7['calls']} B7 calls, not "
                             f"{cfg.num_layers}")
    decode = report(f"decode b{LM_BATCH} cache {LM_MAX_SEQ} fill {rows_read}", dec, b7["ops"],
                    b7["bytes"], model_flops_estimate(
                        cfg, ShapeConfig("decode", LM_MAX_SEQ, LM_BATCH, "decode"), n_params))
    # The decode step's byte floor: every served weight read once and the
    # cache rows B7 reads (q and out included), whatever the program fuses.
    weight_bytes = float(sum(p.numel() * p.element_size() for p in leaves(served)))
    del fake, served

    # the training step
    lm_t = LM(cfg, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    with FakeTensorMode():
        fake = lm_t.init(torch.Generator().manual_seed(0))
        opt = init_opt_state(fake)
    step_fn, _ = make_train_step(lm_t, None, AdamWConfig(lr=MEMO_LR, warmup_steps=0,
                                                         schedule="constant"))
    tr = analyze(step_fn, meta_like(fake), meta_like(opt),
                 torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64, device=meta))
    estimate = model_flops_estimate(
        cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), n_params)
    train = report(f"train b{TRAIN_BATCH}x{TRAIN_SEQ} remat full ce {TRAIN_LOSS_CHUNK}", tr,
                   model=estimate)
    census_s = time.perf_counter() - t0

    def measured(r, host_ms, device_ms):
        d = r.to_dict()
        d.update(measured_step_ms=host_ms, measured_device_ms=device_ms,
                 roofline_step_ms=r.step_time * 1e3,
                 measured_over_roofline=host_ms / (r.step_time * 1e3),
                 device_over_roofline=(None if device_ms is None
                                       else device_ms / (r.step_time * 1e3)))
        return d

    tokens = TRAIN_BATCH * TRAIN_SEQ
    palm = model_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    rows = [
        measured(decode, lm_times["decode_step_ms"],
                 lm_times["decode_step_profile"]["device_ms_per_step"]),
        measured(train, memo["step_ms"], memo["profile_one_step"]["device_ms_per_step"]),
    ]
    floor_ms = (weight_bytes + b7["bytes"]) / HBM_BW * 1e3
    rows[0].update(b7_calls=b7["calls"], b7_bytes=b7["bytes"], b7_ops=b7["ops"],
                   census_ops=sum(dec.op_counts.values()), weight_bytes=weight_bytes,
                   byte_floor_ms=floor_ms,
                   measured_over_byte_floor=rows[0]["measured_step_ms"] / floor_ms,
                   device_over_byte_floor=(None if rows[0]["measured_device_ms"] is None
                                           else rows[0]["measured_device_ms"] / floor_ms))
    rows[1].update(
        census_ops=sum(tr.op_counts.values()),
        census_product_flops=tr.flops, census_flops_by_dtype=tr.flops_by_dtype,
        model_flops_6nt=estimate, model_flops_chip_smoke=palm,
        census_over_model_flops=tr.flops / palm,
        # remat="full" runs each superblock's and each CE chunk's forward
        # products again in backward: 2 N T more, and the attention products
        # of a forward (a third of model_flops' 12 L H hd S T) again.
        remat_recompute_estimate=2.0 * n_params * tokens + (palm - estimate) / 3,
        census_over_model_flops_with_recompute=tr.flops / (
            palm + 2.0 * n_params * tokens + (palm - estimate) / 3))
    emit({"roofline": rows, "card": card, "census_s": census_s,
          "peaks": {"bf16_tensor_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                    "f32_flops": F32_FLOPS},
          "note": "census on meta tensors of the eager program: every op's operands and "
                  "result counted once (no fusion); float32 products (TF32 off) and "
                  "elementwise ops at the float32 non-tensor rate, added to the tensor-core "
                  "time; the roofline estimates the eager program and is no lower bound "
                  "(the decode row's byte_floor_ms is one)"})
    return rows


#: Phase 19's logical meshes as (app, rows), and those it runs the chain on.
MESH_SHAPES = ((2, 1), (1, 2), (2, 2), (1, 4))
MESH_CHAIN_SHAPES = ((1, 2), (2, 2))
#: Shards of the one card a logical mesh holds.
LOGICAL_SHARDS = 4
#: The reference's ladder of ``OverlayPlan(grid=sobel_grid(), batched=True,
#: fused=True, radius=1, backend="pallas", mesh=MeshSpec(app=2, rows=2),
#: tile_rows="auto")`` by ``repro.core.plan.fallback_chain``, as keys (the
#: script imports no JAX; ``tests/test_torch_mesh2d.py`` holds the port's
#: ladder to the reference's own on the CPU).
REFERENCE_LADDER_2D = (
    "sobel-5x9|batched|fused:r1|xla|dev2|rows2|tile:auto",
    "sobel-5x9|batched|fused:r1|xla|dev2|tile:auto",
    "sobel-5x9|batched|fused:r1|xla|dev1|tile:auto",
    "sobel-5x9|batched|fused:r1|xla|dev1",
)


def logical_mesh(device, shards=LOGICAL_SHARDS):
    """``shards`` shards of ``device`` in place of the host's devices: the
    logical mesh, restored on exit."""
    from unittest import mock

    import repro_torch.parallel.axes as axes

    return mock.patch.object(axes, "local_devices", lambda kind="cuda": [device] * shards)


def outputs(results):
    return [np.asarray(r) for r in results]


def assert_outputs(got, want, label):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: output {i} differs from the single-device run")


#: The spin before each shielded mesh dispatch (~10 ms): a logical mesh
#: enqueues up to 39 launches a dispatch, 1-3 ms of host work.
MESH_SHIELD_CYCLES = 20_000_000


def dispatch_times(fn, profile=False):
    """One dispatch's times: CUDA events unshielded (what a caller waits
    for) and shielded by a spin long enough for a mesh's enqueue (the
    card's own time), and with ``profile`` a ``torch.profiler`` trace of 5
    dispatches: launches, the card's busy time and the costliest kernels
    (a trace may drop kernel records; the shielded time does not)."""
    out = {"ms": cuda_ms(fn, 10),
           "device_ms": cuda_ms(fn, 10, shield=True, shield_cycles=MESH_SHIELD_CYCLES)}
    if profile:
        prof = profile_steps(fn, steps=5, top=8)
        out["trace"] = {"launches": prof["kernel_launches_per_step"],
                        "busy_ms": prof["device_busy_union_ms_per_step"],
                        "top_kernels_ms": prof["top_kernels_ms_per_step"]}
    return out


def mesh_fleet_run(spec, ingest, requests, want, flushes, label):
    """A hopper fleet on ``spec`` serves ``requests`` ``flushes`` times;
    every output bitwise ``want``.  Returns the fleet, the launches of the
    run and its halo and settings-replica copies."""
    import torch
    import repro_torch.parallel.axes as axes
    from repro_torch.parallel import MeshSpec
    from repro_torch.runtime.fleet import PixieFleet

    fleet = PixieFleet(mesh=MeshSpec(*spec), ingest=ingest)
    if fleet.stats.mesh_granted != spec or fleet.stats.mesh_degraded:
        raise AssertionError(f"{label}: mesh {spec} not granted: {fleet.stats.mesh_granted}")
    before = launch_counts()
    axes.reset_copy_counts()
    for _ in range(flushes):
        assert_outputs(outputs(fleet.run_many(requests)), want, f"{label} {spec} {ingest}")
    torch.cuda.synchronize()
    assert_sound(fleet, f"{label} {spec} {ingest}")
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    return fleet, launches, axes.halo_copies, axes.replica_copies


def phase_overlay_mesh(device, main_reqs, channel_requests, chain_reqs, pipe_grid, card):
    """Phase 19, the overlay mesh: (a) a (2, 2) fleet and both front-ends
    on this host, degraded and stamped when it has fewer than four cards,
    bitwise a ``MeshSpec()`` fleet; (b) the 8 x 1080p flush on logical
    meshes of four shards of the card, sync and async, B1 once per shard
    and dispatch (B2 once per app shard on the named-channel flush); (c)
    the depth-3 chain on logical meshes, B1 once per stage and shard,
    bitwise the single-device B3 chain; (d) the ladder of a 2-D plan
    against the reference's, and faults on the row-banded and the
    two-device plans served by the next step; (e) real cards where there
    are two or more; then the single-device and logical-mesh dispatches'
    times (:func:`dispatch_times`)."""
    import torch
    import repro_torch.parallel.axes as axes
    from repro_torch.core import applications as apps
    from repro_torch.core.bitstream import VCGRAConfig
    from repro_torch.core.grid import sobel_grid
    from repro_torch.core.ingest import IngestPlan
    from repro_torch.core.pixie import map_app
    from repro_torch.core.plan import OverlayPlan, compile_plan, fallback_chain
    from repro_torch.parallel import MeshSpec
    from repro_torch.runtime import FaultInjector
    from repro_torch.runtime.fleet import FleetRequest, PixieFleet
    from repro_torch.serve import FleetFrontend, StreamingFrontend

    t_phase = time.perf_counter()
    requests = [FleetRequest(app=a, image=img) for a, img, _ in main_reqs]
    chain_requests = [FleetRequest(pipeline=app, image=img, grid=grid)
                      for app, img, grid in chain_reqs]
    want = outputs(PixieFleet().run_many(requests))
    want_channels = outputs(PixieFleet().run_many(channel_requests()))
    want_chain = outputs(PixieFleet().run_many(chain_requests))
    torch.cuda.empty_cache()

    # (a) the mesh this host grants, stamped.
    spec2d, cards = MeshSpec(app=2, rows=2), torch.cuda.device_count()
    degraded = cards < spec2d.size
    fleet = PixieFleet(mesh=spec2d)
    stamp = {k: getattr(fleet.stats, k) for k in ("mesh_requested", "mesh_granted",
                                                   "mesh_degraded", "devices")}
    if stamp["mesh_requested"] != (2, 2) or stamp["mesh_degraded"] != degraded \
            or stamp["mesh_granted"] != ((1, 1) if degraded else (2, 2)):
        raise AssertionError(f"(2, 2) fleet on {cards} card(s) stamped {stamp}")
    assert_outputs(outputs(fleet.run_many(requests)), want, "(a) PixieFleet")
    svc = FleetFrontend(mesh=spec2d)
    assert_outputs(serve(svc, main_reqs), want, "(a) FleetFrontend")
    with StreamingFrontend(mesh=spec2d) as stream:
        handles = [stream.submit(a, img) for a, img, _ in main_reqs]
        assert_outputs([np.asarray(h.result(timeout=600)) for h in handles], want,
                       "(a) StreamingFrontend")
        stream_stamp = (stream.stats.mesh_granted, stream.stats.mesh_degraded)
    if stream_stamp != (stamp["mesh_granted"], degraded) or svc.stats.mesh_degraded != degraded:
        raise AssertionError(f"front-end stamps {stream_stamp}, {svc.stats.mesh_degraded}")
    for f in (fleet, svc.fleet, stream.fleet):
        assert_sound(f, "(a)")
    del fleet, svc, stream
    torch.cuda.empty_cache()

    # (b) and (c): logical meshes of four shards of the card.
    logical, chains = {}, {}
    reset_launches()
    with logical_mesh(device):
        for spec in MESH_SHAPES:
            for ingest, flushes in (("sync", 2), ("async", 3)):
                fleet, launches, halos, replicas = mesh_fleet_run(
                    spec, ingest, requests, want, flushes, "(b)")
                app, rows = spec
                if launches != no_launches(vcgra_fused_batched=flushes * app * rows) \
                        or halos != flushes * app * 2 * (rows - 1) or replicas:
                    raise AssertionError(f"(b) {spec} {ingest}: launches {launches}, "
                                         f"halo copies {halos}, replicas {replicas}")
                logical[f"{app}x{rows} {ingest}"] = dict(
                    flushes=flushes, launches_b1=launches["vcgra_fused_batched"],
                    halo_copies=halos, replica_copies=replicas,
                    canvas_pool_device_hits=dict(fleet.stats.canvas_pool_device_hits),
                    dispatch_plans=fleet.stats.dispatch_plans)
                del fleet
            fleet, launches, _, _ = mesh_fleet_run(
                spec, "sync", channel_requests(), want_channels, 1, "(b) named channels")
            if launches != no_launches(vcgra_batched=spec[0]):
                raise AssertionError(f"(b) named channels {spec}: launches {launches}")
            logical[f"{spec[0]}x{spec[1]} named channels"] = dict(
                launches_b2=launches["vcgra_batched"], dispatch_plans=fleet.stats.dispatch_plans)
            del fleet
            torch.cuda.empty_cache()
        for spec in MESH_CHAIN_SHAPES:
            fleet, launches, halos, _ = mesh_fleet_run(
                spec, "sync", chain_requests, want_chain, 1, "(c) chain")
            app, rows = spec
            if launches != no_launches(vcgra_fused_batched=len(CHAIN) * app * rows) \
                    or halos != len(CHAIN) * app * 2 * (rows - 1):
                raise AssertionError(f"(c) {spec}: launches {launches}, halo copies {halos}")
            chains[f"{app}x{rows}"] = dict(launches_b1=launches["vcgra_fused_batched"],
                                           halo_copies=halos,
                                           dispatch_plans=fleet.stats.dispatch_plans)
            del fleet
            torch.cuda.empty_cache()
        path_launches = launch_counts()
        if not (path_launches["vcgra_fused_batched"] and path_launches["vcgra_batched"]):
            raise AssertionError(f"(b)-(c) did not run B1 and B2: {path_launches}")

        # (d) the ladder: the reference's steps, then persistent faults on
        # the row-banded plans, and on every two-device plan, served by the
        # next step on the card (the ladder's first step is the torch
        # backend, so the survivors run eagerly and launch nothing).
        plan = OverlayPlan(grid=sobel_grid(), batched=True, fused=True, radius=1,
                           backend="hopper", mesh=spec2d, tile_rows="auto")
        ladder = [step.key() for step in fallback_chain(plan)]
        if ladder != [k.replace("|xla|", "|torch|") for k in REFERENCE_LADDER_2D]:
            raise AssertionError(f"(d) ladder {ladder}")
        routes = {}
        for match, served_by in ((("|rows2|",), ladder[1]), (("|dev2|",), ladder[2])):
            faults = FaultInjector(seed=0).inject("dispatch", transient=False, match=match)
            fleet = PixieFleet(mesh=spec2d, faults=faults)
            before = launch_counts()
            assert_outputs(outputs(fleet.run_many(requests)), want, f"(d) faults on {match}")
            served = [k.rsplit("|", 1)[0] for k in fleet.stats.dispatch_plans]
            if (fleet.stats.fallback_dispatches, served, launch_counts()) != (
                    1, [served_by], before):
                raise AssertionError(f"(d) {match}: {fleet.stats.fallback_dispatches} "
                                     f"fallbacks, served by {served}")
            routes[match[0]] = served[0]
            del fleet
            torch.cuda.empty_cache()

        # Times: one dispatch of the 8 x 1080p canvas on device-resident
        # operands, single device against each logical mesh.
        grid = sobel_grid()
        cfgs = [map_app(apps.ALL_APPS[a](), grid) for a, _, _ in main_reqs]
        stacked = VCGRAConfig.stack(cfgs, device=device)
        ingests = IngestPlan.stack([c.ingest for c in cfgs], grid.dtype, device=device)
        canvas = torch.zeros((len(cfgs), 2048, 2048), dtype=grid.dtype, device=device)
        for i, (_, img, _) in enumerate(main_reqs):
            canvas[i, :img.shape[0], :img.shape[1]] = torch.from_numpy(img).to(device)
        single = OverlayPlan(grid=grid, batched=True, fused=True, radius=1, backend="hopper",
                             tile_rows="auto")
        base_fn = compile_plan(single)
        base = base_fn(stacked, ingests, canvas)
        times = {}
        for spec in ((1, 1),) + MESH_SHAPES:
            fn = compile_plan(OverlayPlan(grid=grid, batched=True, fused=True, radius=1,
                                          backend="hopper", tile_rows="auto",
                                          mesh=MeshSpec(*spec)))
            if (fn.mesh is None) != (spec == (1, 1)) \
                    or not torch.equal(fn(stacked, ingests, canvas), base):
                raise AssertionError(f"times: {spec} dispatch differs from the single device")
            times[f"{spec[0]}x{spec[1]}"] = dispatch_times(
                lambda: fn(stacked, ingests, canvas), profile=spec in ((1, 1), (2, 2)))
        del stacked, ingests, canvas, base
        torch.cuda.empty_cache()

    # (e) real cards.
    if cards >= 2:
        real = {}
        for spec in ((2, 1), (1, 2)):
            for ingest, flushes in (("sync", 1), ("async", 3)):
                fleet, launches, halos, replicas = mesh_fleet_run(
                    spec, ingest, requests, want, flushes, "(e) real cards")
                real[f"{spec[0]}x{spec[1]} {ingest}"] = dict(
                    launches_b1=launches["vcgra_fused_batched"], halo_copies=halos,
                    replica_copies=replicas,
                    canvas_pool_device_hits=dict(fleet.stats.canvas_pool_device_hits))
                del fleet
        multi_card = {"ran": True, "cards": cards, "runs": real}
    else:
        multi_card = {"ran": False, "cards": cards,
                      "why": "one CUDA device visible: a real (2, 1) or (1, 2) mesh needs two "
                             "cards, so only the logical mesh ran"}
    emit({"phase": "overlay_mesh_multi_card", **multi_card})
    emit({"phase": "overlay_mesh", "card": card, "degradation": {
              "fleet": stamp, "streaming": list(stream_stamp)},
          "logical_mesh": logical, "chain": chains, "ladder": ladder, "fault_routes": routes,
          "launches": path_launches,
          "dispatch_times_ms": times,
          "times_note": "one dispatch of n8x2048x2048 int32 on sobel-5x9: CUDA events, "
                        "median of 10 after one warm-up; ms includes the host's enqueue, "
                        "device_ms is shielded by a ~10 ms spin; trace: torch.profiler over "
                        "5 dispatches; a logical mesh runs its shards one after another on "
                        "one card, so these are not multi-card scaling",
          "checked_against": ["a MeshSpec() fleet on the card (B1, B2, B3)"],
          "seconds": time.perf_counter() - t_phase})
    return path_launches


# -- phase 20: the LM mesh ---------------------------------------------------------------

#: (a): the plan-based step against the no-plan step, phase 15 (c)'s setup
#: (gemma-2b at full width and depth, float32 masters, bf16 compute,
#: ``remat="full"``, batch 4 x 1,024, TF32 off) over fresh
#: ``TokenPipeline`` batches; each loss within this relative gap of the
#: no-plan step's (the CPU mesh tests' tolerance, tests/test_torch_lm_mesh.py).
MESH_STEPS, MESH_LOSS_RTOL, MESH_LR = 3, 1e-5, 3e-4
#: (b): deepseek-moe-16b's MoE layer at full width, float32, tokens a
#: batch x sequence; ``moe_ffn_ep``'s per-shard path against ``moe_ffn``
#: within tests/test_torch_lm_zoo.py's float32 tolerance (1e-5 of max(1,
#: max |y|)) and the aux loss within the reference's 1e-6.
MESH_MOE_ARCH, MESH_MOE_TOKENS, MESH_MOE_REL, MESH_MOE_AUX = "deepseek-moe-16b", (2, 512), \
    1e-5, 1e-6


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_steps(step_fn, batch_fn):
    """:data:`MESH_STEPS` timed steps (host clock, synchronized) over the
    batches ``batch_fn(i)``, then a ``torch.profiler`` view of one more:
    (losses, ms, profile)."""
    import torch

    losses, ms = [], []
    for i in range(MESH_STEPS):
        batch = batch_fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step_fn(batch)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    profiled = profile_steps(lambda: step_fn(batch_fn(MESH_STEPS)), steps=1, top=6)
    return losses, ms, profiled


def phase_lm_mesh(device, memo, card):
    """(a) the plan-based train step on a one-card host mesh against the
    no-plan step, (b) ``moe_ffn_ep``'s per-shard path against ``moe_ffn``,
    (c) a sharded save, ``restore(shardings=)`` and ``resume_or_init(
    shardings=)`` of (a)'s state, (d) two cards where there are two.  Starts
    a one-process NCCL group and destroys it at the end."""
    import os
    import shutil
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh, mesh_desc
    from repro_torch.models import LM
    from repro_torch.models.moe import init_moe, moe_ffn, moe_ffn_ep
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import lm_mesh, make_plan
    from repro_torch.runtime import resume_or_init
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    dist.init_process_group("nccl", rank=0, world_size=1)
    root = ROOT / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        mesh = make_host_mesh("cuda")
        cfg = get_arch(TRAIN_ARCH)
        lm = LM(cfg, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
        plan = make_plan(cfg, mesh)
        pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=20)
        ocfg = AdamWConfig(lr=MESH_LR, warmup_steps=0, schedule="constant")
        runs = {}
        for label in ("no_plan", "plan"):
            use = plan if label == "plan" else None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt = init_train_state(lm, use, seed=0, device=device)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            step_fn, _ = make_train_step(lm, use, ocfg)
            state = {"params": params, "opt": opt}

            def one(batch, state=state, step_fn=step_fn):
                state["params"], state["opt"], m = step_fn(state["params"], state["opt"], batch)
                return m["loss"]

            if use is None:
                def batch_fn(i):
                    return torch.as_tensor(pipe.batch_at(i), device=device)
            else:
                def batch_fn(i):
                    return pipe.device_batch_at(i, mesh, plan.token_sharding().placements)
            reset_launches()
            losses, ms, profiled = mesh_steps(one, batch_fn)
            torch.cuda.synchronize()
            launches = launch_counts()
            if launches != no_launches():
                raise AssertionError(f"(a) {label}: training launched {launches}; its attention "
                                     "is plain products")
            step_ms = statistics.median(ms[1:])
            runs[label] = {"losses": losses, "step_runs_ms": ms, "step_ms": step_ms,
                           "init_state_s": init_s,
                           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "kernel_launches_per_step": profiled["kernel_launches_per_step"],
                           "device_ms_per_step": profiled["device_ms_per_step"],
                           "device_busy_share": profiled["device_busy_share"],
                           "device_idle_share": (None if profiled["device_ms_per_step"] is None
                                                 else 1.0 - profiled["device_ms_per_step"]
                                                 / step_ms),
                           "top_kernels_ms_per_step": profiled["top_kernels_ms_per_step"]}
            if use is None:
                del params, opt, state
        gaps = [abs(a - b) / abs(b) for a, b in zip(runs["plan"]["losses"],
                                                     runs["no_plan"]["losses"])]
        if not np.isfinite(runs["plan"]["losses"]).all() or max(gaps) > MESH_LOSS_RTOL:
            raise AssertionError(f"(a): plan losses {runs['plan']['losses']} vs no-plan "
                                 f"{runs['no_plan']['losses']}: gaps {gaps} over {MESH_LOSS_RTOL}")
        placed = state["params"]
        if not all(isinstance(t, DTensor) for t in leaves(placed)):
            raise AssertionError("(a): the plan step's params are not DTensors on the mesh")
        emit({"phase": "lm_mesh_train", "arch": TRAIN_ARCH, "mesh": mesh_desc(mesh),
              "attn_mode": plan.attn_mode, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": MESH_STEPS, "max_rel_gap": max(gaps), "rel_gaps": gaps,
              "bitwise": runs["plan"]["losses"] == runs["no_plan"]["losses"],
              "tolerance_rel": MESH_LOSS_RTOL, **runs,
              "phase15_no_plan_step_ms": memo["step_ms"], "card": card})

        # (c) the plan-placed params (and the step count) saved, restored
        t0 = time.perf_counter()
        tree = {"params": placed, "count": state["opt"]["count"]}
        del state["opt"]
        torch.cuda.empty_cache()
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(tree))
        shardings = {"params": plan.param_shardings(placed),
                     "count": plan.opt_shardings(placed)["count"]}
        like = {"params": lm.abstract_params(),
                "count": torch.empty((), dtype=torch.int32, device="meta")}
        ck = Checkpointer(str(root))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ck.save(1, tree)
        save_s = time.perf_counter() - t1

        def held(restored, label):
            for a, b in zip(leaves(restored), leaves(tree)):
                if not (isinstance(a, DTensor) and a.placements == b.placements
                        and torch.equal(a.to_local(), b.to_local())):
                    raise AssertionError(f"(c) {label}: a leaf differs from the saved one or "
                                         "left its placements")

        t1 = time.perf_counter()
        restored = ck.restore(1, like, shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        held(restored, "restore")
        del restored
        t1 = time.perf_counter()
        run = resume_or_init(ck, lambda: like, shardings=shardings)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t1
        if not (run.resumed and run.step == 1):
            raise AssertionError(f"(c): resume_or_init resumed={run.resumed} at {run.step}")
        held(run.tree, "resume_or_init")
        del run, tree, placed, state
        torch.cuda.empty_cache()
        ckpt = {"phase": "lm_mesh_checkpoint", "arch": TRAIN_ARCH, "leaves": "params and count",
                "checkpoint_bytes": n_bytes, "save_s": save_s, "restore_shardings_s": restore_s,
                "resume_or_init_shardings_s": resume_s, "bitwise": True,
                "placements_kept": True, "seconds": time.perf_counter() - t0}
        emit(ckpt)

        # (b) moe_ffn_ep's per-shard path against moe_ffn, full width
        moe_cfg = get_arch(MESH_MOE_ARCH)
        gen = torch.Generator(device=device).manual_seed(20)
        mp = init_moe(gen, moe_cfg.d_model, moe_cfg.d_ff, moe_cfg.moe, moe_cfg.mlp_type)
        x = torch.randn((*MESH_MOE_TOKENS, moe_cfg.d_model), generator=gen, device=device)
        want, want_aux = moe_ffn(mp, x, moe_cfg.moe, moe_cfg.mlp_type)
        with lm_mesh(mesh):
            got, aux = moe_ffn_ep(mp, x, moe_cfg.moe, moe_cfg.mlp_type)
        got, aux = got.full_tensor(), aux.full_tensor()
        tol = MESH_MOE_REL * max(1.0, float(want.abs().max()))
        moe_err = float((got - want).abs().max())
        aux_err = abs(float(aux) - float(want_aux))
        if moe_err > tol or aux_err > MESH_MOE_AUX:
            raise AssertionError(f"(b): moe_ffn_ep off by {moe_err} (tolerance {tol}), aux by "
                                 f"{aux_err}")
        del mp, x, want, got
        torch.cuda.empty_cache()
        moe = {"arch": MESH_MOE_ARCH, "experts": moe_cfg.moe.num_experts,
               "top_k": moe_cfg.moe.top_k, "tokens": list(MESH_MOE_TOKENS),
               "path": "expert-parallel (E % 1 == 0)", "max_abs_err": moe_err,
               "tolerance": tol, "aux_err": aux_err, "aux_tolerance": MESH_MOE_AUX}
        emit({"phase": "lm_mesh_moe", **moe})

        # (d) two cards
        if torch.cuda.device_count() >= 2:
            r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda",
                                "tests/test_torch_kernels_cuda.py::"
                                "test_plan_step_on_two_cards_equals_one"],
                               cwd=ROOT, capture_output=True, text=True, timeout=600,
                               env={**os.environ, "PYTHONPATH": str(SRC)})
            if r.returncode != 0 or "1 passed" not in r.stdout:
                raise AssertionError(f"(d): the two-card plan step failed:\n{r.stdout[-3000:]}")
            two = {"ran": True, "result": r.stdout.strip().splitlines()[-1]}
        else:
            two = {"ran": False, "why": f"{torch.cuda.device_count()} CUDA device(s): the (1, 2) "
                                        "mesh needs two"}
        emit({"phase": "lm_mesh_two_cards", **two})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()
    out = {"train": runs, "max_rel_gap": max(gaps), "checkpoint": ckpt, "moe": moe,
           "two_cards": two, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "lm_mesh", "seconds": out["seconds"], "card": card})
    return out


# -- phase 21: the dry run, B7's sequence-split entry, serving under a plan ----

#: (a) one rank's share of gemma-2b's ``decode_32k`` cache on the 16 x 16
#: mesh: 128 / 16 = 8 sequences, 32,768 rows in 16 blocks of 2,048 (one a
#: 'model' rank), bf16, H 8, G 1, D 256; lengths that leave blocks with no
#: valid row (0 everywhere for the first sequence).
SPLIT_SHAPE = (8, 8, 1, 256, 32768, 16)
SPLIT_LENGTHS = [0, 1, 2048, 5000, 17000, 30000, 32768, 777]
#: (b) plan serving: phase 12's engine shape, 8 greedy decode steps.
PLAN_SERVE_STEPS = 8
#: (b) no-plan decode steps a turn when B7 is timed through its torch op
#: against its direct launch (turns: direct, op, op, direct).
DISPATCH_STEPS = 10
#: (b) B7 calls a turn when its host time a call is taken the same way.
DISPATCH_CALLS = 100
#: (a) B7's split entry over a column block of v: gemma3-12b's global layers
#: at ``long_500k``'s batch of one on 16 x 16 -- q [1, 16, 256], one
#: 'model' rank's 1,024 of the cache's 16,384 rows (the ninth block), G 8,
#: bf16 -- v's head dim split over the 16 'data' ranks (Dv 16) and over 2
#: (Dv 128), the last block of columns; lengths that fill the rank's rows
#: and that end inside them.
COLUMN_SHAPE = (1, 16, 8, 256, 16384, 16)
COLUMN_BLOCK = 8
COLUMN_DVS = (16, 128)
COLUMN_LENGTHS = (16384, 8192 + 517)
#: (c) the dry-run cells at full width: (arch, shape, mesh); gemma-2b's,
#: then hymba's decode MLP over 'model' and the MoE decode whose batch the
#: 32 data ranks of two pods do not split.
DRYRUN_CELLS = tuple((LM_ARCH, shape, mesh) for shape, mesh in (
    ("train_4k", "single"), ("decode_32k", "single"), ("prefill_32k", "multi"),
    ("train_4k", "multi"))) + (("hymba-1.5b", "decode_32k", "single"),
                               ("deepseek-moe-16b", "decode_32k", "multi"))
#: (b) reduced configs served under the one-card plan besides gemma-2b:
#: hymba's decode MLP rank by rank, deepseek's expert-parallel MoE.
PLAN_SERVE_REDUCED = ("hymba-1.5b", "deepseek-moe-16b")
#: (c) the reduced zoo's cells that torch 2.11's DTensor once refused,
#: through ``tests/test_torch_dryrun.py``'s zoo (its cut shapes).
ZOO_211_CELLS = tuple(f"{arch}/{shape}/{mesh}" for arch, shape in (
    ("hymba-1.5b", "train_4k"), ("xlstm-1.3b", "train_4k"), ("xlstm-1.3b", "prefill_32k"))
    for mesh in ("single", "multi"))
#: (d) the tracker's peak against the card's ``max_memory_allocated``.
TRACKER_PEAK_REL = 0.25


def phase21_split(device):
    """(a) B7's sequence-split entry over the 16 row blocks of one rank's
    ``decode_32k`` cache, merged by the blocks' log-sum-exps, against B7 on
    the whole cache and the plain version; per-block and merge times."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import ops, parity, ref

    B, H, G, D, S, n = SPLIT_SHAPE
    rows = S // n
    rng = np.random.default_rng(21)
    q, k, v = flash_inputs(rng, B, H, G, D, S, torch.bfloat16, torch.bfloat16, device)
    lens = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=device)
    ks = [k[:, i * rows:(i + 1) * rows].contiguous() for i in range(n)]
    vs = [v[:, i * rows:(i + 1) * rows].contiguous() for i in range(n)]

    def block(i):
        return ops.decode_attention_split(q, ks[i], vs[i], lens, i * rows, chunk=512)

    reset_launches()
    parts = [block(i) for i in range(n)]
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != no_launches(flash_decode=n):
        raise AssertionError(f"(a): the split launched {launches}, not B7 {n} times")
    part_err = 0.0
    empty_blocks = 0
    for i, (out, lse) in enumerate(parts):
        want_out, want_lse = ref.decode_partial_ref(q, ks[i], vs[i], lens, i * rows)
        valid = [1 if x > i * rows else 0 for x in SPLIT_LENGTHS]
        part_err = max(part_err, parity.check(out, want_out, valid, f"(a) block {i}")[0])
        empty = torch.isneginf(want_lse)
        if not torch.equal(torch.isneginf(lse), empty):
            raise AssertionError(f"(a) block {i}: -inf lse where the plain partial has none")
        if bool(((lse - want_lse).abs() > 2e-5 * (1 + want_lse.abs()))[~empty].any()):
            raise AssertionError(f"(a) block {i}: lse off the plain partial's")
        empty_blocks += int(0 in valid)
    outs, lses = [p[0] for p in parts], [p[1] for p in parts]
    got = ref.merge_ref(outs, lses, q.dtype)
    whole = flash_attention.decode_attention(q, k, v, lens, chunk=512)
    plain = flash_attention.decode_ref(q, k, v, lens)
    torch.cuda.synchronize()
    err_whole, share_whole = parity.check(got, whole, SPLIT_LENGTHS, "(a) merged vs whole B7")
    err_plain, share_plain = parity.check(got, plain, SPLIT_LENGTHS, "(a) merged vs plain")
    block_ms = [cuda_ms(lambda i=i: block(i), 20, shield=True) for i in range(n)]
    merge_ms = cuda_ms(lambda: ref.merge_ref(outs, lses, q.dtype), 20, shield=True)
    whole_ms = cuda_ms(lambda: flash_attention.decode_attention(q, k, v, lens, chunk=512), 20,
                       shield=True)
    bounds = [flash_bound(B, H, G, D, [min(max(x - i * rows, 0), rows) for x in SPLIT_LENGTHS],
                          2)[0] for i in range(n)]
    whole_bound = flash_bound(B, H, G, D, SPLIT_LENGTHS, 2)[0]
    out = {"phase": "dryrun_split", "shape": f"q [{B}, {H}, {D}], k/v [{B}, {S}, {G}, {D}] "
           f"bf16 in {n} blocks of {rows} rows", "lengths": SPLIT_LENGTHS,
           "launches": launches["flash_decode"], "blocks_with_an_empty_sequence": empty_blocks,
           "block_ms": block_ms, "block_bound_ms": bounds, "merge_ms": merge_ms,
           "split_total_ms": sum(block_ms) + merge_ms, "whole_ms": whole_ms,
           "whole_bound_ms": whole_bound, "max_abs_err_vs_whole": err_whole,
           "max_abs_err_vs_plain": err_plain, "share_of_tolerance": max(share_whole, share_plain),
           "partial_max_abs_err": part_err, "bound_by": "bytes"}
    emit(out)
    del q, k, v, ks, vs, parts, outs, lses, whole, plain
    torch.cuda.empty_cache()
    return out


def phase21_columns(device):
    """(a) B7's split entry over a column block of v at gemma3-12b's batch-one
    shape (:data:`COLUMN_SHAPE`): for each ``Dv`` of :data:`COLUMN_DVS` and
    each length, against the plain partial over the same columns and the
    matching columns of the whole-head-dim split entry (the tensor-core
    body), output and lse; its time, its plain version's, its bound and one
    ``scaled_dot_product_attention`` call's over the same rows and columns
    (``enable_gqa``; the yardstick, never called by the port)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, parity, ref

    B, H, G, D, S, m = COLUMN_SHAPE
    rows = S // m
    r0 = COLUMN_BLOCK * rows
    rng = np.random.default_rng(25)
    q, k, v = flash_inputs(rng, B, H, G, D, rows, torch.bfloat16, torch.bfloat16, device)
    runs, launches = [], 0
    for Dv in COLUMN_DVS:
        c0 = D - Dv
        block = v[..., c0:c0 + Dv]
        err = 0.0
        for n in COLUMN_LENGTHS:
            lens = torch.tensor([n], dtype=torch.int32, device=device)
            whole, whole_lse = ops.decode_attention_split(q, k, v, lens, r0, chunk=512)
            reset_launches()
            out, lse = ops.decode_attention_split(q, k, block, lens, r0, chunk=512)
            torch.cuda.synchronize()
            if launch_counts() != no_launches(flash_decode=1):
                raise AssertionError(f"(a) columns: launched {launch_counts()}, not B7 once")
            launches += 1
            want, want_lse = ref.decode_partial_ref(q, k, block, lens, r0)
            valid = [1 if n > r0 else 0]
            label = f"(a) columns {c0}..{D} at length {n}"
            err = max(err, parity.check(out, want, valid, label + " vs plain")[0],
                      parity.check(out, whole[..., c0:].contiguous(), valid,
                                   label + " vs whole B7's")[0])
            for other in (want_lse, whole_lse):
                if not torch.allclose(lse, other, rtol=2e-5, atol=2e-5):
                    raise AssertionError(f"{label}: lse {lse.tolist()} against {other.tolist()}")
        lens = torch.tensor([COLUMN_LENGTHS[0]], dtype=torch.int32, device=device)
        valid_rows = min(max(COLUMN_LENGTHS[0] - r0, 0), rows)
        ms = cuda_ms(lambda: ops.decode_attention_split(q, k, block, lens, r0, chunk=512), 20,
                     shield=True)
        plain_ms = cuda_ms(lambda: ref.decode_partial_ref(q, k, block, lens, r0), 20,
                           shield=True)
        whole_ms = cuda_ms(lambda: ops.decode_attention_split(q, k, v, lens, r0, chunk=512), 20,
                           shield=True)
        # the library: the rank's rows (all valid at this length) and columns
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), block.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)[:, :, 0, :]

        want, _ = ref.decode_partial_ref(q, k, block, lens, r0)
        library_err = float((library().float() - want.float()).abs().max())
        library_ms = cuda_ms(library, 20, shield=True)
        b_ms, b_by, _ = flash_bound(B, H, G, D, [valid_rows], 2, Dv)
        runs.append({"Dv": Dv, "columns": [c0, D], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "whole_head_dim_ms": whole_ms,
                     "whole_head_dim_bound_ms": flash_bound(B, H, G, D, [valid_rows], 2)[0],
                     "library_ms": library_ms, "library_err": library_err,
                     "max_abs_err": err})
    out = {"phase": "dryrun_columns", "shape": f"q [{B}, {H}, {D}], k [{B}, {rows}, {G}, {D}] "
           f"(rows {r0}..{r0 + rows - 1} of {S}) bf16, v a column block",
           "lengths": list(COLUMN_LENGTHS), "launches": launches, "runs": runs,
           "library_call": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True) "
                           f"at length {COLUMN_LENGTHS[0]} (every row of the block valid)",
           "tolerance": "float32 outputs |d| <= 2e-5 (1 + |ref|); lse 2e-5"}
    emit(out)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def phase21_plan_serving(device, card):
    """(b) gemma-2b at full width served under a plan on the one-card host
    mesh: plan prefill and 8 greedy decode steps against the no-plan path
    from the same bf16 weights and prompts, tokens and logits; decode-step
    times, B7's launches and the card's busy share for both; then the
    no-plan decode step with B7 launched through its torch op's dispatch
    against the direct launch the serving path takes."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import parity
    from repro_torch.launch.mesh import make_host_mesh, mesh_desc
    from repro_torch.models import LM
    from repro_torch.models.lm import make_serve_steps
    from repro_torch.parallel import make_plan
    from repro_torch.parallel.sharding import place_tree

    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        mesh = make_host_mesh("cuda")
        cfg = get_arch(LM_ARCH)
        pre_plan = make_plan(cfg, mesh, kind="prefill")
        dec_plan = make_plan(cfg, mesh, kind="decode")
        lm = LM(cfg, attn_seq_shard=pre_plan.attn_mode == "seq")
        params = lm.init(torch.Generator(device=device).manual_seed(0), cast=True)
        prompts = torch.as_tensor(np.random.default_rng(12).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), device=device)
        plan_prefill, _ = make_serve_steps(lm, pre_plan)
        _, plan_decode = make_serve_steps(lm, dec_plan)
        # placed once (on one card every placement is Replicate(), so the
        # prefill plan's placing finds them in place)
        placed = place_tree(params, dec_plan.param_shardings(params))
        paths = {"no_plan": (params, lambda p, t, n: lm.prefill(p, t, cache_len=n),
                             lm.decode_step),
                 "plan": (placed, plan_prefill, plan_decode)}
        runs = {}
        for label, (params, prefill, decode) in paths.items():
            torch.cuda.synchronize()
            reset_launches()
            with torch.no_grad():
                logits, cache, lengths = prefill(params, prompts, LM_MAX_SEQ)
                torch.cuda.synchronize()
                prefill_launches = launch_counts()
                all_logits, tokens, ms = [logits.full_tensor() if hasattr(logits, "full_tensor")
                                          else logits], [], []
                tok = all_logits[0].argmax(-1)[:, None]
                for _ in range(PLAN_SERVE_STEPS):
                    tokens.append(tok)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, cache, lengths = decode(params, tok, cache, lengths)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    logits = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
                    all_logits.append(logits)
                    tok = logits.argmax(-1)[:, None]
                torch.cuda.synchronize()
                launches = launch_counts()
                want = no_launches(flash_decode=cfg.num_layers * PLAN_SERVE_STEPS)
                if launches != want or prefill_launches != no_launches():
                    raise AssertionError(f"(b) {label}: launches {launches} (prefill "
                                         f"{prefill_launches}), not B7 "
                                         f"{cfg.num_layers} a decode step")
                pos = lengths
                profiled = profile_steps(lambda: decode(params, tok, cache, pos), steps=2, top=6)
            runs[label] = {"logits": all_logits, "tokens": torch.cat(tokens, 1),
                           "decode_step_runs_ms": ms, "decode_step_ms": statistics.median(ms[1:]),
                           "b7_launches": launches["flash_decode"],
                           "device_ms_per_step": profiled["device_ms_per_step"],
                           "device_busy_share": profiled["device_busy_share"],
                           "kernel_launches_per_step": profiled["kernel_launches_per_step"]}
            del cache
        # B7 through its torch op against the direct launch the serving path
        # takes, on the no-plan decode step
        from unittest import mock

        from repro_torch.kernels.flash_attention import ops

        params0, prefill0, decode0 = paths["no_plan"]
        dispatch = {"direct": [], "op": []}
        with torch.no_grad():
            _, cache, lengths = prefill0(params0, prompts, LM_MAX_SEQ)
            tok = prompts[:, -1:]
            for label in ("direct", "op", "op", "direct"):
                route = ops._direct if label == "direct" else (lambda *t: False)
                with mock.patch.object(ops, "_direct", route):
                    for _ in range(DISPATCH_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        decode0(params0, tok, cache, lengths)
                        torch.cuda.synchronize()
                        dispatch[label].append((time.perf_counter() - t0) * 1e3)
            del cache
            # and the host time of one B7 call alone, at the engine's shape
            q = torch.randn(LM_BATCH, cfg.num_heads, cfg.head_dim, device=device,
                            dtype=torch.bfloat16)
            kv = torch.randn(LM_BATCH, LM_MAX_SEQ, cfg.num_kv_heads, cfg.head_dim,
                             device=device, dtype=torch.bfloat16)
            lens = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int32, device=device)
            host_us = {"direct": [], "op": []}
            for label in ("direct", "op", "op", "direct"):
                route = ops._direct if label == "direct" else (lambda *t: False)
                with mock.patch.object(ops, "_direct", route):
                    for _ in range(DISPATCH_CALLS):
                        t0 = time.perf_counter()
                        ops.decode_attention(q, kv, kv, lens)
                        host_us[label].append((time.perf_counter() - t0) * 1e6)
                    torch.cuda.synchronize()
        b7_dispatch = {**{f"{label}_decode_step_ms": statistics.median(ms)
                          for label, ms in dispatch.items()},
                       **{f"{label}_host_us_a_call": statistics.median(us)
                          for label, us in host_us.items()}}
        reduced_runs = {arch: plan_serving_reduced(arch, mesh, device)
                        for arch in PLAN_SERVE_REDUCED}
        same_tokens = torch.equal(runs["plan"]["tokens"], runs["no_plan"]["tokens"])
        if not same_tokens:
            raise AssertionError("(b): the plan path's greedy tokens differ from the no-plan "
                                 "path's")
        err = 0.0
        bitwise = True
        for i, (a, b) in enumerate(zip(runs["plan"]["logits"], runs["no_plan"]["logits"])):
            bitwise &= torch.equal(a, b)
            err = max(err, parity.check(a, b, [1] * LM_BATCH, f"(b) logits {i}")[0])
        out = {"phase": "dryrun_plan_serving", "arch": LM_ARCH, "mesh": mesh_desc(mesh),
               "attn_mode": {"prefill": pre_plan.attn_mode, "decode": dec_plan.attn_mode},
               "batch": LM_BATCH, "prompt": LM_PROMPT, "cache": LM_MAX_SEQ,
               "decode_steps": PLAN_SERVE_STEPS, "same_tokens": same_tokens,
               "logits_bitwise": bitwise, "logits_max_abs_err": err,
               "tolerance": "flash_attention.parity float32 (2e-5 relative and absolute)",
               **{label: {k: v for k, v in r.items() if k not in ("logits", "tokens")}
                  for label, r in runs.items()},
               "b7_dispatch": {**b7_dispatch, "steps": 2 * DISPATCH_STEPS,
                               "calls": 2 * DISPATCH_CALLS, "order": "direct, op, op, direct"},
               "reduced": reduced_runs, "card": card}
        emit(out)
        del params, placed, paths, runs
        torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


def plan_serving_reduced(arch: str, mesh, device) -> dict:
    """(b) reduced ``arch`` served under the one-card plan: plan prefill and
    :data:`PLAN_SERVE_STEPS` decode steps over forced tokens against the
    no-plan path from the same bf16 weights, every logit bit for bit, B7
    once an attention layer a decode step on both."""
    import torch
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import LM
    from repro_torch.models.lm import make_serve_steps
    from repro_torch.parallel import make_plan

    cfg = reduced(ARCHS[arch])
    pre_plan = make_plan(cfg, mesh, kind="prefill")
    dec_plan = make_plan(cfg, mesh, kind="decode")
    lm = LM(cfg, attn_seq_shard=pre_plan.attn_mode == "seq")
    params = lm.init(torch.Generator(device=device).manual_seed(0), cast=True)
    rng = np.random.default_rng(27)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)),
                              device=device)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_BATCH, PLAN_SERVE_STEPS)),
                             device=device)
    plan_prefill, _ = make_serve_steps(lm, pre_plan)
    _, plan_decode = make_serve_steps(lm, dec_plan)
    paths = {"no_plan": (lambda p, t, n: lm.prefill(p, t, cache_len=n), lm.decode_step),
             "plan": (plan_prefill, plan_decode)}
    logits, launches = {}, {}
    with torch.no_grad():
        for label, (prefill, decode) in paths.items():
            out, cache, lengths = prefill(params, prompts, LM_MAX_SEQ)
            torch.cuda.synchronize()
            reset_launches()
            logits[label] = [out]
            for t in range(PLAN_SERVE_STEPS):
                out, cache, lengths = decode(params, forced[:, t:t + 1], cache, lengths)
                logits[label].append(out)
            torch.cuda.synchronize()
            launches[label] = launch_counts()
            logits[label] = [x.full_tensor() if hasattr(x, "full_tensor") else x
                             for x in logits[label]]
            del cache
    want = no_launches(flash_decode=cfg.num_layers * PLAN_SERVE_STEPS)
    for label, got in launches.items():
        if got != want:
            raise AssertionError(f"(b) reduced {arch} {label}: decode launched {got}, not B7 "
                                 f"{cfg.num_layers} a step")
    steps = [torch.equal(a, b) for a, b in zip(logits["plan"], logits["no_plan"])]
    err = max(float((a - b).abs().max()) for a, b in zip(logits["plan"], logits["no_plan"]))
    if not all(steps[1:]):
        raise AssertionError(f"(b) reduced {arch}: the plan's decode logits are not the no-plan "
                             f"path's bit for bit ({err:.3g} off)")
    del params
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "attn_mode": dec_plan.attn_mode,
            "decode_logits_bitwise": all(steps[1:]), "prefill_logits_bitwise": steps[0],
            "max_abs_err": err, "b7_launches": launches["plan"]["flash_decode"]}


def tracker_child(plan: bool) -> None:
    """(d), run in a process of its own: gemma-2b's training step of phase
    15 (c) (batch 4 x 1,024, ``remat="full"``, CE chunks of 512) on
    ``meta`` under the live-bytes tracker, without a plan or, with
    ``plan``, through the plan step on a one-rank world's (1, 1) mesh;
    prints one JSON line."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.roofline.hlo_analysis import analyze_with_memory
    from repro_torch.train import make_train_step

    cfg = get_arch(TRAIN_ARCH)
    lm = LM(cfg, remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    params = lm.abstract_params()
    opt = init_opt_state(params)
    tokens = torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64, device="meta")
    ocfg = AdamWConfig(lr=MEMO_LR, warmup_steps=0, schedule="constant")
    t0 = time.perf_counter()
    if plan:
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel import make_plan
        from repro_torch.parallel.sharding import abstract_placed

        fake_world(1)
        mesh = make_host_mesh("cpu")
        pl = make_plan(cfg, mesh)
        params, opt = (abstract_placed(params, pl.param_shardings(params)),
                       abstract_placed(opt, pl.opt_shardings(lm.abstract_params())))
        tokens = abstract_placed(tokens, pl.token_sharding())
        step, _ = make_train_step(lm, pl, ocfg)
    else:
        step, _ = make_train_step(lm, None, ocfg)
    _, mem, _ = analyze_with_memory(step, params, opt, tokens)
    print(json.dumps({"argument_bytes": mem.argument_bytes, "peak_bytes": mem.peak_bytes,
                      "output_bytes": mem.output_bytes, "alias_bytes": mem.alias_bytes,
                      "peak_by_op": dict(list(mem.peak_by_op.items())[:10]),
                      "seconds": time.perf_counter() - t0}))


def phase21_tracker_card_bytes(device):
    """(d) the bytes the card holds for phase 15 (c)'s params, AdamW moments
    and tokens, each distinct storage once."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.train import init_train_state
    from repro_torch.tree import leaves

    lm = LM(get_arch(TRAIN_ARCH), remat="full", loss_chunk=TRAIN_LOSS_CHUNK)
    params, opt = init_train_state(lm, None, seed=0, device=device)
    tokens = torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64, device=device)
    seen, total = set(), 0
    for t in leaves(params) + leaves(opt) + [tokens]:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    del params, opt, tokens
    torch.cuda.empty_cache()
    return total


def phase_dryrun(device, memo, lm_mesh, card):
    """Phase 21: (a) B7's sequence-split entry on the card, (b) serving
    under a plan on the one-card mesh, (c) dry-run cells of gemma-2b on the
    fake 256- and 512-rank worlds (each in a subprocess: one world a
    process), (d) the live-bytes tracker against the card's
    ``max_memory_allocated`` of phases 15 (c) and 20."""
    import os
    import shutil
    import signal
    import tempfile

    import torch

    t_phase = time.perf_counter()
    split = phase21_split(device)
    columns = phase21_columns(device)
    serving = phase21_plan_serving(device, card)
    card_bytes = phase21_tracker_card_bytes(device)

    # (c) and (d): CPU work in subprocesses, all at once
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    t0 = time.perf_counter()
    procs = {}
    for arch, shape, mesh in DRYRUN_CELLS:
        procs[(arch, shape, mesh)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--out", str(out_dir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label in ("no_plan", "plan"):
        code = f"import chip_smoke; chip_smoke.tracker_child({label == 'plan'})"
        procs[label] = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["zoo"] = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "test_torch_dryrun.py"), "--jobs",
         str(len(ZOO_211_CELLS)), *ZOO_211_CELLS], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    results = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"(c)/(d) {key} exited {p.returncode}:\n"
                                     f"{(stdout or '')[-3000:]}{(stderr or '')[-3000:]}")
            results[key] = stdout
    finally:
        for key, p in procs.items():
            if p.poll() is not None:
                continue
            if key == "zoo":
                os.killpg(p.pid, signal.SIGKILL)    # and its cells' subprocesses
            else:
                p.kill()
    cells = []
    for arch, shape, mesh in DRYRUN_CELLS:
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        if not path.exists():
            raise AssertionError(f"(c) no report for {arch} {shape} {mesh}")
        r = json.loads(path.read_text())
        if "error" in r or r.get("skipped"):
            raise AssertionError(f"(c) {arch} {shape} {mesh}: "
                                 f"{r.get('error') or r.get('reason')}")
        cells.append({k: r[k] for k in (
            "arch", "shape", "mesh", "chips", "attn_mode", "bottleneck", "t_compute_s",
            "t_memory_s", "t_collective_s", "step_time_s", "flops_per_device",
            "xla_cost_analysis_flops", "bytes_per_device", "coll_breakdown", "t_lower_s")}
            | {"peak_gib": r["memory_analysis"]["peak_bytes_per_device"] / 2 ** 30,
               "argument_gib": r["memory_analysis"]["argument_size_in_bytes"] / 2 ** 30,
               "peak_by_op": r["memory_analysis"]["peak_by_op"]})
    shutil.rmtree(out_dir, ignore_errors=True)
    dryrun_s = time.perf_counter() - t0
    peaks = {c["mesh"]: c["peak_gib"] for c in cells
             if c["arch"] == LM_ARCH and c["shape"] == "train_4k"}
    if peaks["multi"] > peaks["single"]:
        raise AssertionError(f"(c) train_4k: {peaks['multi']:.2f} GiB a rank on two pods, more "
                             f"than one pod's {peaks['single']:.2f}")
    zoo = [line for line in results["zoo"].splitlines() if line.split(" ", 1)[0] in ZOO_211_CELLS]
    emit({"phase": "dryrun_cells", "cells": cells, "seconds_all_cells": dryrun_s,
          "train_4k_peak_gib": peaks, "reduced_zoo_cells": zoo,
          "torch": torch.__version__,
          "note": "per rank of a fake 256- or 512-rank world; t_* at the H100's published "
                  "peaks; nothing runs on the card"})

    # (d) the tracker against the card
    tracked = {label: json.loads(results[label].strip().splitlines()[-1])
               for label in ("no_plan", "plan")}
    card_peaks = {"no_plan": memo["peak_gb"] * 1e9,
                  "plan": lm_mesh["train"]["plan"]["peak_gb"] * 1e9}
    for label, t in tracked.items():
        if t["argument_bytes"] != card_bytes:
            raise AssertionError(f"(d) {label}: the tracker's argument bytes "
                                 f"{t['argument_bytes']} are not the card's {card_bytes}")
        rel = t["peak_bytes"] / card_peaks[label] - 1
        t["card_peak_bytes"] = card_peaks[label]
        t["peak_rel_to_card"] = rel
        if abs(rel) > TRACKER_PEAK_REL:
            raise AssertionError(f"(d) {label}: tracked peak {t['peak_bytes'] / 1e9:.2f} GB "
                                 f"against the card's {card_peaks[label] / 1e9:.2f} GB "
                                 f"({rel:+.1%}, limit {TRACKER_PEAK_REL:.0%})")
    extra = {op: tracked["plan"]["peak_by_op"].get(op, 0) - tracked["no_plan"]["peak_by_op"]
             .get(op, 0) for op in set(tracked["plan"]["peak_by_op"])
             | set(tracked["no_plan"]["peak_by_op"])}
    tracker = {"card_argument_bytes": card_bytes, **tracked,
               "plan_minus_no_plan_at_peak_by_op": dict(sorted(
                   extra.items(), key=lambda kv: -abs(kv[1]))[:8])}
    emit({"phase": "dryrun_tracker", **tracker, "limit_rel": TRACKER_PEAK_REL, "card": card})
    out = {"split": split, "columns": columns, "serving": serving, "cells": cells,
           "tracker": tracker, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "dryrun", "seconds": out["seconds"], "card": card})
    return out



def table_times(device) -> dict:
    """B1 to B7 at the kernel table's shapes (``PERF.md`` section 6:
    :func:`b1_case` with the main flush's apps, :func:`b2_case`,
    :func:`b3_case`, :func:`b4_case`; B5 and B6 on :func:`b4_case`'s app and
    frame as :func:`phase_single_times` runs them; B7 at the engine's shape
    of :func:`phase_lm_times`) on random 1080p frames, each the median of
    20 shielded runs by CUDA events, from whichever ``repro_torch`` is
    first on ``sys.path``.  Each output is held to its plain version first."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import applications as apps
    from repro_torch.core.grid import sobel_grid
    from repro_torch.kernels import flash_attention, stencil
    from repro_torch.kernels.flash_attention import parity
    from repro_torch.kernels.vcgra import (
        SpecializedKernel, vcgra_specialized, vcgra_specialized_ref,
    )

    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (1080, 1920)).astype(np.int32) for _ in MAIN_APPS]
    cases = {"vcgra_fused_batched": lambda: b1_case(device, sobel_grid(), MAIN_APPS, imgs),
             "vcgra_batched": lambda: b2_case(device, sobel_grid(),
                                              channel_requests_of(imgs[:len(CHANNEL_APPS)])),
             "vcgra_pipeline_batched": lambda: b3_case(device, shared_grid(CHAIN, "pipe-shared"),
                                                       imgs, rng),
             "vcgra_conventional": lambda: b4_case(device, imgs[0])}
    out = {}
    for name, case in cases.items():
        run, plain, _, _ = case()
        compare(run(), plain(), "int32", name != "vcgra_pipeline_batched")
        out[name] = cuda_ms(run, 20, shield=True)
        del run, plain
        torch.cuda.empty_cache()
    _, _, _, (grid, cfg, _, x) = b4_case(device, imgs[0])
    kernel = SpecializedKernel(grid, cfg, False, device)
    frame, pair = torch.as_tensor(imgs[0], device=device), (apps.SOBEL_X, apps.SOBEL_Y)
    for name, run, plain in (
            ("vcgra_specialized", lambda: vcgra_specialized(kernel, x),
             lambda: vcgra_specialized_ref(grid, cfg, x)),
            ("stencil_fused", lambda: stencil.stencil_fused(frame, pair),
             lambda: stencil.stencil_fused_ref(frame, pair))):
        compare(run(), plain(), "int32")
        out[name] = cuda_ms(run, 20, shield=True)
    lm = get_arch(LM_ARCH)
    n = LM_PROMPT + LM_GEN
    q, k, v = flash_inputs(rng, LM_BATCH, lm.num_heads, lm.num_kv_heads, lm.head_dim,
                           LM_MAX_SEQ, torch.bfloat16, torch.bfloat16, device)
    lens = torch.full((LM_BATCH,), n, dtype=torch.int32, device=device)

    def b7():
        return flash_attention.decode_attention(q, k, v, lens, chunk=512)

    parity.check(b7(), flash_attention.decode_ref(q, k, v, lens), [n] * LM_BATCH,
                 "B7 at the engine shape")
    out["flash_decode"] = cuda_ms(b7, 20, shield=True)
    del kernel, x, frame, q, k, v
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--table-times":
        # python3 chip_smoke.py --table-times [ROOT]: B1-B7 at the table's
        # shapes from the port under ROOT/src (default: this checkout), so
        # that two trees can be timed in turns within one session.
        root = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT
        sys.path.insert(0, str(root / "src"))
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: needs a CUDA device", file=sys.stderr)
            return 2
        import repro_torch

        if Path(repro_torch.__file__).resolve().parents[1] != root / "src":
            raise RuntimeError(f"imported {repro_torch.__file__}, not {root}/src")
        from repro_torch.kernels import build

        build.build_all()
        emit({"table_times": table_times(torch.device("cuda")), "root": str(root),
              "card": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                  capture_output=True, text=True, timeout=60, check=True).stdout.strip()})
        return 0
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = phase_device_and_build()

    from repro_torch.core import applications as apps

    all_grid = shared_grid(sorted(apps.ALL_APPS))
    tally = Tally()
    t0 = time.perf_counter()
    phase_kernels_vs_plain(device, all_grid, tally)
    emit({"phase": "kernels_vs_plain", "kernels": tally.of("vcgra_fused_batched", "vcgra_batched"),
          "tolerance": "bitwise in every dtype, bf16 included",
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    phase_pipeline_vs_plain(device, all_grid, tally)
    emit({"phase": "pipeline_vs_plain", "kernels": tally.of("vcgra_pipeline_batched"),
          "tolerance": "bitwise for int32/int16/float32; bf16 |d| <= 0.5 + 0.5|ref|",
          "seconds": time.perf_counter() - t0})

    pipe_grid = shared_grid(CHAIN, "pipe-shared")
    wide_deep_launches, wide_deep_rows = phase_wide_and_deep(device, pipe_grid, tally)

    svc, main_reqs, channel_requests, main_launches = phase_main_path(device, all_grid)
    chain_reqs, chain_launches = phase_chain_path(svc, pipe_grid)
    synthesis_launches = phase_synthesis_case(svc)
    resilience = phase_resilience_path(svc, main_reqs, chain_reqs, pipe_grid)
    streaming = phase_streaming_path(svc, main_reqs, pipe_grid)
    frame = np.random.default_rng(6).integers(0, 256, (1080, 1920)).astype(np.int32)
    single_launches, pixies, mag_cfg, sec_v_e = phase_single_app_path(device, frame)

    t0 = time.perf_counter()
    compiles = phase_single_vs_plain(device, tally)
    emit({"phase": "single_vs_plain",
          "kernels": tally.of("vcgra_conventional", "vcgra_specialized", "stencil_fused"),
          **compiles, "tolerance": "B4 bitwise in every dtype, bf16 included; B5 and B6 bitwise "
                                   "for int32/int16/float32, bf16 |d| <= 0.5 + 0.5|ref|",
          "seconds": time.perf_counter() - t0})

    rows, e2e = phase_times(device, svc, main_reqs, channel_requests, all_grid)
    rows["vcgra_pipeline_batched"], chain_e2e = phase_chain_times(
        device, svc, chain_reqs, pipe_grid)
    single_rows, four_ms, single_idle = phase_single_times(device, frame, mag_cfg, pixies)
    rows.update(single_rows)
    del pixies
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flash_errs, flash_cases = phase_flash_vs_plain(device)
    errs = {name: tally.max_err(name) for name in tally.rows}
    errs["flash_decode"] = max(e["max_abs_err"] for e in flash_errs.values())
    bf16_errs = {name: row["max_abs_err"]["bfloat16"] for name, row in tally.rows.items()}
    bf16_errs["flash_decode"] = flash_errs["bfloat16 q / bfloat16 cache"]["max_abs_err"]
    emit({"phase": "flash_vs_plain", "cases": flash_cases, "by_dtype": flash_errs,
          "tolerance": "float32 outputs |d| <= 2e-5 (1 + |ref|) (the reference's); bf16 "
                       "outputs |d| <= 2^-7 |ref| + 1e-3 max|ref| (one bf16 unit); exactly 0 "
                       "at length 0; poisoned tail bitwise",
          "seconds": time.perf_counter() - t0})
    lm, engine, prompts, lm_launches = phase_lm_serve_path(device)
    flash_rows, lm_times = phase_lm_times(device, lm, engine, prompts)
    rows["flash_decode"] = flash_rows["engine"]
    del lm, engine
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    zoo = {}
    for run in ZOO:
        zoo[run.arch] = phase_lm_zoo(device, run)
    zoo_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    card_vs_cpu = phase_train_card_vs_cpu(device)
    memo, trained_launches, bf16 = phase_train_gemma(device)
    resume = phase_train_resume(device)
    kinds = phase_train_kinds(device)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    examples = phase_examples()
    examples_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resources = phase_resources(device, card)
    emit({"resources": [
        {"component": r["component"], "paper_lut_reduction_pct": r["paper_lut_reduction_pct"],
         "cpu_total_ops_reduction_pct": r["cpu_census"]["total_ops_reduction_pct"],
         "cpu_flops_reduction_pct": r["cpu_census"]["flops_reduction_pct"],
         "sass": [r["card_census"][m]["sass_instructions"]
                  for m in ("conventional", "parameterized")],
         "registers": [r["card_census"][m]["registers_per_thread"]
                       for m in ("conventional", "parameterized")],
         "input_bytes_per_pixel": [r["card_census"][m]["input_bytes_per_pixel"]
                                   for m in ("conventional", "parameterized")],
         "ms": [r["time"]["conventional_ms"], r["time"]["parameterized_ms"]],
         "bound_ms": r["time"]["bound_ms"], "card_reduction_pct": r["card_census"]["reduction_pct"]}
        for r in resources], "card": card, "seconds": time.perf_counter() - t0,
        "columns": "[conventional (B4), parameterized (B5)]",
        "paper": "Table I LUT reductions (Xilinx FPGA); not a GPU measurement"})
    t0 = time.perf_counter()
    roofline = phase_roofline(lm_times, memo, card)
    roofline_s = time.perf_counter() - t0
    mesh_launches = phase_overlay_mesh(device, main_reqs, channel_requests, chain_reqs,
                                       pipe_grid, card)
    lm_mesh = phase_lm_mesh(device, memo, card)
    dryrun = phase_dryrun(device, memo, lm_mesh, card)

    # Each kernel's launches come from the path it serves, counted from 0.
    launches = {"vcgra_fused_batched": main_launches["vcgra_fused_batched"],
                "vcgra_batched": main_launches["vcgra_batched"],
                "vcgra_pipeline_batched": chain_launches["vcgra_pipeline_batched"],
                **{k: single_launches[k] for k in
                   ("vcgra_conventional", "vcgra_specialized", "stencil_fused")},
                "flash_decode": lm_launches["flash_decode"]}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], r["main_path_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"), "shape": r["shape"],
            "bf16_max_abs_err": bf16_errs[name],
            **{k: r[k] for k in ("cold_ms", "library_cold_ms") if k in r},
        })
        if name in IMAGE_KERNELS and name != "stencil_fused":
            kernels[-1]["launches_wide_and_deep"] = wide_deep_launches[name]
        if name in wide_deep_rows:
            kernels[-1]["wide_and_deep"] = {k: wide_deep_rows[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "shape")}
    b7 = next(k for k in kernels if k["name"] == "flash_decode")
    b7["launches_lm_zoo"] = {arch: z["launches"]["flash_decode"] for arch, z in zoo.items()}
    b7["launches_seq_split"] = dryrun["split"]["launches"]
    b7["launches_plan_serving"] = dryrun["serving"]["plan"]["b7_launches"]
    b7["seq_split_block_ms"] = statistics.median(dryrun["split"]["block_ms"])
    b7["seq_split_block_bound_ms"] = max(dryrun["split"]["block_bound_ms"])
    b7["launches_column_block"] = dryrun["columns"]["launches"]
    b7["column_block"] = {r["Dv"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
                          for r in dryrun["columns"]["runs"]}
    emit({"kernels": kernels, "launches": {"main_path": main_launches,
                                           "wide_and_deep_path": wide_deep_launches,
                                           "chain_path": chain_launches,
                                           "synthesis_case": synthesis_launches,
                                           "resilience_path": {k: r["launches"] for k, r in
                                                               resilience.items()},
                                           "streaming_path": {k: r["launches"] for k, r in
                                                              streaming.items()},
                                           "single_app_path": single_launches,
                                           "lm_path": lm_launches,
                                           "lm_zoo": {arch: z["launches"]
                                                      for arch, z in zoo.items()},
                                           "trained_weights_served": trained_launches,
                                           "overlay_mesh": mesh_launches},
          "card": card, "end_to_end_flush_ms": e2e["median_ms"],
          "chain_flush_ms": chain_e2e["median_ms"],
          "staged_chain_ms": rows["vcgra_pipeline_batched"]["staged_ms"],
          "sobel_four_way_ms": four_ms, "single_frame_idle_share": single_idle,
          "sec_v_e_s": sec_v_e,
          "flash_decode_32k_ms": flash_rows["decode_32k"]["ms"],
          "streaming_flush_ms": {k: [f["median_ms"] for f in r["flushes_8x1080p"]]
                                 for k, r in streaming.items()},
          "lm_decode_step_ms": lm_times["decode_step_ms"],
          "lm_generate_tokens_per_s": lm_times["generate_tokens_per_s"],
          "lm_zoo": {arch: {"decode_step_ms": z["times"]["decode_step_ms"],
                            "generate_tokens_per_s": z["times"]["generate_tokens_per_s"],
                            "flash_decode_ms": z["flash_decode"]["ms"]}
                     for arch, z in zoo.items() if "times" in z},
          "lm_zoo_s": zoo_s,
          "training": {"card_vs_cpu_loss_rel": {a: r["loss_rel"] for a, r in card_vs_cpu.items()},
                       "bf16_vs_f32": {k: bf16[k] for k in ("loss_rel", "grad_norm_ratio",
                                                            "one_minus_cosine")},
                       "gemma_2b_step_ms": memo["step_ms"],
                       "gemma_2b_tokens_per_s": memo["tokens_per_s"],
                       "gemma_2b_peak_gb": memo["peak_gb"],
                       "memorisation_drop": memo["drop"],
                       "resume_max_rel_gap": max(resume["resumed_rel_gaps"]),
                       "planted_count_max_rel_gap": max(resume["planted_count_zero_rel_gaps"]),
                       "checkpoint_save_s": resume["save_s"],
                       "checkpoint_restore_s": resume["restore_s"],
                       "kinds_step_ms": {a: r["step_ms"] for a, r in kinds.items()},
                       "seconds": train_s},
          "examples_s": {name: r["seconds"] for name, r in examples.items()},
          "examples_total_s": examples_s,
          "roofline_measured_over_roofline": {r["shape"]: r["measured_over_roofline"]
                                              for r in roofline},
          "roofline_s": roofline_s,
          "lm_mesh": {"max_rel_gap": lm_mesh["max_rel_gap"],
                      "plan_step_ms": lm_mesh["train"]["plan"]["step_ms"],
                      "no_plan_step_ms": lm_mesh["train"]["no_plan"]["step_ms"],
                      "save_s": lm_mesh["checkpoint"]["save_s"],
                      "restore_shardings_s": lm_mesh["checkpoint"]["restore_shardings_s"],
                      "moe_max_abs_err": lm_mesh["moe"]["max_abs_err"],
                      "two_cards_ran": lm_mesh["two_cards"]["ran"],
                      "seconds": lm_mesh["seconds"]},
          "dryrun": {"split_total_ms": dryrun["split"]["split_total_ms"],
                     "split_whole_ms": dryrun["split"]["whole_ms"],
                     "plan_decode_step_ms": dryrun["serving"]["plan"]["decode_step_ms"],
                     "no_plan_decode_step_ms": dryrun["serving"]["no_plan"]["decode_step_ms"],
                     "plan_logits_bitwise": dryrun["serving"]["logits_bitwise"],
                     "cells": {f"{c['shape']} {c['mesh']}": {"bottleneck": c["bottleneck"],
                                                             "peak_gib": c["peak_gib"]}
                               for c in dryrun["cells"]},
                     "tracker_peak_rel_to_card": {k: dryrun["tracker"][k]["peak_rel_to_card"]
                                                  for k in ("no_plan", "plan")},
                     "seconds": dryrun["seconds"]}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
