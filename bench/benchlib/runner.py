"""One run of one cell: set-up, the measured window, the check, the line.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

1. Set-up (timed from process start): the port's serving entry as
   the configuration states it, the frame pool from the seed, a warm-up of
   the cell's own work and sizes (kernel libraries built or loaded,
   executables, pooled buffers), and the clients' ramp.
2. The window: the closed loop runs ``--seconds``; with ``--trace 1`` under
   ``torch.profiler``.
3. After it closes: the clients finish what they sent, the card's memory
   peak is read, the front end is closed and freed, and the configuration's
   plain reference checks the sampled answers.
4. Standard output's last line is one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``, each number compared beside its
   limit; standard error ends with the same numbers.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 2.  It exits 3, with no result, when a JAX module was
loaded in the process.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import threading
import time
from typing import Optional

from benchlib import check as chk
from benchlib import traffic as tr
from benchlib.load import ClosedLoop, warm
from benchlib.record import LADDER, Run, fleet_snapshot
from benchlib.spec import ROOT, Cell, load_cell, load_module
from benchlib.system import build_frontend, build_grid
from benchlib.trace import Profiled

#: Top-level module names that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Answers a client keeps for the check, at seeded moments of the window.
CHECK_PER_CLIENT = 8
#: Seconds the clients may still wait, past the window, for what they sent.
DRAIN_S = 60.0


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--grid-dtype", default=None,
                   help="run the grid in this dtype instead of the configuration's "
                        "(the lower-precision control; its answers should fail the check)")
    return p.parse_args(argv)


def host_cpu() -> list:
    """The host's CPU time counters (``/proc/stat``'s ``cpu`` line: user,
    nice, system, idle, iowait, irq, softirq, steal), or ``[]``."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return []


def cpu_shares(before: list, after: list) -> str:
    """Busy and stolen shares of the host's CPUs between two readings."""
    if len(before) < 8 or len(after) < 8:
        return "not read"
    d = [b - a for a, b in zip(before, after)]
    total = sum(d) or 1
    return (f"busy {100 * (total - d[3] - d[4] - d[7]) / total:.1f}%, "
            f"stolen {100 * d[7] / total:.1f}%")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             started: float, grid_dtype: Optional[str] = None,
             traffic_overrides: Optional[dict] = None):
    """Set up, measure and check one run; returns ``(run, checks, ladder,
    device)``: the records, each number compared beside its limit, the
    ladder's and builds' counts over the window, and the result's device.  ``device`` is ``"cuda"`` for a measurement; the tests
    drive the rest of a run on ``"cpu"``."""
    import torch

    marks = [("torch", time.perf_counter())]
    import repro_torch.serve  # noqa: F401 -- the port's import, timed on its own

    marks.append(("port import", time.perf_counter()))
    traffic = {**cell.traffic, **(traffic_overrides or {})}
    dtype = grid_dtype or cell.config["dtype"]
    grid = build_grid(cell.config, dtype)
    pools = tr.frame_pool(traffic, seed)
    marks.append(("frames", time.perf_counter()))
    mix_keys = sorted({tr.work_key(w) for w in traffic["mix"]})
    svc = build_frontend(cell.config, device)
    on_card = svc.device.type == "cuda"
    marks.append(("front end", time.perf_counter()))
    stop = threading.Event()
    profiled = None
    try:
        answer_dtype = warm(svc, grid, traffic, pools, int(traffic["warm_rounds"]))
        load = ClosedLoop(svc, grid, traffic, seed, seconds, pools, stop, CHECK_PER_CLIENT,
                          answer_dtype)
        if on_card:
            torch.cuda.synchronize()
        marks.append(("warm-up", time.perf_counter()))
        load.start()
        time.sleep(float(traffic["ramp_s"]))
        profiled = Profiled(svc.fleet) if trace else None
        with profiled or contextlib.nullcontext():
            t_start = profiled.open() if profiled else time.perf_counter()
            marks.append(("ramp", t_start))
            load.t_start = t_start
            cpu_start = host_cpu()
            fleet_start = fleet_snapshot(svc.fleet)
            while time.perf_counter() < t_start + seconds:
                time.sleep(min(0.05, max(0.0, t_start + seconds - time.perf_counter())))
            fleet_end = fleet_snapshot(svc.fleet)
            t_end = profiled.close_window() if profiled else time.perf_counter()
            host_window = cpu_shares(cpu_start, host_cpu())
        stop.set()
        load.join(DRAIN_S)
        stuck = len(load.in_flight) if load.is_alive() else 0
        memory_peak = torch.cuda.max_memory_allocated(svc.device) if on_card else 0
        batch_tile = svc.fleet.batch_tile
    finally:
        stop.set()
        svc.close(timeout=DRAIN_S)
    run = Run(
        cell=cell.name, config=cell.config, traffic=traffic, dtype=dtype,
        batch_tile=batch_tile, seconds=seconds, setup_seconds=t_start - started,
        t_start=t_start, t_end=t_end,
        requests=list(load.records),
        fleet_start=fleet_start, fleet_end=fleet_end,
        trace=profiled.reduce() if profiled else None,
        setup_phases={name: t - prev for (name, t), prev in
                      zip(marks, [started] + [t for _, t in marks[:-1]])},
        host_cpu=host_window,
    )
    samples = load.samples
    ladder = {k: run.delta(k) for k in LADDER + ("overlay_builds",)}
    del svc, load, profiled
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    unanswered = stuck + sum(not r.ok for r in run.requests)
    checks = chk.check(cell.config, pools, samples, mix_keys, unanswered,
                       "cuda" if on_card else "cpu", min_checked=int(traffic["clients"]))
    info = {"platform": "gpu" if on_card else device,
            "kind": torch.cuda.get_device_name(0) if on_card else device,
            "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return run, checks, ladder, info


def result_line(cell: Cell, run: Run, checks, ladder, info) -> dict:
    metrics = {}
    for metric in (cell.per_layer if run.trace is not None else cell.end_to_end):
        value = load_module("metrics", metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    errors = len(run.failed())
    # A dispatch served off the hopper plan (a ladder fallback) counts every
    # request it could have held as failed.
    off_plan = min(len(run.completed()), int(ladder["fallback_dispatches"]) * run.batch_tile)
    line = {"correct": chk.passed(checks), "attempted": len(run.completed()) + errors,
            "failed": errors + off_plan, "metrics": metrics, "device": info}
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown
    line["checks"] = checks
    return line


def main(argv, started: float) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: {cell.name} needs {cell.chips} CUDA device(s), "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, checks, ladder, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                         "cuda", started, grid_dtype=args.grid_dtype)
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    line = result_line(cell, run, checks, ladder, info)
    print(f"card: {card_line()}; grid dtype {run.dtype}", file=sys.stderr)
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items()),
          file=sys.stderr)
    print("window: " + " ".join(f"{k}={run.delta(k)}" for k in
                                ("dispatches", "partial_tile_dispatches", "executed")),
          file=sys.stderr)
    done = run.completed()
    per_s = [0] * max(1, int(run.window_s))
    for r in done:
        per_s[min(len(per_s) - 1, int(r.t_done - run.t_start))] += 1
    flush_ms = sorted(r.flush_s * 1e3 for r in done if r.flush_s is not None)
    if flush_ms:
        print(f"host CPUs in the window: {run.host_cpu}", file=sys.stderr)
        print(f"answers a second: {per_s}; flush ms p50 {flush_ms[len(flush_ms) // 2]:.2f} "
              f"max {flush_ms[-1]:.2f}; pack ms a dispatch "
              f"{1e3 * run.delta('pack_s') / max(1, run.delta('dispatches')):.2f}", file=sys.stderr)
    print("ladder and builds: " + " ".join(f"{k}={v}" for k, v in ladder.items()), file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0
