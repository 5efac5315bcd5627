"""One run of one cell: set-up, the measured window, the check, the line.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

The configuration names its system (``"system"``: ``image``, the default,
or ``lm``), a module of this package (``benchlib/<system>.py``) whose
``System`` the run drives in one fixed order:

1. Set-up (timed from process start): the system builds the port's
   serving entry as the configuration states it and its inputs from the
   seed, warms up the cell's own work and sizes (kernel libraries built or
   loaded, pooled buffers), and starts its clients; then the clients' ramp.
2. The window: the load runs ``--seconds``; with ``--trace 1`` under
   ``torch.profiler``.
3. After it closes: the load stops, the card's memory peak is read, the
   system's serving state is freed, and the configuration's plain
   reference checks what the timed path produced.
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
import importlib
import json
import subprocess
import sys
import threading
import time
from types import ModuleType
from typing import Optional

from benchlib import check as chk
from benchlib.spec import ROOT, Cell, load_cell, load_module
from benchlib.trace import Profiled

#: Top-level module names that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Seconds the clients may still wait, past the window, for what they sent.
DRAIN_S = 60.0


def system_of(config: dict) -> ModuleType:
    """The module of the configuration's system, ``benchlib/<system>.py``."""
    return importlib.import_module(f"benchlib.{config.get('system', 'image')}")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="run the lower-precision control, whose answers should fail the "
                        "check: the configuration's ``control`` (image: the grid's dtype, "
                        "int16; lm: the weights rounded through float8_e4m3fn)")
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
             started: float, control: Optional[str] = None,
             traffic_overrides: Optional[dict] = None):
    """Set up, measure and check one run; returns ``(run, checks, counters,
    device)``: the records, each number compared beside its limit, the
    system's counters over the window, and the result's device.
    ``device`` is ``"cuda"`` for a measurement; the tests drive the rest of
    a run on ``"cpu"``."""
    import torch

    marks = [("torch", time.perf_counter())]
    sut = system_of(cell.config).System(cell, seed, seconds, device, marks, control,
                                        traffic_overrides)
    on_card = sut.device.type == "cuda"
    stop = threading.Event()
    profiled = None
    try:
        sut.warm(stop)
        if on_card:
            torch.cuda.synchronize()
        marks.append(("warm-up", time.perf_counter()))
        sut.start()
        time.sleep(float(sut.traffic["ramp_s"]))
        profiled = Profiled(sut.host_spans(), sut.between) if trace else None
        with profiled or contextlib.nullcontext():
            t_start = profiled.open() if profiled else time.perf_counter()
            marks.append(("ramp", t_start))
            sut.open_window(t_start)
            cpu_start = host_cpu()
            while time.perf_counter() < t_start + seconds:
                time.sleep(min(0.05, max(0.0, t_start + seconds - time.perf_counter())))
            sut.close_window()
            t_end = profiled.close_window() if profiled else time.perf_counter()
            host_window = cpu_shares(cpu_start, host_cpu())
        stop.set()
        sut.drain(DRAIN_S)
        memory_peak = torch.cuda.max_memory_allocated(sut.device) if on_card else 0
    finally:
        stop.set()
        sut.close(DRAIN_S)
    run = sut.record(
        cell=cell.name, config=cell.config, traffic=sut.traffic, seconds=seconds,
        setup_seconds=t_start - started, t_start=t_start, t_end=t_end,
        trace=profiled.reduce() if profiled else None,
        setup_phases={name: t - prev for (name, t), prev in
                      zip(marks, [started] + [t for _, t in marks[:-1]])},
        host_cpu=host_window,
    )
    counters = sut.counters
    del profiled
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = sut.check(run)
    print(f"check s: {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    info = {"platform": "gpu" if on_card else device,
            "kind": torch.cuda.get_device_name(0) if on_card else device,
            "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return run, checks, counters, info


def result_line(cell: Cell, run, checks, counters, info) -> dict:
    metrics = {}
    for metric in (cell.per_layer if run.trace is not None else cell.end_to_end):
        value = load_module("metrics", metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    attempted, failed = system_of(run.config).tally(run, counters)
    line = {"correct": chk.passed(checks), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": info}
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
    run, checks, counters, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                           "cuda", started, control=args.control)
    found = forbidden_modules()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 3
    line = result_line(cell, run, checks, counters, info)
    print(f"card: {card_line()}", file=sys.stderr)
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items()),
          file=sys.stderr)
    for text in system_of(run.config).report(run, counters):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0
