"""A run never measures the CPU: without a card it exits non-zero and
prints no result line, and so does a checkout that holds only
``BENCHMARK.json`` and ``bench/`` (no program to measure)."""

import json
import shutil
import subprocess
import sys

from benchlib.spec import BENCH, ROOT

ARGS = ["--workload", "fleet-1080p", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def run_in(root):
    proc = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, lines[-1] if lines else ""


def is_result(line):
    try:
        return "correct" in json.loads(line)
    except ValueError:
        return False


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return   # on a card the run measures; the bare checkout below still fails
    rc, last = run_in(ROOT)
    assert rc != 0 and not is_result(last)


def test_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, last = run_in(tmp_path)
    assert rc != 0 and not is_result(last)
