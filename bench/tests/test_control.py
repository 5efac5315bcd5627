"""The lower-precision control, on the card at each cell's own size.

The configuration states int32 grids; the program's own int16 grid (the
nearest narrower type) is the control.  Its answers to 16-bit samples must
fail the check on every seed: run with ``--control int16`` for a short
window, three seeds a cell.  Card only (``-m cuda``)."""

import json
import subprocess
import sys

import pytest

from benchlib.spec import ROOT, load_spec

CELLS = [w["name"] for w in load_spec()["workloads"]]
SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_int16_control_fails(card, cell, seed):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", "2", "--trace", "0", "--control", "int16"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(cell, seed, json.dumps(line["checks"]))
    assert line["correct"] is False
    assert line["checks"]["wrong_pixels"]["value"] > 0
