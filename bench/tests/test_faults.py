"""The check fails a run whose timed path is broken underneath.

Each test drives the rest of a run on the CPU (the port's kernels then run
their plain versions; the harness's look for a card is skipped) at a small
size, with one fault planted where the answers are produced: B1's and B3's
entry points.  A sound run is correct; each fault makes it not correct."""

import time

import pytest
import torch

from pairs import pair

from benchlib.runner import result_line, run_cell

#: 12 clients keep 96 answers: every app of the mix is among them but for ~1e-5.
SMALL = {"frames": [[40, 56, 1]], "clients": 12, "pool": 24, "ramp_s": 0.1}
#: B1's path and B3's (two segments).
CELLS = [("sobel-5x9", "fleet-1080p"), ("pipe-shared", "chain17-1080p")]


def altered(out, frames):
    """An answer altered where it is produced: one pixel of every slot."""
    out = out.clone()
    out[:, 0, 0] += 1
    return out


def unchanged(out, frames):
    """The step returns its input unchanged."""
    return frames.to(out.dtype).reshape(out.shape)


def half_left_out(out, frames):
    """Half of the batch left out: every other slot answers zeros."""
    out = out.clone()
    out[1::2] = 0
    return out


def plant(monkeypatch, fault):
    from repro_torch.kernels.vcgra import ops

    for name in ("vcgra_fused_batched", "vcgra_pipeline_batched"):
        real = getattr(ops, name)

        def broken(*args, _real=real, **kwargs):
            # Both entry points take the frames as their last positional.
            return fault(_real(*args, **kwargs), args[-1])

        monkeypatch.setattr(ops, name, broken)


def run_small(cell, seed=2**31 + 99):
    cell = pair(*cell)
    run, checks, ladder, info = run_cell(cell, seed, 1.0, False, "cpu", time.perf_counter(),
                                         traffic_overrides=SMALL)
    return result_line(cell, run, checks, ladder, info)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_sound_run_is_correct(cell):
    line = run_small(cell)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
@pytest.mark.parametrize("fault", [altered, unchanged, half_left_out], ids=lambda f: f.__name__)
def test_fault_is_caught(monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    line = run_small(cell)
    assert not line["correct"]
    assert line["checks"]["wrong_pixels"]["value"] > 0
