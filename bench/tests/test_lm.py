"""A served model's run, driven on the CPU at the reduced size (the
harness's look for a card skipped): a sound run is correct, on three
architectures of the zoo built from a configuration dict alone, and
reports its system's metrics; the float8 control is not; and each fault
that a one-card serving cell can have, planted under the timed path, makes
``correct`` false.  A served model's cell, added to ``BENCHMARK.json`` by
new entries alone, takes its system's metrics and none of the image
service's."""

import copy
import json
import time

import numpy as np
import pytest
import torch

from lm_small import LM_END_TO_END, LM_PER_LAYER, run_small, small_cell, small_config, with_cell

from benchlib.runner import result_line, run_cell
from benchlib.spec import load_cell, load_spec, metrics_of

from repro_torch.models import LM
from repro_torch.serve import SlotServer

SEED = 2**31 + 101


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-moe-a2.7b", "glm4-9b"])
def test_sound_run_is_correct(arch):
    line = run_small(small_cell(small_config(arch)), SEED)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"tokens_per_s", "itl_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == {"token_gap_max", "row_err_ratio", "failed_requests",
                                   "rows_checked_min", "tokens_checked_min"}


def test_a_served_models_cell_is_added_by_entries_alone():
    spec = load_spec()
    later = with_cell(spec, "model-chat", "model", "chat")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert later[key][:len(spec[key])] == spec[key]
    end_to_end, per_layer = metrics_of("model-chat", later)
    assert [m["name"] for m in end_to_end] == ["setup_s"] + [m["name"] for m in LM_END_TO_END]
    assert [m["name"] for m in per_layer] == [m["name"] for m in LM_PER_LAYER]
    for cell in spec["workloads"]:
        assert metrics_of(cell["name"], later) == metrics_of(cell["name"], spec)
    # a second cell of the system joins the lists of its end-to-end metrics,
    # and takes every per-layer one with them
    again = copy.deepcopy(later)
    again["workloads"].append(dict(later["workloads"][-1], name="model-long", traffic="long"))
    for metric in again["end_to_end"]:
        if metric.get("workloads") == ["model-chat"]:
            metric["workloads"].append("model-long")
    assert metrics_of("model-long", again) == metrics_of("model-chat", again)


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_float8_control_fails(seed):
    line = run_small(small_cell(small_config("deepseek-moe-16b")), seed,
                     control="float8_e4m3fn")
    assert not line["correct"], line["checks"]


def unchanged_state(real):
    """A decode step that returns its cache unchanged: no new k/v row is
    written."""
    def step(self, params, tokens, cache, lengths):
        scratch = {"prefix": tuple({k: v.clone() for k, v in c.items()} for c in cache["prefix"])
                   if "prefix" in cache else (),
                   "blocks": {key: {k: v.clone() for k, v in c.items()}
                              for key, c in cache["blocks"].items()}}
        logits, _, lengths = real(self, params, tokens, scratch, lengths)
        return logits, cache, lengths
    return step


def half_left_out(real):
    """Half of the batch left out: every other slot's logits zero."""
    def step(self, *args):
        logits, cache, lengths = real(self, *args)
        logits = logits.clone()
        logits[1::2] = 0
        return logits, cache, lengths
    return step


def token_altered(real):
    """A token altered where it is produced: each slot's best logit moved
    to the next token id."""
    def step(self, *args):
        logits, cache, lengths = real(self, *args)
        best = logits.argmax(dim=-1)
        rows = torch.arange(logits.shape[0])
        logits = logits.clone()
        logits[rows, (best + 1) % logits.shape[1]] = logits.max(dim=-1).values + 1.0
        return logits, cache, lengths
    return step


def served_token_altered(real):
    """A served token altered after the step chose it: each active slot's
    newest token moved to the next id (the step's own input unchanged)."""
    def tick(self):
        real(self)
        for slot in np.nonzero(self.active)[0]:
            self.outputs[slot][-1] = (self.outputs[slot][-1] + 1) % self.lm.cfg.vocab_size
    return tick


@pytest.mark.parametrize("fault", [unchanged_state, half_left_out, token_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(LM, "decode_step", fault(LM.decode_step))
    line = run_small(small_cell(small_config("deepseek-moe-16b")), SEED)
    assert not line["correct"], line["checks"]


def test_served_token_fault_is_caught(monkeypatch):
    monkeypatch.setattr(SlotServer, "tick", served_token_altered(SlotServer.tick))
    line = run_small(small_cell(small_config("deepseek-moe-16b")), SEED)
    assert not line["correct"], line["checks"]
    assert line["checks"]["token_gap_max"]["value"] > line["checks"]["token_gap_max"]["limit"]


#: Served models' cells of the benchmark.
LM_CELLS = [w["name"] for w in load_spec()["workloads"]
            if load_cell(w["name"]).config.get("system") == "lm"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 41, 2**31 + 42, 2**31 + 43])
@pytest.mark.parametrize("cell", LM_CELLS)
def test_served_token_fault_on_the_card(card, monkeypatch, cell, seed):
    """The served-token fault at the cell's own size: its readings of
    ``token_gap_max`` are that number's upper ones (``PERF.md``)."""
    monkeypatch.setattr(SlotServer, "tick", served_token_altered(SlotServer.tick))
    cell = load_cell(cell)
    run, checks, counters, info = run_cell(cell, seed, 10.0, False, "cuda", time.perf_counter())
    line = result_line(cell, run, checks, counters, info)
    print(cell.name, seed, json.dumps(line["checks"]))
    assert not line["correct"]
