"""Every file ``BENCHMARK.json`` names is found by its name alone, and the
file itself keeps to the benchmark's format."""

import json
import re

import pytest

from benchlib.spec import BENCH, ROOT, load_cell, load_json, load_module, load_spec

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_loads(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    load_module("reference", data["reference"])
    assert config["reduced"] == []


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_loads(cell):
    loaded = load_cell(cell["name"])
    traffic = load_json("workloads", cell["traffic"])
    assert loaded.traffic == traffic and traffic["loop"] == "closed"
    names = [m["name"] for m in loaded.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and loaded.per_layer
    assert cell["chips"] == 1 and len(cell["why"]) <= 200


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    assert callable(load_module("metrics", metric["name"]).read)
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in SPEC["workloads"]}


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and (ROOT / SPEC["command"][1]).is_file()
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_harness_names_no_cell_config_or_metric():
    """The harness finds cells, configurations and metrics by name: no
    file of ``bench/benchlib`` or ``bench/run.py`` holds one."""
    names = ({w["name"] for w in SPEC["workloads"]} | {c["name"] for c in SPEC["configs"]}
             | {m["name"] for m in METRICS})
    for path in sorted(BENCH.glob("benchlib/*.py")) + [BENCH / "run.py"]:
        text = path.read_text()
        assert not [n for n in names if re.search(rf"\b{re.escape(n)}\b", text)], path
