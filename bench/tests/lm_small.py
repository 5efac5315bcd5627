"""A served model's cell at a size the CPU tests hold: the port's reduced
twin of an architecture of the zoo (``configs.reduced``: d_model 64, 8
experts top-2), 4 slots of a 64-row cache and short requests.  Only the
test names the architecture; the harness builds it from the configuration
dict alone, and the cell's metrics are chosen from ``BENCHMARK.json`` with
the served model's entries added as a later change would add them."""

import copy
import time

from benchlib.lm import ARCH_KEYS
from benchlib.runner import result_line, run_cell
from benchlib.spec import Cell, load_spec, metrics_of

#: The reduced size's traffic: 4 clients, prompts 8-32, outputs 4-16.
SMALL_TRAFFIC = {"loop": "closed", "clients": 4, "prompt_tokens": {"low": 8, "high": 32},
                 "output_tokens": {"low": 4, "high": 16}, "block": 4, "warm_ticks": 2,
                 "ramp_s": 0.2, "check_rows": 8, "check_clients": 2, "check_tokens_min": 16}
#: Limits of the check at the reduced size, from CPU readings (``PERF.md``):
#: sound runs read ``row_err_ratio`` 0.907-1.113 over 12 seeds of the reduced
#: deepseek-moe-16b (0.93-1.06 on qwen2-moe and glm4), the float8 control
#: 9.38-15.36 over 6; ``token_gap_max`` reads at most 0.036 in sound runs, and
#: the served-token fault is that number's to catch (the control's 0.010-0.023
#: is the ratio's).
SMALL_CHECK = {"token_gap_max": 0.1, "row_err_ratio": 3.0}

#: A served model's metrics, as a change that adds its first cell would
#: enter them in ``BENCHMARK.json``: the end-to-end ones list the cell, the
#: per-layer ones carry no list and follow ``tokens_per_s``.
LM_END_TO_END = [
    {"name": "tokens_per_s", "unit": "tokens/s", "better": "higher", "bound": 0.25,
     "source": "host_clock"},
    {"name": "itl_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock"},
]
LM_PER_LAYER = [
    {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
     "moves": "tokens_per_s"}
    for name, unit, better, source, layer in [
        ("step_ms_p50", "ms", "lower", "host_clock", "serving engine: serve/engine.py"),
        ("prefill_share_pct", "%", "lower", "host_clock", "serving engine: serve/engine.py"),
        ("slot_fill_pct", "%", "higher", "host_clock", "serving engine: serve/engine.py"),
        ("mfu_pct", "%", "higher", "host_clock", "model: models/lm.py"),
        ("b7_roofline", "%", "higher", "device_trace", "kernels: kernels/flash_attention"),
        ("device_ms_per_step", "ms", "lower", "device_trace", "device: H100"),
    ]]
#: The readers of a served model's run (``read(run)`` over a ``record.LMRun``).
LM_READERS = sorted(m["name"] for m in LM_END_TO_END + LM_PER_LAYER)


def model_numbers(arch) -> dict:
    """The configuration's ``model`` numbers of a port ``ArchConfig``."""
    return {**{k: get(arch) for k, get in ARCH_KEYS.items()},
            "norm_topk_prob": True, "rms_norm_eps": 1e-6}


def small_config(arch_name: str) -> dict:
    """A served-model configuration on the reduced ``arch_name``, dropless
    (``capacity_factor`` = experts / top-k) where it has experts."""
    from repro_torch.configs import get_arch, reduced

    arch = reduced(get_arch(arch_name))
    overrides = ({"moe": {"capacity_factor": arch.moe.num_experts / arch.moe.top_k}}
                 if arch.moe else {})
    return {"name": f"{arch_name}-small", "system": "lm", "arch": arch_name, "reduce": True,
            "overrides": overrides, "dtype": "bfloat16", "init_std": 0.02,
            "serve": {"max_batch": 4, "max_seq": 64}, "reference": "deepseek_moe",
            "control": "float8_e4m3fn", "check": dict(SMALL_CHECK),
            "model": model_numbers(arch)}


def with_cell(spec: dict, cell: str, config: str, traffic: str) -> dict:
    """``spec`` as a change that adds a served model's first cell leaves it:
    its configuration, its cell and its metrics appended, no entry edited."""
    spec = copy.deepcopy(spec)
    spec["configs"].append({"name": config, "source": "https://arxiv.org/abs/2401.06066",
                            "file": f"bench/configs/{config}.json", "reduced": [],
                            "why": "a served model"})
    spec["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                              "chips": 1, "why": "a served model's cell"})
    spec["end_to_end"] += [dict(m, workloads=[cell]) for m in LM_END_TO_END]
    spec["per_layer"] += copy.deepcopy(LM_PER_LAYER)
    return spec


def small_cell(config: dict, traffic: dict = None) -> Cell:
    name = f"{config['arch']}-small"
    end_to_end, per_layer = metrics_of(name, with_cell(load_spec(), name, config["name"],
                                                       "chat-small"))
    return Cell(name=name, chips=1, config=config, traffic=dict(traffic or SMALL_TRAFFIC),
                end_to_end=end_to_end, per_layer=per_layer)


def run_small(cell: Cell, seed: int, control=None, seconds: float = 1.5) -> dict:
    run, checks, counters, info = run_cell(cell, seed, seconds, False, "cpu",
                                           time.perf_counter(), control=control)
    return result_line(cell, run, checks, counters, info)
