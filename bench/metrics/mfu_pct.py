"""The whole step's share of the card's dense bf16 peak (%): the model
operations (``bench/bounds/lm_flops.py``) of every token processed by the
ticks and prefills that started inside the window, over the window's
seconds times the peak (``bench/bounds/h100.json``)."""

from benchlib.spec import load_json, load_module

#: The system whose run this reader reads (``record.LMRun``).
SYSTEM = "lm"


def read(run):
    flops = load_module("bounds", "lm_flops")
    model = run.config["model"]
    work = (sum(flops.decode_flops(model, k.active, k.kv_rows) for k in run.window_ticks())
            + sum(flops.prefill_flops(model, p.tokens) for p in run.window_prefills()))
    if work <= 0:
        return None
    peak = load_json("bounds", "h100")["bf16_dense_flops_per_s"]
    return 100.0 * work / (run.window_s * peak)
