"""A served model's readers on a synthetic run, the yardstick's counts at
deepseek-moe-16b's sizes, and the chat generator's balance across seeds."""

import pytest

from lm_small import LM_END_TO_END, LM_PER_LAYER, model_numbers

from benchlib import traffic as tr
from benchlib.record import LMRun, Prefill, Stream, Tick, Trace
from benchlib.spec import load_module

from repro_torch.configs import get_arch

MODEL = model_numbers(get_arch("deepseek-moe-16b"))
CONFIG = {"system": "lm", "model": MODEL, "serve": {"max_batch": 32, "max_seq": 4096}}
#: Closed-loop chat traffic for the generator's test: 32 clients, prompts
#: 256-2048 and outputs 64-512 tokens, log-uniform in strata of 16.
CHAT = {"loop": "closed", "clients": 32, "prompt_tokens": {"low": 256, "high": 2048},
        "output_tokens": {"low": 64, "high": 512}, "block": 16}
B7 = "flash_decode_tc<__nv_bfloat16, 128, 1, 1>"


def fake_run(trace=None):
    """Window [10, 20]: two requests, three ticks, one prefill of 100
    tokens half inside the window."""
    a = Stream(0, 0, 50, 4, 8.0, token_times=[9.0, 11.0, 12.0, 15.0], tokens=[1, 2, 3, 4],
               t_done=15.0)
    b = Stream(1, 0, 60, 9, 9.5, token_times=[19.5, 21.0], tokens=[5, 6])
    ticks = [Tick(11.0, 11.5, 2, 110), Tick(12.0, 13.0, 2, 112), Tick(19.9, 21.0, 1, 70)]
    prefills = [Prefill(9.5, 10.5, 100), Prefill(19.0, 19.5, 60)]
    return LMRun(cell="c", config=CONFIG, traffic={}, seconds=10.0, setup_seconds=3.0,
                 t_start=10.0, t_end=20.0, streams=[a, b], ticks=ticks, prefills=prefills,
                 trace=trace)


def read(name, run):
    return load_module("metrics", name).read(run)


def test_readers_say_their_system():
    for metric in LM_END_TO_END + LM_PER_LAYER:
        assert load_module("metrics", metric["name"]).SYSTEM == "lm"


def test_host_readers():
    run = fake_run()
    # tokens at 11, 12, 15 (a) and 19.5 (b) inside the window
    assert read("tokens_per_s", run) == pytest.approx(0.4)
    # gaps ending inside: 2.0, 1.0, 3.0
    assert read("itl_p95_ms", run) == pytest.approx(1e3 * 2.9)
    assert read("step_ms_p50", run) == pytest.approx(1e3 * 1.0)
    assert read("prefill_share_pct", run) == pytest.approx(100 * (0.5 + 0.5) / 10)
    assert read("slot_fill_pct", run) == pytest.approx(100 * 5 / (3 * 32))
    assert len(run.completed()) == 1 and not run.failed()
    for name in ("device_ms_per_step", "b7_roofline", "device_idle_pct"):
        assert read(name, run) is None


def test_device_readers():
    device = [(B7, 11.1, 11.2), (B7, 12.1, 12.15), ("flash_decode_combine", 12.2, 12.25),
              (B7, 19.95, 20.0), ("nvjet_gemm", 12.3, 12.9)]
    run = fake_run(Trace(10.0, 20.0, device, 1.0, {}))
    # the image service's idle reader reads any system's trace
    assert read("device_idle_pct", run) == pytest.approx(90.0)
    assert read("device_ms_per_step", run) == pytest.approx(1e3 * 1.0 / 3)
    # the third tick ends past the window: its kernel counts nothing
    b7 = load_module("bounds", "b7")
    least = (b7.tick_bytes(MODEL, 2, 110) + b7.tick_bytes(MODEL, 2, 112)) / 3.35e12
    assert read("b7_roofline", run) == pytest.approx(100 * least / 0.2)
    assert b7.TRACE_NAME.search(B7) and not b7.TRACE_NAME.search("nvjet_gemm")


def test_b7_bytes():
    b7 = load_module("bounds", "b7")
    # 28 layers: q and out of 32 slots x 16 heads x 128, k and v of 40000 rows
    assert b7.tick_bytes(MODEL, 32, 40000) == 28 * 2 * (2 * 32 * 16 * 128 + 2 * 40000 * 16 * 128)


def test_model_flops_against_the_port():
    """The yardstick's active parameters are the port's ``param_count``
    active ones, less the embedding, the unembedding and the norms."""
    from repro_torch.configs import get_arch, param_count

    flops = load_module("bounds", "lm_flops")
    cfg = get_arch("deepseek-moe-16b")
    norms = cfg.num_layers * 2 * cfg.d_model
    want = param_count(cfg)["active"] - 2 * cfg.vocab_size * cfg.d_model - norms
    assert flops.layer_params(MODEL) == want == 2_350_514_176
    per_token = 2 * 2_350_514_176 + 2 * 2048 * 102400
    assert flops.decode_flops(MODEL, 3, 900) == 3 * per_token + 4 * 28 * 16 * 128 * 900
    assert flops.prefill_flops(MODEL, 4) == (4 * 2 * 2_350_514_176 + 2 * 2048 * 102400
                                             + 4 * 28 * 16 * 128 * 10)


def test_mfu_reads_the_window():
    run = fake_run()
    flops = load_module("bounds", "lm_flops")
    work = (flops.decode_flops(MODEL, 2, 110) + flops.decode_flops(MODEL, 2, 112)
            + flops.decode_flops(MODEL, 1, 70) + flops.prefill_flops(MODEL, 60))
    assert read("mfu_pct", run) == pytest.approx(100 * work / (10.0 * 989.4e12))


def test_chat_traffic_is_the_same_work_in_another_order():
    traffic = CHAT
    prompts = tr.strata(traffic["prompt_tokens"], traffic["block"])
    outputs = tr.strata(traffic["output_tokens"], traffic["block"])
    assert prompts == sorted(prompts) and 256 < prompts[0] and prompts[-1] < 2048
    assert 64 < outputs[0] and outputs[-1] < 512
    seen = {}
    for seed in (1, 2**31 + 9):
        first = tr.first_outputs(traffic, seed)
        seen[seed] = sorted(first)
        gen = tr.chat_requests(traffic, seed, 3)
        n = traffic["block"]
        reqs = [next(gen) for _ in range(2 * n)]
        assert reqs[0][1] == first[3]
        assert sorted(p for p, _ in reqs[:n]) == prompts == sorted(p for p, _ in reqs[n:])
        assert sorted(o for _, o in reqs[n:]) == outputs
    assert seen[1] == seen[2**31 + 9] and len(set(seen[1])) == traffic["clients"]
    # a steady server's remaining tokens: a third of the clients within the shortest output
    assert sum(o < outputs[0] for o in seen[1]) == pytest.approx(
        traffic["clients"] * outputs[0] * len(outputs) / sum(outputs), abs=1)
    ids = tr.prompt_ids(2**31 + 9, 3, 0, 1000, 102400)
    assert ids.min() >= 0 and ids.max() < 102400
    assert (ids == tr.prompt_ids(2**31 + 9, 3, 0, 1000, 102400)).all()


def test_window_names():
    from benchlib.trace import name_gaps

    names = name_gaps([(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)], [],
                      [("host in SlotServer.tick", 0.0, 1.5), ("host in add_request", 1.8, 2.9)],
                      "host between ticks")
    assert names == ["host in SlotServer.tick", "host in add_request", "host between ticks"]
