"""The port's LM serving engine on the CPU: twins of ``tests/test_serve.py``'s
engine and slot-server tests (token equality inside the port), the
engine's greedy tokens against the reference engine's on the same
parameters, seeded sampling, the CLI, and the device contract.

Against the reference the greedy tokens must agree up to the first step
where the reference's own top-two logit margin is inside the decode
tolerance of ``tests/test_torch_lm.py`` (2% of the largest |logit| plus
2e-3, for B7's float32 softmax weights against the reference's bf16
ones); there the two may pick either token and the sequences part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models import LM as R_LM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServeEngine as RServeEngine

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import LAUNCHES
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, params_from_numpy
from repro_torch.serve import ServeConfig, ServeEngine, SlotServer
from repro_torch.serve.engine import _splice


def _lm(name="gemma-2b"):
    cfg = reduced(ARCHS[name])
    lm = LM(cfg, chunk_q=16)
    params = lm.init(torch.Generator().manual_seed(0))
    return cfg, lm, params


def _engine(lm, params, **kw):
    return ServeEngine(lm, params, ServeConfig(**kw), device="cpu")


def test_engine_greedy_deterministic():
    rng = np.random.default_rng(201)
    cfg, lm, params = _lm()
    eng = _engine(lm, params, max_batch=2, max_seq=64)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    before = LAUNCHES["flash_decode"]
    out1 = eng.generate(prompts, 6)
    out2 = eng.generate(prompts, 6)
    assert LAUNCHES["flash_decode"] == before, "the CPU path launches no kernel"
    np.testing.assert_array_equal(out1, out2)
    assert out1.shape == (2, 6)
    assert (out1 >= 0).all() and (out1 < cfg.vocab_size).all()


def _within_decode_tolerance(logits, a, b):
    """Whether tokens ``a`` and ``b`` are a tie at the decode tolerance:
    their logits within twice 2% of the largest |logit| plus 2e-3."""
    tol = 0.02 * float(np.abs(logits).max()) + 2e-3
    return abs(float(logits[a]) - float(logits[b])) <= 2 * tol


def test_engine_matches_stepwise_prefill():
    """Engine's decode chain (B7's float32 softmax weights) == repeated
    prefill from scratch (bf16 weights, as the reference rounds them),
    greedy, up to a step where prefill's two candidates tie within the
    decode tolerance; there the chains may part."""
    rng = np.random.default_rng(202)
    cfg, lm, params = _lm()
    eng = _engine(lm, params, max_batch=1, max_seq=64)
    for _ in range(3):
        prompts = rng.integers(0, cfg.vocab_size, (1, 8))
        gen = eng.generate(prompts, 4)[0]
        seq = prompts[0].tolist()
        for t in range(4):
            logits, _, _ = lm.prefill(eng.params, torch.tensor([seq]), cache_len=64)
            nxt = int(torch.argmax(logits[0]))
            if nxt != int(gen[t]):
                assert _within_decode_tolerance(logits[0].numpy(), nxt, int(gen[t])), t
                break
            seq.append(nxt)


def test_engine_temperature_sampling_seeded():
    rng = np.random.default_rng(203)
    cfg, lm, params = _lm()
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    outs = [_engine(lm, params, max_batch=2, max_seq=64, temperature=1.0, seed=seed)
            .generate(prompts, 5) for seed in (7, 7, 8)]
    np.testing.assert_array_equal(outs[0], outs[1])  # same seed => same samples
    assert not np.array_equal(outs[0], outs[2])


def test_slot_server_matches_engine():
    rng = np.random.default_rng(204)
    cfg, lm, params = _lm()
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    ref = _engine(lm, params, max_batch=2, max_seq=64).generate(prompts, 4)

    srv = SlotServer(lm, params, ServeConfig(max_batch=2, max_seq=64), device="cpu")
    srv.add_request(0, prompts[0])
    srv.add_request(1, prompts[1])
    for _ in range(3):
        srv.tick()
    np.testing.assert_array_equal(np.asarray(srv.finish(0)), ref[0])
    np.testing.assert_array_equal(np.asarray(srv.finish(1)), ref[1])


def test_slot_server_staggered_requests():
    """Second request arrives mid-decode of the first; both must produce
    the same tokens as isolated generation."""
    rng = np.random.default_rng(205)
    cfg, lm, params = _lm()
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    eng = _engine(lm, params, max_batch=1, max_seq=64)
    ref0 = eng.generate(prompts[0:1], 5)[0]
    ref1 = eng.generate(prompts[1:2], 3)[0]

    srv = SlotServer(lm, params, ServeConfig(max_batch=2, max_seq=64), device="cpu")
    srv.add_request(0, prompts[0])
    srv.tick()
    srv.tick()
    srv.add_request(1, prompts[1])   # joins after 2 ticks
    srv.tick()
    srv.tick()
    out0 = srv.finish(0)             # 1 prefill + 4 ticks = 5 tokens
    out1 = srv.finish(1)             # 1 prefill + 2 ticks = 3 tokens
    np.testing.assert_array_equal(np.asarray(out0), ref0)
    np.testing.assert_array_equal(np.asarray(out1), ref1)
    srv.add_request(0, prompts[0])
    with pytest.raises(ValueError, match="busy"):
        srv.add_request(0, prompts[1])


def test_splice_clamps_like_the_reference():
    full = torch.zeros((2, 3, 4))
    one = torch.ones((2, 1, 4))
    _splice(full, one, 5)             # stacked leaf: batch axis 1, start clamped to 2
    assert full[:, 2].eq(1).all() and full[:, :2].eq(0).all()
    same = torch.zeros((2, 1, 4))
    _splice(same, one, 1)             # equal shapes: the whole leaf
    assert same.eq(1).all()


@pytest.mark.parametrize("name", ["gemma-2b", "starcoder2-7b"])
def test_engine_tokens_follow_the_reference_engine(name):
    rng = np.random.default_rng(206)
    cfg = r_reduced(R_ARCHS[name])
    r_lm = R_LM(cfg, remat="none", chunk_q=16, loss_chunk=16)
    jparams = r_lm.init(jax.random.PRNGKey(0))
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    steps = 6
    want = RServeEngine(r_lm, jparams, RServeConfig(max_batch=2, max_seq=64)).generate(
        jnp.asarray(prompts), steps)
    t_lm = LM(reduced(ARCHS[name]), chunk_q=16)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    got = _engine(t_lm, tparams, max_batch=2, max_seq=64).generate(prompts, steps)
    assert got.shape == want.shape
    for b in range(2):
        for t in range(steps):
            if got[b, t] == want[b, t]:
                continue
            # parted: the reference's two picks must tie at the tolerance
            seq = np.concatenate([prompts[b], want[b, :t]])[None]
            logits = np.asarray(r_lm.prefill(jparams, jnp.asarray(seq), cache_len=64)[0])[0]
            assert _within_decode_tolerance(logits, want[b, t], got[b, t]), (b, t)
            break


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg, lm, params = _lm()
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(lm, params, ServeConfig(max_batch=1, max_seq=16))
    with pytest.raises(RuntimeError, match="cuda"):
        SlotServer(lm, params, ServeConfig(max_batch=1, max_seq=16))
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--arch", "gemma-2b", "--reduced"])


def test_serve_cli_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated [2 x 4] tokens on cpu" in out
