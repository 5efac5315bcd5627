"""The plain reference (``bench/reference/deepseek_moe.py``) against the
port's ``LM`` in float32 at the reduced size, on the benchmark's own seeded
weights: a prefill, then teacher-forced decode steps through the port's
cache, each step's logits beside the reference's full forward pass over
the same history.  Float32 on both sides: the prefill's row differs only
by the order of sums (held within 1e-5 of the logits' scale); a decode
step reads the port's cache, which holds k and v in bf16 whatever the
compute dtype (``models/blocks.py`` ``_pack_kv``), so its rows are held
within two bf16 units (2 x 2**-8) of that scale."""

import pytest
import torch

from lm_small import small_config

from benchlib import weights as wts
from benchlib.lm import build_arch
from benchlib.spec import load_module

from repro_torch.models import LM

REF = load_module("reference", "deepseek_moe")
PROMPT, STEPS, CACHE = 12, 5, 32


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-moe-a2.7b", "glm4-9b"])
def test_reference_matches_prefill_and_decode(arch):
    config = small_config(arch)
    lm = LM(build_arch(config), compute_dtype=None)
    weights = wts.make(wts.template(lm.abstract_params(), torch.float32), 2**31 + 3, "cpu",
                       float(config["init_std"]))
    gen = torch.Generator().manual_seed(5)
    vocab = config["model"]["vocab_size"]
    prompt = torch.randint(0, vocab, (PROMPT,), generator=gen)
    forced = torch.randint(0, vocab, (STEPS,), generator=gen)
    with torch.no_grad():
        logits, cache, lengths = lm.prefill(weights, prompt[None], cache_len=CACHE)
        got = [logits[0]]
        for t in forced[:-1]:
            logits, cache, lengths = lm.decode_step(weights, t.view(1, 1), cache, lengths)
            got.append(logits[0])
    history = torch.cat([prompt, forced[:-1]])
    (h,), _ = REF.hidden(weights, config["model"], [history],
                         [torch.arange(PROMPT - 1, PROMPT - 1 + STEPS)])
    want = REF.logits(weights, h)
    err = (torch.stack(got) - want).abs().amax(dim=-1)
    scale = max(1.0, float(want.abs().max()))
    assert float(err[0]) <= 1e-5 * scale
    assert float(err[1:].max()) <= 2 * 2.0 ** -8 * scale


def test_reference_ranks_its_experts_and_normalises():
    """The router keeps ``num_experts_per_tok`` experts, its gates summing
    to 1 where ``norm_topk_prob`` says so, and reports each token's margin
    in bf16 spacings of the k-th probability."""
    config = small_config("deepseek-moe-16b")
    model = config["model"]
    lm = LM(build_arch(config), compute_dtype=None)
    weights = wts.make(wts.template(lm.abstract_params(), torch.float32), 7, "cpu", 0.02)
    layer = {k: v[0] for k, v in weights["blocks"]["0:moe"]["moe"].items() if k != "shared"}
    x = torch.randn(5, model["hidden_size"], generator=torch.Generator().manual_seed(1))
    out, margin = REF._moe(layer, x, dict(model, norm_topk_prob=True), torch.float32)
    probs = torch.softmax(x @ layer["router"], dim=-1)
    top, ids = probs.sort(dim=-1, descending=True)
    k = model["num_experts_per_tok"]
    want = torch.zeros_like(x)
    for t in range(5):
        for j in range(k):
            e = ids[t, j]
            y = (torch.nn.functional.silu(x[t] @ layer["w_gate"][e]) * (x[t] @ layer["w_up"][e])
                 ) @ layer["w_down"][e]
            want[t] += top[t, j] / top[t, :k].sum() * y
    assert torch.allclose(out, want, atol=1e-5)
    ulp = 2.0 ** (torch.floor(torch.log2(top[:, k - 1])) - 7)
    assert torch.allclose(margin, (top[:, k - 1] - top[:, k]) / ulp)
