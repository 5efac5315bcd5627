"""Port parity, the whole LM zoo: for every config in ``ARCHS`` at reduced
size (``configs.reduced``: a window of 16), the port's ``LM`` against the
reference's on the same parameters (the reference's ``LM.init`` through
``params_from_numpy``) and the same numpy-made tokens: prefill of a
20-token prompt, so the window kinds' rings wrap in prefill and again in
decode, then 6 teacher-forced decode steps from the reference's cache;
with hymba's meta tokens and paligemma's stub embeddings (prefix-LM mask)
ahead of the prompt.  Then ``ServeEngine`` and ``SlotServer`` serve every
config on the CPU, the served-dtype init equals float32 init then cast
bitwise, and the CLI sizes its cache past the stub and meta positions.

Every decode step starts both sides from the reference's cache, so each
step is held on its own and its cache writes (ring slots, recurrent
states) are compared step by step.

Tolerances, each with its reason:

- Logits within 2% of the largest |logit| plus 2e-3,
  ``tests/test_torch_lm.py``'s: the port decodes through B7's function,
  which keeps the softmax weights in float32 where the reference rounds
  them to bf16 (``repro/models/attention.py:235``, ``:283``).  A float32
  prefill has no such step: there the logits are held within 1e-5 of
  their scale.
- bf16 runs add the reference's own rounding noise on the same input:
  the largest |difference| between the reference's bf16 result and its
  float32 result (same parameters, tokens and cache).  XLA rounds every
  bf16 primitive and PyTorch rounds at other points, so the two packages
  differ by that noise, not by the 2% set for B7; where it is small (the
  attention kinds, ~1% of max |logit|) the allowance is small, and where
  the recurrent gates amplify it (hymba: exp of a sum of 16 bf16
  log-decays, ~4%) the allowance follows.
- Caches after a float32 prefill: bf16 k/v within one bf16 unit of their
  scale (float32 projections apart by an ulp can round to neighbouring
  bf16 values), float32 recurrent states within 1e-4 of their scale (the
  same float32 math through several layers, summed in another order).
  Every other cache (a bf16 prefill, any decode step) within 2% of its
  scale plus two bf16 units, plus in bf16 the reference's own noise on
  that leaf, for the causes above.
- MoE in bf16: router logits are bf16, so where a token's k-th and
  (k+1)-th router logits lie within two bf16 units of each other the two
  packages may route it to different experts, a different function
  whose logits the tolerance does not cover.  Such a decode row is left
  out of that step's comparison (the port's router tells which); the
  rest of the step, and every row of every other config, is held.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models.lm import LM as R_LM

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import LAUNCHES
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM, cache_from_numpy, params_from_numpy
from repro_torch.models import lm as t_lm_mod
from repro_torch.models import moe as t_moe
from repro_torch.serve import ServeConfig, ServeEngine, SlotServer

ZOO = sorted(ARCHS)
BF16_EPS = 2.0 ** -7
PROMPT, STEPS, CACHE_LEN = 20, 6, 40


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _logit_tol(want):
    return 0.02 * float(np.abs(want).max()) + 2e-3


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _stub_embeds(rng, cfg, B):
    if cfg.modality != "vision_stub":
        return None
    return (0.02 * rng.standard_normal((B, cfg.prefix_tokens, cfg.d_model))).astype(np.float32)


def _assert_caches_close(tcache, jcache, tight, rows=None, noise_cache=None):
    """The port's cache against the reference's, leaf by leaf, at the
    tolerances of the module docstring (``tight``: after a float32
    prefill; ``noise_cache``: the reference's float32 twin of ``jcache``,
    whose distance from it is added); ``rows`` limits the comparison to
    those batch rows."""
    got = dict(_flat(tcache))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jcache)))
    twin = {} if noise_cache is None else dict(_flat(noise_cache))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        kv = path.endswith(("/k", "/v"))
        assert g.dtype == (torch.bfloat16 if kv else torch.float32), path
        g, w = _np(g), _np(w)
        t = _np(twin[path]) if path in twin else w
        if rows is not None:
            axis = 0 if path.startswith("/prefix") else 1   # stacked leaves: [n_sb, B, ...]
            g, w, t = (np.take(a, rows, axis=axis) for a in (g, w, t))
        scale = max(1.0, float(np.abs(w).max()))
        if tight:
            tol = (BF16_EPS if kv else 1e-4) * scale
        else:
            tol = (0.02 * float(np.abs(w).max()) + 2 * BF16_EPS * scale
                   + float(np.abs(w - t).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=path)


class _RouterTies:
    """Wraps the port's ``moe.route`` and records, for each call, the rows
    whose k-th and (k+1)-th router logits lie within two bf16 units."""

    def __init__(self, monkeypatch):
        self.rows = set()
        real = t_moe.route

        def route(logits, k):
            top = torch.sort(logits, dim=-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            near = gap <= 2 * BF16_EPS * top[:, k - 1:k + 1].abs().amax(dim=-1)
            self.rows.update(torch.nonzero(near)[:, 0].tolist())
            return real(logits, k)

        monkeypatch.setattr(t_moe, "route", route)


#: Configs whose run of :func:`teacher_forced_parity` lives in the test
#: file of their layer kind, so that no file runs long.
ELSEWHERE = {"gemma3-12b": "test_torch_lm_ring.py",
             "deepseek-moe-16b": "test_torch_moe.py", "qwen2-moe-a2.7b": "test_torch_moe.py",
             "hymba-1.5b": "test_torch_linear_rnn.py"}


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", [n for n in ZOO if n not in ELSEWHERE])
def test_prefill_and_teacher_forced_decode(name, dtype_name, monkeypatch):
    teacher_forced_parity(name, dtype_name, monkeypatch)


def test_every_config_is_held_against_the_reference():
    here = Path(__file__).parent
    for name, where in ELSEWHERE.items():
        assert f'"{name}"' in (here / where).read_text(), (name, where)


def teacher_forced_parity(name, dtype_name, monkeypatch):
    """Prefill and :data:`STEPS` teacher-forced decode steps of the reduced
    ``name`` against the reference's, at the module's tolerances."""
    rng = np.random.default_rng(301)
    cfg = r_reduced(R_ARCHS[name])
    bf16 = dtype_name == "bfloat16"
    r_lm = R_LM(cfg, remat="none", chunk_q=8, loss_chunk=16,
                compute_dtype=jnp.bfloat16 if bf16 else None)
    # the reference in float32 on the same inputs: its own bf16 noise
    r_f32 = R_LM(cfg, remat="none", chunk_q=8, loss_chunk=16, compute_dtype=None)
    t_lm = LM(reduced(ARCHS[name]), chunk_q=8, compute_dtype=torch.bfloat16 if bf16 else None)
    jparams = r_lm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    B = 2
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT))
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS))
    pe = _stub_embeds(rng, cfg, B)
    jpe = None if pe is None else jnp.asarray(pe)

    prefill = jax.jit(r_lm.prefill, static_argnames=("cache_len",))
    want, jcache, jlen = prefill(jparams, jnp.asarray(prompt), cache_len=CACHE_LEN,
                                 prefix_embeds=jpe)
    got, tcache, tlen = t_lm.prefill(tparams, torch.from_numpy(prompt), cache_len=CACHE_LEN,
                                     prefix_embeds=None if pe is None else torch.from_numpy(pe))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert int(tlen[0]) == PROMPT + cfg.prefix_tokens + cfg.meta_tokens
    w = _np(want)
    if bf16:
        want32, cache32, _ = jax.jit(r_f32.prefill, static_argnames=("cache_len",))(
            jparams, jnp.asarray(prompt), cache_len=CACHE_LEN, prefix_embeds=jpe)
        tol = _logit_tol(w) + float(np.abs(w - _np(want32)).max())
        _assert_caches_close(tcache, jcache, tight=False,
                             noise_cache=jax.tree_util.tree_map(np.asarray, cache32))
    else:
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        _assert_caches_close(tcache, jcache, tight=True)
    np.testing.assert_allclose(_np(got), w, rtol=0, atol=tol, err_msg="prefill")

    ties = _RouterTies(monkeypatch) if (cfg.moe is not None and bf16) else None
    r_decode, r_decode32 = jax.jit(r_lm.decode_step), jax.jit(r_f32.decode_step)
    agree = total = 0
    for t in range(STEPS):
        tok = jnp.asarray(forced[:, t:t + 1])
        tcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
        tlen = torch.from_numpy(np.array(jlen))
        if ties is not None:
            ties.rows.clear()
        noise_cache = None
        if bf16:
            want32, noise_cache, _ = r_decode32(jparams, tok, jcache, jlen)
        want, jcache, jlen = r_decode(jparams, tok, jcache, jlen)
        got, tcache, tlen = t_lm.decode_step(tparams, torch.from_numpy(forced[:, t:t + 1]),
                                             tcache, tlen)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        rows = [b for b in range(B) if ties is None or b not in ties.rows]
        if not rows:
            continue
        w, g = _np(want)[rows], _np(got)[rows]
        tol = _logit_tol(w)
        if bf16:
            tol += float(np.abs(w - _np(want32)[rows]).max())
            noise_cache = jax.tree_util.tree_map(np.asarray, noise_cache)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"decode step {t}")
        _assert_caches_close(tcache, jcache, tight=False, rows=rows, noise_cache=noise_cache)
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        same = g.argmax(-1) == w.argmax(-1)
        assert same[clear].all(), f"greedy token differs at step {t} with a clear margin"
        agree += int(same.sum())
        total += same.size
    assert total >= B * STEPS // 2, "most decode rows must be held"
    assert agree >= total - 1


@pytest.mark.parametrize("name", ZOO)
def test_engine_and_slot_server_serve_every_config(name):
    """``ServeEngine.generate`` and a ``SlotServer`` with a request arriving
    mid-decode give the same greedy tokens (one program, one set of
    numbers); no kernel launches on the CPU."""
    rng = np.random.default_rng(302)
    cfg = reduced(ARCHS[name])
    lm = LM(cfg, chunk_q=8)
    params = lm.init(torch.Generator().manual_seed(0))
    prompts = rng.integers(0, cfg.vocab_size, (2, PROMPT))
    pe = _stub_embeds(rng, cfg, 2)
    max_seq = 48 + cfg.prefix_tokens + cfg.meta_tokens
    before = LAUNCHES["flash_decode"]
    eng = ServeEngine(lm, params, ServeConfig(max_batch=2, max_seq=max_seq), device="cpu")
    ref = eng.generate(prompts, 5, prefix_embeds=pe)
    assert ref.shape == (2, 5) and ((ref >= 0) & (ref < cfg.vocab_size)).all()

    srv = SlotServer(lm, params, ServeConfig(max_batch=2, max_seq=max_seq), device="cpu")
    srv.add_request(0, prompts[0], prefix_embeds=None if pe is None else pe[0])
    srv.tick()
    srv.tick()
    srv.add_request(1, prompts[1], prefix_embeds=None if pe is None else pe[1])
    for _ in range(2):
        srv.tick()
    np.testing.assert_array_equal(np.asarray(srv.finish(0)), ref[0])
    np.testing.assert_array_equal(np.asarray(srv.finish(1)), ref[1, :3])
    assert LAUNCHES["flash_decode"] == before, "the CPU path launches no kernel"


@pytest.mark.parametrize("name", ZOO)
def test_init_in_the_served_dtype_is_cast_init(name):
    """``init(cast=True)`` draws what ``init`` draws, in the same order, and
    casts leaf by leaf: bitwise ``cast_params(init())`` from the same seed,
    with no float32 matmul weight left."""
    lm = LM(reduced(ARCHS[name]))
    want = lm.cast_params(lm.init(torch.Generator().manual_seed(5)))
    got = lm.init(torch.Generator().manual_seed(5), cast=True)
    want_leaves, got_leaves = dict(_flat(want)), dict(_flat(got))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path
        assert g.dtype == torch.bfloat16 or g.dim() == 1, path


def test_stacked_writes_each_call_cast():
    """``_stacked`` into a served dtype: float32 leaves cast as written,
    integer leaves kept, and only one call's leaves alive at a time."""
    calls = []

    def make():
        calls.append(len(calls))
        return {"w": torch.full((2, 3), 1.0 + 2.0 ** -10 * len(calls)),
                "i": torch.tensor([len(calls)])}

    out = t_lm_mod._stacked(make, 3, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int64
    assert out["w"].shape == (3, 2, 3)
    want = torch.stack([torch.full((2, 3), 1.0 + 2.0 ** -10 * (i + 1)) for i in range(3)])
    assert torch.equal(out["w"], want.to(torch.bfloat16))
    assert out["i"][:, 0].tolist() == [1, 2, 3]


@pytest.mark.parametrize("name", ["paligemma-3b", "hymba-1.5b"])
def test_serve_cli_sizes_the_cache_past_stub_and_meta(name, capsys):
    assert serve_cli.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                           "--prompt-len", "8", "--gen", "3", "--max-seq", "12"]) == 0
    assert "generated [2 x 3] tokens on cpu" in capsys.readouterr().out
