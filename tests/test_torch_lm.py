"""Port parity, the LM serving path: the port's layers, attention and ``LM``
(``repro_torch.models``) against the reference's on the same inputs, made
with numpy from a seed.  Parameters made by the reference's ``LM.init`` go
through ``params_from_numpy``; caches are compared like with like.

Tolerances, each with its reason:

- ``embed``: bitwise (a gather and one product in the table's dtype).
- float32 layers (``rmsnorm``, ``mlp``, ``unembed``, attention): within
  1e-5 (the same float32 math, libm and Eigen apart by an ulp, sums in
  another order); ``rope`` within 1e-4 absolute (angles up to 4096 rad,
  whose last bits differ between XLA's fused and PyTorch's rounded ops).
- bf16 layers: ``rmsnorm`` within one bf16 unit of the output's scale,
  ``rope`` four units, ``mlp`` two units (XLA on the CPU may keep a bf16
  chain in float32 where PyTorch rounds after each op, and products sum
  in another order).
- The LM, prefill + 6 teacher-forced decode steps: the port decodes
  through the flash decode function (B7), which keeps the softmax weights
  in float32 where the reference rounds them to the cache's bf16 before
  the weighted sum (``repro/models/attention.py:235``), a relative error
  of up to 2^-9 on every weight, carried through every layer; so the
  logits are held within 2% of the largest |logit| plus 2e-3, and every
  greedy token must agree wherever the reference's top-two margin exceeds
  twice that tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models.lm import LM as R_LM

from repro_torch.configs import ARCHS, get_arch, param_count, reduced
from repro_torch.kernels.flash_attention import LAUNCHES
from repro_torch.models import LM, cache_from_numpy, params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import blocks as t_blocks
from repro_torch.models import layers as t_layers

LM_ARCHS = ["gemma-2b", "glm4-9b", "starcoder2-7b"]
BF16_EPS = 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(a, dtype_name="float32"):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _tree_to_torch(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _assert_close(got, want, dtype_name, rel_units=1.0):
    g, w = _np(got), _np(want)
    if dtype_name == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        tol = rel_units * BF16_EPS * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_configs_are_the_references():
    assert sorted(ARCHS) == sorted(R_ARCHS)
    for name, cfg in ARCHS.items():
        r = R_ARCHS[name]
        assert repr(cfg) == repr(r)
        assert repr(reduced(cfg)) == repr(r_reduced(r))
    assert param_count(get_arch("gemma-2b"))["total"] == pytest.approx(2.506e9, rel=1e-3)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_rmsnorm(dtype_name):
    rng = np.random.default_rng(101)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _both(x, dtype_name)
    want = r_layers.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    got = t_layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert got.dtype == tx.dtype
    _assert_close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_rope(dtype_name):
    rng = np.random.default_rng(102)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9))
    jx, tx = _both(x, dtype_name)
    for theta in (10_000.0, 1_000_000.0):
        want = r_layers.rope(jx, jnp.asarray(pos), theta)
        got = t_layers.rope(tx, torch.from_numpy(pos), theta)
        # angles up to 4096 rad: a last-bit difference in a float32 angle
        # (XLA fuses the exp and products, PyTorch rounds each) moves the
        # rotated values in the fifth decimal.
        tol = 1e-4 if dtype_name == "float32" else BF16_EPS * 4
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mlp(mlp_type, dtype_name):
    rng = np.random.default_rng(103)
    params = r_layers.init_mlp(jax.random.PRNGKey(1), 64, 128, mlp_type)
    tparams = {k: v.to(torch.bfloat16 if dtype_name == "bfloat16" else torch.float32)
               for k, v in _tree_to_torch_leaves(params).items()}
    jparams = {k: v.astype(jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32)
               for k, v in params.items()}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jx, tx = _both(x, dtype_name)
    want = r_layers.mlp(jparams, jx, mlp_type)
    got = t_layers.mlp(tparams, tx, mlp_type)
    _assert_close(got, want, dtype_name, rel_units=2.0)


def _tree_to_torch_leaves(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def test_embed_scale_rounds_to_the_table_dtype():
    """At d = 2048 in bf16 the scale is bf16(sqrt(2048)) = 45.25."""
    rng = np.random.default_rng(104)
    table = (0.02 * rng.standard_normal((300, 2048))).astype(np.float32)
    tokens = rng.integers(0, 300, (2, 5))
    for dtype_name in ("float32", "bfloat16"):
        jt, tt = _both(table, dtype_name)
        want = r_layers.embed({"table": jt}, jnp.asarray(tokens), True, 2048)
        got = t_layers.embed({"table": tt}, torch.from_numpy(tokens), True, 2048)
        assert got.dtype == tt.dtype
        np.testing.assert_array_equal(_np(got), _np(want))
    got = t_layers.embed({"table": tt}, torch.from_numpy(tokens), True, 2048)
    rows = tt[torch.from_numpy(tokens)]
    np.testing.assert_array_equal(_np(got), _np((rows.float() * 45.25).to(torch.bfloat16)))


@pytest.mark.parametrize("tie", [True, False])
def test_unembed_is_float32_from_bf16(tie):
    rng = np.random.default_rng(105)
    p = r_layers.init_embedding(jax.random.PRNGKey(2), 200, 64, tie)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    jp = {k: v.astype(jnp.bfloat16) for k, v in p.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in _tree_to_torch_leaves(p).items()}
    want = r_layers.unembed(jp, jx)
    got = t_layers.unembed(tp, tx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_masks_and_pick_chunk():
    for S, c in ((64, 16), (68, 16), (7, 512), (1, 1)):
        assert t_attn.pick_chunk(S, c) == r_attn.pick_chunk(S, c)
    # The port's one _mask against both of the reference's formulations
    # (its _mask and its scan body's _make_dynamic_mask), on whole and
    # offset query blocks.
    pk = np.arange(12)
    for window, prefix in ((0, 0), (4, 0), (0, 3), (4, 3)):
        for pq in (np.arange(12), np.arange(12) + 4):
            got = t_attn._mask(torch.from_numpy(pq), torch.from_numpy(pk), window, prefix)
            for ref_mask in (r_attn._mask, r_attn._make_dynamic_mask):
                want = np.asarray(ref_mask(jnp.asarray(pq), jnp.asarray(pk), window, prefix))
                np.testing.assert_array_equal(got.numpy(), want)


def _attn_params(G, Hg, hd, d=64):
    p = r_attn.init_attention(jax.random.PRNGKey(3), d, G * Hg, G, hd)
    return p, _tree_to_torch_leaves(p)


@pytest.mark.parametrize("window,prefix_len,chunk_q", [
    (0, 0, 64), (0, 0, 8), (6, 0, 8), (0, 5, 8), (6, 5, 8),
])
def test_attention_train(window, prefix_len, chunk_q):
    rng = np.random.default_rng(106)
    jp, tp = _attn_params(2, 2, 16)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10_000.0,
              window=window, prefix_len=prefix_len, chunk_q=chunk_q, return_kv=True)
    want, (wk, wv) = r_attn.attention_train(jp, jnp.asarray(x), **kw)
    got, (gk, gv) = t_attn.attention_train(tp, torch.from_numpy(x), **kw)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


def test_attention_decode_writes_in_place_and_clamps():
    """Lengths 0, ragged and S: the write at S clamps to row S - 1, as the
    reference's dynamic_update_slice does, and every row is attended."""
    rng = np.random.default_rng(107)
    G, Hg, hd, S, B = 1, 4, 16, 32, 3
    jp, tp = _attn_params(G, Hg, hd)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    k = rng.standard_normal((B, S, G, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, G, hd)).astype(np.float32)
    lengths = np.array([0, 17, S], np.int32)
    jk, tk = _both(k, "bfloat16")
    jv, tv = _both(v, "bfloat16")
    kw = dict(num_heads=G * Hg, num_kv_heads=G, head_dim=hd, rope_theta=10_000.0)
    want, (wk, wv) = r_attn.attention_decode(jp, jnp.asarray(x), (jk, jv),
                                             jnp.asarray(lengths), **kw)
    before = LAUNCHES["flash_decode"]
    got, (gk, gv) = t_attn.attention_decode(tp, torch.from_numpy(x), (tk, tv),
                                            torch.from_numpy(lengths), **kw)
    assert LAUNCHES["flash_decode"] == before
    assert gk is tk and gv is tv, "the cache is written in place"
    np.testing.assert_array_equal(_np(gk), _np(wk))
    np.testing.assert_array_equal(_np(gv), _np(wv))
    # float32 activations over a bf16 cache; the reference rounds the
    # softmax weights to bf16 before the weighted sum, B7 does not: the
    # outputs differ by up to a bf16 unit of |v| (~1) times |wo|.
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-2)
    # a window over the full cache decodes too (tests/test_torch_lm_ring.py
    # holds it against the reference at every window and length)
    got_w, _ = t_attn.attention_decode(tp, torch.from_numpy(x), (tk, tv),
                                       torch.from_numpy(lengths), window=4, **kw)
    want_w, _ = r_attn.attention_decode(jp, jnp.asarray(x), (wk, wv), jnp.asarray(lengths),
                                         window=4, **kw)
    np.testing.assert_allclose(_np(got_w), _np(want_w), rtol=0, atol=2e-2)


def test_unported_kinds_and_modalities_raise():
    """Every kind, prefix pattern, meta-token count and modality stub of
    the zoo is ported: each config constructs and builds its caches; only a
    kind or modality the reference does not have raises."""
    for name, cfg in ARCHS.items():
        lm = LM(reduced(cfg))
        cache = lm.init_cache(1, 8)
        assert len(cache.get("prefix", ())) == len(cfg.prefix_pattern), name
    cfg = reduced(ARCHS["gemma-2b"])
    assert t_blocks.init_block_cache(cfg, "local", 1, 8)["k"].shape[1] == 8
    with pytest.raises(ValueError, match="kind"):
        LM(dataclasses.replace(cfg, pattern=("dense", "conv")))
    with pytest.raises(ValueError, match="kind"):
        t_blocks.init_block_cache(cfg, "conv", 1, 8)
    with pytest.raises(ValueError, match="modality"):
        LM(dataclasses.replace(cfg, modality="video_stub"))


def _lm_pair(name, dtype_name):
    cfg = r_reduced(R_ARCHS[name])
    r_lm = R_LM(cfg, remat="none", chunk_q=8, loss_chunk=16,
                compute_dtype=jnp.bfloat16 if dtype_name == "bfloat16" else None)
    t_lm = LM(reduced(ARCHS[name]), chunk_q=8,
              compute_dtype=torch.bfloat16 if dtype_name == "bfloat16" else None)
    params = r_lm.init(jax.random.PRNGKey(0))
    return cfg, r_lm, t_lm, params, _tree_to_torch(params)


def _logit_tol(want):
    return 0.02 * float(np.abs(want).max()) + 2e-3


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_and_teacher_forced_decode(name, dtype_name):
    rng = np.random.default_rng(108)
    cfg, r_lm, t_lm, jparams, tparams = _lm_pair(name, dtype_name)
    B, P, steps, cache_len = 2, 12, 6, 32
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    forced = rng.integers(0, cfg.vocab_size, (B, steps))

    want, jcache, jlen = jax.jit(r_lm.prefill, static_argnames=("cache_len",))(
        jparams, jnp.asarray(prompt), cache_len=cache_len)
    got, tcache, tlen = t_lm.prefill(tparams, torch.from_numpy(prompt), cache_len=cache_len)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=_logit_tol(_np(want)))
    for key in jcache["blocks"]:
        for leaf in ("k", "v"):
            # bf16 caches: projections of float32 or bf16 activations, one
            # bf16 unit apart at most.
            w = _np(jcache["blocks"][key][leaf])
            np.testing.assert_allclose(_np(tcache["blocks"][key][leaf]), w, rtol=0,
                                       atol=2 * BF16_EPS * max(1.0, float(np.abs(w).max())))

    # teacher-forced: both sides decode the same tokens from the reference's cache
    tcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    r_decode = jax.jit(r_lm.decode_step)
    agree = total = 0
    for t in range(steps):
        tok = forced[:, t:t + 1]
        want, jcache, jlen = r_decode(jparams, jnp.asarray(tok), jcache, jlen)
        got, tcache, tlen = t_lm.decode_step(tparams, torch.from_numpy(tok), tcache, tlen)
        w, g = _np(want), _np(got)
        tol = _logit_tol(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"decode step {t}")
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        same = g.argmax(-1) == w.argmax(-1)
        assert same[clear].all(), f"greedy token differs at step {t} with a clear margin"
        agree += int(same.sum())
        total += same.size
    assert agree >= total - 1


def test_prefill_with_prefix_embeds():
    """Precomputed embeddings lead the prompt; float32 prefill on both
    sides is the same math in another summation order."""
    rng = np.random.default_rng(109)
    cfg, r_lm, t_lm, jparams, tparams = _lm_pair("gemma-2b", "float32")
    prompt = rng.integers(0, cfg.vocab_size, (2, 6))
    pe = (0.02 * rng.standard_normal((2, 3, cfg.d_model))).astype(np.float32)
    want, _, jlen = r_lm.prefill(jparams, jnp.asarray(prompt), cache_len=16,
                                 prefix_embeds=jnp.asarray(pe))
    got, _, tlen = t_lm.prefill(tparams, torch.from_numpy(prompt), cache_len=16,
                                prefix_embeds=torch.from_numpy(pe))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


def test_params_from_numpy_keeps_the_layout():
    cfg, r_lm, t_lm, jparams, tparams = _lm_pair("gemma-2b", "bfloat16")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(tparams))
    mine = t_lm.init(torch.Generator().manual_seed(0))
    assert _shapes(mine) == _shapes(tparams)
    assert tparams["blocks"]["0:dense"]["attn"]["wq"].shape[0] == cfg.n_superblocks
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy({"blocks": {}})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


def test_init_is_seeded_and_truncated():
    t_lm = LM(reduced(ARCHS["glm4-9b"]))
    a = t_lm.init(torch.Generator().manual_seed(3))
    b = t_lm.init(torch.Generator().manual_seed(3))
    wq = a["blocks"]["0:dense"]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"]["0:dense"]["attn"]["wq"])
    std = 64 ** -0.5
    assert float(wq.abs().max()) <= 2 * std + 1e-7
    # a normal truncated at +-2 sigma has std 0.8796 sigma
    assert float(wq.std()) == pytest.approx(0.8796 * std, rel=0.05)
