"""Port parity, the window kinds' attention: the ring-buffer decode cache
(``attention_decode_ring``, the ``local``/``hymba`` kinds) and the window
over a full cache (``attention_decode(..., window=)``), against the
reference on the same numpy-made inputs; ``_store_kv``'s ring layout; and
gemma3-12b's 5:1 local:global LM through ``test_torch_lm_zoo``'s
teacher-forced parity.

Tolerances, each with its reason: the cache writes are bitwise (the same
bf16 roundings of the same float32 projections, in place at the same
slots); the attention outputs within 2e-2, ``tests/test_torch_lm.py``'s
decode tolerance, because B7's function keeps the softmax weights in
float32 where the reference rounds them to the cache's bf16 (an error of
up to a bf16 unit of |v| ~ 1 times |wo|); the ring decode against the
windowed prefill within the reference's own 3e-2 (``tests/test_attention.py``:
the ring is bf16, the prefill's k/v float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models import attention as r_attn
from repro.models import blocks as r_blocks

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.flash_attention import LAUNCHES
from repro_torch.models import attention as t_attn
from repro_torch.models import blocks as t_blocks

from test_torch_lm_zoo import teacher_forced_parity

G, HG, HD, D = 2, 2, 16, 64
KW = dict(num_heads=G * HG, num_kv_heads=G, head_dim=HD, rope_theta=10_000.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params():
    p = r_attn.init_attention(jax.random.PRNGKey(3), D, G * HG, G, HD)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _bf16_pair(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(np.asarray(a)).bfloat16()


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (21, 8), (21, 32)])
def test_store_kv_ring_layout_is_the_references(S, W):
    """The last min(W, S) positions at slot pos % W, for a prefill shorter
    than, as long as and longer than the ring (and a ring cut to the
    cache length); the full layout left-aligned."""
    rng = np.random.default_rng(401)
    k = rng.standard_normal((2, S, G, HD)).astype(np.float32)
    for cache_len, window in ((32, W), (W, 64), (32, 0)):
        want = r_blocks._store_kv(jnp.asarray(k), cache_len, window)
        got = t_blocks._store_kv(torch.from_numpy(k), cache_len, window)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        _assert_bitwise(got, want)


def test_ring_decode_matches_windowed_prefill():
    """Twin of the reference's ``test_ring_decode_matches_windowed_train``:
    ring decode of the last token from a ring built as ``block_prefill``
    builds it == windowed attention at the last position."""
    rng = np.random.default_rng(402)
    W, S = 8, 24
    jp, tp = _params()
    x = torch.from_numpy(rng.standard_normal((2, S, D)).astype(np.float32))
    y_full, (k, v) = t_attn.attention_train(tp, x, window=W, chunk_q=S, return_kv=True, **KW)
    ring_k = t_blocks._store_kv(k[:, :S - 1], W, W)
    ring_v = t_blocks._store_kv(v[:, :S - 1], W, W)
    lengths = torch.full((2,), S - 1, dtype=torch.int32)
    y_dec, _ = t_attn.attention_decode_ring(tp, x[:, S - 1:], (ring_k, ring_v), lengths, **KW)
    np.testing.assert_allclose(_np(y_dec[:, 0]), _np(y_full[:, S - 1]), atol=3e-2)


def test_ring_decode_steps_follow_the_reference(monkeypatch):
    """Twelve decode steps over an 8-slot ring from ragged positions (one
    empty, one inside, one wrapping in the first steps, one long past the
    end): every step writes the same slot with the same bits, and the
    outputs agree at the decode tolerance.  B7 reads min(lengths + 1, W)
    rows."""
    rng = np.random.default_rng(403)
    W, B = 8, 4
    jp, tp = _params()
    ring = rng.standard_normal((B, W, G, HD)).astype(np.float32)
    jk, tk = _bf16_pair(ring)
    jv, tv = _bf16_pair(-ring[:, ::-1])
    lengths = np.array([0, 3, 6, 29], np.int32)
    seen = []
    real = t_attn.decode_attention

    def spy(q, k, v, n_rows, chunk=512):
        seen.append(n_rows.tolist())
        return real(q, k, v, n_rows, chunk=chunk)

    monkeypatch.setattr(t_attn, "decode_attention", spy)
    for step in range(12):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        want, (jk, jv) = r_attn.attention_decode_ring(jp, jnp.asarray(x), (jk, jv),
                                                      jnp.asarray(lengths), **KW)
        got, (gk, gv) = t_attn.attention_decode_ring(tp, torch.from_numpy(x), (tk, tv),
                                                     torch.from_numpy(lengths), **KW)
        assert gk is tk and gv is tv, "the ring is written in place"
        _assert_bitwise(gk, jk)
        _assert_bitwise(gv, jv)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2e-2,
                                   err_msg=f"step {step}")
        assert seen[-1] == np.minimum(lengths + 1, W).tolist()
        lengths = lengths + 1


@pytest.mark.parametrize("window", [1, 5, 16, 40])
def test_window_over_the_full_cache_follows_the_reference(window):
    """``attention_decode(..., window=)``: rows max(0, lengths + 1 - window)
    .. lengths gathered for B7, lengths 0, inside, at the end and S (whose
    write clamps to row S - 1, as the reference's dynamic_update_slice
    does); a window wider than the cache reads all of it.  A window of 1
    at lengths = S (a cache already full) leaves no valid row: the
    reference's all-masked softmax then averages every row, B7 gives 0 for
    a sequence with no row, and the port keeps B7's 0 (that row is
    checked to be 0, the others against the reference)."""
    rng = np.random.default_rng(404)
    S, B = 32, 5
    jp, tp = _params()
    k = rng.standard_normal((B, S, G, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, G, HD)).astype(np.float32)
    (jk, tk), (jv, tv) = _bf16_pair(k), _bf16_pair(v)
    lengths = np.array([0, 4, 17, S - 1, S], np.int32)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    want, (wk, wv) = r_attn.attention_decode(jp, jnp.asarray(x), (jk, jv), jnp.asarray(lengths),
                                             window=window, **KW)
    before = LAUNCHES["flash_decode"]
    got, (gk, gv) = t_attn.attention_decode(tp, torch.from_numpy(x), (tk, tv),
                                            torch.from_numpy(lengths), window=window, **KW)
    assert LAUNCHES["flash_decode"] == before, "the CPU path launches no kernel"
    _assert_bitwise(gk, wk)
    _assert_bitwise(gv, wv)
    held = [b for b in range(B) if not (window == 1 and lengths[b] == S)]
    np.testing.assert_allclose(_np(got)[held], _np(want)[held], rtol=0, atol=2e-2)
    if window == 1:
        # no valid row: the output projection of a zero attention output
        assert not _np(got)[-1].any()


@pytest.mark.parametrize("S,window,prefix_len", [(23, 0, 0), (23, 6, 0), (37, 8, 0),
                                                 (23, 6, 5), (29, 0, 4)])
def test_prefill_at_prime_lengths_follows_the_reference(S, window, prefix_len):
    """A prime prompt length: the reference shrinks its query chunk to 1,
    the port runs ragged chunks of ``chunk_q``; the banded window and the
    prefix-LM mask give the same outputs and k/v, float32 within 1e-5."""
    rng = np.random.default_rng(405)
    jp, tp = _params()
    x = rng.standard_normal((2, S, D)).astype(np.float32)
    kw = dict(window=window, prefix_len=prefix_len, chunk_q=8, return_kv=True, **KW)
    want, (wk, wv) = r_attn.attention_train(jp, jnp.asarray(x), **kw)
    got, (gk, gv) = t_attn.attention_train(tp, torch.from_numpy(x), **kw)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["gemma3-12b", "hymba-1.5b"])
def test_ring_cache_shapes_are_the_references(name):
    """``init_block_cache``: min(seq, window) ring slots for the window
    kinds, the full sequence for the others, for a cache shorter and
    longer than the window."""
    cfg, tcfg = r_reduced(R_ARCHS[name]), reduced(ARCHS[name])
    for kind in set(cfg.pattern):
        for seq in (10, 40):
            want = r_blocks.init_block_cache(cfg, kind, 3, seq)
            got = t_blocks.init_block_cache(tcfg, kind, 3, seq)
            assert sorted(got) == sorted(want)
            for leaf in want:
                assert tuple(got[leaf].shape) == want[leaf].shape, (kind, seq, leaf)
                assert str(got[leaf].dtype)[6:] == str(want[leaf].dtype), (kind, seq, leaf)
            assert t_blocks._window_for(tcfg, kind) == r_blocks._window_for(cfg, kind)


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_gemma3_prefill_and_teacher_forced_decode(dtype_name, monkeypatch):
    """gemma3-12b reduced: five local layers over a 16-slot ring and one
    global layer, a 20-token prompt (the rings wrap in prefill and again in
    decode)."""
    teacher_forced_parity("gemma3-12b", dtype_name, monkeypatch)
