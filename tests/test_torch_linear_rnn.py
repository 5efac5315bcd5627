"""Port parity, the linear-recurrent mixers: ``repro_torch.models.linear_rnn``
and the mLSTM / sLSTM / hymba blocks against the reference's on the same
numpy-made inputs; the gate activations as the reference rounds them; then
hymba-1.5b (meta tokens) through ``test_torch_lm_zoo``'s teacher-forced
parity.

Tolerances, each with its reason: float32 within 1e-5 (the same float32
math, libm and Eigen apart by an ulp, sums in another order) -- the
chunked form against the step form as well, which the reference's own
suite holds to 1e-4 over longer sequences; the bf16 gate activations
bitwise, as they repeat the reference's operations one rounding at a time;
bf16 outputs within one bf16 unit of their scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.models import blocks as r_blocks
from repro.models import linear_rnn as r_lrnn

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import blocks as t_blocks
from repro_torch.models import layers as t_layers
from repro_torch.models import linear_rnn as t_lrnn

from test_torch_lm_zoo import teacher_forced_parity

B, L, H, DK, DV = 2, 24, 3, 8, 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _gla_inputs(rng, L=L, dtype=np.float32):
    q = rng.standard_normal((B, L, H, DK)).astype(np.float32)
    k = rng.standard_normal((B, L, H, DK)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, L, H, DV)).astype(np.float32)
    log_f = np.log(1.0 / (1.0 + np.exp(-rng.standard_normal((B, L, H)) - 2.0))).astype(np.float32)
    i_gate = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, L, H))))).astype(np.float32)
    return q, k, v, log_f, i_gate


def _both(arrays, dtype="float32"):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(np.asarray(a)).to(tdt) for a in arrays])


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 24, 7])
def test_gla_chunked_matches_the_reference(normalize, chunk):
    """Chunks that divide L, one chunk, and a chunk that does not divide L
    (both shrink it to the largest divisor); with and without a carried
    initial state."""
    rng = np.random.default_rng(601)
    jx, tx = _both(_gla_inputs(rng))
    for state in (None, (rng.standard_normal((B, H, DK, DV)).astype(np.float32),
                         np.abs(rng.standard_normal((B, H, DK))).astype(np.float32))):
        js = None if state is None else tuple(jnp.asarray(s) for s in state)
        ts = None if state is None else tuple(torch.from_numpy(s) for s in state)
        want, (wS, wn) = r_lrnn.gla_chunked(*jx, state=js, normalize=normalize, chunk=chunk)
        got, (gS, gn) = t_lrnn.gla_chunked(*tx, state=ts, normalize=normalize, chunk=chunk)
        assert gS.dtype == torch.float32 and gn.dtype == torch.float32
        _close(got, want)
        _close(gS, wS)
        _close(gn, wn)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_step_matches_the_reference_and_continues_chunked(normalize):
    """``gla_step`` against the reference's, and against the chunked form:
    the chunked prefix then steps equals chunked over the whole."""
    rng = np.random.default_rng(602)
    arrays = _gla_inputs(rng)
    jx, tx = _both(arrays)
    full, (S_full, n_full) = t_lrnn.gla_chunked(*tx, normalize=normalize, chunk=8)
    _, state = t_lrnn.gla_chunked(*(t[:, :16] for t in tx), normalize=normalize, chunk=8)
    jstate = tuple(jnp.asarray(s.numpy()) for s in state)
    for t in range(16, L):
        want, jstate = r_lrnn.gla_step(*(a[:, t] for a in jx), jstate, normalize=normalize)
        got, state = t_lrnn.gla_step(*(a[:, t] for a in tx), state, normalize=normalize)
        _close(got, want)
        _close(state[0], jstate[0])
        _close(got, full[:, t])
    _close(state[0], S_full)
    _close(state[1], n_full)


def test_gla_chunked_sums_bf16_decays_in_float32():
    """bf16 q/k/v and gates, chunks of 16 and 256 with deep decays (|P| up
    to ~15 and ~240): the port sums the log-decays in float32, so its
    output is the reference's given the same gate values in float32 (the
    reference rounds every partial sum of a bf16 input; that choice the
    port does not keep, see ``linear_rnn``'s docstring), and its chunked
    prefill agrees with its own step-by-step decode."""
    rng = np.random.default_rng(603)
    arrays = list(_gla_inputs(rng, L=256))
    arrays[3] = arrays[3] * 3.0
    jx, tx = _both(arrays, "bfloat16")
    jx32 = jx[:3] + [a.astype(jnp.float32) for a in jx[3:]]
    for chunk in (16, 256):
        want, (wS, _) = r_lrnn.gla_chunked(*jx32, normalize=True, chunk=chunk)
        got, (gS, _) = t_lrnn.gla_chunked(*tx, normalize=True, chunk=chunk)
        assert got.dtype == torch.bfloat16
        # bf16 outputs: one rounding of nearly equal float32 values
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=2.0 ** -7 * max(1.0, float(np.abs(_np(want)).max())))
        _close(gS, wS)
    # the step rounds each decay exp(log_f) to bf16 (2^-9), as the
    # reference's step does, and the recent ones dominate the state: 1e-2
    state = (torch.zeros((B, H, DK, DV)), torch.zeros((B, H, DK)))
    for t in range(256):
        y, state = t_lrnn.gla_step(*(a[:, t] for a in tx), state, normalize=True)
    _close(state[0], gS, 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_activations_round_as_the_reference(dtype):
    x = np.linspace(-12, 12, 4001).astype(np.float32)
    (jx,), (tx,) = _both([x], dtype)
    for mine, theirs in ((t_layers.sigmoid, jax.nn.sigmoid),
                         (t_layers.softplus, jax.nn.softplus),
                         (t_layers.log_sigmoid, jax.nn.log_sigmoid)):
        got, want = mine(tx), theirs(jx)
        assert got.dtype == tx.dtype
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=mine.__name__)
        else:
            _close(got, want, 1e-6)


def test_causal_conv_and_its_step_match_the_reference():
    rng = np.random.default_rng(604)
    x = rng.standard_normal((B, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    (jx, jw), (tx, tw) = _both([x, w])
    _close(t_lrnn.causal_conv1d(tx, tw), r_lrnn.causal_conv1d(jx, jw))
    # the step continues the sequence from a buffer of the last K - 1 inputs
    full = t_lrnn.causal_conv1d(tx, tw)
    jbuf, tbuf = jnp.zeros((B, 3, 5)), torch.zeros((B, 3, 5))
    for t in range(9):
        want, jbuf = r_lrnn.causal_conv1d_step(jx[:, t], jw, jbuf)
        got, tbuf = t_lrnn.causal_conv1d_step(tx[:, t], tw, tbuf)
        _close(got, want)
        _close(tbuf, jbuf)
        _close(got, full[:, t])


def test_slstm_scan_and_step_match_the_reference():
    """``slstm_scan`` against the reference's, and ``slstm_step`` token by
    token against the scan (states float32 throughout)."""
    rng = np.random.default_rng(605)
    Dm, heads = 16, 4
    jp = r_lrnn.init_slstm(jax.random.PRNGKey(4), Dm, heads)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rng.standard_normal((B, 11, Dm)).astype(np.float32)
    (jx,), (tx,) = _both([x])
    want, (wc, wn, wh) = r_lrnn.slstm_scan(jp, jx, heads)
    got, (gc, gn, gh) = t_lrnn.slstm_scan(tp, tx, heads)
    for g, w in ((got, want), (gc, wc), (gn, wn), (gh, wh)):
        _close(g, w)
    state = None
    for t in range(11):
        y, state = t_lrnn.slstm_step(tp, tx[:, t], heads, state)
        _close(y, got[:, t])
    assert all(s.dtype == torch.float32 for s in state)
    for g, w in zip(state, (gc, gn, gh)):
        _close(g, w)


@pytest.mark.parametrize("name,kind", [("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm"),
                                       ("hymba-1.5b", "hymba"), ("hymba-1.5b", "hymba_g")])
def test_recurrent_block_prefill_and_decode_match_the_reference(name, kind):
    """One block of each recurrent kind in float32: ``block_prefill`` (its
    output and its cache: the float32 states, the conv tail, the ring or
    full k/v) and three ``block_decode`` steps from the reference's cache,
    the states updated in place."""
    rng = np.random.default_rng(606)
    cfg, tcfg = r_reduced(R_ARCHS[name]), reduced(ARCHS[name])
    jp = r_blocks.init_block(jax.random.PRNGKey(8), cfg, kind)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    r_prefill = jax.jit(functools.partial(r_blocks.block_prefill, cfg=cfg, kind=kind,
                                          cache_len=32))
    r_decode = jax.jit(functools.partial(r_blocks.block_decode, cfg=cfg, kind=kind))
    want, jcache = r_prefill(jp, x=jnp.asarray(x))
    got, tcache = t_blocks.block_prefill(tp, tcfg, kind, torch.from_numpy(x), 32)
    _close(got, want)
    assert sorted(tcache) == sorted(jcache)
    for leaf in jcache:
        _close(tcache[leaf], jcache[leaf], 1e-5 if tcache[leaf].dtype == torch.float32 else 1e-2)
    tcache = {k: torch.from_numpy(np.array(jnp.asarray(v).astype(jnp.float32))).to(
        tcache[k].dtype) for k, v in jcache.items()}
    lengths = np.full((B,), 20, np.int32)
    for step in range(3):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = r_decode(jp, x=jnp.asarray(xt), cache=jcache,
                                lengths=jnp.asarray(lengths))
        views = dict(tcache)
        got, out = t_blocks.block_decode(tp, tcfg, kind, torch.from_numpy(xt), tcache,
                                         torch.from_numpy(lengths))
        assert all(out[k] is views[k] for k in views), "the cache is updated in place"
        # hymba's attention branch decodes through B7's function (float32
        # softmax weights against the reference's bf16 ones): 2e-2
        _close(got, want, 1e-5 if kind in ("mlstm", "slstm") else 2e-2)
        for leaf in ("S", "n", "conv", "c", "h"):
            if leaf in jcache:
                _close(tcache[leaf], jcache[leaf], 1e-5 if kind in ("mlstm", "slstm") else 2e-2)
        lengths = lengths + 1


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_hymba_lm_prefill_and_teacher_forced_decode(dtype_name, monkeypatch):
    """hymba-1.5b reduced: 4 meta tokens, a global and seven 16-slot window
    layers of parallel attention + SSM (xlstm-1.3b's LM runs in
    ``test_torch_lm_zoo.py``)."""
    teacher_forced_parity("hymba-1.5b", dtype_name, monkeypatch)
