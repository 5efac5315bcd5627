"""Port parity, flash decode attention: ``decode_ref`` and
``decode_attention`` of ``repro_torch.kernels.flash_attention`` against the
reference's, whose Pallas ``flash_decode`` runs in interpret mode as
``tests/test_kernels_flash.py`` runs it off the TPU, over that suite's
sweeps plus length 0.

On the CPU the wrapper computes B7's plain version; the CUDA kernel is
held against it on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.  Tolerances are ``flash_attention.parity``'s, which
those two use as well: float32 within the reference suite's ``rtol = atol
= 2e-5`` (the same float32 math summed in another order), bf16 within one
bf16 unit (each side computes in float32 from the same bf16 values and
rounds its output once), and exactly 0 for a sequence with no valid row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode_attention as r_decode_attention
from repro.kernels.flash_attention import decode_ref as r_decode_ref

from repro_torch.kernels.flash_attention import LAUNCHES, decode_attention, decode_ref, parity


def _mk(rng, B, H, G, D, S, dtype_name):
    """The same q, k, v for both packages: float32 numpy from the seed,
    rounded to bf16 by each package where asked (both round to nearest even)."""
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, G, D)).astype(np.float32)
    v = rng.standard_normal((B, S, G, D)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    return ([jnp.asarray(a).astype(jdt) for a in (q, k, v)],
            [torch.from_numpy(a).to(tdt) for a in (q, k, v)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _check(rng, B, H, G, D, S, lengths, chunk, dtype_name="float32"):
    (jq, jk, jv), (tq, tk, tv) = _mk(rng, B, H, G, D, S, dtype_name)
    jl = jnp.asarray(lengths, jnp.int32)
    tl = torch.tensor(lengths, dtype=torch.int32)
    wants = [r_decode_attention(jq, jk, jv, jl, chunk=chunk), r_decode_ref(jq, jk, jv, jl)]
    before = LAUNCHES["flash_decode"]
    got = decode_attention(tq, tk, tv, tl, chunk=chunk)
    assert LAUNCHES["flash_decode"] == before, "the CPU path launches no kernel"
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    got_ref = decode_ref(tq, tk, tv, tl)
    for want in wants:
        want = torch.tensor(_np(want)).to(tq.dtype)
        for g in (got, got_ref):
            parity.check(g, want, lengths)


@pytest.mark.parametrize("B,H,G,D,S", [
    (2, 8, 8, 64, 512),    # MHA
    (2, 8, 2, 64, 512),    # GQA 4:1
    (1, 8, 1, 128, 1024),  # MQA
    (3, 25, 5, 64, 512),   # hymba-like ragged head count
])
def test_decode_matches_reference_full_cache(B, H, G, D, S):
    rng = np.random.default_rng(301)
    _check(rng, B, H, G, D, S, [S] * B, chunk=256)


@pytest.mark.parametrize("chunk", [128, 256, 512])
def test_decode_chunk_sweep(chunk):
    rng = np.random.default_rng(302)
    _check(rng, 2, 4, 2, 64, 1024, [700, 1024], chunk=chunk)


def test_decode_lengths_zero_one_ragged():
    rng = np.random.default_rng(303)
    _check(rng, 4, 8, 1, 256, 512, [0, 1, 257, 512], chunk=512)


def test_decode_bf16_cache():
    rng = np.random.default_rng(304)
    _check(rng, 2, 8, 4, 64, 512, [512, 300], chunk=256, dtype_name="bfloat16")


def test_decode_partial_lengths_mask():
    """Rows past each sequence's length, poisoned with 1e9, change nothing."""
    rng = np.random.default_rng(305)
    B, H, G, D, S = 2, 4, 2, 64, 512
    _, (q, k, v) = _mk(rng, B, H, G, D, S, "float32")
    lengths = torch.tensor([100, 257], dtype=torch.int32)
    out1 = decode_attention(q, k, v, lengths, chunk=128)
    tail = torch.arange(S)[None, :, None, None] >= lengths[:, None, None, None]
    out2 = decode_attention(q, k.masked_fill(tail, 1e9), v.masked_fill(tail, 1e9), lengths,
                            chunk=128)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def test_decode_keeps_the_reference_contract():
    rng = np.random.default_rng(306)
    _, (q, k, v) = _mk(rng, 1, 6, 4, 32, 128, "float32")
    with pytest.raises(ValueError, match="not divisible"):
        decode_attention(q, k, v, torch.ones(1, dtype=torch.int32), chunk=128)
    _, (q, k, v) = _mk(rng, 1, 4, 2, 32, 96, "float32")
    with pytest.raises(ValueError, match="multiple of chunk"):
        decode_attention(q, k, v, torch.ones(1, dtype=torch.int32), chunk=64)


@pytest.mark.parametrize("fault,caught", [
    ("none", False), ("one_bf16_unit", False), ("two_bf16_units", True),
    ("float32_1e-4", True), ("nonzero_at_length_0", True), ("other_dtype", True),
])
def test_parity_check_holds_b7_to_its_tolerance(fault, caught):
    """The shared kernel-vs-plain check: one bf16 unit passes, two do not;
    float32 is held to 2e-5; length 0 must give exactly 0."""
    rng = np.random.default_rng(307)
    dtype = torch.float32 if fault == "float32_1e-4" else torch.bfloat16
    want = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32)).to(dtype)
    lengths = [5, 0, 7]
    want[1] = 0
    got = want.clone()
    if fault == "one_bf16_unit":
        got = torch.nextafter(want, torch.full_like(want, float("inf")))
        got[1] = 0
    elif fault == "two_bf16_units":
        got[0, 0, 0] = want[0, 0, 0].float() * (1 + 2 ** -5)
    elif fault == "float32_1e-4":
        got[0, 0, 0] += 1e-4
    elif fault == "nonzero_at_length_0":
        got[1, 0, 0] = 1e-30
    elif fault == "other_dtype":
        got = got.float()
    if caught:
        with pytest.raises(AssertionError):
            parity.check(got, want, lengths)
    else:
        err, share = parity.check(got, want, lengths)
        assert share <= 1.0 and (err > 0) == (fault != "none")
