"""Linear-recurrent sequence mixers: chunked gated linear attention (GLA)
core shared by xLSTM's mLSTM and Hymba's SSM heads, plus the sequential
sLSTM.

Twin of the reference's ``models/linear_rnn.py``.  The recurrence

    S_t = f_t * S_{t-1} + i_t * k_t v_t^T        (matrix state per head)
    y_t = q_t . S_t   [optionally / max(|q_t . n_t|, 1)]

is evaluated chunkwise: within a chunk the contribution is a masked
quadratic form, across chunks a Python loop (the reference's
``lax.scan``) carries the [dk, dv] state.  The state is float32
throughout, as the reference keeps it; the sLSTM's time scan is a Python
loop over tokens.

One deliberate difference: the chunked form sums the log-decays in
float32.  The reference casts q, k and v to float32 in the chunk but not
the gates, so under a bf16 compute dtype it sums bf16 log-decays in bf16,
every partial sum rounded (XLA's reduce-window).  Over a 256-step chunk
|P| reaches tens to hundreds, where a bf16 ulp is 0.25 to 1, so
exp(P_t - P_s) is off by up to a factor e and the chunked prefill parts
from the step-by-step decode (``gla_step``, whose float32 state never
holds a bf16 sum).  Summed in float32, prefill and decode compute one
function, the reference's float32 one.

A second one, for training: the reference masks the intra-chunk weights
after the exp (``where(tril, exp(P_t - P_s) i_s, 0)``).  Above the
diagonal P_t - P_s is the sum of the decays between them, positive, and
past 88 (hymba at full width: ~0.7 a step over a 256-step chunk) its exp
overflows to inf; the forward value takes the 0, but the gradient of the
discarded branch is 0 x inf = NaN, and a train step's grads are NaN.  The
port masks the gaps before the exp (exp(-inf) = 0): the same forward
values, bitwise, and finite grads.

Gate conventions: ``log_f`` (log forget) <= 0 and ``i_gate`` in [0, 1]
(sigmoid), so every chunk weight exp(log-sum) stays in [0, 1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, promoted, sigmoid, truncated_normal

GLAState = Tuple[torch.Tensor, torch.Tensor]  # S: [B,H,dk,dv], n: [B,H,dk]


def gla_chunked(
    q: torch.Tensor,        # [B, L, H, dk]
    k: torch.Tensor,        # [B, L, H, dk]
    v: torch.Tensor,        # [B, L, H, dv]
    log_f: torch.Tensor,    # [B, L, H]  (<= 0)
    i_gate: torch.Tensor,   # [B, L, H]  (in [0, 1])
    state: Optional[GLAState] = None,
    normalize: bool = False,
    chunk: int = 256,
) -> Tuple[torch.Tensor, GLAState]:
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, L)
    while L % c:  # largest divisor of L <= chunk (meta-token raggedness)
        c -= 1

    if state is None:
        S = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=torch.float32, device=q.device)
    else:
        S, n = state

    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ys = []
    for start in range(0, L, c):
        # float32 throughout, the gates too: see the module docstring
        qb, kb, vb, fb, ib = (t[:, start:start + c].float()
                              for t in (q, k, v, log_f, i_gate))   # [B,c,H,*]
        P = torch.cumsum(fb, dim=1)                 # [B,c,H] inclusive logs
        Ptot = P[:, -1]                             # [B,H]

        # inter-chunk: queries read the carried state, decayed to their slot
        q_dec = qb * torch.exp(P)[..., None]
        y_inter = torch.einsum("bthd,bhdv->bthv", q_dec, S)
        n_inter = torch.einsum("bthd,bhd->bth", q_dec, n)

        # intra-chunk: masked decayed quadratic form; the mask goes in before
        # the exp (see the module docstring)
        gap = (P[:, :, None, :] - P[:, None, :, :]).masked_fill(
            ~tril[None, :, :, None], -torch.inf)    # [B,t,s,H]
        w = torch.exp(gap) * ib[:, None]
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * w
        y = y_inter + torch.einsum("btsh,bshv->bthv", scores, vb)

        if normalize:
            # n_t = decayed carry + intra contribution of k's
            kn = torch.einsum("btsh,bshd->bthd", *promoted(w, kb))   # sum_s w ks
            qn = torch.einsum("bthd,bthd->bth", qb, kn) + n_inter
            y = y / torch.clamp_min(qn.abs(), 1.0)[..., None]
        ys.append(y)

        # state update to chunk end
        decay_to_end = torch.exp(Ptot[:, None] - P) * ib          # [B,c,H]
        k_dec = kb * decay_to_end[..., None]
        S = torch.exp(Ptot)[:, :, None, None] * S + torch.einsum("bshd,bshv->bhdv", k_dec, vb)
        n = torch.exp(Ptot)[:, :, None] * n + k_dec.sum(dim=1)

    return torch.cat(ys, dim=1).to(v.dtype), (S, n)


def gla_step(
    q: torch.Tensor,       # [B, H, dk]
    k: torch.Tensor,
    v: torch.Tensor,       # [B, H, dv]
    log_f: torch.Tensor,   # [B, H]
    i_gate: torch.Tensor,  # [B, H]
    state: GLAState,
    normalize: bool = False,
) -> Tuple[torch.Tensor, GLAState]:
    """Single decode step of the same recurrence."""
    S, n = state
    qf, kf, vf = (t.float() for t in (q, k, v))
    f = torch.exp(log_f)[..., None]
    ig = i_gate[..., None]
    S_new = f[..., None] * S + (ig * kf)[..., None] * vf[..., None, :]
    n_new = f * n + ig * kf
    y = torch.einsum("bhd,bhdv->bhv", qf, S_new)
    if normalize:
        denom = torch.clamp_min(torch.einsum("bhd,bhd->bh", qf, n_new).abs(), 1.0)
        y = y / denom[..., None]
    return y.to(v.dtype), (S_new, n_new)


# -- causal depthwise conv (mLSTM / mamba front-end) ---------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, L, C]; w: [K, C] depthwise causal convolution."""
    K = w.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for j in range(K):
        out = out + xp[:, j:j + L, :] * w[j]
    return out


def causal_conv1d_step(
    x: torch.Tensor, w: torch.Tensor, buf: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode step: x [B, C], buf [B, K-1, C] (previous inputs)."""
    # The reference concatenates in the promoted dtype (float32 buffer).
    window = torch.cat(promoted(buf, x[:, None]), dim=1)      # [B, K, C]
    y = torch.einsum("bkc,kc->bc", *promoted(window, w))
    return y, window[:, 1:]


# -- sLSTM ----------------------------------------------------------------------


def init_slstm(generator: torch.Generator, d: int, num_heads: int) -> Params:
    dh = d // num_heads
    return {
        "w": truncated_normal(generator, (d, 4 * d), d ** -0.5),
        "r": truncated_normal(generator, (num_heads, dh, 4 * dh), dh ** -0.5),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=generator.device),
    }


def slstm_scan(params: Params, x: torch.Tensor, num_heads: int, state=None):
    """Sequential sLSTM (paper: not parallelizable by design).

    x: [B, L, D] -> y: [B, L, D]; per-head recurrent gates.
    State: (c, n, h) each [B, H, dh], float32.
    """
    B, L, D = x.shape
    H = num_heads
    dh = D // H
    zx = (x @ params["w"] + params["b"]).reshape(B, L, H, 4 * dh)

    if state is None:
        z0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (z0, z0, z0)
    c, n, h = state
    r = params["r"]
    hs = []
    for t in range(L):
        rec = torch.einsum("bhd,hde->bhe", *promoted(h, r))     # [B,H,4dh]
        z, i, f, o = torch.split(zx[:, t] + rec, dh, dim=-1)
        z = torch.tanh(z)
        i = sigmoid(i)
        f = sigmoid(f)
        o = sigmoid(o)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp_min(n, 1e-6)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, L, D).to(x.dtype)
    return y, (c, n, h)


def slstm_step(params: Params, x: torch.Tensor, num_heads: int, state):
    """x: [B, D] single step."""
    y, st = slstm_scan(params, x[:, None], num_heads, state)
    return y[:, 0], st
