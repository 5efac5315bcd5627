"""Plain PyTorch version of GQA flash decode attention (twin of the
reference's ``kernels/flash_attention/ref.py`` ``decode_ref``)."""

from __future__ import annotations

import torch


def decode_ref(
    q: torch.Tensor,        # [B, H, D]
    k: torch.Tensor,        # [B, S, G, D]
    v: torch.Tensor,        # [B, S, G, D]
    lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """One query per sequence over its first ``lengths[b]`` cache rows, in
    float32, returned in q's dtype; a sequence with no valid row gives 0."""
    B, H, D = q.shape
    _, S, G, _ = k.shape
    Hg = H // G
    qg = q.reshape(B, G, Hg, D).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bghd,bsgd->bghs", qg, kf) * (D ** -0.5)   # [B,G,Hg,S]
    mask = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    mask = mask[:, None, None, :]
    scores = torch.where(mask, scores, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bghs,bsgd->bghd", p, vf)
    return out.reshape(B, H, D).to(q.dtype)


def decode_partial_ref(
    q: torch.Tensor,        # [B, H, D]
    k: torch.Tensor,        # [B, S, G, D]: global rows r0 .. r0 + S - 1
    v: torch.Tensor,        # [B, S, G, Dv]: D or a column block of it
    lengths: torch.Tensor,  # [B] global lengths
    r0: int,
):
    """One block of a sequence-split cache: each sequence's rows of the
    block below its length (``clamp(lengths - r0, 0, S)`` of them), in
    float32, the scores over k's whole head dim and the weighted sum over
    v's ``Dv`` columns.  Returns the output normalised over those rows,
    float32 ``[B, H, Dv]`` (0 where there are none), and the log-sum-exp of
    their scaled scores, float32 ``[B, H]`` (-inf where there are none)."""
    B, H, D = q.shape
    _, S, G, _ = k.shape
    Hg = H // G
    qg = q.reshape(B, G, Hg, D).float()
    scores = torch.einsum("bghd,bsgd->bghs", qg, k.float()) * (D ** -0.5)   # [B,G,Hg,S]
    rows = (lengths.to(q.device).long() - r0).clamp(0, S)
    mask = (torch.arange(S, device=q.device)[None, :] < rows[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                                   # [B,G,Hg]
    p = torch.where(mask, torch.exp(scores - torch.where(torch.isneginf(lse), 0.0, lse)[..., None]),
                    0.0)
    out = torch.einsum("bghs,bsgd->bghd", p, v.float())
    return out.reshape(B, H, v.shape[3]), lse.reshape(B, H)


def merge_ref(outs, lses, dtype: torch.dtype) -> torch.Tensor:
    """The blocks' ``(out, lse)`` of :func:`decode_partial_ref` (or of the
    kernel's sequence-split entry) merged into the output over all their
    rows, in ``dtype``: each block weighted by ``exp(lse - max lse)`` (0 for
    a block with no valid row); a sequence with none anywhere gives 0."""
    lse = torch.stack(list(lses))                                           # [n, B, H]
    empty = torch.isneginf(lse)
    top = lse.amax(dim=0)
    w = torch.where(empty, 0.0, torch.exp(torch.where(empty, 0.0, lse - top)))
    num = (torch.stack(list(outs)).float() * w[..., None]).sum(dim=0)
    return (num / w.sum(dim=0).clamp_min(1e-30)[..., None]).to(dtype)
