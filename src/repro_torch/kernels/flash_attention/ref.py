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
