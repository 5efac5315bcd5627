"""Batched serving engine: prefill + decode with slot-based continuous
batching.

Twin of the reference's ``serve/engine.py``.  The engine owns a fixed
[max_batch, max_seq] cache; requests claim slots, prefill fills them, and
the decode step advances every active slot each tick (inactive slots are
masked from sampling).  Every attention layer of a decode step runs the
flash decode kernel (B7) on the card, over a full or a ring cache.  Greedy or temperature sampling;
deterministic under a fixed seed (temperature sampling draws from a
``torch.Generator`` seeded with ``ServeConfig.seed``: the same law as the
reference's ``jax.random.categorical``, other numbers).

Both entry points run on ``device`` ("cuda" unless the caller asks for the
CPU) and raise where that device is missing.  They cast the f32 master
weights to the LM's compute dtype once, at construction, where the
reference casts them inside every jitted step; the values are the same.
Weights drawn already cast (``LM.init(..., cast=True)``, the way to build
a 16 B model on one card) pass through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.interpreter import check_device
from repro_torch.models.lm import LM, tree_map


@dataclasses.dataclass
class ServeConfig:
    max_batch: int
    max_seq: int
    temperature: float = 0.0     # 0 => greedy
    seed: int = 0


def _on_device(lm: LM, params, device: torch.device):
    return lm.cast_params(tree_map(lambda p: p.to(device), params))


class ServeEngine:
    def __init__(self, lm: LM, params, cfg: ServeConfig, device="cuda"):
        self.device = check_device(device)
        self.lm = lm
        self.params = _on_device(lm, params, self.device)
        self.cfg = cfg

    # -- one-shot batch generation -------------------------------------------

    def generate(
        self,
        prompts,                       # [B, S_prompt] int
        num_steps: int,
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> np.ndarray:
        """Prefill the batch, then decode ``num_steps`` tokens; returns
        ``[B, num_steps]`` token ids."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B = prompts.shape[0]
        if B > self.cfg.max_batch:
            raise ValueError(f"{B} prompts exceed max_batch={self.cfg.max_batch}")
        if prefix_embeds is not None:
            prefix_embeds = torch.as_tensor(prefix_embeds, device=self.device)
        logits, cache, lengths = self.lm.prefill(
            self.params, prompts, cache_len=self.cfg.max_seq, prefix_embeds=prefix_embeds,
        )
        generator = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        tok = self._sample(logits, generator)
        out = [tok]
        for _ in range(num_steps - 1):
            logits, cache, lengths = self.lm.decode_step(
                self.params, tok[:, None], cache, lengths
            )
            tok = self._sample(logits, generator)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()   # [B, steps]

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class SlotServer:
    """Continuous-batching skeleton: requests arrive/finish independently;
    every tick decodes all active slots in one batched step."""

    def __init__(self, lm: LM, params, cfg: ServeConfig, device="cuda"):
        self.device = check_device(device)
        self.lm = lm
        self.params = _on_device(lm, params, self.device)
        self.cfg = cfg
        self.cache = lm.init_cache(cfg.max_batch, cfg.max_seq, self.device)
        self.lengths = torch.zeros((cfg.max_batch,), dtype=torch.int32, device=self.device)
        self.active = np.zeros((cfg.max_batch,), bool)
        self.last_token = torch.zeros((cfg.max_batch,), dtype=torch.int32, device=self.device)
        self.outputs: Dict[int, List[int]] = {}

    def add_request(self, slot: int, prompt, prefix_embeds=None) -> None:
        """Single-slot prefill (production would batch these too).
        ``prefix_embeds`` ``[P, D]``: the request's modality-stub
        embeddings, ahead of its prompt."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is busy")
        prompt = torch.as_tensor(prompt, device=self.device)
        if prefix_embeds is not None:
            prefix_embeds = torch.as_tensor(prefix_embeds, device=self.device)[None]
        logits, cache1, lengths1 = self.lm.prefill(
            self.params, prompt[None], cache_len=self.cfg.max_seq, prefix_embeds=prefix_embeds
        )
        # splice slot 0 of the single-request cache into the shared cache
        _splice_tree(self.cache, cache1, slot)
        tok = torch.argmax(logits[0]).to(torch.int32)
        self.lengths[slot] = lengths1[0]
        self.last_token[slot] = tok
        self.active[slot] = True
        self.outputs[slot] = [int(tok)]

    def tick(self) -> None:
        if not self.active.any():
            return
        logits, self.cache, new_lengths = self.lm.decode_step(
            self.params, self.last_token[:, None], self.cache, self.lengths
        )
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        mask = torch.as_tensor(self.active, device=self.device)
        self.lengths = torch.where(mask, new_lengths, self.lengths)
        self.last_token = torch.where(mask, tok, self.last_token)
        tok = tok.cpu()
        for slot in np.nonzero(self.active)[0]:
            self.outputs[slot].append(int(tok[slot]))

    def finish(self, slot: int) -> List[int]:
        self.active[slot] = False
        self.lengths[slot] = 0
        return self.outputs.pop(slot)


def _splice_tree(full, one, slot: int) -> None:
    """:func:`_splice` on every leaf of two cache trees of one structure."""
    if isinstance(full, dict):
        for key in full:
            _splice_tree(full[key], one[key], slot)
    elif isinstance(full, (tuple, list)):
        for f, o in zip(full, one):
            _splice_tree(f, o, slot)
    else:
        _splice(full, one, slot)


def _splice(full: torch.Tensor, one: torch.Tensor, slot: int) -> torch.Tensor:
    """Write a batch-1 cache leaf into batch slot ``slot`` of the full
    cache, in place.  Batch is axis 0 for unstacked leaves and axis 1 for
    stacked ones, identified by matching trailing dims; the start is
    clamped as the reference's ``dynamic_update_slice`` clamps it."""
    axis = 0 if full.shape[1:] == one.shape[1:] else 1
    start = max(0, min(slot, full.shape[axis] - one.shape[axis]))
    full.narrow(axis, start, one.shape[axis]).copy_(one.to(full.dtype))
    return full
