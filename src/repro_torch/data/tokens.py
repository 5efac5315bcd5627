"""Deterministic synthetic token pipeline.

Twin of the reference's ``data/tokens.py``, bitwise: batches come from a
counter-based hash (step, position) -> token, so every host of a
multi-host job can materialise exactly its own shard without
communication, restarts are reproducible from the step counter alone (no
data-loader checkpoint) and the stream is identical across runs.

``batch_at(step)`` gives the full logical batch and ``host_shard_at(step,
host_id, num_hosts)`` one host's slice, as numpy int32 arrays; the caller
moves them to its device.  The reference's ``device_batch_at`` places a
batch over a mesh, which the port does not have yet (ROADMAP Queue A
item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


def _philox_hash(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cheap counter-based mix (splitmix-like) on uint64 grids."""
    x = (a.astype(np.uint64) << np.uint64(32)) ^ b.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> np.ndarray:
        """[global_batch, seq_len] int32 tokens for `step` (deterministic)."""
        rows = np.arange(self.global_batch, dtype=np.uint64)[:, None]
        cols = np.arange(self.seq_len, dtype=np.uint64)[None, :]
        ctr = (
            np.uint64(step) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(self.seed) * np.uint64(0xD1B54A32D192ED03)
        )
        h = _philox_hash(rows * np.uint64(self.seq_len) + cols, ctr + rows + cols)
        return (h % np.uint64(self.vocab_size)).astype(np.int32)

    def host_shard_at(self, step: int, host_id: int, num_hosts: int) -> np.ndarray:
        if self.global_batch % num_hosts:
            raise ValueError(f"a batch of {self.global_batch} does not split over "
                             f"{num_hosts} hosts")
        per = self.global_batch // num_hosts
        return self.batch_at(step)[host_id * per : (host_id + 1) * per]

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
