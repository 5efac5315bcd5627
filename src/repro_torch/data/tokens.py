"""Deterministic synthetic token pipeline.

Twin of the reference's ``data/tokens.py``, bitwise: batches come from a
counter-based hash (step, position) -> token, so every host of a
multi-host job can materialise exactly its own shard without
communication, restarts are reproducible from the step counter alone (no
data-loader checkpoint) and the stream is identical across runs.

``batch_at(step)`` gives the full logical batch and ``host_shard_at(step,
host_id, num_hosts)`` one host's slice, as numpy int32 arrays; the caller
moves them to its device.  ``device_batch_at(step, mesh, placements)``
gives the batch as a DTensor over an LM mesh, each rank generating only
its own block.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard


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
        return self._block(step, 0, self.global_batch, 0, self.seq_len)

    def _block(self, step: int, r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
        """Rows ``r0:r1``, columns ``c0:c1`` of :meth:`batch_at` (a token
        depends only on its row, column, step and seed)."""
        rows = np.arange(r0, r1, dtype=np.uint64)[:, None]
        cols = np.arange(c0, c1, dtype=np.uint64)[None, :]
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
        return self._block(step, host_id * per, (host_id + 1) * per, 0, self.seq_len)

    def device_batch_at(self, step: int, mesh, placements: Sequence[Placement]) -> DTensor:
        """The ``[global_batch, seq_len]`` batch of ``step`` as a DTensor
        over ``mesh`` laid out by ``placements`` (a plan's
        ``token_sharding().placements``).  Each rank generates only its own
        block -- the multi-host-safe path -- on the mesh's device."""
        shape = (self.global_batch, self.seq_len)
        lo, hi = [0, 0], list(shape)
        for dim in range(2):
            # the block index of this rank along ``dim``, mesh dims major first
            idx, n = 0, 1
            for i, p in enumerate(placements):
                if isinstance(p, Shard) and p.dim == dim:
                    idx = idx * mesh.size(i) + mesh.get_local_rank(i)
                    n *= mesh.size(i)
                elif not isinstance(p, (Shard, Replicate)):
                    raise ValueError(f"a token batch cannot be laid out as {p}")
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of a {shape} batch does not split {n} ways")
            per = shape[dim] // n
            lo[dim], hi[dim] = idx * per, (idx + 1) * per
        local = torch.from_numpy(self._block(step, lo[0], hi[0], lo[1], hi[1]))
        device = "cpu" if mesh.device_type == "cpu" else torch.device(
            mesh.device_type, torch.cuda.current_device())
        return DTensor.from_local(local.to(device), mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=(shape[1], 1))

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
