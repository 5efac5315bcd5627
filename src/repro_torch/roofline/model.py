"""Roofline of one NVIDIA H100 SXM from a census of executed ATen ops.

Twin of the reference's ``roofline/model.py``.  Three terms per (arch x
shape x mesh), all in seconds per step:

    compute    = flops / (989e12)  +  f32_flops / (67e12)
                 [bf16 tensor-core peak; float32 outside the tensor cores]
    memory     = bytes / (3.35e12)                  [HBM3 bandwidth]
    collective = collective_bytes / (450e9)         [NVLink, one direction]

The numerators come from :func:`repro_torch.roofline.hlo_analysis.analyze`,
which runs a program once under a dispatch mode (on ``meta`` tensors, so a
full-width model costs no memory) and counts what it executes: the
counterpart of the reference's optimized-HLO census.  The rates are the
published dense peaks of one H100 SXM at its full 700 W power limit
(NVIDIA's data sheet; a card set below 700 W runs slower under load).  The
data sheet's float32 row has no tensor cores: float32 products with TF32
off and every elementwise op (counted one per output element) run at the
67e12 rate, so they go to the second compute term.

Collective bytes are the result bytes of every ``c10d`` functional
collective the census saw (:func:`collective_bytes`); one card issues none.

Both numerators describe the eager program as it runs, not the least work
of the step: the memory term counts every op's operands and result once
with no fusion, and the compute term adds the tensor-core and the
non-tensor work rather than taking the larger.  The step time is therefore
an estimate of the eager program, and a measured time over it is not a
share of a lower bound.

MODEL_FLOPS = 6 * N_active * tokens (the classic transformer estimate); the
ratio MODEL_FLOPS / census FLOPs exposes remat recompute (with
``remat="full"`` the forward runs twice) and any product the estimate
leaves out (attention scores, the unembedding's chunks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

# -- hardware constants (one NVIDIA H100 SXM, data sheet, dense, 700 W) -----

PEAK_FLOPS = 989e12               # bf16 / fp16 tensor cores, per card
F32_FLOPS = 67e12                 # float32 outside the tensor cores, per card
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW_PER_DIRECTION = 450e9   # bytes/s per card, one direction (900e9 both)

#: One tensor of a census record: its dtype and its shape.
TensorRecord = Tuple[torch.dtype, Tuple[int, ...]]
#: One executed op of a census: its ATen name (``namespace::op``) and its
#: result tensors.
OpRecord = Tuple[str, Tuple[TensorRecord, ...]]

#: The reference's collective kinds, and the ``c10d`` functional ops of
#: each (in-place ``c10d`` forms and the functional ``_c10d_functional``).
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
    "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")


def collective_kind(op_name: str) -> Optional[str]:
    """The reference's collective kind of ATen op ``namespace::op``, or None."""
    namespace, _, name = op_name.partition("::")
    if namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return COLLECTIVE_OPS.get(name)


def shape_bytes(record: Union[TensorRecord, Sequence[TensorRecord]]) -> int:
    """Bytes of one tensor record ``(dtype, shape)`` or of a sequence of
    them (an op's tuple result)."""
    if len(record) == 2 and isinstance(record[0], torch.dtype):
        records = (record,)
    else:
        records = record
    total = 0
    for dtype, shape in records:
        n = 1
        for d in shape:
            n *= int(d)
        total += n * dtype.itemsize
    return total


def collective_bytes(records: Iterable[OpRecord]) -> Dict[str, int]:
    """Per-collective-kind result bytes (per card) of a census's op
    records; every other op is skipped."""
    out = {c: 0 for c in _COLLECTIVES}
    for name, results in records:
        kind = collective_kind(name)
        if kind is not None:
            out[kind] += shape_bytes(results)
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float             # at the bf16 tensor-core peak
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float                  # global, 6*N_active*tokens
    peak_memory_per_device: Optional[float] = None
    coll_breakdown: Optional[Dict[str, int]] = None
    f32_flops_per_device: float = 0.0   # at the float32 non-tensor peak

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS + self.f32_flops_per_device / F32_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / NVLINK_BW_PER_DIRECTION

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time: the largest of the compute, memory and
        collective terms (the compute term itself a sum of tensor-core and
        non-tensor time)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        counted = (self.flops_per_device + self.f32_flops_per_device) * self.chips
        return self.model_flops / counted if counted else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilisation at the roofline step time."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "f32_flops_per_device": self.f32_flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_roofline": self.mfu,
            "peak_memory_per_device": self.peak_memory_per_device,
            "coll_breakdown": self.coll_breakdown,
        }


def model_flops_estimate(cfg, shape, n_active: float) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference shapes."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def format_roofline_rows(reports: Iterable[RooflineReport]) -> str:
    rows = [r.to_dict() for r in reports]
    if not rows:
        return "(empty)"
    cols = [
        "arch", "shape", "mesh", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "useful_flops_ratio", "mfu_at_roofline",
    ]

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.3e}" if (abs(v) < 1e-2 and v) else f"{v:.3f}"
        return str(v)
    widths = {c: max(len(c), *(len(fmt(r[c])) for r in rows)) for c in cols}
    head = " | ".join(c.ljust(widths[c]) for c in cols)
    sep = "-+-".join("-" * widths[c] for c in cols)
    body = "\n".join(
        " | ".join(fmt(r[c]).ljust(widths[c]) for c in cols) for r in rows
    )
    return f"{head}\n{sep}\n{body}"
