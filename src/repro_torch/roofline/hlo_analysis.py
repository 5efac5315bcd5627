"""Census of the ATen ops a PyTorch program executes.

Twin of the reference's ``roofline/hlo_analysis.py``, which re-derives the
three roofline numerators from XLA's optimized HLO, multiplying every
instruction by the trip counts of the ``while`` loops around it.  A torch
program has no HLO: its counterpart is the stream of ATen ops it dispatches.
:func:`analyze` runs the program once under one ``TorchDispatchMode`` and
counts every op as it executes, so a Python loop is counted once per
iteration (the trip-count-aware behaviour the reference has to derive) and
a recomputed (``checkpoint``) forward shows up again in backward:

  * flops            2 * |out| * |contracted| for every matrix product,
                     convolution and fused attention (mm, addmm, bmm,
                     baddbmm, convolution, ``_scaled_dot_product_*`` and
                     their backward forms: ``torch.utils.flop_counter``'s
                     formulas), split by the operands' dtype;
  * elementwise ops  one per output element of elementwise arithmetic
                     (:data:`ELEMENTWISE_OPS`); reductions, copies and
                     data movement count none;
  * hbm bytes        operand + result bytes of every executed op that is
                     not a view or an allocation (each tensor's distinct
                     elements: a broadcast dimension of stride 0 counts
                     once), the fused-nothing eager model -- an upper
                     estimate of what a fused program moves;
  * collective bytes result bytes of every ``c10d`` functional collective
                     (:func:`repro_torch.roofline.model.collective_bytes`);
  * per op name      its executions (``op_counts``), the elements it wrote
                     (``op_elements``) and one record of its result shapes
                     per execution (``records``).

It runs on any device.  On ``torch.device("meta")`` tensors nothing is
allocated or computed, so a full-width model's step is censused on any
host; a program that reads a value back (``.item()``) cannot run there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.model import OpRecord, collective_bytes

#: Elementwise arithmetic (ATen overload-packet names; in-place and ``out``
#: forms count under the same name without the trailing ``_``).
ELEMENTWISE_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "reciprocal",
    "floor_divide", "remainder", "fmod", "floor", "ceil", "round", "trunc",
    "maximum", "minimum", "fmax", "fmin", "clamp", "clamp_min", "clamp_max", "where",
    "eq", "ne", "gt", "ge", "lt", "le", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__and__", "__or__", "__xor__",
    "__lshift__", "__rshift__", "pow", "sqrt", "rsqrt", "exp", "exp2", "expm1", "log",
    "log2", "log1p", "sin", "cos", "tanh", "sigmoid", "erf", "erfinv", "silu", "gelu",
    "relu", "softplus", "lerp", "addcmul", "addcdiv", "square", "log_sigmoid_forward",
    "sigmoid_backward", "tanh_backward", "silu_backward", "gelu_backward",
    "threshold_backward", "softplus_backward", "log_sigmoid_backward",
})

#: Ops that move no bytes: allocations without a write, and alias
#: bookkeeping (every view op is skipped by its schema as well).
NO_BYTES_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "set_",
})


@dataclasses.dataclass
class Census:
    flops: float
    elementwise_ops: float
    hbm_bytes: float
    collective_bytes: float
    coll_breakdown: Dict[str, float]
    op_counts: Dict[str, int]
    op_elements: Dict[str, int]
    flops_by_dtype: Dict[str, float]
    records: List[OpRecord] = dataclasses.field(repr=False, default_factory=list)

    def to_dict(self) -> Dict:
        out = dataclasses.asdict(self)
        del out["records"]
        return out


def op_name(func) -> str:
    """The census name of an ATen overload: the packet name for ``aten``
    ops (``add_`` for the in-place form), ``namespace::name`` otherwise."""
    packet = func._overloadpacket.__name__
    return packet if func.namespace == "aten" else f"{func.namespace}::{packet}"


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a stride-0 dimension counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _CensusMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.elementwise = 0.0
        self.bytes = 0.0
        self.counts: Dict[str, int] = {}
        self.elements: Dict[str, int] = {}
        self.records: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = op_name(func)
        self.counts[name] = self.counts.get(name, 0) + 1
        results = _tensors(out)
        self.elements[name] = self.elements.get(name, 0) + sum(r.numel() for r in results)
        self.records.append((f"{func.namespace}::{func._overloadpacket.__name__}",
                             tuple((r.dtype, tuple(r.shape)) for r in results)))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            operands = _tensors((args, kwargs))
            dtype = str(operands[0].dtype if operands else results[0].dtype)[6:]
            self.flops_by_dtype[dtype] = (self.flops_by_dtype.get(dtype, 0.0)
                                          + float(formula(*args, **kwargs, out_val=out)))
        elif name.rstrip("_") in ELEMENTWISE_OPS:
            self.elementwise += sum(r.numel() for r in results)
        if not func.is_view and name not in NO_BYTES_OPS:
            self.bytes += sum(distinct_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(distinct_bytes(t) for t in results)
        return out


def analyze(fn: Callable, *args, **kw) -> Census:
    """Run ``fn(*args, **kw)`` once and census every ATen op it executes
    (backward passes that ``fn`` runs included)."""
    mode = _CensusMode()
    with mode:
        fn(*args, **kw)
    coll = collective_bytes(mode.records)
    return Census(
        flops=sum(mode.flops_by_dtype.values()),
        elementwise_ops=mode.elementwise,
        hbm_bytes=mode.bytes,
        collective_bytes=float(coll["total"]),
        coll_breakdown={k: float(v) for k, v in coll.items()},
        op_counts=dict(mode.counts),
        op_elements=dict(mode.elements),
        flops_by_dtype=dict(mode.flops_by_dtype),
        records=mode.records,
    )


def meta_like(tree):
    """``tree`` with every tensor replaced by an uninitialised one of its
    shape and dtype on ``meta`` (no memory): the operands of a census."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree
