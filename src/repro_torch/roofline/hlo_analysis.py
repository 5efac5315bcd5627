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

**Per rank.**  On DTensors (a program over a ``DeviceMesh``) the census
counts what one rank executes: the ops on its local blocks and the
collectives DTensor issues, the redistributions inside its sharding
propagation included.  The mode lets every op on a DTensor pass
(``NotImplemented``) to DTensor, whose local ops come back to it as plain
tensors, and pauses while DTensor's sharding propagator runs an op on
global-shape fake tensors to learn its output's shape
(``ShardingPropagator._propagate_tensor_meta_non_cached``).  Without that
hook (another torch) a census that meets a DTensor raises rather than
count the world's work.  On plain tensors nothing of this applies.

**B7's ops** (``repro_torch::flash_decode`` and ``flash_decode_split``)
count by its own formula, ``kernels.flash_attention.ops.census_op_cost``
(``flash_bound``'s bytes and 4 D operations per row and query head, over
all of a call's rows); their operations count as float32.

**Live bytes** (:func:`analyze_with_memory`): the same run also tracks each
storage an op creates until it dies, from the arguments' storages on: the
high-water mark is the bytes one rank holds at its peak (on ``meta``, the
bytes it would hold), with the ops whose storages were live then.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention.ops import census_op_cost
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


#: The custom ops counted by their own formula (B7's entries).
B7_OPS = frozenset({"repro_torch::flash_decode", "repro_torch::flash_decode_split"})


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank; a plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


@contextlib.contextmanager
def _per_rank(mode: "_CensusMode"):
    """Pauses ``mode`` while DTensor's sharding propagator runs an op on
    global-shape fake tensors; sets ``mode.hooked`` when it could."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        yield
        return
    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        yield
        return

    def paused(self, *args, **kwargs):
        mode.paused += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            mode.paused -= 1

    setattr(ShardingPropagator, name, paused)
    mode.hooked = True
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@dataclasses.dataclass
class LiveBytes:
    """One rank's storage bytes over a run (:func:`analyze_with_memory`):
    the arguments' that an output depends on (distinct storages; ``jax.jit``
    leaves an input no output needs out of the executable), the outputs'
    (each distinct tensor once), the outputs that are arguments' storages
    written in place, the high-water mark of every live storage, and at
    that mark the live bytes by the op that made them (``"argument"`` for
    the arguments)."""

    argument_bytes: float
    output_bytes: float
    alias_bytes: float
    peak_bytes: float
    peak_by_op: Dict[str, float]

    @property
    def temp_bytes(self) -> float:
        """What the peak holds beyond the arguments and the new outputs."""
        return self.peak_bytes - self.argument_bytes - self.output_bytes + self.alias_bytes


class _Tracker:
    """Live storage bytes: each storage counted from the op that created it
    until it dies (a weak reference's finalizer)."""

    def __init__(self):
        self.live = 0.0
        self.peak = 0.0
        self.by_op: Dict[str, float] = {}
        self.peak_by_op: Dict[str, float] = {}
        self._seen: Dict[int, weakref.finalize] = {}

    def add(self, tensors, op: str) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = float(st.nbytes())
            self._seen[key] = weakref.finalize(st, self._free, key, n, op)
            self.live += n
            self.by_op[op] = self.by_op.get(op, 0.0) + n
            if self.live > self.peak:
                self.peak = self.live
                self.peak_by_op = dict(self.by_op)

    def _free(self, key: int, n: float, op: str) -> None:
        self._seen.pop(key, None)
        self.live -= n
        self.by_op[op] -= n

    def close(self) -> None:
        for fin in list(self._seen.values()):
            fin.detach()
        self._seen.clear()


class _Flow:
    """Which arguments each storage's values derive from, a bit per
    argument: an op's outputs take the union of its inputs' bits (a fresh
    storage takes them, one an op writes in place or views adds them)."""

    def __init__(self, args):
        self.bits: Dict[int, int] = {}
        for i, t in enumerate(args):
            key = id(t.untyped_storage())
            self.bits[key] = self.bits.get(key, 0) | (1 << i)

    def op(self, inputs, results) -> None:
        keys = {id(t.untyped_storage()) for t in inputs}
        bits = 0
        for key in keys:
            bits |= self.bits.get(key, 0)
        for t in results:
            key = id(t.untyped_storage())
            self.bits[key] = (self.bits.get(key, 0) | bits) if key in keys else bits

    def reaching(self, outs) -> int:
        bits = 0
        for t in outs:
            bits |= self.bits.get(id(t.untyped_storage()), 0)
        return bits


def _distinct_tensor_bytes(tensors) -> float:
    seen = set()
    total = 0.0
    for t in tensors:
        key = (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


class _CensusMode(TorchDispatchMode):
    def __init__(self, tracker: Optional[_Tracker] = None, flow: Optional[_Flow] = None):
        super().__init__()
        self.flow = flow
        self.flops_by_dtype: Dict[str, float] = {}
        self.elementwise = 0.0
        self.bytes = 0.0
        self.counts: Dict[str, int] = {}
        self.elements: Dict[str, int] = {}
        self.records: List[OpRecord] = []
        self.tracker = tracker
        self.paused = 0
        self.hooked = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            if not self.hooked:
                raise RuntimeError(
                    "the census met a DTensor but could not hook this torch's sharding "
                    "propagator (ShardingPropagator._propagate_tensor_meta_non_cached): it "
                    "would count the global shapes' work")
            return NotImplemented          # DTensor runs it; its local ops come back
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name = op_name(func)
        self.counts[name] = self.counts.get(name, 0) + 1
        results = _tensors(out)
        if self.tracker is not None:
            self.tracker.add(results, name)
        if self.flow is not None:
            self.flow.op(_tensors((args, kwargs)), results)
        self.elements[name] = self.elements.get(name, 0) + sum(r.numel() for r in results)
        self.records.append((f"{func.namespace}::{func._overloadpacket.__name__}",
                             tuple((r.dtype, tuple(r.shape)) for r in results)))
        if name in B7_OPS:
            ops, nbytes = census_op_cost(*args, **kwargs)
            self.flops_by_dtype["float32"] = self.flops_by_dtype.get("float32", 0.0) + ops
            self.bytes += nbytes
            return out
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
    (backward passes that ``fn`` runs included); on DTensors, what this
    rank executes."""
    mode = _CensusMode()
    with _per_rank(mode), mode:
        fn(*args, **kw)
    return _census(mode)


def analyze_with_memory(fn: Callable, *args, **kw) -> Tuple[Census, LiveBytes, object]:
    """:func:`analyze`, tracking live storage bytes as well: returns the
    census, this rank's :class:`LiveBytes` and ``fn``'s result."""
    tracker = _Tracker()
    arg_tensors = [_local(t) for t in _tensors((args, kw))]
    tracker.add(arg_tensors, "argument")
    flow = _Flow(arg_tensors)
    mode = _CensusMode(tracker, flow)
    try:
        with _per_rank(mode), mode:
            out = fn(*args, **kw)
        outs = [_local(t) for t in _tensors(out)]
        arg_keys = {id(t.untyped_storage()) for t in arg_tensors}
        used = flow.reaching(outs)
        memory = LiveBytes(
            argument_bytes=_distinct_tensor_bytes(
                [t for i, t in enumerate(arg_tensors) if used >> i & 1]),
            output_bytes=_distinct_tensor_bytes(outs),
            alias_bytes=_distinct_tensor_bytes(
                [t for t in outs if id(t.untyped_storage()) in arg_keys]),
            peak_bytes=tracker.peak,
            peak_by_op=dict(sorted(((k, v) for k, v in tracker.peak_by_op.items() if v > 0),
                                   key=lambda kv: -kv[1])))
    finally:
        tracker.close()
    return _census(mode), memory, out


def _census(mode: _CensusMode) -> Census:
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
