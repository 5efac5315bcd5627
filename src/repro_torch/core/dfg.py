"""Dataflow-graph IR for Pixie applications.

The paper's toolchain input is "the data-flow graph of an application.
Nodes of a graph represent the processing element functions, while edges
show the dependencies and the dataflow between the processing elements"
(Sec. III).  External inputs are the pixel values (blue nodes in Fig. 4)
and the filter coefficients (red nodes); operations are gray nodes; the
green node is the output.

Coefficients are modelled as *const inputs*: they enter through the memory
interface VC like any input, but they carry a default value and change far
less often than pixel data — which makes them "parameters" in the
parameterized-configuration sense and therefore candidates for baking in
the specialized execution path (see ``core/specialize.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.ops import Op, SCHEDULABLE_OPS, UNARY_OPS


@dataclasses.dataclass(frozen=True)
class InRef:
    """Reference to an external (memory-interface) input by name."""

    name: str


@dataclasses.dataclass(frozen=True)
class NodeRef:
    """Reference to the output of an op node by index."""

    idx: int


Ref = Union[InRef, NodeRef]


@dataclasses.dataclass(frozen=True)
class Node:
    op: Op
    a: Ref
    b: Optional[Ref]  # None only for unary ops


class DFG:
    """A Pixie application graph with a small builder API.

    >>> g = DFG("demo")
    >>> x, y = g.input("x"), g.input("y")
    >>> g.output(g.add(g.mul(x, x), y))
    """

    def __init__(self, name: str):
        self.name = name
        self.inputs: List[str] = []
        self.const_values: Dict[str, float] = {}
        self.nodes: List[Node] = []
        self.outputs: List[Ref] = []

    # -- builders ---------------------------------------------------------

    def input(self, name: str) -> InRef:
        if name in self.inputs:
            raise ValueError(f"duplicate input {name!r}")
        self.inputs.append(name)
        return InRef(name)

    def const(self, name: str, value: float) -> InRef:
        """A coefficient input: enters through the memory VC with a default
        value; infrequently changing, hence a specialization parameter."""
        ref = self.input(name)
        self.const_values[name] = float(value)
        return ref

    def add_node(self, op: Op, a: Ref, b: Optional[Ref] = None) -> NodeRef:
        op = Op(op)
        if op not in SCHEDULABLE_OPS:
            raise ValueError(f"{op.name} is not schedulable on the grid")
        if op in UNARY_OPS:
            b = a if b is None else b
        elif b is None:
            raise ValueError(f"{op.name} needs two operands")
        for r in (a, b):
            self._check_ref(r)
        self.nodes.append(Node(op, a, b))
        return NodeRef(len(self.nodes) - 1)

    def add(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.ADD, a, b)

    def sub(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.SUB, a, b)

    def mul(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.MUL, a, b)

    def div(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.DIV, a, b)

    def gt(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.GT, a, b)

    def eq(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.EQ, a, b)

    def buf(self, a: Ref) -> NodeRef:
        return self.add_node(Op.BUF, a)

    def maximum(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.MAX, a, b)

    def minimum(self, a: Ref, b: Ref) -> NodeRef:
        return self.add_node(Op.MIN, a, b)

    def absolute(self, a: Ref) -> NodeRef:
        return self.add_node(Op.ABS, a)

    def output(self, ref: Ref) -> None:
        self._check_ref(ref)
        self.outputs.append(ref)

    # -- queries ----------------------------------------------------------

    def _check_ref(self, r: Ref) -> None:
        if isinstance(r, InRef):
            if r.name not in self.inputs:
                raise ValueError(f"unknown input {r.name!r}")
        elif isinstance(r, NodeRef):
            if not (0 <= r.idx < len(self.nodes)):
                raise ValueError(f"unknown node {r.idx}")
        else:
            raise TypeError(f"bad ref {r!r}")

    def validate(self) -> None:
        if not self.outputs:
            raise ValueError(f"DFG {self.name!r}: no outputs")
        for n in self.nodes:
            self._check_ref(n.a)
            self._check_ref(n.b)
        # Builder order guarantees acyclicity (a node may only reference
        # earlier nodes), assert it anyway:
        for i, n in enumerate(self.nodes):
            for r in (n.a, n.b):
                if isinstance(r, NodeRef) and r.idx >= i:
                    raise ValueError(f"node {i} references later node {r.idx}")

    def asap_levels(self) -> List[int]:
        """ASAP levelization: level(node) = 1 + max(level(preds)); external
        inputs live at level -1 (the memory-interface VC feeds level 0).

        Data flows strictly top-to-bottom (paper Fig. 2), so this is the
        earliest pipeline stage each op can execute in.
        """
        levels: List[int] = []
        for n in self.nodes:
            lp = -1
            for r in (n.a, n.b):
                if isinstance(r, NodeRef):
                    lp = max(lp, levels[r.idx])
            levels.append(lp + 1)
        return levels

    def depth(self) -> int:
        lv = self.asap_levels()
        return (max(lv) + 1) if lv else 0

    def num_ops(self) -> int:
        return len(self.nodes)

    def op_histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {}
        for n in self.nodes:
            h[n.op.name] = h.get(n.op.name, 0) + 1
        return h

    def structural_hash(self) -> str:
        """Stable content hash of the graph (name, inputs, consts, nodes,
        outputs).  Two DFGs with equal hashes map to identical settings on
        a given grid, so the hash is the cache key that lets a multi-tenant
        runtime skip place/route for repeat tenants (see runtime/fleet.py).

        The preimage is JSON, not delimiter-joined strings: names may
        contain any character without creating cross-field collisions."""
        import hashlib
        import json

        def ref_key(r: Optional[Ref]):
            if r is None:
                return None
            if isinstance(r, InRef):
                return ["i", r.name]
            return ["n", r.idx]

        doc = {
            "name": self.name,
            "inputs": self.inputs,
            "consts": {k: self.const_values[k] for k in sorted(self.const_values)},
            "nodes": [[n.op.name, ref_key(n.a), ref_key(n.b)] for n in self.nodes],
            "outputs": [ref_key(r) for r in self.outputs],
        }
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def consumers(self) -> Dict[Ref, List[int]]:
        out: Dict[Ref, List[int]] = {}
        for i, n in enumerate(self.nodes):
            for r in {n.a, n.b}:
                out.setdefault(r, []).append(i)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"DFG({self.name!r}, inputs={len(self.inputs)}, "
            f"nodes={len(self.nodes)}, outputs={len(self.outputs)}, "
            f"depth={self.depth()})"
        )


def reference_eval(
    dfg: DFG, inputs: Dict[str, "object"]
) -> List["object"]:
    """Pure-Python/numpy oracle evaluation of a DFG (used by tests and as
    the semantic ground truth for the interpreter/specializer/kernels)."""
    import numpy as np

    env: Dict[str, object] = {}
    for name in dfg.inputs:
        if name in inputs:
            env[name] = np.asarray(inputs[name])
        elif name in dfg.const_values:
            env[name] = np.asarray(dfg.const_values[name])
        else:
            raise KeyError(f"missing input {name!r}")

    def get(r: Ref):
        if isinstance(r, InRef):
            return env[r.name]
        return vals[r.idx]

    vals: List[object] = []
    for n in dfg.nodes:
        a = get(n.a)
        b = get(n.b)
        if n.op == Op.ADD:
            v = a + b
        elif n.op == Op.SUB:
            v = a - b
        elif n.op == Op.MUL:
            v = a * b
        elif n.op == Op.DIV:
            if np.issubdtype(np.asarray(a).dtype, np.integer):
                v = np.where(b == 0, 0, a // np.where(b == 0, 1, b))
            else:
                v = np.where(b == 0, 0.0, a / np.where(b == 0, 1.0, b))
        elif n.op == Op.GT:
            v = (a > b).astype(np.asarray(a).dtype)
        elif n.op == Op.EQ:
            v = (a == b).astype(np.asarray(a).dtype)
        elif n.op == Op.BUF:
            v = a
        elif n.op == Op.MAX:
            v = np.maximum(a, b)
        elif n.op == Op.MIN:
            v = np.minimum(a, b)
        elif n.op == Op.ABS:
            v = np.abs(a)
        else:  # pragma: no cover
            raise ValueError(n.op)
        vals.append(v)
    return [get(r) for r in dfg.outputs]
