"""Synthesis front-end: textual application description -> PE netlist.

Paper Sec. II: "the textual description of the application design is
parsed and converted into a netlist of Processing Elements (PEs)".

We accept a tiny expression language (one assignment per line, C-like
operators) and emit a :class:`repro_torch.core.dfg.DFG`:

    # comments allowed
    gx  = (p22 - p20) + 2*(p12 - p10) + (p02 - p00)
    gy  = (p22 - p02) + 2*(p21 - p01) + (p20 - p00)
    out = abs(gx) + abs(gy)

* identifiers that are never assigned become external inputs;
* numeric literals become coefficient (const) inputs;
* ``out``-prefixed targets (or the last assignment) become outputs;
* supported: ``+ - * / > ==``, ``abs(x) max(a,b) min(a,b) buf(x)``.

This is the programming-model claim of the paper: the user writes at the
abstraction level of the dataflow, not of the fabric.

A copy of the reference package's ``core/synthesis.py`` (pure Python over
:mod:`repro_torch.core.dfg`; the port may not import the reference).
"""

from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.core.dfg import DFG, Ref

_FUNCS = {"abs": "absolute", "max": "maximum", "min": "minimum", "buf": "buf"}


class SynthesisError(ValueError):
    pass


def synthesize(name: str, source: str) -> DFG:
    """Parse `source` and return the equivalent DFG netlist."""
    g = DFG(name)
    env: Dict[str, Ref] = {}
    n_const = 0

    def const_ref(value: float) -> Ref:
        nonlocal n_const
        cname = f"c{n_const}"
        n_const += 1
        return g.const(cname, value)

    def input_ref(ident: str) -> Ref:
        if ident not in env:
            env[ident] = g.input(ident)
        return env[ident]

    def emit(node: ast.expr) -> Ref:
        if isinstance(node, ast.Name):
            return env[node.id] if node.id in env else input_ref(node.id)
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, float)):
                raise SynthesisError(f"bad literal {node.value!r}")
            return const_ref(float(node.value))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return g.sub(const_ref(0.0), emit(node.operand))
            raise SynthesisError(f"unsupported unary op {ast.dump(node.op)}")
        if isinstance(node, ast.BinOp):
            a, b = emit(node.left), emit(node.right)
            if isinstance(node.op, ast.Add):
                return g.add(a, b)
            if isinstance(node.op, ast.Sub):
                return g.sub(a, b)
            if isinstance(node.op, ast.Mult):
                return g.mul(a, b)
            if isinstance(node.op, ast.Div):
                return g.div(a, b)
            raise SynthesisError(f"unsupported operator {ast.dump(node.op)}")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise SynthesisError("chained comparisons unsupported")
            a, b = emit(node.left), emit(node.comparators[0])
            if isinstance(node.ops[0], ast.Gt):
                return g.gt(a, b)
            if isinstance(node.ops[0], ast.Eq):
                return g.eq(a, b)
            raise SynthesisError(f"unsupported comparison {ast.dump(node.ops[0])}")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) or node.func.id not in _FUNCS:
                raise SynthesisError(f"unknown function {ast.dump(node.func)}")
            meth = getattr(g, _FUNCS[node.func.id])
            args = [emit(a) for a in node.args]
            return meth(*args)
        raise SynthesisError(f"unsupported syntax {ast.dump(node)}")

    try:
        tree = ast.parse(source, mode="exec")
    except SyntaxError as e:
        raise SynthesisError(str(e)) from e

    targets: List[str] = []
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            raise SynthesisError("only single-target assignments allowed")
        tgt = stmt.targets[0]
        if not isinstance(tgt, ast.Name):
            raise SynthesisError("assignment target must be a name")
        env[tgt.id] = emit(stmt.value)
        targets.append(tgt.id)

    outs = [t for t in targets if t.startswith("out")]
    if not outs and targets:
        outs = [targets[-1]]
    for t in outs:
        g.output(env[t])
    return g


SOBEL_SOURCE = """
gx  = (p22 - p20) + 2*(p12 - p10) + (p02 - p00)
gy  = (p22 - p02) + 2*(p21 - p01) + (p20 - p00)
out = abs(gx) + abs(gy)
"""
