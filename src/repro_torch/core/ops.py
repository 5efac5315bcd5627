"""Processing-Element opcodes and semantics for the Pixie VCGRA, on tensors.

The paper's PE applies one configured operation to its two equal-width
inputs: arithmetic (Add, Sub, Mul, Div), comparison (Gt, Eq), BUF (copy,
used to carry values across levels) and NONE (idle).  MAX, MIN and ABS are
extension opcodes; MAC has semantics but is never scheduled by the mapper.

Two forms, as in the reference package:

* ``apply_op``      -- *specialized*: the opcode is a Python constant and
                       only that functional unit runs;
* ``apply_generic`` -- *conventional*: the opcode is a tensor (one per PE
                       lane) and the result is selected per lane.

Both are bitwise twins of the JAX reference on int32, int16 and float32
(the parity contract): integer DIV is floor division with a guarded
divisor, ``INT_MIN // -1`` is ``INT_MIN`` (XLA's definition; C++ and
torch-CPU would trap), integers wrap, GT/EQ return 1/0 in the data type and
MAX/MIN propagate NaN.
"""

from __future__ import annotations

import enum

import torch


class Op(enum.IntEnum):
    """PE opcodes. Values are the settings-register encoding."""

    NONE = 0   # idle: PE produces no output, does not raise valid
    ADD = 1
    SUB = 2
    MUL = 3
    DIV = 4
    GT = 5     # a > b  -> 1/0 in the data type
    EQ = 6     # a == b -> 1/0 in the data type
    BUF = 7    # copy: both inputs carry the same value (paper Sec III-A)
    MAX = 8    # extension op
    MIN = 9    # extension op
    ABS = 10   # extension op (unary; port b ignored)
    MAC = 11   # experimental, not schedulable by the mapper (paper Sec III-A)


#: Opcodes the place-and-route flow may schedule onto the grid.
SCHEDULABLE_OPS = frozenset(
    {Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.GT, Op.EQ, Op.BUF, Op.MAX, Op.MIN, Op.ABS}
)

#: Opcodes whose second input port is ignored.
UNARY_OPS = frozenset({Op.ABS, Op.BUF, Op.NONE})


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Division with a guarded divisor: 0 where the divisor is 0.

    Integer grids floor-divide, float grids divide exactly (IEEE).  The
    integer ``INT_MIN // -1`` case divides by 1 instead, which gives
    XLA's defined result (``INT_MIN``) without the host trap.
    """
    zero = b == 0
    if a.dtype.is_floating_point:
        return torch.where(zero, 0, a / torch.where(zero, 1, b))
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    q = torch.div(a, torch.where(zero | overflow, 1, b), rounding_mode="floor")
    return torch.where(zero, 0, q)


def _unit(op: Op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == Op.ADD:
        return a + b
    if op == Op.SUB:
        return a - b
    if op == Op.MUL:
        return a * b
    if op == Op.DIV:
        return _safe_div(a, b)
    if op == Op.GT:
        return (a > b).to(a.dtype)
    if op == Op.EQ:
        return (a == b).to(a.dtype)
    if op == Op.BUF:
        return a
    if op == Op.MAX:
        return torch.maximum(a, b)
    if op == Op.MIN:
        return torch.minimum(a, b)
    if op == Op.ABS:
        return torch.abs(a)
    raise ValueError(f"opcode {op!r} has no combinational semantics")


def apply_op(op: Op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Specialized PE: ``op`` is a Python constant; emit only its unit."""
    op = Op(op)
    if op == Op.NONE:
        return torch.zeros_like(a)
    return _unit(op, a, b)


#: The units ``apply_generic`` muxes between, in the reference's order.
_GENERIC_UNITS = (
    Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.GT, Op.EQ, Op.BUF, Op.MAX, Op.MIN, Op.ABS,
)


def apply_generic(opcode: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Conventional PE: each lane's opcode selects its unit's result.

    ``opcode`` has shape ``a.shape[:-1]`` (one opcode per PE lane) or
    broadcasts against ``a``/``b``.  NONE, MAC and any opcode outside the
    unit set give 0, exactly like the reference's mux chain.  Units no lane
    selects are skipped (one host read of the opcodes per call): the
    result is the same, and the oracle stays within device memory at
    full-frame sizes.
    """
    if opcode.dim() == a.dim() - 1:
        opcode = opcode[..., None]
    present = set(torch.unique(opcode).tolist())
    out = torch.zeros_like(a)
    for op in _GENERIC_UNITS:
        if int(op) in present:
            out = torch.where(opcode == int(op), _unit(op, a, b), out)
    return out

