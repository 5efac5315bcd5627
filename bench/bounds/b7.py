"""B7, ``flash_decode``: one decode token's attention over each slot's
cached rows, every layer of a tick (the tensor-core body, or the CUDA-core
one, then the combine of its splits).

The least bytes of a tick are counted from the slots it decoded for
requests alone: each slot's query and output (``H`` heads of ``hd``) once,
and the ``k`` and ``v`` rows of its prompt and output so far (``G`` heads
of ``hd``) once, in the served element size, in every layer.  A slot with
no request, which B7 also reads, counts nothing.
"""

import re

TRACE_NAME = re.compile(r"flash_decode_(tc|partial|combine)")


def tick_bytes(model: dict, active: int, kv_rows: int, itemsize: int = 2) -> float:
    """Least bytes B7 moves in one tick of ``active`` slots attending over
    ``kv_rows`` cached rows in all."""
    heads, kv_heads, hd = (int(model[k]) for k in
                           ("num_attention_heads", "num_key_value_heads", "head_dim"))
    per_layer = 2 * active * heads * hd + 2 * kv_rows * kv_heads * hd
    return float(int(model["num_hidden_layers"]) * per_layer * itemsize)
