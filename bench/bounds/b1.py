"""B1, ``vcgra_fused_batched``: one app a request, a tile of raw frames a
launch (the tile kernel without its chain)."""

import re

TRACE_NAME = re.compile(r"vcgra_tile_kernel<[^,<>]+, false")


def serves(stages) -> bool:
    return len(stages) == 1
