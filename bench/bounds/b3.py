"""B3, ``vcgra_pipeline_batched``: a chain of apps a request, a tile of raw
frames a launch or one a segment of the chain (the tile kernel's chain
instance); the intermediates never leave the card."""

import re

TRACE_NAME = re.compile(r"vcgra_tile_kernel<[^,<>]+, true")


def serves(stages) -> bool:
    return len(stages) > 1
