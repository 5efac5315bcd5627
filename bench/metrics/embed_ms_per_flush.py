"""Host time the fleet spent writing the tile's frames into the canvas a
flush (ms): self time of the port's ``fleet.embed`` spans in the traced
window, over its front-end flushes."""

from benchlib.spans import self_ms_per_flush


def read(run):
    return self_ms_per_flush(run, "fleet.embed")
