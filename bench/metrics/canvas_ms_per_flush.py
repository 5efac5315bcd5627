"""Host time the fleet spent getting a zeroed frame canvas a flush (ms):
self time of the port's ``fleet.canvas`` spans (the pool's get and the
canvas's ``zero_()``) in the traced window, over its front-end flushes."""

from benchlib.spans import self_ms_per_flush


def read(run):
    return self_ms_per_flush(run, "fleet.canvas")
