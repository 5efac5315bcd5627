"""Host time the fleet spent in the executable's call a flush (ms): self
time of the port's ``fleet.launch`` spans (the plan's packing of the
stages' settings and the kernels' launches) in the traced window, over its
front-end flushes."""

from benchlib.spans import self_ms_per_flush


def read(run):
    return self_ms_per_flush(run, "fleet.launch")
