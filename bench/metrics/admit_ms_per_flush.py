"""Host time the front end's worker spent handing a selected batch to the
fleet a flush (ms): the port's ``frontend.admit`` spans (``fleet.submit``
of each request: mapping lookups, the chain's spec) in the traced window,
over its front-end flushes."""

from benchlib.spans import ms_per_flush


def read(run):
    return ms_per_flush(run, "frontend.admit")
