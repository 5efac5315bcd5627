"""Device time of the copies to and from the card a dispatch (ms): the
trace's ``Memcpy HtoD`` and ``Memcpy DtoH`` over the dispatches."""

import re

COPIES = re.compile(r"^Memcpy (HtoD|DtoH)")


def read(run):
    dispatches = run.delta("dispatches")
    if run.trace is None or dispatches <= 0:
        return None
    return 1e3 * run.trace.device_s(COPIES) / dispatches
