"""Process start to the opening of the window: imports, kernel build or
load, mapping, frames, warm-up and the clients' ramp (s)."""


def read(run):
    return run.setup_seconds
