"""Host time the fleet spent packing a dispatch (ms): ``PixieFleet.
timings["pack_s"]`` across the window, over the dispatches."""


def read(run):
    dispatches = run.delta("dispatches")
    if dispatches <= 0:
        return None
    return 1e3 * run.delta("pack_s") / dispatches
