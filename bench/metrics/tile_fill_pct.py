"""Requests a dispatch served, over the tile's slots (%): ``FleetStats``'
``executed`` over ``dispatches`` x ``batch_tile`` across the window."""


def read(run):
    dispatches = run.delta("dispatches")
    if dispatches <= 0:
        return None
    return 100.0 * run.delta("executed") / (dispatches * run.batch_tile)
