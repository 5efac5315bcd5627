"""The plain reference equals the port's eager ``backend="torch"`` path on
small frames of 16-bit samples, for every app and chain of the cells."""

import numpy as np
import pytest

from pairs import PAIRS, pair

from benchlib import traffic as tr
from benchlib.spec import load_module
from benchlib.system import build_grid

SIZES = [(37, 53), (1, 9), (5, 130)]


@pytest.mark.parametrize("config,traffic", PAIRS)
def test_reference_equals_the_port(config, traffic):
    import torch
    from repro_torch.serve import FleetFrontend

    cell = pair(config, traffic)
    ref = load_module("reference", cell.config["reference"])
    grid = build_grid(cell.config)
    svc = FleetFrontend(backend="torch", device="cpu")
    gen = tr.rng(7, 0)
    works = {tr.work_key(w): w for w in cell.traffic["mix"]}
    for hw in SIZES:
        frame = gen.integers(0, 1 << cell.traffic["sample_bits"], hw, dtype=np.int32)
        handles = {key: svc.submit(work, frame, grid=grid) for key, work in works.items()}
        svc.flush()
        for key, handle in handles.items():
            got = np.asarray(handle.result())
            want = ref.run(key.split("+"), torch.as_tensor(frame)).numpy()
            assert got.shape == want.shape and np.array_equal(got.astype(np.int64), want), key


def test_int16_differs_on_16_bit_samples():
    """The control's grid: an int16 grid cannot carry 16-bit samples, so
    its answers leave the reference's."""
    import torch
    from repro_torch.serve import FleetFrontend

    cell = pair("sobel-5x9", "fleet-1080p")
    ref = load_module("reference", cell.config["reference"])
    grid = build_grid(cell.config, "int16")
    svc = FleetFrontend(backend="torch", device="cpu")
    frame = tr.rng(8, 0).integers(0, 1 << 16, (37, 53), dtype=np.int32)
    for app in sorted(set(cell.traffic["mix"])):
        got = np.asarray(svc.submit(app, frame, grid=grid).result()).astype(np.int64)
        assert not np.array_equal(got, ref.run([app], torch.as_tensor(frame)).numpy()), app
