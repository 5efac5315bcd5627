"""Port parity, the textual synthesis front-end: ``repro_torch.core.
synthesis`` against the reference's ``core/synthesis.py``.

Every source the reference's own suites synthesize
(``tests/test_pixie_dfg.py``, ``tests/test_system.py``) gives the same
DFG in both packages, and that DFG maps to identical settings
(``VCGRAConfig.to_json()``) on the Sobel grid and on the grid the
generator sizes for it.  Every rejected source raises ``SynthesisError``
in both.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import applications as r_apps
from repro.core import SOBEL_SOURCE as R_SOBEL_SOURCE
from repro.core import for_dfg as r_for_dfg
from repro.core import map_app as r_map_app
from repro.core import reference_eval as r_reference_eval
from repro.core import sobel_grid as r_sobel_grid
from repro.core import synthesize as r_synthesize
from repro.core.synthesis import SynthesisError as RSynthesisError

from repro_torch.core import (
    SOBEL_SOURCE, SynthesisError, for_dfg, map_app, reference_eval, sobel_grid,
    synthesize,
)
from repro_torch.core import applications as t_apps
from repro_torch.runtime.fleet import FleetRequest, PixieFleet

#: (name, source) of every accepted source in the reference's suites.
SOURCES = [
    ("sobel", SOBEL_SOURCE),
    ("unary_minus_and_compare", "out = (-x > y) + (x == y)"),
]
#: Every source the reference's suites expect to be rejected.
GARBAGE = ["out = foo(x)", "out = x ** 2", "for i in x: pass"]


def settings_json(cfg):
    return json.loads(cfg.to_json())


def test_sources_are_the_reference_sources():
    assert SOBEL_SOURCE == R_SOBEL_SOURCE


@pytest.mark.parametrize("name,source", SOURCES, ids=[n for n, _ in SOURCES])
def test_synthesized_graph_matches_reference(name, source):
    t_dfg, r_dfg = synthesize(name, source), r_synthesize(name, source)
    assert t_dfg.structural_hash() == r_dfg.structural_hash()
    assert list(t_dfg.inputs) == list(r_dfg.inputs)
    assert t_dfg.num_ops() == r_dfg.num_ops() and t_dfg.depth() == r_dfg.depth()


@pytest.mark.parametrize("grid_kind", ["sobel", "for_dfg"])
@pytest.mark.parametrize("name,source", SOURCES, ids=[n for n, _ in SOURCES])
def test_synthesized_settings_match_reference(name, source, grid_kind):
    """Identical settings wherever the reference maps the graph, the same
    error where it does not (the synthesized Sobel magnitude is six
    levels deep, one more than ``sobel-5x9`` has)."""
    t_dfg, r_dfg = synthesize(name, source), r_synthesize(name, source)
    if grid_kind == "sobel":
        t_grid, r_grid = sobel_grid(), r_sobel_grid()
    else:
        t_grid, r_grid = for_dfg(t_dfg, shape="rect"), r_for_dfg(r_dfg, shape="rect")
        assert t_grid.name == r_grid.name and t_grid.pes_per_level == r_grid.pes_per_level
    try:
        want = settings_json(r_map_app(r_dfg, r_grid))
    except Exception as exc:  # noqa: BLE001 -- the port must raise the same class
        with pytest.raises(Exception) as got:
            map_app(t_dfg, t_grid)
        assert type(got.value).__name__ == type(exc).__name__
        return
    assert settings_json(map_app(t_dfg, t_grid)) == want


@pytest.mark.parametrize("source", GARBAGE)
def test_garbage_raises_in_both(source):
    with pytest.raises(RSynthesisError):
        r_synthesize("bad", source)
    with pytest.raises(SynthesisError):
        synthesize("bad", source)
    assert issubclass(SynthesisError, ValueError)


def test_synthesized_sobel_evaluates_like_the_reference():
    """The reference's ``test_synthesis_sobel_equals_reference`` on both
    packages' graphs, and the unary-minus/compare source on its inputs."""
    img = np.arange(25, dtype=np.int32).reshape(5, 5)
    t_dfg = synthesize("s", SOBEL_SOURCE)
    taps = {k: v.numpy() for k, v in t_apps.stencil_inputs(torch.from_numpy(img)).items()}
    (got,) = reference_eval(t_dfg, {k: taps[k] for k in t_dfg.inputs if k in taps})
    r_dfg = r_synthesize("s", R_SOBEL_SOURCE)
    r_taps = {k: np.asarray(v) for k, v in r_apps.stencil_inputs(img).items()}
    (want,) = r_reference_eval(r_dfg, {k: r_taps[k] for k in r_dfg.inputs if k in r_taps})
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got),
                                  r_apps.sobel_magnitude_reference(img).reshape(-1))
    feed = {"x": np.array([-5, 2]), "y": np.array([1, 2])}
    (t_out,) = reference_eval(synthesize("t", SOURCES[1][1]), feed)
    (r_out,) = r_reference_eval(r_synthesize("t", SOURCES[1][1]), feed)
    np.testing.assert_array_equal(np.asarray(t_out), np.asarray(r_out))


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_synthesized_sobel_served_like_library_sobel_mag(backend):
    """``synthesize("sobel_mag", SOBEL_SOURCE)`` served through the fleet
    equals the library ``sobel_mag`` bitwise (the chip smoke's synthesis
    case, at a small size on the CPU)."""
    img = np.random.default_rng(0).integers(0, 256, (19, 23)).astype(np.int32)
    grid = for_dfg(t_apps.sobel_magnitude(), shape="rect")
    fleet = PixieFleet(default_grid=grid, backend=backend, device="cpu")
    got, want = fleet.run_many([
        FleetRequest(app=synthesize("sobel_mag", SOBEL_SOURCE), image=img),
        FleetRequest(app="sobel_mag", image=img)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, r_apps.sobel_magnitude_reference(img))
