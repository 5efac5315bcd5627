"""The yardstick: operations and bytes of a request, counted from its
frame and its apps alone."""

import pytest

from benchlib.roofline import least_s, request_work
from benchlib.spec import load_json, load_module

HD = (1080, 1920)


def test_seventeen_gaussians():
    _, ops = request_work(["gauss3"] * 17, HD, "int32")
    assert ops == 306 * HD[0] * HD[1]


def test_chain17_and_its_bound():
    bytes_, ops = request_work(["gauss3"] * 16 + ["sobel_x"], HD, "int32")
    assert ops == 305 * 1920 * 1080 and bytes_ == 2 * 4 * 1920 * 1080
    # A tile of 8 such frames is bound by its operations: 0.0757 ms.
    assert least_s(8 * bytes_, 8 * ops) == pytest.approx(8 * ops / 67e12)


def test_a_1080p_frame_moves_its_pixels_once_each_way():
    assert request_work(["sobel_x"], HD, "int32")[0] == 16_588_800
    assert request_work(["sobel_x"], HD, "int16")[0] == 8_294_400


def test_table_is_the_apps_own_graphs():
    """Checked once against the port's library: the table counts each
    app's operation nodes (its products, sums, divide, compare, buffer)."""
    from repro_torch.core import applications

    table = load_json("bounds", "app_ops")["ops_per_pixel"]
    assert table == {name: len(make().nodes) for name, make in applications.ALL_APPS.items()}


@pytest.mark.parametrize("kernel,name,stages", [
    ("b1", "void vcgra_tile_kernel<int, false, true, false>(int const*)", ["sobel_x"]),
    ("b3", "void vcgra_tile_kernel<int, true, true, false>(int const*)", ["gauss3", "sobel_x"]),
])
def test_bound_files_name_their_kernel(kernel, name, stages):
    bound = load_module("bounds", kernel)
    assert bound.TRACE_NAME.search(name) and bound.serves(stages)
    other = load_module("bounds", "b3" if kernel == "b1" else "b1")
    assert not other.TRACE_NAME.search(name) and not other.serves(stages)
