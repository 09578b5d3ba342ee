"""The yardstick's work counts against the totals PERF.md gave each
kernel at the north star's shapes."""

import pytest

from lfit_bench import work


def test_k1_operations_at_the_north_star():
    # 5120 rows x 512 elements, f = 0.9316 eclipsed: 9.058 GFLOP, 135.2 us
    ops, nbytes = work.k1(5120, 512, 0.9316)
    assert ops / 1e9 == pytest.approx(9.058, abs=5e-4)
    assert nbytes == 5120 * 512 * 17 + 5120 * 24
    t, by = work.least_seconds(ops, nbytes)
    assert by == "operations" and t * 1e6 == pytest.approx(135.2, abs=0.1)


def test_k1_backward_operations():
    # 1280 x 512 at f = 0.9316: 1.088 GFLOP (883 an eclipsed edge), 16.2 us
    ops, nbytes = work.k1_backward(1280, 512, 0.9316)
    assert work.K1_BWD_OPS_EDGE == 883
    assert ops / 1e9 == pytest.approx(1.088, abs=5e-4)
    assert nbytes == 1280 * 512 * 33
    assert work.least_seconds(ops, nbytes)[0] * 1e6 == pytest.approx(
        16.2, abs=0.1)


def test_k2_operations():
    # 1024 walkers x 4352 steps: 11.97 us f32, 23.59 us f64 by operations
    for dtype, us in (("float32", 11.97), ("float64", 23.59)):
        ops, nbytes = work.k2(1024, 5, 4352, dtype=dtype)
        t, by = work.least_seconds(ops, nbytes, dtype)
        assert by == "operations" and t * 1e6 == pytest.approx(us, abs=0.01)


def test_k3_bytes():
    # 5120 series x 128 points, 5 eclipses: 5.9 MB, 1.77 us by bytes
    ops, nbytes = work.k3(5120, 128, 5)
    assert ops == 5120 * 128 * 71
    assert nbytes / 1e6 == pytest.approx(5.945, abs=1e-3)
    t, by = work.least_seconds(ops, nbytes)
    assert by == "bytes" and t * 1e6 == pytest.approx(1.77, abs=0.01)


@pytest.mark.parametrize("rows, n, widths, gops, us", [
    (5120, 960, False, 5.033, 75.1),     # K7 instant, 8 a term
    (1280, 960, True, 2.674, 39.9),      # K7 with widths, 17 a term
])
def test_k7_operations(rows, n, widths, gops, us):
    ops, nbytes = work.k7(rows, 128, n, widths)
    assert ops / 1e9 == pytest.approx(gops, abs=5e-4)
    assert work.least_seconds(ops, nbytes)[0] * 1e6 == pytest.approx(
        us, abs=0.1)


def test_k7_backward_operations():
    # 1280 x 128 x 960 with widths: 5.662 G (36 a term), 84.5 us
    ops, nbytes = work.k7_backward(1280, 128, 960, True)
    assert ops / 1e9 == pytest.approx(5.662, abs=5e-4)
    assert work.least_seconds(ops, nbytes)[0] * 1e6 == pytest.approx(
        84.5, abs=0.1)
