"""The operation and byte counts behind every roofline share, at one shape
each, against arithmetic done by hand."""
from __future__ import annotations

import pytest


def test_band_terms_by_hand():
    from portbench.core import work

    # n = 5, b = 1: rows 0 and 4 have 2 terms, rows 1-3 have 3
    assert work.band_terms(1, 5) == 13
    assert work.band_terms(0, 7) == 7
    assert work.band_terms(10, 4) == 16  # a band wider than the grid: dense


def test_k1_launches_by_hand():
    from portbench.core import work

    c, m, b, n = 2, 3, 1, 5
    pair, single, single_t, pair_t = work.k1_launches(c, m, b, n)
    assert pair == (2 * 2 * c * m * 13, 4 * (2 * m * 3 * n + 3 * c * m * n))
    assert single == single_t == (2 * c * m * 13, 4 * (m * 3 * n + 2 * c * m * n))
    assert pair_t == (2 * 2 * c * m * 13, 4 * (2 * m * 3 * n + 3 * c * m * n))


def test_centered_vg_and_product_by_hand():
    from portbench.core import work

    flops, nbytes = work.centered_vg(c=2, n=5, b=1, dim=13, m=2, n_scalars=15)
    assert flops == 2 * 6 * 2 * 2 * 13
    assert nbytes == 4 * (2 * 2 * 13 + 2 + 6 * 2 * 3 * 5 + 5 * 2 * 5 + 15)
    assert work.dense_product(3, 4) == (2 * 3 * 16, 4 * (16 + 2 * 3 * 4))
    assert work.dense_product(3, 4, n_mats=2) == (2 * 3 * 16, 4 * (32 + 2 * 3 * 4))


def test_least_time_takes_the_larger_bound():
    from portbench.core import work

    assert work.least_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.least_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_slice_leaf_counts():
    """[slice]'s shapes (128 chains, n 397, b 40, dim 799): both kernels are
    bound by their operations, at the least times the port's own timing
    scripts give (``perf/vg_timing.py`` 0.0014 ms, ``perf/product_timing.py``
    0.00244 ms)."""
    from portbench.core import work

    vg = work.centered_vg(128, 397, 40, 799)
    assert vg[0] / work.PEAK_FLOPS > vg[1] / work.PEAK_BYTES
    assert work.least_s(*vg) == pytest.approx(1.40e-6, rel=0.01)
    mm = work.dense_product(128, 799)
    assert mm[0] == 2 * 128 * 799 ** 2
    assert work.least_s(*mm) == pytest.approx(2.44e-6, rel=0.01)
