# SPDX-License-Identifier: CECILL-2.1
"""3x3 median (ops/rank.py): the fused min/max network against SciPy.

``median_filter2d`` evaluates Paeth's median-of-9 network over the nine
shifted slices of the symmetric-padded frame; SciPy's
``median_filter(mode="reflect")`` is the reference semantics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from barc4dip_tpu.ops.rank import _median9, median_filter2d


def test_median9_network_matches_sort(rng):
    vals = [jnp.asarray(rng.normal(size=(16, 16)).astype(np.float32)) for _ in range(9)]
    got = np.asarray(_median9(vals))
    want = np.median(np.stack([np.asarray(v) for v in vals]), axis=0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (64, 64), (200, 130), (67, 257)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_median3x3_matches_scipy(rng, shape, dtype):
    x = rng.normal(size=shape).astype(dtype)
    got = np.asarray(jax.jit(median_filter2d)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ndimage.median_filter(x, size=3, mode="reflect"))


def test_median3x3_ties_and_integers(rng):
    """Heavy ties (integer counts) and an integer dtype stay exact."""
    x = rng.integers(0, 4, size=(50, 61)).astype(np.uint16)
    got = np.asarray(median_filter2d(jnp.asarray(x)))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ndimage.median_filter(x, size=3, mode="reflect"))


def test_median3x3_batched_frames(rng):
    x = rng.normal(size=(3, 40, 33)).astype(np.float32)
    got = np.asarray(median_filter2d(jnp.asarray(x)))
    for k in range(3):
        np.testing.assert_array_equal(
            got[k], ndimage.median_filter(x[k], size=3, mode="reflect")
        )


def test_median3x3_nan_propagates_like_sort(rng):
    """A NaN in a window poisons that window's median, as in the
    sort-based median the other sizes use."""
    x = rng.normal(size=(20, 20))
    x[7, 9] = np.nan
    net = np.asarray(median_filter2d(jnp.asarray(x)))
    p = np.pad(x, 1, mode="symmetric")
    stack = np.stack([p[dy : dy + 20, dx : dx + 20] for dy in range(3) for dx in range(3)])
    sort = np.median(stack, axis=0)
    np.testing.assert_array_equal(np.isnan(net), np.isnan(sort))
    np.testing.assert_array_equal(net[~np.isnan(net)], sort[~np.isnan(sort)])


@pytest.mark.parametrize("size", [1, 5])
def test_other_sizes_match_scipy(rng, size):
    x = rng.normal(size=(30, 41))
    got = np.asarray(median_filter2d(jnp.asarray(x), size=size))
    np.testing.assert_array_equal(got, ndimage.median_filter(x, size=size, mode="reflect"))


def test_even_size_rejected():
    with pytest.raises(ValueError, match="odd"):
        median_filter2d(jnp.zeros((4, 4)), size=4)
