# SPDX-License-Identifier: CECILL-2.1
"""Rank filters (median) on-device.

Parity target: ``scipy.ndimage.median_filter(x, size=k, mode="reflect")``
(reference preprocessing/normalize.py:136, utils/range.py:36,71,78). SciPy's
"reflect" duplicates edges -> ``jnp.pad(mode="symmetric")``.

Implementation: gather the k*k shifted windows of the padded image and take
their median. The 3x3 case (flat-field bad-pixel repair, the common one)
evaluates Paeth's 19-exchange median-of-9 network over the nine shifted
slices: branch-free min/max that XLA fuses with the slices into one pass,
no materialised window stack and no sort. Other sizes stack the windows
and take ``jnp.median``.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["median_filter2d"]


def _median9(v):
    """Median of 9 same-shaped arrays via Paeth's 19-exchange network."""
    v = list(v)

    def sort2(i, j):
        lo = jnp.minimum(v[i], v[j])
        hi = jnp.maximum(v[i], v[j])
        v[i], v[j] = lo, hi

    sort2(1, 2); sort2(4, 5); sort2(7, 8)
    sort2(0, 1); sort2(3, 4); sort2(6, 7)
    sort2(1, 2); sort2(4, 5); sort2(7, 8)
    sort2(0, 3); sort2(5, 8); sort2(4, 7)
    sort2(3, 6); sort2(1, 4); sort2(2, 5)
    sort2(4, 7); sort2(4, 2); sort2(6, 4)
    sort2(4, 2)
    return v[4]


def median_filter2d(x, size: int = 3):
    """Median filter over the last two axes with an odd square window."""
    k = int(size)
    if k < 1 or k % 2 == 0:
        raise ValueError("size must be a positive odd integer.")
    if k == 1:
        return x

    h = k // 2
    pad = [(0, 0)] * (x.ndim - 2) + [(h, h), (h, h)]
    p = jnp.pad(x, pad, mode="symmetric")
    H, W = x.shape[-2], x.shape[-1]

    windows = [
        p[..., dy : dy + H, dx : dx + W] for dy in range(k) for dx in range(k)
    ]
    if k == 3:
        return _median9(windows)
    return jnp.median(jnp.stack(windows, axis=0), axis=0)
