# SPDX-License-Identifier: CECILL-2.1
"""Exact order statistics without sorting.

Percentiles and medians only need a handful of order statistics, so
instead of sorting we find them by binary search on the *bit pattern*: the
IEEE-754 total order maps monotonically onto unsigned integers, and 32/64
counting passes (cheap fused VPU reductions) pin down the exact k-th smallest
value. Results match ``np.nanpercentile(..., method="linear")`` bit-for-bit
modulo the final interpolation arithmetic.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["nanquantiles_exact", "nanpercentiles_exact", "nanmedian_exact", "median_exact"]


def _sortable_bits(x):
    """Map floats to unsigned ints preserving numeric order (NaNs excluded
    by callers via masks)."""
    if x.dtype == jnp.float64:
        u = jax.lax.bitcast_convert_type(x, jnp.uint64)
        sign = jnp.uint64(1) << jnp.uint64(63)
        full = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    else:
        u = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
        sign = jnp.uint32(1) << jnp.uint32(31)
        full = jnp.uint32(0xFFFFFFFF)
    return jnp.where((u & sign) != 0, full - u, u | sign)


def _bits_to_float(u, dtype):
    if dtype == jnp.float64:
        sign = jnp.uint64(1) << jnp.uint64(63)
        full = jnp.uint64(0xFFFFFFFFFFFFFFFF)
        raw = jnp.where((u & sign) != 0, u ^ sign, full - u)
        return jax.lax.bitcast_convert_type(raw, jnp.float64)
    sign = jnp.uint32(1) << jnp.uint32(31)
    full = jnp.uint32(0xFFFFFFFF)
    raw = jnp.where((u & sign) != 0, u ^ sign, full - u)
    return jax.lax.bitcast_convert_type(raw, jnp.float32)


def _order_stats_bits(u, finite, ks, nbits: int):
    """Smallest bit value v_k with count(finite & u <= v_k) >= k+1, for each
    rank in ``ks`` (traced ints, shape (R,)). Returns (R,) bit values."""
    utype = u.dtype
    zero = jnp.zeros((), utype)

    def body(i, state):
        lo, hi = state  # invariants: f(hi) >= k+1, f(lo - 1) < k+1 (lo > 0)
        mid = lo + (hi - lo) // 2
        # counting pass shared across ranks: (npix, 1) <= (1, R)
        cnt = jnp.sum(
            (finite[:, None]) & (u[:, None] <= mid[None, :]), axis=0
        )
        ge = cnt >= (ks + 1)
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
        return lo, hi

    R = ks.shape[0]
    lo0 = jnp.full((R,), zero, utype)
    hi0 = jnp.full((R,), ~zero, utype)
    lo, hi = jax.lax.fori_loop(0, nbits + 1, body, (lo0, hi0))
    return hi


def _order_stats_int(x, valid, ks, lo_v: int, hi_v: int, nsteps: int):
    """Integer-value-space variant of :func:`_order_stats_bits`: when every
    finite value is an integer in [lo_v, hi_v] (e.g. uint16 detector counts
    cast to float), the k-th order statistic IS an integer in that range,
    so the binary search runs over integer thresholds — ceil(log2(span))+1
    counting passes instead of 32/64 (17 for uint16: ~2x fewer full-array
    reads). Exact under the caller's integer-valued contract; thresholds
    stay exactly representable (span < 2^24 enforced by the caller)."""
    def body(i, state):
        lo, hi = state
        mid = lo + (hi - lo) // 2
        thr = mid.astype(x.dtype)
        cnt = jnp.sum(valid[:, None] & (x[:, None] <= thr[None, :]), axis=0)
        ge = cnt >= (ks + 1)
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
        return lo, hi

    R = ks.shape[0]
    lo0 = jnp.full((R,), lo_v, jnp.int32)
    hi0 = jnp.full((R,), hi_v, jnp.int32)
    _lo, hi = jax.lax.fori_loop(0, nsteps, body, (lo0, hi0))
    return hi.astype(x.dtype)


def nanquantiles_exact(x, qs: tuple[float, ...], *, integer_range=None):
    """Exact nan-aware quantiles (q in [0, 1]) with linear interpolation.

    Returns an array of shape (len(qs),) in x's dtype. All-NaN input yields
    NaNs. Like ``np.nanpercentile``, only NaNs are excluded — infinities
    participate in the ranking (the bit-pattern total order places them at
    the extremes). One deliberate improvement over numpy: an exact hit on
    an infinite order statistic returns that infinity, where numpy's lerp
    produces NaN (with RuntimeWarnings) from ``inf + 0*(inf - inf)``.

    Rank arithmetic runs in float64 when x64 is enabled (bit-exact order
    statistic selection at any size). On float32-only backends the rank
    ``q*(n-1)`` itself rounds at ~2^22 elements, so for >4M-pixel inputs
    the selected PAIR of order statistics can be off by one — a value-level
    error bounded by one inter-sample gap at that quantile (negligible for
    dense detector data, noted here for exactness bookkeeping).

    ``integer_range=(lo, hi)`` is a caller CONTRACT that every finite value
    is an integer in [lo, hi] (e.g. uint16 detector frames cast to float):
    the order-statistic search then bisects integer thresholds —
    ceil(log2(hi-lo+1))+1 counting passes instead of 32/64. Fractional or
    out-of-range values under the hint break exactness silently.
    """
    import math

    import jax

    x = x.reshape(-1)
    dtype = x.dtype
    nbits = 64 if dtype == jnp.float64 else 32

    valid = ~jnp.isnan(x)
    n = jnp.sum(valid)
    nf = jnp.maximum(n, 1)

    if integer_range is not None:
        lo_v, hi_v = (int(v) for v in integer_range)
        if not (lo_v <= hi_v and hi_v - lo_v < (1 << 24) and abs(lo_v) < (1 << 24)):
            raise ValueError(
                "integer_range must satisfy lo <= hi with span/magnitude "
                "< 2^24 (float32-exact thresholds)"
            )
        nsteps = max(1, math.ceil(math.log2(hi_v - lo_v + 1))) + 1
    else:
        u = _sortable_bits(jnp.where(valid, x, 0.0))

    rank_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    qarr = jnp.asarray(qs, dtype=rank_dtype)
    rank = qarr * (nf - 1).astype(rank_dtype)
    lo_k = jnp.floor(rank).astype(jnp.int64 if nbits == 64 else jnp.int32)
    hi_k = jnp.ceil(rank).astype(lo_k.dtype)
    frac = (rank - jnp.floor(rank)).astype(dtype)

    ks = jnp.concatenate([lo_k, hi_k])
    if integer_range is not None:
        vals = _order_stats_int(x, valid, ks, lo_v, hi_v, nsteps)
    else:
        vals_bits = _order_stats_bits(u, valid, ks, nbits)
        vals = _bits_to_float(vals_bits, dtype)
    R = len(qs)
    v_lo, v_hi = vals[:R], vals[R:]

    out = v_lo + frac * (v_hi - v_lo)
    # equal endpoints short-circuit the lerp: keeps inf quantiles inf
    # (inf + 0*(inf-inf) would be NaN) and exact-index picks exact
    out = jnp.where(v_lo == v_hi, v_lo, out)
    return jnp.where(n > 0, out, jnp.nan).astype(dtype)


def nanpercentiles_exact(x, ps: tuple[float, ...], *, integer_range=None):
    """Exact nan-aware percentiles (p in [0, 100])."""
    return nanquantiles_exact(
        x, tuple(p / 100.0 for p in ps), integer_range=integer_range
    )


def nanmedian_exact(x):
    """Exact nan-aware median (scalar)."""
    return nanquantiles_exact(x, (0.5,))[0]


def median_exact(x):
    """Exact median of an array assumed free of NaNs (scalar)."""
    return nanmedian_exact(x)
