# SPDX-License-Identifier: CECILL-2.1
"""Radial reductions on the pixel grid.

Parity with reference maths/radial.py:38-169. The pixel-center origin
convention is ``x = arange(nx) - nx//2`` (radial.py:31-35).

Device design: the radius field, bin ids and polar sample coordinates
are generated ON-DEVICE from iota (shapes are static under jit, but the
tables are huge — materialising them as HLO constants costs minutes of
compile time for 2k^2 maps, while regenerating them costs microseconds of
VPU work). Binned means become one scatter-add segment-sum; interpolated
means one bilinear gather.
"""
from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import ops as jops

__all__ = [
    "radial_mean_binned_core",
    "radial_mean_interpolated_core",
    "binned_geometry",
    "interpolated_geometry",
]


def _inscribed_rmax(shape: tuple[int, int]) -> float:
    ny, nx = shape
    # pixel-center coords x = arange(n) - n//2 -> max|x| = n//2 (left edge)
    return float(min(nx // 2, ny // 2))


@lru_cache(maxsize=256)
def binned_geometry(shape: tuple[int, int], r_max: float | None, bin_size: float):
    """Host-side scalars for annular binning: (r_max, nbins, r_centers)."""
    if r_max is None:
        r_max = _inscribed_rmax(shape)
    if r_max <= 0:
        raise ValueError("r_max must be > 0 (or leave it as None with valid shape).")
    if bin_size <= 0:
        raise ValueError("bin_size must be > 0.")
    nbins = int(np.floor(r_max / bin_size)) + 1
    r_centers = (np.arange(nbins, dtype=np.float64) + 0.5) * float(bin_size)
    return float(r_max), nbins, r_centers


@lru_cache(maxsize=64)
def _binned_counts(shape: tuple[int, int], bin_size: float, nbins: int, dtype_str: str):
    """Per-bin pixel counts — pure geometry, so computed ONCE on host:
    the device program then needs a single scatter (the value sums)
    instead of two.

    Bin ids are computed in the SAME float precision the device program
    uses (``dtype_str``): an f64 host id paired with an f32 device id
    would bin boundary pixels differently (measured: 360 mismatched
    pixels at 2048^2 with bin_size=0.1), making sums and counts
    inconsistent."""
    ny, nx = shape
    ft = np.dtype(dtype_str).type
    x = np.arange(nx, dtype=ft) - ft(nx // 2)
    y = np.arange(ny, dtype=ft) - ft(ny // 2)
    R = np.sqrt(x[None, :] * x[None, :] + y[:, None] * y[:, None], dtype=ft)
    ids = np.floor(R / ft(bin_size)).astype(np.int64).ravel()
    counts = np.bincount(ids[ids < nbins], minlength=nbins)
    return counts.astype(np.float64)


def _radius_field(shape: tuple[int, int], dtype):
    ny, nx = shape
    x = lax.broadcasted_iota(dtype, (ny, nx), 1) - (nx // 2)
    y = lax.broadcasted_iota(dtype, (ny, nx), 0) - (ny // 2)
    return jnp.sqrt(x * x + y * y)


def radial_mean_binned_core(
    signal_2d, *, r_max: float | None = None, bin_size: float = 1.0
):
    """Annular-bin radial mean. Returns (radial[nbins], r_centers[nbins]).

    Bins with zero pixels yield NaN (reference maths/radial.py:94-96).
    """
    shape = tuple(int(s) for s in signal_2d.shape[-2:])
    _, nbins, r_centers = binned_geometry(
        shape, None if r_max is None else float(r_max), float(bin_size)
    )

    # Bin ids must be computed in the SAME dtype on device (radius field)
    # and host (_binned_counts), or boundary pixels land in different bins
    # for sums vs counts. Sub-f32 float inputs (float16/bfloat16) are
    # promoted to float32 for the id computation on both sides.
    id_dtype = (
        np.dtype(signal_2d.dtype)
        if np.dtype(signal_2d.dtype) in (np.dtype(np.float32), np.dtype(np.float64))
        else np.dtype(np.float32)
    )
    R = _radius_field(shape, id_dtype)
    ids = jnp.floor(R / bin_size).astype(jnp.int32).reshape(-1)
    # out-of-range pixels (id >= nbins) go to a discard bin
    ids = jnp.where(ids < nbins, ids, nbins)

    vals = signal_2d.reshape(-1)
    sums = jops.segment_sum(vals, ids, num_segments=nbins + 1)[:nbins]
    counts = jnp.asarray(
        _binned_counts(shape, float(bin_size), nbins, str(id_dtype)),
        dtype=signal_2d.dtype,
    )

    radial = jnp.where(counts > 0, sums / jnp.where(counts > 0, counts, 1.0), jnp.nan)
    return radial, jnp.asarray(r_centers, dtype=radial.dtype)


@lru_cache(maxsize=256)
def interpolated_geometry(
    shape: tuple[int, int],
    r_max: float | None,
    nr: int | None,
    ntheta: int | None,
):
    """Host-side scalars for polar resampling: (r_max, nr, ntheta, r)."""
    if r_max is None:
        r_max = _inscribed_rmax(shape)
    if r_max <= 0:
        raise ValueError("r_max must be > 0 (or leave it as None with valid shape).")
    if nr is None:
        nr = int(np.floor(r_max)) + 1
    if ntheta is None:
        ntheta = int(2.0 * np.pi * 180.0)  # ~1 degree sampling
    if nr <= 1:
        raise ValueError("nr must be > 1.")
    if ntheta <= 3:
        raise ValueError("ntheta must be > 3.")
    r = np.linspace(0.0, float(r_max), int(nr))
    return float(r_max), int(nr), int(ntheta), r


def radial_mean_interpolated_core(
    signal_2d,
    *,
    r_max: float | None = None,
    nr: int | None = None,
    ntheta: int | None = None,
    fill_value: float = 0.0,
    centrosymmetric: bool = False,
):
    """Polar-resampled radial mean (bilinear, high-definition).

    Returns (radial[nr], r[nr]). Matches SciPy RegularGridInterpolator
    bilinear semantics (out-of-bounds points take ``fill_value`` entirely,
    reference maths/radial.py:163-166).

    ``centrosymmetric=True`` (internal fast path for autocorrelation / PSD
    maps, which satisfy map[c+k] == map[c-k] about the shifted centre
    c = n//2): sample theta over [0, pi) only — for an (exactly)
    centro-symmetric map the theta_k and theta_k + pi bilinear samples
    mirror onto the same grid nodes with the same weights, so the half-ring
    mean IS the full-ring mean at half the gather traffic. Requires even ``ntheta`` (the default is even);
    falls back to the full circle otherwise. Public callers keep the
    default (exact equality with the composed reference semantics on
    arbitrary inputs).
    """
    shape = tuple(int(s) for s in signal_2d.shape[-2:])
    ny, nx = shape
    rm, nr_, nt_, r_np = interpolated_geometry(
        shape,
        None if r_max is None else float(r_max),
        None if nr is None else int(nr),
        None if ntheta is None else int(ntheta),
    )

    dt = signal_2d.dtype
    step = 2.0 * jnp.pi / nt_
    half = bool(centrosymmetric and nt_ % 2 == 0)
    if half:
        nt_ = nt_ // 2
    r = jnp.linspace(0.0, rm, nr_, dtype=dt)
    theta = (jnp.arange(nt_, dtype=dt)) * jnp.asarray(step, dt)

    Xs = r[:, None] * jnp.cos(theta)[None, :]
    Ys = r[:, None] * jnp.sin(theta)[None, :]

    # physical -> index coords (grid origin x[0] = -(nx//2))
    xi = (Xs + (nx // 2)).reshape(-1)
    yi = (Ys + (ny // 2)).reshape(-1)

    def _inb(x, y):
        return (x >= 0) & (x <= nx - 1) & (y >= 0) & (y <= ny - 1)

    if half:
        # Each dropped theta_k + pi sample mirrors the kept one through the
        # centre (value-equal on a symmetric map), EXCEPT for bounds: the
        # grid is asymmetric about n//2 for even n, so one member of a pair
        # can be out-of-bounds while its mirror is not (the outermost
        # ring). Reproduce the full-circle mean exactly: evaluate at
        # whichever member is in-bounds and weight by the in-bounds count.
        xm = 2.0 * (nx // 2) - xi
        ym = 2.0 * (ny // 2) - yi
        in_p = _inb(xi, yi)
        in_m = _inb(xm, ym)
        xi = jnp.where(in_p, xi, xm)
        yi = jnp.where(in_p, yi, ym)
        w = 0.5 * (in_p.astype(dt) + in_m.astype(dt))
        oob = ~(in_p | in_m)
    else:
        w = None
        oob = ~_inb(xi, yi)

    x0 = jnp.clip(jnp.floor(xi), 0, nx - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(yi), 0, ny - 2).astype(jnp.int32)
    fx = jnp.clip(xi - x0, 0.0, 1.0)
    fy = jnp.clip(yi - y0, 0.0, 1.0)

    # Four flat scalar gathers, one per bilinear corner.
    flat = signal_2d.reshape(-1)
    base = y0 * nx + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + nx]
    v11 = flat[base + nx + 1]

    vals = (
        (1 - fy) * ((1 - fx) * v00 + fx * v01)
        + fy * ((1 - fx) * v10 + fx * v11)
    )
    fill = jnp.asarray(fill_value, dtype=dt)
    vals = jnp.where(oob, fill, vals)
    if w is not None:
        vals = w * vals + (1.0 - w) * fill
    radial = vals.reshape(nr_, nt_).mean(axis=1)
    return radial, jnp.asarray(r_np, dtype=radial.dtype)
