# SPDX-License-Identifier: CECILL-2.1
"""Dense windowed ZNCC displacement fields (X-ray speckle tracking core).

Extension beyond the reference: barc4dip tracks a single 3x3 ROI grid per
frame (reference metrics/speckles.py:332-386); synchrotron speckle-tracking
instruments (XST) need a DENSE displacement map — one (dy, dx) per
sub-aperture on a regular grid — which then integrates into a wavefront.
This module is the device kernel: thousands of windowed zero-normalised
cross-correlations in ONE jitted program.

Device shape: both full images upload once and everything below is one
jitted program per grid geometry. Two interchangeable correlation cores
(same NCC field to float tolerance):

- ``fft`` (default): batched small rfft2/irfft2 over all grid nodes —
  the faster core on the GPU (cuFFT) and on the CPU;
- ``conv``: one grouped correlation, one filter per node, at full fp32
  (``precision=HIGHEST``; TF32 would cost the NCC ~3 digits).

Both images are globally z-scored first: NCC is affine-invariant, and raw
detector counts (sums ~1e11 in the window-variance cancellation) otherwise
destroy float32 precision.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import ncc as ncc_ops
from . import phasecorr as pc_ops

__all__ = ["grid_starts", "dense_track_program", "resolve_track_method"]


def grid_starts(
    H: int, W: int, tile: int, search: int, step: int
) -> tuple[np.ndarray, np.ndarray]:
    """Tile start positions (y0s, x0s) of a regular tracking grid.

    Starts are chosen so each tile's search window (side ``tile + 2*search``)
    stays fully inside the frame; the grid covers the largest centred span
    with the requested step.
    """
    if tile < 3:
        raise ValueError("tile_size must be >= 3 px.")
    if search < 1:
        raise ValueError("search_radius must be >= 1 px.")
    if step < 1:
        raise ValueError("step must be >= 1 px.")
    lo_y, hi_y = search, H - tile - search
    lo_x, hi_x = search, W - tile - search
    if hi_y < lo_y or hi_x < lo_x:
        raise ValueError(
            f"frame ({H}, {W}) too small for tile_size={tile} with "
            f"search_radius={search}."
        )
    y0s = np.arange(lo_y, hi_y + 1, step, dtype=np.int32)
    x0s = np.arange(lo_x, hi_x + 1, step, dtype=np.int32)
    # centre the grid's leftover margin
    y0s = y0s + (hi_y - y0s[-1]) // 2
    x0s = x0s + (hi_x - x0s[-1]) // 2
    return y0s, x0s


_METHODS = ("conv", "fft")


def resolve_track_method(method: str = "auto") -> str:
    """Resolve ``"auto"`` to the concrete correlation core: ``"fft"``,
    the faster core on every supported platform."""
    if method == "auto":
        return "fft"
    if method not in _METHODS:
        raise ValueError(
            f"method must be 'auto', 'conv' or 'fft'; got {method!r}"
        )
    return method


def dense_track_program(
    H: int, W: int, tile: int, search: int, step: int, subpixel: bool,
    method: str = "auto",
):
    """One jitted program: (img, ref, eps) -> (dy, dx, peak) on the grid.

    ``ref`` provides the tiles (the undisturbed speckle pattern), ``img``
    the search windows; displacements are img-relative-to-ref in pixels.
    Outputs have shape (len(y0s), len(x0s)).

    ``method``: "fft" (batched small FFTs), "conv" (grouped correlation)
    or "auto" (= "fft"). Both produce the same NCC map to float tolerance.
    ``"auto"`` is resolved before the program cache, so one program serves
    both spellings.
    """
    return _dense_track_program(
        H, W, tile, search, step, subpixel, resolve_track_method(method)
    )


@lru_cache(maxsize=32)
def _dense_track_program(
    H: int, W: int, tile: int, search: int, step: int, subpixel: bool,
    method: str,
):
    s, r = int(tile), int(search)
    w = s + 2 * r
    y0s, x0s = grid_starts(H, W, s, r, step)
    gy, gx = len(y0s), len(x0s)

    # static gather indices: tiles (gy, gx, s, s), windows (gy, gx, w, w)
    ty = (y0s[:, None] + np.arange(s)[None, :]).astype(np.int32)  # (gy, s)
    tx = (x0s[:, None] + np.arange(s)[None, :]).astype(np.int32)  # (gx, s)
    wy = (y0s[:, None] - r + np.arange(w)[None, :]).astype(np.int32)
    wx = (x0s[:, None] - r + np.arange(w)[None, :]).astype(np.int32)

    N = gy * gx
    dn = ("NCHW", "OIHW", "NCHW")
    hi = lax.Precision.HIGHEST

    def peak_of(corr):
        i, j = pc_ops.argmax2d(corr)
        di = dj = jnp.zeros((), corr.dtype)
        if subpixel:
            di, dj = pc_ops.subpixel_taylor(corr, i, j, convention="newton")
        dy = i.astype(corr.dtype) + di - float(r)
        dx = j.astype(corr.dtype) + dj - float(r)
        return dy, dx, corr[i, j]

    @jax.jit
    def program(img, ref, eps):
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        if ref.dtype != img.dtype:
            ref = ref.astype(img.dtype)
        # global z-score per image (nan-aware, like the stack tracker's
        # prep): NCC-invariant, fixes f32 conditioning; dead pixels (NaN)
        # become 0 = the global mean, the same neutral fill the reference's
        # flat-field repair converges to
        img = jnp.nan_to_num(
            (img - jnp.nanmean(img)) / (jnp.nanstd(img) + eps)
        )
        ref = jnp.nan_to_num(
            (ref - jnp.nanmean(ref)) / (jnp.nanstd(ref) + eps)
        )

        tiles = ref[ty[:, None, :, None], tx[None, :, None, :]]   # (gy, gx, s, s)
        wins = img[wy[:, None, :, None], wx[None, :, None, :]]    # (gy, gx, w, w)
        t = tiles.reshape(N, s, s)
        t = t - jnp.mean(t, axis=(1, 2), keepdims=True)
        energy = jnp.sum(t * t, axis=(1, 2))
        win = wins.reshape(N, w, w)

        if method == "conv":
            # numerator: one grouped correlation, node k's tile against node
            # k's window (all nodes in one pass)
            numer = lax.conv_general_dilated(
                win[None], t[:, None], (1, 1), "VALID",
                dimension_numbers=dn, feature_group_count=N, precision=hi,
            )[0]                                         # (N, 2r+1, 2r+1)
            # per-position window mean/energy via ones-kernel correlations
            ones = jnp.ones((1, 1, s, s), win.dtype)
            s1 = lax.conv_general_dilated(
                win[:, None], ones, (1, 1), "VALID",
                dimension_numbers=dn, precision=hi,
            )[:, 0]
            s2 = lax.conv_general_dilated(
                (win * win)[:, None], ones, (1, 1), "VALID",
                dimension_numbers=dn, precision=hi,
            )[:, 0]
        else:
            Ft = jnp.fft.rfft2(jnp.pad(t, ((0, 0), (0, w - s), (0, w - s))))
            Fw = jnp.fft.rfft2(win)
            numer = jnp.fft.irfft2(Fw * jnp.conj(Ft), s=(w, w))[
                :, : 2 * r + 1, : 2 * r + 1
            ]
            s1 = jax.vmap(lambda a: ncc_ops.window_sums(a, s, s))(win)
            s2 = jax.vmap(lambda a: ncc_ops.window_sums(a * a, s, s))(win)
        var_sum = jnp.maximum(s2 - (s1 * s1) / float(s * s), 0.0)
        denom = jnp.sqrt(var_sum * energy[:, None, None])
        safe = denom > eps
        corr = jnp.where(safe, numer / jnp.where(safe, denom, 1.0), 0.0)

        dy, dx, peak = jax.vmap(peak_of)(corr)
        return (
            dy.reshape(gy, gx),
            dx.reshape(gy, gx),
            peak.reshape(gy, gx),
        )

    return program, (y0s, x0s)
