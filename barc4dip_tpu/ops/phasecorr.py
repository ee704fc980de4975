# SPDX-License-Identifier: CECILL-2.1
"""Phase correlation + peak localisation device kernels.

Parity with the reference "internal" phase-correlation path
(signal/tracking.py:192-297): z-score both inputs, zero-pad the template into
the frame, whitened cross-power spectrum, inverse FFT, shifted argmax, and an
optional 2D Taylor (Newton) subpixel refinement.

Real-input fast path: the cross-power spectrum of two real images keeps
Hermitian symmetry after magnitude whitening, so ``irfft2`` returns the
exactly-real correlation surface whose abs the reference takes.

Note on the Taylor step: the reference solve (signal/tracking.py:324-375)
swaps the row/column corrections of the Newton step ``-H^{-1} g``. We
implement the documented intent (proper Newton step) by default and keep the
swapped variant available for bug-for-bug comparison.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["zscore2d", "phase_corr_surface", "peak_quality", "subpixel_taylor", "argmax2d"]


def zscore2d(a, *, eps: float = 1e-9):
    """(a - nanmean) / (nanstd + eps) — matches reference _zscore2d."""
    m = jnp.nanmean(a)
    s = jnp.nanstd(a)
    return (a - m) / (s + eps)


def phase_corr_surface(img_z, tpl_pad, *, eps: float = 1e-9):
    """|fftshift(ifft2(cross-power-spectrum))| of two same-shape real images.

    Inputs are expected pre-normalised (z-scored / embedded).
    """
    H, W = img_z.shape[-2], img_z.shape[-1]
    Fi = jnp.fft.rfft2(img_z)
    Ft = jnp.fft.rfft2(tpl_pad)
    prod = Fi * jnp.conj(Ft)
    cps = prod / (jnp.abs(prod) + eps)
    corr = jnp.fft.irfft2(cps, s=(H, W))
    return jnp.abs(jnp.fft.fftshift(corr, axes=(-2, -1)))


def argmax2d(a):
    """(i, j) of the maximum of a 2D array (traced ints)."""
    idx = jnp.argmax(a)
    W = a.shape[-1]
    return idx // W, idx % W


def peak_quality(corr, i, j, *, eps: float = 1e-9):
    """(peak_value, snr) with snr = |peak| / (median|corr| + eps).

    Matches reference _corr_peak_quality (signal/tracking.py:314-321); the
    median uses the sort-free exact selection (ops/quantile.py).
    """
    from .quantile import median_exact

    peak = corr[i, j]
    bg = median_exact(jnp.abs(corr))
    return peak, jnp.abs(peak) / (bg + eps)


def subpixel_taylor(corr, i, j, *, convention: str = "newton", bounds=None):
    """Subpixel (di, dj) from a 3x3 quadratic fit around the integer peak.

    Border peaks and degenerate Hessians return (0, 0) like the reference.
    ``convention="newton"`` is the proper 2D Newton step; ``"reference"``
    reproduces the reference's swapped-component solve. ``bounds=(by, bx)``
    overrides the border extent for maps whose trailing region is masked
    rather than sliced (ops/ncc.py ncc_full_masked_from_preps): a peak on
    the VALID-region border must zero out exactly like the sliced map's.
    """
    ny, nx = corr.shape[-2], corr.shape[-1]
    if bounds is not None:
        ny, nx = bounds

    ic = jnp.clip(i, 1, ny - 2)
    jc = jnp.clip(j, 1, nx - 2)
    nb = jax.lax.dynamic_slice(corr, (ic - 1, jc - 1), (3, 3))

    dy = (nb[2, 1] - nb[0, 1]) / 2.0
    dyy = nb[2, 1] + nb[0, 1] - 2.0 * nb[1, 1]
    dx = (nb[1, 2] - nb[1, 0]) / 2.0
    dxx = nb[1, 2] + nb[1, 0] - 2.0 * nb[1, 1]
    dxy = (nb[2, 2] - nb[2, 0] - nb[0, 2] + nb[0, 0]) / 4.0

    det = dxx * dyy - dxy * dxy
    safe_det = jnp.where(det == 0.0, 1.0, det)

    if convention == "newton":
        di = -(dxx * dy - dxy * dx) / safe_det
        dj = -(dyy * dx - dxy * dy) / safe_det
    elif convention == "reference":
        di = -(dyy * dx - dxy * dy) / safe_det
        dj = -(dxx * dy - dxy * dx) / safe_det
    else:
        raise ValueError("convention must be 'newton' or 'reference'.")

    on_border = (i <= 0) | (i >= ny - 1) | (j <= 0) | (j >= nx - 1)
    bad = on_border | (det == 0.0)
    zero = jnp.zeros((), dtype=corr.dtype)
    return jnp.where(bad, zero, di), jnp.where(bad, zero, dj)
