# SPDX-License-Identifier: CECILL-2.1
"""Gradient-field integration (Frankot-Chellappa least squares).

Extension beyond the reference (no counterpart in barc4dip): reconstruct a
surface from its measured gradients — the final step of speckle-tracking
wavefront sensing, where dense displacement maps (signal.xst) are local
wavefront slopes.

The Frankot-Chellappa solution projects the (possibly inconsistent,
noisy) gradient field onto the nearest integrable surface in the least
squares sense, solved exactly in Fourier space:

    Z = F^-1 [ -i (kx F[gx] + ky F[gy]) / (kx^2 + ky^2) ],  Z(0,0) := 0

which is periodic-boundary least squares — exact for periodic surfaces,
and the standard estimator for smooth non-periodic ones (piston is
undetermined; the result is returned zero-mean).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["integrate_gradients"]


@jax.jit
def _fc_solve(gy, gx, dy, dx):
    """One executable on purpose: the complex spectrum never leaves the
    program (eager mode would make every op its own executable)."""
    ny, nx = gy.shape
    ky = 2.0 * jnp.pi * jnp.fft.fftfreq(ny, d=dy)[:, None]
    kx = 2.0 * jnp.pi * jnp.fft.fftfreq(nx, d=dx)[None, :]
    k2 = ky * ky + kx * kx
    # DC carries the undetermined piston: divide safely, zero it after.
    k2_safe = jnp.where(k2 == 0.0, 1.0, k2)
    Fz = -1j * (kx * jnp.fft.fft2(gx) + ky * jnp.fft.fft2(gy)) / k2_safe
    Fz = Fz.at[0, 0].set(0.0)
    z = jnp.real(jnp.fft.ifft2(Fz))
    return z - jnp.mean(z)


def integrate_gradients(gy, gx, *, dy: float = 1.0, dx: float = 1.0):
    """Surface ``z`` with ``dz/dy ~ gy`` and ``dz/dx ~ gx`` (least squares).

    Parameters
    ----------
    gy, gx : 2D arrays, same shape
        Gradient components on a regular grid (row axis = y, column = x).
    dy, dx : float
        Grid spacing along each axis (same length unit as the gradients'
        denominator, so ``z`` comes out in the gradients' numerator unit).

    Returns
    -------
    2D array (same backend as the inputs' promotion): the zero-mean
    integrated surface.
    """
    gy = jnp.asarray(gy)
    gx = jnp.asarray(gx)
    # promote over BOTH inputs (int gy + f64 gx must compute in f64, and
    # integer gradients would truncate the float grid spacings)
    dtype = jnp.promote_types(gy.dtype, gx.dtype)
    if not jnp.issubdtype(dtype, jnp.inexact):
        dtype = jnp.promote_types(dtype, jnp.float32)
    gy = gy.astype(dtype)
    if gy.ndim != 2 or gy.shape != gx.shape:
        raise ValueError(
            f"gy and gx must be equal-shape 2D arrays; got {gy.shape} vs {gx.shape}"
        )
    if not (np.isfinite(dy) and np.isfinite(dx)) or dy <= 0 or dx <= 0:
        raise ValueError("dy and dx must be positive finite grid spacings.")

    return _fc_solve(
        gy, gx.astype(gy.dtype),
        jnp.asarray(dy, gy.dtype), jnp.asarray(dx, gy.dtype),
    )
