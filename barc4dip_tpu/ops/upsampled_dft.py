# SPDX-License-Identifier: CECILL-2.1
"""Matrix-multiply DFT local upsampling (Guizar-Sicairos et al., Opt. Lett.
33, 156 (2008)) and the upsampled phase cross-correlation built on it.

This natively replaces the reference's skimage
``phase_cross_correlation(..., upsample_factor=10)`` backend
(signal/tracking.py:264-269): a coarse FFT correlation peak refined by an
upsampled DFT evaluated only in a small neighbourhood — two small
matrix-multiplies.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["upsampled_dft", "phase_cross_correlation_upsampled"]


def upsampled_dft(data, upsampled_region_size: int, upsample_factor: int, axis_offsets):
    """Upsampled 2D DFT of ``data`` (complex, shape (ny, nx)) by matrix
    multiplication, evaluated on a (S, S) grid starting at ``axis_offsets``.
    """
    ny, nx = data.shape
    S = int(upsampled_region_size)
    u = float(upsample_factor)

    def kernel(n, offset):
        # (S, n) complex kernel for one axis.
        k = jnp.exp(
            (-2j * jnp.pi / (n * u))
            * (jnp.arange(S)[:, None] - offset)
            * (jnp.fft.ifftshift(jnp.arange(n)) - n // 2)[None, :]
        )
        return k

    ky = kernel(ny, axis_offsets[0])
    kx = kernel(nx, axis_offsets[1])
    # full fp32 products: at the default precision the GPU runs float32
    # matmuls in TF32 (~3 digits), too coarse for a subpixel peak
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(ky, data, precision=hi), kx.T, precision=hi)


@partial(jax.jit, static_argnames=("upsample_factor",))
def phase_cross_correlation_upsampled(reference, moving, *, upsample_factor: int = 1):
    """Subpixel translation registration, skimage-compatible semantics
    (normalization="phase"). Returns (dy, dx) such that shifting ``moving``
    by (dy, dx) aligns it to ``reference``.
    """
    shape = reference.shape
    src_freq = jnp.fft.fft2(reference)
    target_freq = jnp.fft.fft2(moving)

    image_product = src_freq * jnp.conj(target_freq)
    eps = jnp.finfo(image_product.real.dtype).eps
    image_product = image_product / jnp.maximum(jnp.abs(image_product), 100 * eps)

    cross_correlation = jnp.fft.ifft2(image_product)
    mag = jnp.abs(cross_correlation)
    flat = jnp.argmax(mag)
    maxima = jnp.stack([flat // shape[1], flat % shape[1]]).astype(src_freq.real.dtype)

    midpoints = jnp.array([s // 2 for s in shape], dtype=maxima.dtype)
    sizes = jnp.array(shape, dtype=maxima.dtype)
    shifts = jnp.where(maxima > midpoints, maxima - sizes, maxima)

    if upsample_factor == 1:
        return shifts[0], shifts[1]

    import math

    u = float(upsample_factor)
    shifts = jnp.round(shifts * u) / u
    S = int(math.ceil(u * 1.5))
    dftshift = float(int(S / 2))  # np.fix of a positive value

    sample_region_offset = dftshift - shifts * u
    cc_up = jnp.conj(
        upsampled_dft(jnp.conj(image_product), S, upsample_factor, sample_region_offset)
    )
    mag_up = jnp.abs(cc_up)
    flat_up = jnp.argmax(mag_up)
    maxima_up = jnp.stack([flat_up // S, flat_up % S]).astype(shifts.dtype)

    shifts = shifts + (maxima_up - dftshift) / u
    return shifts[0], shifts[1]
