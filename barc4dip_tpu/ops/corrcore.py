# SPDX-License-Identifier: CECILL-2.1
"""FFT-based circular correlation device primitives.

Math parity with reference signal/corr.py:45-321: circular (wrap-around)
correlation ``ifft(Fa * conj(Fb))`` with optional mean removal /
standardisation, fftshifted so zero lag sits at the center, and optional
peak normalisation.

Departure from the reference: for real inputs we go through rfft2/irfft2 — half the
FFT work and an *exactly* real result, which supersedes the reference's
``real_if_close`` + imaginary-residual runtime check (signal/corr.py:309-319).
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["xcorr1d_core", "xcorr2d_core", "autocorr2d_core"]


def _finalize(corr, normalize: str):
    if normalize == "none":
        return corr
    if normalize == "peak":
        m = jnp.max(jnp.abs(corr))
        return jnp.where(m > 0, corr / jnp.where(m > 0, m, 1.0), corr)
    raise ValueError(f"Invalid normalize='{normalize}'. Use 'none' or 'peak'.")


def _precondition(a, remove_mean: bool, standardize: bool):
    if remove_mean:
        a = a - jnp.mean(a)
    if standardize:
        s = jnp.std(a)
        a = jnp.where(s > 0, a / jnp.where(s > 0, s, 1.0), a)
    return a


def xcorr1d_core(a, b, *, remove_mean=True, standardize=False, normalize="peak"):
    """Shifted circular cross-correlation of two 1D signals (real fast path)."""
    a = _precondition(a, remove_mean, standardize)
    b = _precondition(b, remove_mean, standardize)
    n = a.shape[-1]
    if jnp.iscomplexobj(a) or jnp.iscomplexobj(b):
        corr = jnp.fft.ifft(jnp.fft.fft(a) * jnp.conj(jnp.fft.fft(b)))
    else:
        corr = jnp.fft.irfft(jnp.fft.rfft(a) * jnp.conj(jnp.fft.rfft(b)), n=n)
    corr = jnp.fft.fftshift(corr, axes=-1)
    return _finalize(corr, normalize)


def xcorr2d_core(a, b, *, remove_mean=True, standardize=False, normalize="peak"):
    """Shifted circular cross-correlation of two 2D signals (real fast path)."""
    a = _precondition(a, remove_mean, standardize)
    b = _precondition(b, remove_mean, standardize)
    shape = a.shape[-2:]
    if jnp.iscomplexobj(a) or jnp.iscomplexobj(b):
        corr = jnp.fft.ifft2(jnp.fft.fft2(a) * jnp.conj(jnp.fft.fft2(b)))
    else:
        corr = jnp.fft.irfft2(
            jnp.fft.rfft2(a) * jnp.conj(jnp.fft.rfft2(b)), s=shape
        )
    corr = jnp.fft.fftshift(corr, axes=(-2, -1))
    return _finalize(corr, normalize)


def autocorr2d_core(a, *, remove_mean=True, standardize=False, normalize="peak"):
    """Shifted circular auto-correlation of a real 2D signal.

    Uses ``irfft2(|rfft2(a)|^2)`` — exactly real by construction.
    """
    a = _precondition(a, remove_mean, standardize)
    shape = a.shape[-2:]
    F = jnp.fft.rfft2(a)
    P = jnp.real(F) ** 2 + jnp.imag(F) ** 2
    corr = jnp.fft.irfft2(P, s=shape)
    corr = jnp.fft.fftshift(corr, axes=(-2, -1))
    return _finalize(corr, normalize)
