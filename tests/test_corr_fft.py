# SPDX-License-Identifier: CECILL-2.1
"""Autocorrelation and phase correlation through jnp.fft against NumPy.

These are the grain metric's and the phase tracker's correlation cores
(ops/corrcore.py, ops/phasecorr.py), checked at square, rectangular and
non-power-of-two shapes against a direct NumPy complex-FFT formulation.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from barc4dip_tpu.ops.corrcore import autocorr2d_core, xcorr2d_core
from barc4dip_tpu.ops.phasecorr import phase_corr_surface, zscore2d

SHAPES = [(64, 64), (48, 80), (67, 53)]


def _np_autocorr(a):
    a = a - a.mean()
    F = np.fft.fft2(a)
    c = np.fft.fftshift(np.fft.ifft2(F * np.conj(F)).real)
    return c / np.abs(c).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_autocorr_matches_numpy(rng, shape):
    a = rng.normal(size=shape) + 5.0
    got = np.asarray(autocorr2d_core(jnp.asarray(a)))
    np.testing.assert_allclose(got, _np_autocorr(a), atol=1e-12)


def test_autocorr_batched_matches_per_image(rng):
    """Leading axes batch the transform (the mean removal is global, so it
    is off here)."""
    a = rng.normal(size=(3, 40, 56))
    kw = dict(remove_mean=False, normalize="none")
    got = np.asarray(autocorr2d_core(jnp.asarray(a), **kw))
    for k in range(3):
        one = np.asarray(autocorr2d_core(jnp.asarray(a[k]), **kw))
        np.testing.assert_allclose(got[k], one, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
def test_phase_corr_surface_matches_numpy(rng, shape):
    H, W = shape
    img = rng.normal(size=shape)
    tpl = np.zeros(shape)
    tpl[5:25, 7:30] = img[9:29, 4:27]
    a, b = zscore2d(jnp.asarray(img)), zscore2d(jnp.asarray(tpl))
    got = np.asarray(phase_corr_surface(a, b))
    prod = np.fft.fft2(np.asarray(a)) * np.conj(np.fft.fft2(np.asarray(b)))
    want = np.abs(np.fft.fftshift(np.fft.ifft2(prod / (np.abs(prod) + 1e-9))))
    np.testing.assert_allclose(got, want, atol=1e-12)
    # the peak sits at the template's displacement from zero lag
    iy, ix = np.unravel_index(np.argmax(got), got.shape)
    assert (iy - H // 2, ix - W // 2) == (4, -3)


def test_xcorr2d_matches_numpy(rng):
    a = rng.normal(size=(40, 72))
    b = np.roll(a, (3, -5), axis=(0, 1))
    got = np.asarray(xcorr2d_core(jnp.asarray(a), jnp.asarray(b), normalize="none"))
    a0, b0 = a - a.mean(), b - b.mean()
    want = np.fft.fftshift(
        np.fft.ifft2(np.fft.fft2(a0) * np.conj(np.fft.fft2(b0))).real
    )
    np.testing.assert_allclose(got, want, atol=1e-10)
