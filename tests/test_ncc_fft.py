# SPDX-License-Identifier: CECILL-2.1
"""FFT normalized cross-correlation (ops/ncc.py) against brute force.

The tracker's correlation maps come from one rfft2/irfft2 round trip plus
integral-image window statistics. Here every map is checked against a
direct NumPy ZNCC (explicit window loops), at square, rectangular and
non-power-of-two frame sizes, and the bank's integer peaks against an
argmax over those brute-force maps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from barc4dip_tpu.ops import ncc
from barc4dip_tpu.ops import phasecorr as pc

SHAPES = [(64, 64), (48, 80), (67, 53), (100, 72)]


def _zncc_brute(img, tpl):
    """Valid-mode ZNCC by explicit windows (float64)."""
    H, W = img.shape
    h, w = tpl.shape
    t = tpl - tpl.mean()
    tn = np.sqrt(np.sum(t * t))
    out = np.zeros((H - h + 1, W - w + 1))
    for i in range(H - h + 1):
        for j in range(W - w + 1):
            win = img[i : i + h, j : j + w]
            wc = win - win.mean()
            den = np.sqrt(np.sum(wc * wc)) * tn
            out[i, j] = np.sum(wc * t) / den if den > 1e-9 else 0.0
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_ncc_valid_matches_brute_force(rng, shape):
    img = rng.normal(size=shape)
    tpl = img[5:18, 7:22] + 0.1 * rng.normal(size=(13, 15))
    got = np.asarray(ncc.ncc_valid(jnp.asarray(img), jnp.asarray(tpl)))
    np.testing.assert_allclose(got, _zncc_brute(img, tpl), atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES)
def test_bank_masked_peaks_match_brute_force(rng, shape):
    """Masked bank maps equal the brute-force valid maps inside the valid
    region, are -inf outside it, and the bank's integer peaks are the
    brute-force argmax."""
    H, W = shape
    h = w = 11
    img = rng.normal(size=shape)
    spots = [(3, 4), (H - h - 2, W - w - 5), (H // 2 - 5, W // 3)]
    tiles = np.stack([img[y : y + h, x : x + w] for y, x in spots])
    prep = ncc.zncc_prepare_image(jnp.asarray(img), h, w)
    bank = jax.vmap(lambda t: ncc.prep_template(t, H, W))(jnp.asarray(tiles))
    maps, iy, ix, (vh, vw) = ncc.ncc_bank_masked_peaks(prep, bank)
    assert (vh, vw) == (H - h + 1, W - w + 1)
    maps = np.asarray(maps)
    for k, (y, x) in enumerate(spots):
        want = _zncc_brute(img, tiles[k])
        np.testing.assert_allclose(maps[k][:vh, :vw], want, atol=1e-9)
        assert np.all(np.isneginf(maps[k][vh:, :]))
        assert np.all(np.isneginf(maps[k][:, vw:]))
        assert (int(iy[k]), int(ix[k])) == np.unravel_index(np.argmax(want), want.shape)
        assert (int(iy[k]), int(ix[k])) == (y, x)


def test_bank_maps_equal_single_template_maps(rng):
    img = jnp.asarray(rng.normal(size=(96, 80)))
    tiles = jnp.asarray(rng.normal(size=(3, 9, 9)))
    prep = ncc.zncc_prepare_image(img, 9, 9)
    bank = jax.vmap(lambda t: ncc.prep_template(t, 96, 80))(tiles)
    maps, vb = ncc.ncc_bank_masked_from_preps(prep, bank)
    for k in range(3):
        tp = jax.tree_util.tree_map(lambda a: a[k], bank)
        one, vb1 = ncc.ncc_full_masked_from_preps(prep, tp)
        assert vb1 == vb
        np.testing.assert_array_equal(np.asarray(maps[k]), np.asarray(one))


def test_masked_map_subpixel_matches_sliced_map(rng):
    """The masked full-frame map gives the same integer peak and subpixel
    refinement as the sliced valid map, given the valid extent."""
    img = jnp.asarray(rng.normal(size=(128, 128)))
    tpl = img[40:61, 30:51] + 0.0
    prep = ncc.zncc_prepare_image(img, 21, 21)
    tp = ncc.prep_template(tpl, 128, 128)
    sliced = ncc.ncc_valid_from_preps(prep, tp)
    masked, (vh, vw) = ncc.ncc_full_masked_from_preps(prep, tp)
    np.testing.assert_array_equal(np.asarray(masked)[:vh, :vw], np.asarray(sliced))
    i1, j1 = pc.argmax2d(sliced)
    i2, j2 = pc.argmax2d(masked)
    assert (int(i1), int(j1)) == (int(i2), int(j2)) == (40, 30)
    d1 = pc.subpixel_taylor(sliced, i1, j1)
    d2 = pc.subpixel_taylor(masked, i2, j2, bounds=(vh, vw))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2))


def test_subpixel_taylor_bounds_border_zeroes(rng):
    """A peak ON the valid-region border must return (0, 0) through the
    bounds override exactly like the sliced map does natively — even
    though the masked map has -inf neighbours there."""
    m = np.full((64, 64), -np.inf)
    m[:50, :50] = rng.normal(size=(50, 50))
    m[49, 20] = 100.0  # peak on the valid border row
    mj = jnp.asarray(m)
    i, j = pc.argmax2d(mj)
    di, dj = pc.subpixel_taylor(mj, i, j, bounds=(50, 50))
    assert float(di) == 0.0 and float(dj) == 0.0
    # sliced equivalent: same zero
    sj = jnp.asarray(m[:50, :50])
    i2, j2 = pc.argmax2d(sj)
    d2 = pc.subpixel_taylor(sj, i2, j2)
    assert float(d2[0]) == 0.0 and float(d2[1]) == 0.0


def test_float32_ncc_tracks_float64(rng):
    """The production dtype: float32 maps agree with float64 to f32
    resolution and keep the same peak."""
    img = rng.normal(size=(96, 112)) * 1000.0 + 8000.0
    tpl = img[30:47, 41:58].copy()
    m64 = np.asarray(ncc.ncc_valid(jnp.asarray(img), jnp.asarray(tpl)))
    m32 = np.asarray(ncc.ncc_valid(jnp.asarray(img, jnp.float32),
                                   jnp.asarray(tpl, jnp.float32)))
    assert m32.dtype == np.float32
    np.testing.assert_allclose(m32, m64, atol=2e-5)
    assert np.unravel_index(np.argmax(m32), m32.shape) == (30, 41)
