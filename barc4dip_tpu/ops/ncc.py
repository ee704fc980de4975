# SPDX-License-Identifier: CECILL-2.1
"""Normalized cross-correlation (template matching) on-device.

Parity target: the correlation maps consumed by the reference's
``template_matching`` (signal/tracking.py:82-188) — OpenCV
``TM_CCOEFF_NORMED`` and skimage ``match_template(pad_input=False)`` compute
the *same* zero-normalised cross-correlation:

    corr[u,v] = sum_w (I_w - mean(I_w)) (T - mean(T))
                / sqrt( sum_w (I_w - mean(I_w))^2 * sum (T - mean(T))^2 )

NCC is invariant to affine rescaling of either input, so the reference's
global z-scoring of the search image changes nothing mathematically; we
z-score internally anyway so float32 stays well-conditioned on the device.

Device design (replaces the OpenCV C++ kernel, reference
signal/tracking.py:149-167): the numerator is one circular FFT correlation
(valid region sliced out); per-window mean/energy come from integral images
(two cumsums). O(HW log HW) total, batched over many templates by vmap with
the image spectrum computed once.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "ncc_valid",
    "window_sums",
    "zncc_prepare_image",
    "ncc_valid_from_prepared",
    "ncc_full_masked_from_preps",
    "ncc_bank_masked_from_preps",
    "ncc_bank_masked_peaks",
]


def window_sums(image, h: int, w: int):
    """Sliding-window sums of ``image`` over all (h, w) windows (valid mode).

    Returns an array of shape (H-h+1, W-w+1) via a zero-padded integral image.
    """
    ii = jnp.cumsum(jnp.cumsum(image, axis=-2), axis=-1)
    ii = jnp.pad(ii, ((1, 0), (1, 0)))
    return (
        ii[h:, w:]
        - ii[:-h, w:]
        - ii[h:, :-w]
        + ii[:-h, :-w]
    )


def zncc_prepare_image(image, h: int, w: int, *, eps: float = 1e-9):
    """Precompute the image-side quantities shared by every template of size
    (h, w): spectrum, per-window mean and window variance-sum.

    The image is z-scored first (nanmean/nanstd, matching the reference's
    ``_zscore2d``) — a no-op for the NCC value, a big win for f32 conditioning.
    Returns a dict to feed :func:`ncc_valid_from_prepared`.
    """
    m = jnp.nanmean(image)
    s = jnp.nanstd(image)
    img = (image - m) / (s + eps)

    s1 = window_sums(img, h, w)
    area = float(h * w)
    # the z-scored square has mean ~1: integrating img^2 - 1 keeps the
    # integral image a zero-mean random walk (~sqrt(HW)) instead of a ramp
    # up to H*W, whose float32 differences would cost ~1e-3 of each
    # window's energy at 2048^2 (algebraically identical)
    s2 = window_sums(img * img - 1.0, h, w) + area
    # sum over window of (I - mean_w)^2 = S2 - S1^2/A ; clamp tiny negatives.
    var_sum = jnp.maximum(s2 - (s1 * s1) / area, 0.0)
    return {
        "s1": s1, "var_sum": var_sum, "shape": image.shape, "hw": (h, w),
        "F": jnp.fft.rfft2(img),
    }


def prep_template(template, H: int, W: int):
    """Precompute a template's padded spectrum + energy for repeated use
    against many prepared images (e.g. the fixed frame-0 template bank in
    stack tracking)."""
    h, w = template.shape[-2], template.shape[-1]
    t = template - jnp.mean(template)
    # (h, w) ride on the image prep; only array leaves here so the dict
    # vmaps cleanly as a template bank
    tpl_pad = jnp.pad(t, ((0, H - h), (0, W - w)))
    return {"Ft": jnp.fft.rfft2(tpl_pad), "energy": jnp.sum(t * t)}


def _corr_full(img_prep, tpl_prep):
    """Circular cross-correlation of the prepared image and template."""
    H, W = img_prep["shape"]
    return jnp.fft.irfft2(img_prep["F"] * jnp.conj(tpl_prep["Ft"]), s=(H, W))


def ncc_valid_from_preps(img_prep, tpl_prep, *, eps: float = 1e-9):
    """NCC valid map from a prepared image and a prepared template."""
    H, W = img_prep["shape"]
    h, w = img_prep["hw"]
    corr_full = _corr_full(img_prep, tpl_prep)
    numer = corr_full[: H - h + 1, : W - w + 1]
    denom = jnp.sqrt(img_prep["var_sum"] * tpl_prep["energy"])
    safe = denom > eps
    return jnp.where(safe, numer / jnp.where(safe, denom, 1.0), 0.0)


def ncc_full_masked_from_preps(img_prep, tpl_prep, *, eps: float = 1e-9):
    """Full-frame ALIGNED NCC map for peak finding: the (H, W) correlation
    with the circular-wrap region (beyond the valid (H-h+1, W-w+1) window)
    set to -inf instead of sliced away.

    Peak semantics are identical to argmax over
    :func:`ncc_valid_from_preps` — valid cells carry the same NCC values
    (degenerate denominators still read 0.0, matching the sliced map) and
    masked cells can never win the argmax — but the unaligned slice is
    gone, so every downstream pass keeps the frame's aligned (H, W)
    layout. Returns (corr_masked, (Vh, Vw)); pass the valid extent to
    ``subpixel_taylor(..., bounds=(Vh, Vw))`` so border peaks zero out
    exactly like the sliced path."""
    H, W = img_prep["shape"]
    h, w = img_prep["hw"]
    Vh, Vw = H - h + 1, W - w + 1
    corr_full = _corr_full(img_prep, tpl_prep)
    var_full = jnp.pad(img_prep["var_sum"], ((0, h - 1), (0, w - 1)))
    denom = jnp.sqrt(var_full * tpl_prep["energy"])
    iy = lax.broadcasted_iota(jnp.int32, (H, W), 0)
    ix = lax.broadcasted_iota(jnp.int32, (H, W), 1)
    valid = (iy < Vh) & (ix < Vw)
    safe = denom > eps
    ncc = jnp.where(safe, corr_full / jnp.where(safe, denom, 1.0), 0.0)
    neg_inf = jnp.asarray(-jnp.inf, ncc.dtype)
    return jnp.where(valid, ncc, neg_inf), (Vh, Vw)


def ncc_bank_masked_from_preps(img_prep, tpl_bank, *, eps: float = 1e-9):
    """Masked full-frame NCC maps for a whole template bank at once.

    Returns (bank_maps, (Vh, Vw)). See :func:`ncc_bank_masked_peaks`."""
    maps, _iy, _ix, vb = ncc_bank_masked_peaks(img_prep, tpl_bank, eps=eps)
    return maps, vb


def ncc_bank_masked_peaks(img_prep, tpl_bank, *, eps: float = 1e-9):
    """Masked full-frame NCC maps + integer peaks for a template bank.

    ``tpl_bank`` is a vmapped :func:`prep_template` dict (leading bank
    axis): the vmap of :func:`ncc_full_masked_from_preps` plus one argmax
    per map. Returns (bank_maps, iy, ix, (Vh, Vw)) with (iy, ix) int32
    (B,) equal to ``argmax2d`` of each masked map."""
    H, W = img_prep["shape"]
    h, w = img_prep["hw"]
    Vh, Vw = H - h + 1, W - w + 1

    def one(ft, energy):
        m, _vb = ncc_full_masked_from_preps(
            img_prep, {"Ft": ft, "energy": energy}, eps=eps
        )
        return m

    maps = jax.vmap(one)(tpl_bank["Ft"], tpl_bank["energy"])
    flat = jnp.argmax(maps.reshape(maps.shape[0], -1), axis=1)
    iy = (flat // W).astype(jnp.int32)
    ix = (flat % W).astype(jnp.int32)
    return maps, iy, ix, (Vh, Vw)


def ncc_valid_from_prepared(prep, template, *, eps: float = 1e-9):
    """NCC valid-mode map for one (raw) template against a prepared image."""
    H, W = prep["shape"]
    tpl_prep = prep_template(template, int(H), int(W))
    return ncc_valid_from_preps(prep, tpl_prep, eps=eps)


def ncc_valid(image, template, *, eps: float = 1e-9):
    """Full NCC valid-mode map: shape (H-h+1, W-w+1)."""
    h, w = template.shape[-2], template.shape[-1]
    prep = zncc_prepare_image(image, int(h), int(w), eps=eps)
    return ncc_valid_from_prepared(prep, template, eps=eps)
