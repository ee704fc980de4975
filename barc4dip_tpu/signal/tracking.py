# SPDX-License-Identifier: CECILL-2.1
"""Translation tracking of a template ROI inside a full frame.

Parity with reference signal/tracking.py:25-375:
- string-keyed tracker registry dispatched by :func:`track_translation`;
- ``template_matching``: normalized cross-correlation peak + optional Taylor
  subpixel refinement, NumPy convention (+dy down, +dx right), returning
  ``(dy, dx, peak, snr)`` with ``snr = |peak| / median|corr|``;
- ``phase_correlation``: whitened cross-power spectrum of the z-scored frame
  vs the zero-embedded z-scored template.

Device departures:
- Both the "opencv" and "skimage" template backends evaluate the *same*
  zero-normalised cross-correlation (mathematically identical maps, see
  ops/ncc.py), computed by one FFT + integral-image device kernel.
- The "skimage" phase backend is replaced by a native upsampled-DFT
  registration kernel (ops/upsampled_dft.py) with skimage-compatible output
  (peak/snr returned as NaN, as in the reference).
- The Taylor subpixel step defaults to the proper Newton solve; the
  reference's swapped-component variant (signal/tracking.py:362-373) is
  available as ``subpixel_convention="reference"``.

The scalar API here mirrors the reference for drop-in use; the batched
stack-tracking path (T x 9 x 2 correlations in one program) lives in
:mod:`barc4dip_tpu.metrics.stack_fused`.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops


def _centered_slices(H: int, W: int, h: int, w: int) -> tuple[slice, slice]:
    """Default reference position: the template centred in the image.

    Equivalent to geometry.roi_slices around the image centre for odd
    sizes, but also valid for EVEN templates (roi_slices enforces its own
    odd-symmetry invariant, which is not a tracker limitation — power-of-
    two templates are common)."""
    y0 = (H - h) // 2
    x0 = (W - w) // 2
    return slice(y0, y0 + h), slice(x0, x0 + w)
from ..ops.upsampled_dft import phase_cross_correlation_upsampled

__all__ = ["track_translation", "template_matching", "phase_correlation"]

_Tracker = Callable[..., tuple[float, float, float, float]]
_TRACKERS: dict[str, _Tracker] = {}


def _register(method: str) -> Callable[[_Tracker], _Tracker]:
    method_norm = method.strip().lower()

    def _decorator(fn: _Tracker) -> _Tracker:
        _TRACKERS[method_norm] = fn
        return fn

    return _decorator


def track_translation(
    template,
    image,
    *,
    slices_yx: tuple[slice, slice] | None = None,
    method: str = "phase",
    backend: str = "internal",
    subpixel: bool = True,
    eps: float = 1e-9,
) -> tuple[float, float, float, float]:
    """Dispatch a registered tracking method. Returns (dy, dx, peak, snr)."""
    method_norm = method.strip().lower()
    fn = _TRACKERS.get(method_norm)
    if fn is None:
        supported = ", ".join(sorted(_TRACKERS))
        raise ValueError(
            f"Unsupported tracking method: {method!r}. Supported: {supported}"
        )
    return fn(
        template, image, slices_yx=slices_yx, backend=backend, subpixel=subpixel, eps=eps
    )


def _as_float2d(a, *, name: str):
    a = jnp.asarray(a)
    if a.ndim != 2:
        raise ValueError(f"{name} must be a 2D array.")
    if not jnp.issubdtype(a.dtype, jnp.floating):
        a = a.astype(jnp.float32)
    return a


@partial(jax.jit, static_argnames=("subpixel", "convention"))
def _tm_device(img, tpl, *, subpixel: bool, convention: str, eps: float):
    corr = ncc_ops.ncc_valid(img, tpl, eps=eps)
    i, j = pc_ops.argmax2d(corr)
    peak, snr = pc_ops.peak_quality(corr, i, j, eps=eps)
    py = i.astype(corr.dtype)
    px = j.astype(corr.dtype)
    if subpixel:
        di, dj = pc_ops.subpixel_taylor(corr, i, j, convention=convention)
        py = py + di
        px = px + dj
    return py, px, peak, snr


@_register("template")
def template_matching(
    template,
    image,
    *,
    slices_yx: tuple[slice, slice] | None = None,
    backend: str = "opencv",
    subpixel: bool = True,
    eps: float = 1e-9,
    subpixel_convention: str = "newton",
) -> tuple[float, float, float, float]:
    """Estimate (dy, dx) by normalized cross-correlation template matching.

    ``backend`` accepts "opencv" or "skimage" for API parity; both resolve to
    the same device NCC kernel (the two reference backends compute the same
    normalized map).
    """
    tpl = _as_float2d(template, name="template")
    img = _as_float2d(image, name="image")

    H, W = (int(s) for s in img.shape)
    h, w = (int(s) for s in tpl.shape)
    if h > H or w > W:
        raise ValueError(f"template shape {(h, w)} must fit inside image shape {(H, W)}")
    # "internal" (the dispatcher's default) resolves to the same device NCC
    # kernel as the two reference backends — method="template" must work
    # through track_translation without an explicit backend
    if backend not in ("opencv", "skimage", "internal"):
        raise ValueError("backend must be 'internal', 'opencv' or 'skimage'.")

    if slices_yx is None:
        slices_yx = _centered_slices(H, W, h, w)
    sy_ref, sx_ref = slices_yx
    y0 = (sy_ref.start + sy_ref.stop - 1) / 2.0
    x0 = (sx_ref.start + sx_ref.stop - 1) / 2.0

    py, px, peak, snr = _tm_device(
        img, tpl, subpixel=bool(subpixel), convention=str(subpixel_convention),
        eps=float(eps),
    )

    y_match = float(py) + (h - 1) / 2.0
    x_match = float(px) + (w - 1) / 2.0
    return float(y_match - y0), float(x_match - x0), float(peak), float(snr)


@partial(jax.jit, static_argnames=("subpixel", "convention", "pad"))
def _pc_device(img, tpl, *, subpixel: bool, convention: str, eps: float, pad):
    H, W = img.shape
    img_z = pc_ops.zscore2d(img, eps=eps)
    tpl_z = pc_ops.zscore2d(tpl, eps=eps).astype(jnp.float32)
    tpl_pad = jnp.pad(tpl_z, pad).astype(img_z.dtype)

    mag = pc_ops.phase_corr_surface(img_z, tpl_pad, eps=eps)
    i, j = pc_ops.argmax2d(mag)
    peak, snr = pc_ops.peak_quality(mag, i, j, eps=eps)

    dy = (i - H // 2).astype(mag.dtype)
    dx = (j - W // 2).astype(mag.dtype)
    if subpixel:
        di, dj = pc_ops.subpixel_taylor(mag, i, j, convention=convention)
        dy = dy + di
        dx = dx + dj
    return dy, dx, peak, snr


@partial(jax.jit, static_argnames=("upsample", "pad"))
def _pc_skimage_device(img, tpl, *, eps: float, upsample: int, pad):
    img_z = pc_ops.zscore2d(img, eps=eps)
    tpl_z = pc_ops.zscore2d(tpl, eps=eps).astype(jnp.float32)
    tpl_pad = jnp.pad(tpl_z, pad).astype(img_z.dtype)
    return phase_cross_correlation_upsampled(img_z, tpl_pad, upsample_factor=upsample)


@_register("phase")
def phase_correlation(
    template,
    image,
    *,
    slices_yx: tuple[slice, slice] | None = None,
    backend: str = "internal",
    subpixel: bool = True,
    eps: float = 1e-9,
    subpixel_convention: str = "newton",
) -> tuple[float, float, float, float]:
    """Estimate (dy, dx) by phase correlation of a template ROI vs a frame.

    backend="internal": whitened cross-power spectrum + optional Taylor
    refinement. backend="skimage": native upsampled-DFT registration
    (upsample 10 when ``subpixel``), peak/snr returned as NaN.
    """
    tpl = _as_float2d(template, name="template")
    img = _as_float2d(image, name="image")

    H, W = (int(s) for s in img.shape)
    h, w = (int(s) for s in tpl.shape)

    if slices_yx is None:
        slices_yx = _centered_slices(H, W, h, w)
    sy, sx = slices_yx
    pad = ((sy.start, H - sy.stop), (sx.start, W - sx.stop))

    if backend == "skimage":
        up = 10 if subpixel else 1
        dy, dx = _pc_skimage_device(img, tpl, eps=float(eps), upsample=up, pad=pad)
        return float(dy), float(dx), float("nan"), float("nan")

    if backend != "internal":
        raise ValueError("backend must be 'internal' or 'skimage'.")

    dy, dx, peak, snr = _pc_device(
        img, tpl, subpixel=bool(subpixel), convention=str(subpixel_convention),
        eps=float(eps), pad=pad,
    )
    return float(dy), float(dx), float(peak), float(snr)
