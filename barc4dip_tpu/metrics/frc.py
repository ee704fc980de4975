# SPDX-License-Identifier: CECILL-2.1
"""Fourier Ring Correlation — resolution estimation from two acquisitions.

No reference counterpart (extension): the standard way to measure the
ACHIEVED spatial resolution of a detector/optics chain is to correlate
two independent noisy acquisitions of the same field ring-by-ring in
frequency space (van Heel & Schatz, JSB 151 (2005) 250):

    FRC(r) = Re Σ_{|f|∈r} F1(f)·conj(F2(f))
             / sqrt( Σ_{|f|∈r} |F1|² · Σ_{|f|∈r} |F2|² )

The curve falls from ~1 (correlated signal dominates) to ~0 (independent
noise); the frequency where it crosses a threshold (0.143 is the
single-image gold standard, 0.5 the conservative classic) is the
resolution. This complements the framework's speckle bandwidth metrics:
``bandwidth`` characterises one image's spectrum, FRC separates signal
from noise using two.

Implementation notes: one fused device program per frame shape — both
FFTs, the conjugate product and the three per-ring reductions
(`segment_sum` over integer-radius frequency rings built from iota, the
same pattern as ``ops/radialcore.py``) run on device; only the (nr,)
curves come to the host, where the threshold crossing is interpolated.
Complex values never cross the program boundary.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fourier_ring_correlation"]

import logging

logger = logging.getLogger(__name__)


@lru_cache(maxsize=32)
def _frc_program(shape: tuple[int, int]):
    H, W = shape
    nr = min(H, W) // 2  # rings up to the inscribed Nyquist circle

    def run(a, b):
        # integer-radius ring ids on the UNSHIFTED frequency grid
        fy = jnp.fft.fftfreq(H).astype(jnp.float32)[:, None]
        fx = jnp.fft.fftfreq(W).astype(jnp.float32)[None, :]
        # ring index in cycles/(full extent): |f| * min(H, W) rounds to
        # integer rings of width one frequency sample
        rid = jnp.rint(jnp.sqrt(fy * fy + fx * fx) * min(H, W)).astype(jnp.int32)
        rid = jnp.where(rid < nr, rid, nr)  # overflow rings -> discard bin

        Fa = jnp.fft.fft2(a.astype(jnp.complex64))
        Fb = jnp.fft.fft2(b.astype(jnp.complex64))
        cross = Fa * jnp.conj(Fb)

        flat_rid = rid.ravel()
        num = jax.ops.segment_sum(cross.real.ravel(), flat_rid,
                                  num_segments=nr + 1)[:nr]
        pa = jax.ops.segment_sum(jnp.abs(Fa).ravel() ** 2, flat_rid,
                                 num_segments=nr + 1)[:nr]
        pb = jax.ops.segment_sum(jnp.abs(Fb).ravel() ** 2, flat_rid,
                                 num_segments=nr + 1)[:nr]
        den = jnp.sqrt(pa * pb)
        frc = jnp.where(den > 0.0, num / jnp.where(den > 0.0, den, 1.0),
                        jnp.nan)
        return frc

    return jax.jit(run)


def fourier_ring_correlation(
    image1,
    image2,
    *,
    threshold: float = 0.143,
    verbose: bool = False,
) -> dict:
    """FRC curve of two same-shape acquisitions plus the resolution at
    ``threshold``.

    Parameters
    ----------
    image1, image2 : (H, W) arrays (NumPy or device)
        Two independent acquisitions of the same field (e.g. split frames
        or consecutive exposures). Means are removed (the DC ring carries
        no resolution information and would otherwise pin FRC(0) to 1).
    threshold : float
        Crossing level; 0.143 (default) or 0.5 are the standard choices.

    Returns
    -------
    dict with ``freq`` (cycles/px ring centers, (nr,)), ``frc`` ((nr,)),
    ``threshold``, ``resolution_cyc_per_px`` (first downward crossing,
    linearly interpolated; NaN if the curve never falls below the
    threshold) and ``resolution_px`` (its reciprocal: the full period of
    the finest reliably-transferred feature).
    """
    a = np.asarray(image1) if not isinstance(image1, jax.Array) else image1
    b = np.asarray(image2) if not isinstance(image2, jax.Array) else image2
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("fourier_ring_correlation expects two 2D images.")
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    if not (0.0 < float(threshold) < 1.0):
        raise ValueError("threshold must be in (0, 1).")

    H, W = (int(s) for s in a.shape)
    n = min(H, W)
    program = _frc_program((H, W))
    a32 = jnp.asarray(a, jnp.float32)
    b32 = jnp.asarray(b, jnp.float32)
    a32 = a32 - jnp.mean(a32)
    b32 = b32 - jnp.mean(b32)
    frc = np.asarray(program(a32, b32), np.float64)
    nr = frc.shape[0]
    freq = np.arange(nr, dtype=np.float64) / n  # cycles per pixel

    # first downward crossing below the threshold (skip the DC ring, whose
    # mean-removed numerator is ~0 by construction)
    res_f = np.nan
    thr = float(threshold)
    for i in range(2, nr):
        y0, y1 = frc[i - 1], frc[i]
        if np.isfinite(y0) and np.isfinite(y1) and y0 >= thr > y1:
            t = (y0 - thr) / (y0 - y1)
            res_f = freq[i - 1] + t * (freq[i] - freq[i - 1])
            break
    out = {
        "freq": freq,
        "frc": frc,
        "threshold": thr,
        "resolution_cyc_per_px": float(res_f),
        "resolution_px": float(1.0 / res_f) if np.isfinite(res_f) else np.nan,
    }
    if verbose:
        logger.info(
            "> fourier_ring_correlation: rings=%d | threshold=%.3f | "
            "resolution=%.4f cyc/px (%.2f px)",
            nr, thr, out["resolution_cyc_per_px"], out["resolution_px"],
        )
    return out
