# SPDX-License-Identifier: CECILL-2.1
"""Masked distribution moments (finite-value statistics) on-device.

Parity with reference metrics/statistics.py:17-125: mean, population std/var,
biased skewness/kurtosis (scipy.stats.describe conventions: m3/m2^1.5 and
Fisher m4/m2^2-3 without bias correction), frac_zero, frac_sat, SNRdB.

The reference filters non-finite values by boolean indexing — a
data-dependent shape. Here the same statistics come from masked reductions
(weight 0 for non-finite entries): identical results, static shapes, jittable
and vmappable. Two-pass central moments keep float32 accurate on the device.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["distribution_moments_core"]


def distribution_moments_core(
    x, *, saturation_value: float | None = 65535.0, eps: float = 1e-6
) -> dict:
    """Returns a dict of scalar arrays (jit/vmap-friendly).

    NaN/Inf entries are excluded from every statistic. If no finite values
    exist all outputs are NaN (the public wrapper raises host-side instead,
    matching the reference).
    """
    x = x.reshape(-1)
    finite = jnp.isfinite(x)
    n = jnp.sum(finite)
    nf = jnp.maximum(n, 1).astype(x.dtype)

    xz = jnp.where(finite, x, 0.0)
    mean = jnp.sum(xz) / nf

    d = jnp.where(finite, x - mean, 0.0)
    m2 = jnp.sum(d * d) / nf
    m3 = jnp.sum(d * d * d) / nf
    m4 = jnp.sum(d * d * d * d) / nf

    std = jnp.sqrt(m2)
    variance = std * std

    # scipy.stats.describe: biased skew / Fisher kurtosis. For zero variance
    # scipy returns nan (0/0); jnp.where keeps that propagation explicit.
    zero_m2 = m2 == 0
    m2s = jnp.where(zero_m2, 1.0, m2)
    skewness = jnp.where(zero_m2, jnp.nan, m3 / m2s**1.5)
    kurtosis = jnp.where(zero_m2, jnp.nan, m4 / (m2s * m2s) - 3.0)

    frac_zero = jnp.sum(finite & (jnp.abs(x) <= eps)) / nf

    if saturation_value is None:
        frac_sat = jnp.full((), jnp.nan, dtype=x.dtype)
    else:
        frac_sat = jnp.sum(finite & (x >= saturation_value)) / nf

    # SNRdB edge cases (reference metrics/statistics.py:85-99):
    #   std == 0: +inf if mean > 0 else nan
    #   mean/std == 0: -inf ; mean/std < 0: nan
    snr_lin = jnp.where(std == 0, jnp.inf, mean / jnp.where(std == 0, 1.0, std))
    snr_db = jnp.where(
        std == 0.0,
        jnp.where(mean > 0.0, jnp.inf, jnp.nan),
        jnp.where(
            snr_lin > 0.0,
            20.0 * jnp.log10(jnp.where(snr_lin > 0.0, snr_lin, 1.0)),
            jnp.where(snr_lin == 0.0, -jnp.inf, jnp.nan),
        ),
    )

    empty = n == 0
    def _guard(v):
        return jnp.where(empty, jnp.nan, v)

    return {
        "mean": _guard(mean),
        "std": _guard(std),
        "variance": _guard(variance),
        "skewness": _guard(skewness),
        "kurtosis": _guard(kurtosis),
        "frac_zero": _guard(frac_zero),
        "frac_sat": _guard(frac_sat),
        "SNRdB": _guard(snr_db),
    }
