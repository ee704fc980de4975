# SPDX-License-Identifier: CECILL-2.1
"""Device estimator cores for speckle and sharpness metrics.

Every function here is pure, jittable and vmap-friendly: one (h, w) image in,
a dict of scalar arrays out (plus map/axis arrays where the reference returns
them). Degenerate cases produce NaN/Inf instead of raising — the public
aggregators re-check full-frame outputs host-side to reproduce the
reference's error behaviour.

Parity sources: metrics/speckles.py:497-817 (grain, amplitude, bandwidth),
metrics/sharpness.py:405-861 (tenengrad, laplacian_variance,
spectral_entropy, inverse_autocorr_width, eigenvalues).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.masks import square_embed_slices
from ..ops.corrcore import autocorr2d_core
from ..ops.fftcore import psd2d_core
from ..ops.momentscore import distribution_moments_core
from ..ops.radialcore import radial_mean_binned_core, radial_mean_interpolated_core
from ..ops.stencils import laplace as laplace_op
from ..ops.stencils import sobel_x, sobel_y
from ..ops.widths import distance_at_fraction_core, width_at_fraction_core
from ..signal.common import lag_axis_from_step

__all__ = [
    "amplitude_core",
    "grain_core",
    "grain_map_core",
    "bandwidth_core",
    "tenengrad_core",
    "laplacian_variance_core",
    "spectral_entropy_core",
    "inverse_autocorr_width_core",
    "eigenvalues_core",
    "distribution_moments_core",
]

_INV_E = float(1.0 / np.e)


def _pad_to_square_mean(img):
    """Pad to (N, N) with the image mean as fill (grain/bandwidth convention,
    reference metrics/speckles.py:539, :747). The fill region is selected by
    an iota-generated mask (no large HLO constants)."""
    H, W = (int(s) for s in (img.shape[-2], img.shape[-1]))
    sy, sx, N = square_embed_slices((H, W))
    if N == H and N == W:
        return img
    fill = jnp.mean(img)
    pad = ((sy.start, N - sy.stop), (sx.start, N - sx.stop))
    padded = jnp.pad(img, pad, mode="constant", constant_values=0.0)
    yy = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    inside = (
        (yy >= sy.start) & (yy < sy.stop) & (xx >= sx.start) & (xx < sx.stop)
    )
    return jnp.where(inside, padded, fill)


# ---------------------------------------------------------------------------
# amplitude
# ---------------------------------------------------------------------------

def amplitude_core(
    img, *, p_low: float = 0.05, p_high: float = 99.95, integer_range=None
) -> dict:
    """Visibility (nanstd/nanmean) and robust Michelson contrast from the
    [p_low, p_high] nan-percentile range (sort-free exact percentiles).

    ``integer_range``: optional (lo, hi) contract that the float image
    holds only integer values in that range (uint16 detector provenance,
    known statically at trace time) — halves the percentile search's
    counting passes (ops/quantile.py)."""
    from ..ops.quantile import nanpercentiles_exact

    mu = jnp.nanmean(img)
    sigma = jnp.nanstd(img)
    visibility = sigma / mu

    q = nanpercentiles_exact(img, (p_low, p_high), integer_range=integer_range)
    vmin, vmax = q[0], q[1]
    denom = vmax + vmin
    contrast = jnp.where(denom > 0, (vmax - vmin) / jnp.where(denom > 0, denom, 1.0), jnp.nan)
    visibility = jnp.where(mu > 0, visibility, jnp.nan)
    return {"visibility": visibility, "contrast": contrast}


# ---------------------------------------------------------------------------
# grain / inverse autocorrelation width (shared pipeline)
# ---------------------------------------------------------------------------

def _autocorr_widths(img, *, fraction: float, standardize: bool, radial_method: str):
    """Shared pipeline: pad -> autocorr -> argmax -> cuts -> widths -> radial
    1/e distance. Returns (lx, ly, leq, ac, N)."""
    data = _pad_to_square_mean(img)
    ac = autocorr2d_core(
        data, remove_mean=True, standardize=standardize, normalize="peak"
    )
    lx, ly, leq = _widths_from_autocorr(ac, fraction=fraction, radial_method=radial_method)
    return lx, ly, leq, ac, ac.shape[-1]


def _widths_from_autocorr(ac, *, fraction: float, radial_method: str):
    """argmax -> axis cuts -> 1/e widths -> radial 1/e diameter, given the
    peak-normalized autocorrelation map."""
    N = ac.shape[-1]

    flat_idx = jnp.argmax(ac)
    iy = flat_idx // N
    ix = flat_idx % N

    y_cut = jnp.take(ac, ix, axis=1)
    x_cut = jnp.take(ac, iy, axis=0)

    ly, _ = width_at_fraction_core(y_cut, fraction=fraction, center_index=iy)
    lx, _ = width_at_fraction_core(x_cut, fraction=fraction, center_index=ix)

    # dr is a compile-time constant derived from the (static) radial geometry.
    from ..ops.radialcore import binned_geometry, interpolated_geometry

    if radial_method == "binned":
        rad, _ = radial_mean_binned_core(ac)
        *_rest, r_np = binned_geometry((int(N), int(N)), None, 1.0)
        dr = float(r_np[1] - r_np[0])
    elif radial_method == "interpolated":
        # the peak-normalized autocorr is exactly centro-symmetric about
        # n//2, so the half-ring polar sampling is the identical mean at
        # half the gather cost (the gather dominates grain's device time)
        rad, _ = radial_mean_interpolated_core(ac, centrosymmetric=True)
        *_rest, r_np = interpolated_geometry((int(N), int(N)), None, None, None)
        dr = float(r_np[1] - r_np[0])
    else:
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")

    dist, _ = distance_at_fraction_core(rad, fraction=fraction, peak_index=0)
    leq = 2.0 * dist * dr
    return lx, ly, leq


def grain_core(
    img,
    *,
    fraction: float = _INV_E,
    radial_method: str = "interpolated",
    with_map: bool = True,
) -> dict:
    """Speckle grain metrics from the autocorrelation peak.

    ``with_map=False`` drops the (N, N) autocorr map and lag axes (tile
    mode).
    """
    lx, ly, leq, ac, N = _autocorr_widths(
        img, fraction=fraction, standardize=False, radial_method=radial_method
    )
    r_aniso = jnp.where(ly != 0, lx / jnp.where(ly != 0, ly, 1.0), jnp.inf)

    out = {"lx": lx, "ly": ly, "leq": leq, "r": r_aniso}
    if with_map:
        lag = jnp.asarray(lag_axis_from_step(N, 1.0), dtype=ac.dtype)
        out["autocorr"] = ac
        out["xlag"] = lag
        out["ylag"] = lag
    return out


def grain_map_core(img):
    """Just the peak-normalized autocorrelation map of ``grain_core`` (no
    width scalars) — the re-derivation target for lazy map leaves: scalars
    ship with the fused stack program, the (N, N) map only ever computes
    and transfers when a consumer actually reads it."""
    data = _pad_to_square_mean(img)
    ac = autocorr2d_core(
        data, remove_mean=True, standardize=False, normalize="peak"
    )
    return ac


def inverse_autocorr_width_core(
    img, *, fraction: float = _INV_E, radial_method: str = "interpolated"
) -> dict:
    """Sharpness from inverse autocorrelation widths (standardized autocorr).

    Unlike the reference (metrics/sharpness.py:704-708, which routes "binned"
    to the interpolated estimator), ``radial_method`` is honoured.
    """
    lx, ly, leq, _, _ = _autocorr_widths(
        img, fraction=fraction, standardize=True, radial_method=radial_method
    )
    def _inv(v):
        return jnp.where(v != 0, 1.0 / jnp.where(v != 0, v, 1.0), jnp.inf)

    r_aniso = jnp.where(ly != 0, lx / jnp.where(ly != 0, ly, 1.0), jnp.inf)
    return {"sx": _inv(lx), "sy": _inv(ly), "seq": _inv(leq), "r": r_aniso}


# ---------------------------------------------------------------------------
# bandwidth (spectral moments of the PSD)
# ---------------------------------------------------------------------------

def bandwidth_core(img) -> dict:
    """RMS radial bandwidth, 95% encircled-energy radius, per-axis RMS
    bandwidths, spectral anisotropy and participation ratio — from the
    mean-removed, DC-zeroed PSD over the inscribed frequency circle.

    Frequency grids are generated on-device from iota (no HLO constants);
    pixels outside the inscribed circle get zero weight and sort to the end
    of the encircled-energy CDF with key +inf.
    """
    data = _pad_to_square_mean(img)
    mu = jnp.nanmean(data)
    data = data - mu

    P = psd2d_core(data, step_x=1.0, step_y=1.0, scale=True)
    return _bandwidth_from_psd(P)


def _bandwidth_from_psd(P) -> dict:
    """The bandwidth metric body, given the scaled, fftshifted PSD of the
    mean-removed padded image (shared by the fused grain+bandwidth core)."""
    N = int(P.shape[-1])
    P = jnp.nan_to_num(P, nan=0.0, posinf=0.0, neginf=0.0)

    dt = P.dtype
    P = P.at[N // 2, N // 2].set(0.0)
    ixi = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1) - (N // 2)
    iyi = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0) - (N // 2)

    # shifted fftfreq values: signed index / N
    FX = ixi.astype(dt) / N
    FY = iyi.astype(dt) / N
    FR = jnp.sqrt(FX * FX + FY * FY)
    f_max = float(max(N // 2, N - 1 - N // 2)) / N  # max|shifted freq|
    inside = FR <= f_max

    Pm = jnp.where(inside, P, 0.0).reshape(-1)
    fxm = FX.reshape(-1)
    fym = FY.reshape(-1)
    frm = FR.reshape(-1)

    total = jnp.sum(Pm)
    tsafe = jnp.where(total > 0, total, 1.0)

    feq = jnp.sqrt(jnp.sum(frm * frm * Pm) / tsafe)
    sig_fx = jnp.sqrt(jnp.sum(fxm * fxm * Pm) / tsafe)
    sig_fy = jnp.sqrt(jnp.sum(fym * fym * Pm) / tsafe)
    rf = jnp.where(sig_fy != 0, sig_fx / jnp.where(sig_fy != 0, sig_fy, 1.0), jnp.inf)

    # f95 via exact integer-radius classes: shifted frequencies are
    # (i - N//2)/N with integer i, so FR groups exactly by the integer
    # s = ix^2 + iy^2, and the crossing radius is the smallest class
    # radius whose inclusive CDF reaches 0.95. Found by BISECTION on s —
    # ~21 fused masked reductions — instead of a (N/2)^2-segment
    # scatter histogram, with the same exact integer-class semantics.
    s_flat = (ixi * ixi + iyi * iyi).reshape(-1)
    smax = (N // 2) ** 2  # FR <= f_max  <=>  s <= (N//2)^2 exactly
    target = jnp.asarray(0.95, dt) * tsafe
    n_iter = max(1, int(np.ceil(np.log2(smax + 1)))) + 1

    def _bisect(_, bounds):
        lo, hi = bounds
        mid = (lo + hi) // 2
        mass = jnp.sum(jnp.where(s_flat <= mid, Pm, 0.0))
        reached = mass >= target
        return (jnp.where(reached, lo, mid + 1), jnp.where(reached, mid, hi))

    _, s95 = jax.lax.fori_loop(
        0, n_iter, _bisect,
        (jnp.asarray(0, jnp.int32), jnp.asarray(smax, jnp.int32)),
    )
    f95 = jnp.sqrt(s95.astype(P.dtype)) / N

    p = Pm / tsafe
    spr_denom = jnp.sum(p * p)
    spr = jnp.where(spr_denom > 0, 1.0 / jnp.where(spr_denom > 0, spr_denom, 1.0), jnp.nan)

    bad = ~(jnp.isfinite(total) & (total > 0))
    def _guard(v):
        return jnp.where(bad, jnp.nan, v)

    return {
        "feq": _guard(feq),
        "f95": _guard(f95),
        "sig_fx": _guard(sig_fx),
        "sig_fy": _guard(sig_fy),
        "rf": _guard(rf),
        "spr": _guard(spr),
    }


# ---------------------------------------------------------------------------
# sharpness operators
# ---------------------------------------------------------------------------

def tenengrad_core(img, *, eps: float = 1e-12) -> dict:
    """(GRA6) Sobel gradient energy: ex, ey, their sum, anisotropy ex/(ey+eps).

    The mean runs over positions where the *input* is finite (reference
    convention); NaNs in the stencil output propagate exactly as in NumPy.
    """
    finite = jnp.isfinite(img)
    n = jnp.maximum(jnp.sum(finite), 1).astype(img.dtype)

    gx = sobel_x(img)
    gy = sobel_y(img)
    ex = jnp.sum(jnp.where(finite, gx * gx, 0.0)) / n
    ey = jnp.sum(jnp.where(finite, gy * gy, 0.0)) / n
    ten = ex + ey
    re = ex / (ey + eps)
    return {"tenengrad": ten, "ex": ex, "ey": ey, "re": re}


def laplacian_variance_core(img) -> dict:
    """(LAP4) Population variance of the Laplacian over finite positions."""
    finite = jnp.isfinite(img)
    n = jnp.maximum(jnp.sum(finite), 1).astype(img.dtype)

    lap = laplace_op(img)
    lz = jnp.where(finite, lap, 0.0)
    mean = jnp.sum(lz) / n
    d = jnp.where(finite, lap - mean, 0.0)
    var = jnp.sum(d * d) / n
    return {"laplacian_variance": var}


def spectral_entropy_core(
    img, *, remove_mean: bool = True, remove_dc: bool = True, eps: float = 1e-30
) -> dict:
    """Normalized Shannon entropy of the PSD.

    Matches the reference's *effective* behaviour: the square-pad at
    metrics/sharpness.py:590 is dead code (immediately overwritten), so no
    padding here either.
    """
    x = img
    if remove_mean:
        x = x - jnp.mean(x)

    P = psd2d_core(x, step_x=1.0, step_y=1.0, scale=False)
    ny, nx = P.shape[-2], P.shape[-1]
    if remove_dc:
        P = P.at[ny // 2, nx // 2].set(0.0)

    s = jnp.sum(P)
    ssafe = jnp.where(s > 0, s, 1.0)
    p = P.reshape(-1) / ssafe

    M = (ny * nx - 1) if remove_dc else (ny * nx)
    p = jnp.clip(p, eps, None)
    H = -jnp.sum(p * jnp.log(p))
    Hn = H / np.log(float(M))
    Hn = jnp.where(s > 0, Hn, jnp.nan)
    return {"spectral_entropy": Hn}


def eigenvalues_core(
    img, *, k: int = 5, eps: float = 1e-30, eig_method: str = "auto"
) -> dict:
    """(STA2) Sum of the top-k eigenvalues of the image covariance.

    Device route: instead of LAPACK SVD (reference
    metrics/sharpness.py:839), form the (M, M) Gram matrix J J^T with one
    full-fp32 matmul (``precision="highest"``: TF32 would cost the value
    gates) and take eigvalsh — the eigenvalues are exactly the squared
    singular values.

    ``eig_method``: "auto" (subspace iteration above 1024 px, exact dense
    below — the default), "dense" (always exact), or "subspace" (always
    iterative). Subspace iteration is ~1e-6 on decaying/speckle spectra but
    degrades to ~1e-3 on perfectly flat (white-noise) spectra, where the
    top eigenvalues carry no structure anyway; pass "dense" when ranking
    near-identical noise-dominated frames matters more than speed.
    """
    x = img
    energy = jnp.sqrt(jnp.sum(x * x))
    esafe = jnp.where(energy > 0, energy, 1.0)
    x_tilde = x / esafe
    J = x_tilde - jnp.mean(x_tilde)

    M, N = (int(s) for s in J.shape[-2:])
    denom = float(M * N - 1)

    G = jnp.matmul(J, J.T, precision="highest")

    n_eig = min(M, N)
    k_use = min(int(k), n_eig)
    k_want = max(k_use, 2)  # e1/e2 ride along even when k < 2

    if eig_method not in ("auto", "dense", "subspace"):
        raise ValueError("eig_method must be 'auto', 'dense' or 'subspace'.")
    use_subspace = (
        eig_method == "subspace"
        or (eig_method == "auto" and n_eig >= 1024 and k_want <= 32)
    )
    if use_subspace:
        # Large frames: dense eigvalsh computes the full spectrum; blocked
        # subspace iteration gets the same top-k to ~1e-6 rel with a few
        # matmuls (see ops/eig.py, incl. the flat-spectrum caveat). Small
        # frames/tiles keep the exact dense path.
        from ..ops.eig import topk_eigvalsh_subspace

        ev = topk_eigvalsh_subspace(G, k_want) / denom
    else:
        ev = jnp.flip(jnp.linalg.eigvalsh(G), axis=-1)[:k_want] / denom
    ev = jnp.maximum(ev, 0.0)

    val = jnp.sum(ev[:k_use])
    e1 = ev[0] if n_eig >= 1 else jnp.zeros((), img.dtype)
    e2 = ev[1] if n_eig >= 2 else jnp.zeros((), img.dtype)
    re = e1 / (e2 + eps)

    bad = ~(jnp.isfinite(energy) & (energy > 0))
    def _guard(v):
        return jnp.where(bad, jnp.nan, v)

    return {"eigenvalues": _guard(val), "e1": _guard(e1), "e2": _guard(e2), "re": _guard(re)}
