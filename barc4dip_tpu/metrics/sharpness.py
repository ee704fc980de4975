# SPDX-License-Identifier: CECILL-2.1
"""Sharpness metrics (public aggregators).

Focus-measure operators after Pertuz et al., Pattern Recognition 46(5) 2013
(operator codes GRA6, LAP4, STA2). Parity with reference
metrics/sharpness.py:89-861: same groups (stats, gradient, laplacian,
spectral, autocorrelation, eigenvalues), same schema and tiling policy.

Execution model identical to speckles: one fused jit program per static
configuration, tiles batched by vmap (see metrics/speckles.py docstring).
"""
from __future__ import annotations

import logging
from functools import lru_cache
from typing import Literal, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MIN_TILE_PX
from ..utils import elapsed_time, now, progress_done, progress_update
from .common import (
    choose_tiling_mode,
    chunk_layout_signature,
    normalize_display_origin,
    normalize_groups,
    subtile_grids_to_3x3_device,
    tiled_scalar_fields_device,
    tiles_meta,
)
from .estimators import (
    distribution_moments_core,
    eigenvalues_core,
    inverse_autocorr_width_core,
    laplacian_variance_core,
    spectral_entropy_core,
    tenengrad_core,
)
from .speckles import _device_float, _unflatten_tiles

logger = logging.getLogger(__name__)

__all__ = [
    "sharpness_stats",
    "sharpness_stack_stats",
    "tenengrad",
    "laplacian_variance",
    "spectral_entropy",
    "inverse_autocorr_width",
    "eigenvalues",
]

_SHARPNESS_UNITS: dict[str, dict[str, str]] = {
    "stats": {
        "mean": "a.u.",
        "std": "a.u.",
        "variance": "a.u.^2",
        "skewness": "",
        "kurtosis": "",
        "frac_zero": "",
        "frac_sat": "",
        "SNRdB": "dB",
    },
    "gradient": {"tenengrad": "a.u.^2", "ex": "a.u.^2", "ey": "a.u.^2", "re": ""},
    "laplacian": {"laplacian_variance": "a.u.^2"},
    "spectral": {"spectral_entropy": ""},
    "autocorrelation": {"sx": "1/px", "sy": "1/px", "seq": "1/px", "r": ""},
    "eigenvalues": {"eigenvalues": "", "e1": "", "e2": "", "re": ""},
}

_ALL_SHARPNESS_GROUPS: set[str] = {
    "stats",
    "gradient",
    "laplacian",
    "spectral",
    "autocorrelation",
    "eigenvalues",
}

_IAW_MIN_PX = 32


def _sharpness_device_fn(groups: frozenset, mode: str, sat: float | None, eps: float):
    def group_values(x) -> dict:
        vals: dict = {}
        if "stats" in groups:
            vals["stats"] = distribution_moments_core(x, saturation_value=sat, eps=eps)
        if "gradient" in groups:
            vals["gradient"] = tenengrad_core(x)
        if "laplacian" in groups:
            vals["laplacian"] = laplacian_variance_core(x)
        if "spectral" in groups:
            vals["spectral"] = spectral_entropy_core(x)
        if "autocorrelation" in groups:
            vals["autocorrelation"] = inverse_autocorr_width_core(x)
        if "eigenvalues" in groups:
            vals["eigenvalues"] = eigenvalues_core(x)
        return vals

    def tile_fn(tile):
        vals = group_values(tile)
        return {f"{g}/{k}": v for g, d in vals.items() for k, v in d.items()}

    def fn(img):
        out: dict = {"full": group_values(img)}
        if mode == "subtiles_9x9":
            grids = tiled_scalar_fields_device(img, n=9, compute_fn=tile_fn)
            out["tiles"] = subtile_grids_to_3x3_device(grids)
        elif mode == "tiles_3x3":
            grids = tiled_scalar_fields_device(img, n=3, compute_fn=tile_fn)
            out["tiles"] = {k: {"mean": v} for k, v in grids.items()}
        return out

    return fn


@lru_cache(maxsize=128)
def _sharpness_program(
    groups: tuple, mode: str, sat: float | None, eps: float, flip: bool = False
):
    import jax.numpy as jnp

    fn = _sharpness_device_fn(frozenset(groups), mode, sat, eps)

    def cast_fn(img):
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        # display-origin flip on device keeps the uploaded host bytes
        # content-addressable (see _speckle_program)
        if flip:
            img = img[::-1, :]
        return fn(img)

    return jax.jit(cast_fn)


@lru_cache(maxsize=128)
def _sharpness_stack_program(
    groups: tuple, mode: str, sat: float | None, eps: float, flip: bool = False
):
    """vmapped per-frame program: (B, H, W) -> pytree with leading B axis.

    Casts integer frames to float32 and applies the display-origin flip
    on-device, so chunks upload in their original dtype (half the bytes for
    uint16 detector frames)."""
    import jax.numpy as jnp

    fn = _sharpness_device_fn(frozenset(groups), mode, sat, eps)

    def frame(img):
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        if flip:
            img = img[::-1, :]
        return fn(img)

    return jax.jit(jax.vmap(frame))


def _assemble_stack_output(raw: dict, mode: str) -> tuple[dict, dict | None]:
    full_raw = raw["full"]
    out_full = {
        g: {k: np.asarray(v) for k, v in d.items()} for g, d in full_raw.items()
    }

    out_tiles = None
    if mode != "off" and "tiles" in raw:
        out_tiles = {}
        T = next(iter(out_full[next(iter(out_full))].values())).shape[0]
        for key, v in raw["tiles"].items():
            g, f = key.split("/", 1)
            dst = out_tiles.setdefault(g, {})
            if mode == "subtiles_9x9":
                dst[f] = {"mean": np.asarray(v["mean"]), "std": np.asarray(v["std"])}
            else:
                dst[f] = {
                    "mean": np.asarray(v["mean"]),
                    "std": np.full((T, 3, 3), np.nan),
                }
    return out_full, out_tiles


# ---------------------------------------------------------------------------
# standalone estimators
# ---------------------------------------------------------------------------

def _check_2d_finite_any(data, name: str):
    if data.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={data.ndim}")
    if data.size == 0:
        raise ValueError(f"{name} received an empty image.")
    if not np.any(np.isfinite(data)):
        raise ValueError(f"{name} received image with no finite values.")


def tenengrad(image, *, eps: float = 1e-12, verbose: bool = False) -> dict:
    """(GRA6) Sobel gradient energy: tenengrad, ex, ey, re = ex/(ey+eps)."""
    data = np.asarray(image)
    _check_2d_finite_any(data, "tenengrad")
    out = jax.jit(lambda x: tenengrad_core(x, eps=eps))(_device_float(data))
    res = {k: float(v) for k, v in out.items()}
    if verbose:
        logger.info(
            "> tenengrad: %.6g | ex: %.6g | ey: %.6g | ex/ey: %.3f",
            res["tenengrad"], res["ex"], res["ey"], res["re"],
        )
    return res


def laplacian_variance(image, *, verbose: bool = False) -> float:
    """(LAP4) Population variance of the Laplacian."""
    data = np.asarray(image)
    _check_2d_finite_any(data, "laplacian_variance")
    out = jax.jit(laplacian_variance_core)(_device_float(data))
    var = float(out["laplacian_variance"])
    if verbose:
        logger.info("> laplacian variance: %.6g", var)
    return var


def spectral_entropy(
    image,
    *,
    remove_mean: bool = True,
    remove_dc: bool = True,
    eps: float = 1e-30,
    verbose: bool = False,
) -> float:
    """Normalized Shannon entropy of the PSD (in [0, 1])."""
    data = np.asarray(image)
    if data.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={data.ndim}")
    if data.size == 0:
        raise ValueError("spectral_entropy received an empty image.")
    if not np.all(np.isfinite(data)):
        raise ValueError("spectral_entropy requires all values to be finite.")
    if data.size < 3:
        raise ValueError("Insufficient number of spectral bins to compute normalized entropy.")

    fn = jax.jit(
        lambda x: spectral_entropy_core(
            x, remove_mean=remove_mean, remove_dc=remove_dc, eps=eps
        )
    )
    Hn = float(fn(_device_float(data))["spectral_entropy"])
    if not np.isfinite(Hn):
        raise ValueError("PSD sum is non-positive; cannot compute spectral entropy.")
    if verbose:
        logger.info("> spectral_entropy: %.6g", Hn)
    return Hn


@lru_cache(maxsize=32)
def _iaw_jit(fraction: float, radial_method: str):
    return jax.jit(
        lambda x: inverse_autocorr_width_core(
            x, fraction=fraction, radial_method=radial_method
        )
    )


def inverse_autocorr_width(
    image,
    *,
    fraction: float = 1.0 / np.e,
    radial_method: Literal["binned", "interpolated"] = "interpolated",
    min_size_px: int = _IAW_MIN_PX,
    verbose: bool = False,
) -> dict:
    """Sharpness from the inverse width of the standardized autocorrelation
    peak: sx, sy, seq (1/px) and width-domain anisotropy r."""
    data = np.asarray(image)
    if data.ndim != 2:
        raise ValueError("image must be a 2D array.")
    if data.size == 0:
        raise ValueError("inverse_autocorr_width received an empty image.")
    if min(data.shape) < int(min_size_px):
        raise ValueError(
            f"image too small for inverse autocorrelation width "
            f"(min dimension < {int(min_size_px)})."
        )
    if radial_method not in ("binned", "interpolated"):
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")

    out = _iaw_jit(float(fraction), str(radial_method))(_device_float(data))
    res = {k: float(v) for k, v in out.items()}
    if verbose:
        logger.info(
            "> inv_ac_width: sx=%.4g | sy=%.4g | sx/sy=%.3g | seq=%.4g | r(lx/ly)=%.3g",
            res["sx"],
            res["sy"],
            (res["sx"] / res["sy"]) if np.isfinite(res["sy"]) and res["sy"] != 0 else float("inf"),
            res["seq"],
            res["r"],
        )
    return res


@lru_cache(maxsize=32)
def _eig_jit(k: int, eps: float, eig_method: str = "auto"):
    return jax.jit(lambda x: eigenvalues_core(x, k=k, eps=eps, eig_method=eig_method))


def eigenvalues(
    image, *, k: int = 5, eps: float = 1e-30, eig_method: str = "auto",
    verbose: bool = False,
) -> dict:
    """(STA2) Sum of the top-k covariance eigenvalues (plus e1, e2, e1/e2).

    ``eig_method``: "auto" (default; subspace iteration above 1024 px),
    "dense" (always-exact eigvalsh) or "subspace" — see
    :func:`barc4dip_tpu.ops.eig.topk_eigvalsh_subspace` for the accuracy
    trade-off on flat (noise-only) spectra.
    """
    data = np.asarray(image)
    if data.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={data.ndim}")
    if data.size == 0:
        raise ValueError("eigenvalues received an empty image.")
    if not np.all(np.isfinite(data)):
        raise ValueError("eigenvalues requires all values to be finite.")
    if int(k) < 1:
        raise ValueError("k must be >= 1.")
    if data.size < 2:
        raise ValueError("eigenvalues requires at least 2 pixels (M*N >= 2).")
    if not np.any(data != 0):
        raise ValueError("eigenvalues cannot normalize an all-zero image.")

    out = _eig_jit(int(k), float(eps), str(eig_method))(_device_float(data))
    res = {key: float(v) for key, v in out.items()}
    if verbose:
        logger.info(
            "> eigenvalues: %.6g | e1: %.6g | e2: %.6g | e1/e2: %.3f | k=%d",
            res["eigenvalues"], res["e1"], res["e2"], res["re"],
            min(int(k), min(data.shape)),
        )
    return res


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------

def sharpness_stats(
    image,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
) -> dict:
    """Compute sharpness metrics on a single 2D image (reference schema)."""
    t0 = now()

    is_device = isinstance(image, jax.Array)
    if not isinstance(image, np.ndarray) and not is_device:
        raise TypeError("sharpness_stats expects a numpy.ndarray")
    if image.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={image.ndim}")

    # row flip for origin="lower" happens on device (static `flip` arg) so
    # the uploaded host bytes stay content-addressable for the upload cache
    flip = normalize_display_origin(display_origin) == "lower"
    h, w = (int(v) for v in image.shape)
    groups = normalize_groups(
        metrics, all_groups=_ALL_SHARPNESS_GROUPS, context="sharpness", param_name="metrics"
    )

    if "autocorrelation" in groups and min(h, w) < _IAW_MIN_PX:
        raise ValueError(
            f"image too small for inverse autocorrelation width "
            f"(min dimension < {_IAW_MIN_PX})."
        )
    if (
        not is_device
        and ("stats" in groups or "gradient" in groups or "laplacian" in groups)
        and not np.any(np.isfinite(image))
    ):
        raise ValueError("received image with no finite values.")

    if verbose:
        logger.info("\nsharpness stats for a (h x w: %.0f x %.0f) image:", h, w)

    mode, tile_shape_px = choose_tiling_mode(h, w, tiles=tiles, min_tile_px=MIN_TILE_PX)

    program = _sharpness_program(
        tuple(sorted(groups)),
        mode,
        None if saturation_value is None else float(saturation_value),
        float(eps),
        flip,
    )
    from ..ops.uploadcache import device_resident

    dev_img = image if is_device else device_resident(np.ascontiguousarray(image))
    raw = jax.device_get(program(dev_img))

    out: dict = {
        "meta": {
            "kind": "sharpness",
            "display_origin": display_origin,
            "input_shape": (int(h), int(w)),
            "requested_groups": sorted(groups),
            "units": _SHARPNESS_UNITS,
        },
        "full": {},
    }

    full = raw["full"]
    if "stats" in groups:
        out["full"]["stats"] = {k: float(v) for k, v in full["stats"].items()}
    if "gradient" in groups:
        out["full"]["gradient"] = {k: float(v) for k, v in full["gradient"].items()}
    if "laplacian" in groups:
        out["full"]["laplacian"] = {
            "laplacian_variance": float(full["laplacian"]["laplacian_variance"])
        }
    if "spectral" in groups:
        out["full"]["spectral"] = {
            "spectral_entropy": float(full["spectral"]["spectral_entropy"])
        }
    if "autocorrelation" in groups:
        out["full"]["autocorrelation"] = {
            k: float(v) for k, v in full["autocorrelation"].items()
        }
    if "eigenvalues" in groups:
        out["full"]["eigenvalues"] = {k: float(v) for k, v in full["eigenvalues"].items()}

    if verbose:
        _log_full(out["full"])

    if mode == "off":
        if verbose:
            elapsed_time(t0)
        return out

    out["meta"].update(tiles_meta(h, w, tile_mode=mode, tile_shape_px=tile_shape_px))
    out["tiles"] = _unflatten_tiles(raw["tiles"], has_std=(mode == "subtiles_9x9"))

    if verbose:
        elapsed_time(t0)
    return out


def _log_full(full: dict) -> None:
    if "stats" in full:
        m = full["stats"]
        logger.info(
            "> moments: mean=%.0f | std=%.0f | var=%.0f | skew=%.2f | kurt=%.2f | SNR=%.2f dB | zero=%.6f | sat=%.6f",
            m["mean"], m["std"], m["variance"], m["skewness"], m["kurtosis"],
            m["SNRdB"], m["frac_zero"], m["frac_sat"],
        )
    if "gradient" in full:
        g = full["gradient"]
        logger.info(
            "> tenengrad: %.6g | ex: %.6g | ey: %.6g | ex/ey: %.3f",
            g["tenengrad"], g["ex"], g["ey"], g["re"],
        )
    if "laplacian" in full:
        logger.info("> laplacian variance: %.6g", full["laplacian"]["laplacian_variance"])
    if "spectral" in full:
        logger.info("> spectral_entropy: %.6g", full["spectral"]["spectral_entropy"])
    if "autocorrelation" in full:
        a = full["autocorrelation"]
        logger.info(
            "> inv_ac_width: sx=%.4g | sy=%.4g | sx/sy=%.3g | seq=%.4g | r(lx/ly)=%.3g",
            a["sx"], a["sy"],
            (a["sx"] / a["sy"]) if np.isfinite(a["sy"]) and a["sy"] != 0 else float("inf"),
            a["seq"], a["r"],
        )
    if "eigenvalues" in full:
        e = full["eigenvalues"]
        logger.info(
            "> eigenvalues: %.6g | e1: %.6g | e2: %.6g | e1/e2: %.3f",
            e["eigenvalues"], e["e1"], e["e2"], e["re"],
        )


def sharpness_stack_stats(
    stack,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
    parallel: bool = True,
    n_jobs: int | None = None,
    frame_chunk: int = 8,
    mesh=None,
    checkpoint_dir=None,
) -> dict:
    """Per-frame sharpness metrics stacked along a leading time axis.

    ``parallel``/``n_jobs`` are accepted for API parity (device batching
    replaces the joblib thread pool)."""
    t0 = now()

    if not isinstance(stack, (np.ndarray, jax.Array)):
        # jax.Array = the serving pattern: frames stay device-resident and
        # the chunked pipeline slices them on device (same contract as
        # speckle_stack_stats)
        raise TypeError(
            "sharpness_stack_stats expects a numpy.ndarray or jax.Array"
        )
    if stack.ndim != 3:
        raise ValueError(
            f"stack must be a 3D array with shape (T, H, W); got ndim={stack.ndim}"
        )
    T, H, W = (int(s) for s in stack.shape)
    if T < 1:
        raise ValueError("stack must contain at least one frame.")

    groups = normalize_groups(
        metrics, all_groups=_ALL_SHARPNESS_GROUPS, context="sharpness", param_name="metrics"
    )

    serial_mode = (not parallel) or (n_jobs is not None and int(n_jobs) <= 1)
    tile_mode, tile_shape_px = choose_tiling_mode(
        H, W, tiles=tiles, min_tile_px=MIN_TILE_PX
    )

    if "autocorrelation" in groups and min(H, W) < _IAW_MIN_PX:
        raise ValueError(
            f"image too small for inverse autocorrelation width "
            f"(min dimension < {_IAW_MIN_PX})."
        )

    # per-frame metrics, frames batched on-device in chunks (cast + origin
    # flip happen on-device; chunks upload in the stack's own dtype)
    from .common import run_stack_program

    program = _sharpness_stack_program(
        tuple(sorted(groups)),
        tile_mode,
        None if saturation_value is None else float(saturation_value),
        float(eps),
        display_origin == "lower",
    )
    ckpt = None
    if checkpoint_dir is not None:
        from ..utils.checkpoint import ChunkStore

        config = {
            "kind": "sharpness_stack", "shape": (T, H, W), "groups": sorted(groups),
            "mode": tile_mode, "sat": saturation_value, "eps": eps,
            "origin": display_origin, "chunk": frame_chunk,
            "schedule": chunk_layout_signature(T, frame_chunk, mesh),
        }
        ckpt = ChunkStore(checkpoint_dir, "sharpness_metrics", config)

    if verbose:
        progress_update("Sharpness stats loop", 0, T, -1)
    raw = run_stack_program(
        stack, program, frame_chunk=frame_chunk, mesh=mesh,
        checkpoint=ckpt, dtype=stack.dtype,
    )
    out_full, out_tiles = _assemble_stack_output(raw, tile_mode)
    if verbose:
        progress_done("Sharpness stats loop")

    meta: dict = {
        "kind": "sharpness_stack_stats",
        "input_shape": (H, W),
        "stack_shape": (T, H, W),
        "n_frames": T,
        "display_origin": display_origin,
        "requested_groups": sorted(groups),
        "units": _SHARPNESS_UNITS,
        "parallel": {
            "enabled": bool(not serial_mode),
            "n_jobs": None if serial_mode else n_jobs,
            "device_batched": True,
        },
    }
    meta.update(tiles_meta(H, W, tile_mode=tile_mode, tile_shape_px=tile_shape_px))

    out: dict = {"meta": meta, "full": out_full}
    if out_tiles is not None:
        out["tiles"] = out_tiles

    if verbose:
        logger.info(
            "> sharpness_stack_stats | frames=%d | parallel=%s | n_jobs=%s | elapsed=%s s",
            T,
            "yes" if not serial_mode else "no",
            "1" if serial_mode else str(n_jobs),
            int(elapsed_time(t0, verbose=False)),
        )

    return out
