# SPDX-License-Identifier: CECILL-2.1
"""Speckle field metrics (public aggregators).

Parity with reference metrics/speckles.py:83-817: same groups (amplitude,
grain, bandwidth, stats), same meta/full/tiles schema, same units tables,
same tiling policy, same stack + tracking pipeline.

Device execution model: one jitted program per (shape, dtype, groups,
tile mode) computes every full-frame metric AND every tile metric — the
reference's up-to-324 sequential estimator invocations per image
(metrics/speckles.py:201-250 via common.py:363-371) become a handful of
vmapped bucket evaluations fused by XLA. Stacks batch frames on top of that
(see speckle_stack_stats), and tracking runs as batched FFT correlation
(stack_fused.py) instead of 18*T sequential OpenCV calls.
"""
from __future__ import annotations

import logging
from functools import lru_cache
from typing import Literal, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MIN_TILE_PX
from ..geometry.roi import odd_size, roi_grid_3x3
from ..utils import elapsed_time, now
from .common import (
    chunk_layout_signature,
    choose_tiling_mode,
    nan_std_grid_3x3,
    normalize_display_origin,
    normalize_groups,
    pack_mean_std,
    tiles_meta,
)
from .estimators import amplitude_core, bandwidth_core, grain_core
from .speckles_device import speckle_device_fn as _speckle_device_fn

logger = logging.getLogger(__name__)

__all__ = [
    "speckle_stats",
    "speckle_stack_stats",
    "amplitude",
    "grain",
    "bandwidth",
]

_SPECKLE_UNITS: dict[str, dict[str, str]] = {
    "amplitude": {"visibility": "", "contrast": ""},
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
    "grain": {
        "lx": "px",
        "ly": "px",
        "leq": "px",
        "r": "",
        "xlag": "px",
        "ylag": "px",
        "autocorr": "",
    },
    "bandwidth": {
        "spr": "",
        "feq": "1/px",
        "f95": "1/px",
        "sig_fx": "1/px",
        "sig_fy": "1/px",
        "rf": "",
    },
    "temporal": {
        "dx": "px",
        "dy": "px",
        "r": "px",
        "std_dx": "px",
        "std_dy": "px",
        "std_r": "px",
    },
}

_ALL_SPECKLE_GROUPS: set[str] = {"amplitude", "grain", "bandwidth", "stats"}

_GRAIN_MIN_PX = 128


# ---------------------------------------------------------------------------
# fused device program
# ---------------------------------------------------------------------------

@lru_cache(maxsize=128)
def _speckle_program(
    groups: tuple, mode: str, sat: float | None, eps: float, flip: bool = False
):
    # Maps never ride the scalar program: the grain autocorr leaf attaches
    # as a lazy view that re-derives from the caller's image on first
    # access, so no device buffer stays pinned to the stats dict.
    fn = _speckle_device_fn(frozenset(groups), mode, sat, eps, False)

    def cast_fn(img):
        from .speckles_device import int_value_hint

        hint = int_value_hint(img.dtype)  # static: raw input dtype
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        # display-origin row flip happens ON DEVICE (a free layout op XLA
        # fuses into the first consumer) so the uploaded host bytes stay
        # content-addressable: a flat_field numpy-out result registered in
        # the upload cache is redeemed byte-identically here.
        if flip:
            img = img[::-1, :]
        return fn(img, int_range=hint)

    return jax.jit(cast_fn)


def _assemble_stack_output(raw: dict, mode: str) -> tuple[dict, dict | None]:
    """Convert a stacked raw pytree into the reference (full, tiles) schema."""
    full_raw = raw["full"]
    out_full: dict = {}
    for g in ("amplitude", "grain", "stats", "bandwidth"):
        if g in full_raw:
            out_full[g] = {k: np.asarray(v) for k, v in full_raw[g].items()}

    out_tiles = None
    if mode != "off" and "tiles" in raw:
        out_tiles = {}
        T = next(iter(full_raw[next(iter(full_raw))].values())).shape[0]
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


@lru_cache(maxsize=32)
def _grain_map_program(flip: bool):
    """jitted: raw frame (H, W, any dtype) -> peak-normalized autocorr map,
    with the display-origin flip applied on device exactly as the fused
    stack program does."""
    from .estimators import grain_map_core

    def fn(img):
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        if flip:
            img = img[::-1, :]
        return grain_map_core(img)

    return jax.jit(fn)


def _attach_lazy_grain_maps(
    grain_out: dict, stack, T: int, H: int, W: int, *, flip: bool
) -> None:
    """Attach the per-frame autocorr map / lag-axis leaves to a stack grain
    block as lazy views: frame ``t``'s map is re-derived on device from
    ``stack[t]`` the first time a consumer indexes it. Keeps the reference contract (map keys present,
    reference metrics/speckles.py:474-476) without the hot loop paying
    ~N^2 floats/frame of downlink."""
    from ..geometry.masks import square_embed_slices
    from ..utils.lazy import LazyMapStack

    from ..signal.common import lag_axis_from_step

    _, _, N = square_embed_slices((int(H), int(W)))
    # what the device program will actually emit (x64 may be disabled)
    compute_dtype = np.dtype(
        jnp.result_type(np.float64 if stack.dtype == np.float64 else np.float32)
    )
    program = _grain_map_program(bool(flip))

    def fetch(t: int) -> np.ndarray:
        frame = np.ascontiguousarray(stack[int(t)])
        return np.asarray(program(jnp.asarray(frame)))

    lag = lag_axis_from_step(N, 1.0).astype(compute_dtype)
    grain_out["autocorr"] = LazyMapStack(T, (N, N), compute_dtype, fetch)
    grain_out["xlag"] = np.broadcast_to(lag, (T, N)).copy()
    grain_out["ylag"] = np.broadcast_to(lag, (T, N)).copy()


def _unflatten_tiles(flat: dict, *, has_std: bool) -> dict:
    """{"group/field": {"mean","std"}|{"mean"}} -> nested reference schema."""
    tiles: dict = {}
    for key, v in flat.items():
        g, f = key.split("/", 1)
        dst = tiles.setdefault(g, {})
        if has_std:
            dst[f] = pack_mean_std(np.asarray(v["mean"]), np.asarray(v["std"]))
        else:
            dst[f] = pack_mean_std(np.asarray(v["mean"]), nan_std_grid_3x3())
    return tiles


# ---------------------------------------------------------------------------
# standalone estimators (reference metrics/speckles.py:497-817)
# ---------------------------------------------------------------------------

def amplitude(image, verbose: bool = False) -> dict:
    """Visibility (std/mean) and robust Michelson contrast."""
    img = np.asarray(image)
    if img.ndim != 2:
        raise ValueError("image must be a 2D array.")

    mu = float(np.nanmean(img.astype(np.float64, copy=False)))
    if not np.isfinite(mu) or mu <= 0.0:
        raise ValueError("Mean intensity must be positive and finite.")

    out = jax.jit(amplitude_core)(_device_float(img))
    res = {"visibility": float(out["visibility"]), "contrast": float(out["contrast"])}
    if not np.isfinite(res["contrast"]):
        raise ValueError("Invalid percentile range for Michelson contrast.")

    if verbose:
        logger.info("> visibility: %.2f | contrast: %.2f", res["visibility"], res["contrast"])
    return res


@lru_cache(maxsize=32)
def _grain_jit(fraction: float, radial_method: str, with_map: bool):
    return jax.jit(
        lambda img: grain_core(
            img, fraction=fraction, radial_method=radial_method, with_map=with_map
        )
    )


def grain(
    image,
    *,
    fraction: float = 1.0 / np.e,
    radial_method: Literal["binned", "interpolated"] = "interpolated",
    verbose: bool = False,
) -> dict:
    """Speckle grain metrics from the autocorrelation peak (lx, ly, leq, r,
    plus the peak-normalized autocorr map and lag axes)."""
    data = np.asarray(image)
    if data.ndim != 2:
        raise ValueError("image must be a 2D array.")
    if min(data.shape) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")
    if radial_method not in ("binned", "interpolated"):
        raise ValueError("radial_method must be 'binned' or 'interpolated'.")

    out = _grain_jit(float(fraction), str(radial_method), True)(
        _device_float(data)
    )
    metrics = {
        "lx": float(out["lx"]),
        "ly": float(out["ly"]),
        "leq": float(out["leq"]),
        "r": float(out["r"]),
        "autocorr": np.asarray(out["autocorr"], dtype=float),
        "xlag": np.asarray(out["xlag"], dtype=float),
        "ylag": np.asarray(out["ylag"], dtype=float),
    }
    if verbose:
        logger.info(
            "> grain: lx=%.2f | ly=%.2f | lx/ly=%.2f | leq=%.2f ",
            metrics["lx"],
            metrics["ly"],
            metrics["r"],
            metrics["leq"],
        )
    return metrics


def bandwidth(image, verbose: bool = False) -> dict[str, float]:
    """Spatial-frequency bandwidth metrics from the 2D PSD (see
    estimators.bandwidth_core)."""
    img = np.asarray(image)
    if img.ndim != 2:
        raise ValueError("image must be a 2D array.")

    out = jax.jit(bandwidth_core)(_device_float(img))
    spectral = {k: float(v) for k, v in out.items()}
    if not np.isfinite(spectral["feq"]):
        raise ValueError("PSD energy is not positive/finite after mean/DC removal.")

    if verbose:
        logger.info(
            "> bandwidth: fx=%.4f | fy=%.4f | fx/fy=%.2f | feq=%.4f | f95=%.4f | spr=%.0f",
            spectral["sig_fx"],
            spectral["sig_fy"],
            spectral["rf"],
            spectral["feq"],
            spectral["f95"],
            spectral["spr"],
        )
    return spectral


def _device_float(arr: np.ndarray):
    x = jnp.asarray(arr)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        from ..config import default_float

        x = x.astype(default_float())
    return x


# ---------------------------------------------------------------------------
# single-image aggregator
# ---------------------------------------------------------------------------

def speckle_stats(
    image,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
) -> dict:
    """Compute speckle metrics on a single 2D image.

    Returns the reference dict schema:
    ``{"meta": {...}, "full": {group: {...}}, "tiles": {group: {field:
    {"mean": (3,3), "std": (3,3)}}}}``.
    """
    t0 = now()

    is_device = isinstance(image, jax.Array)
    if not isinstance(image, np.ndarray) and not is_device:
        raise TypeError("speckle_stats expects a numpy.ndarray")
    if image.ndim != 2:
        raise ValueError(f"Expected 2D array, got ndim={image.ndim}")

    # the row flip for origin="lower" is applied on device inside the
    # program (static `flip` arg) — flipping host-side would change the
    # uploaded bytes and defeat the content-addressed upload cache
    flip = normalize_display_origin(display_origin) == "lower"
    h, w = (int(v) for v in image.shape)
    groups = normalize_groups(
        metrics, all_groups=_ALL_SPECKLE_GROUPS, context="speckles", param_name="metrics"
    )

    if "grain" in groups and min(h, w) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")
    # Host inputs validate up-front (reference error behaviour); device
    # inputs validate post-hoc on the pulled results — every early device
    # check is a blocking round-trip that serialises against upstream
    # device work.
    if not is_device:
        if "amplitude" in groups:
            mu = float(np.nanmean(np.asarray(image, dtype=np.float64)))
            if not np.isfinite(mu) or mu <= 0.0:
                raise ValueError("Mean intensity must be positive and finite.")
        if "stats" in groups:
            if image.size == 0 or not np.any(np.isfinite(image)):
                raise ValueError("distribution_moments received no finite values.")

    if verbose:
        logger.info("\nspeckle stats for a (h x w: %.0f x %.0f) image:", h, w)

    mode, tile_shape_px = choose_tiling_mode(h, w, tiles=tiles, min_tile_px=MIN_TILE_PX)

    program = _speckle_program(
        tuple(sorted(groups)),
        mode,
        None if saturation_value is None else float(saturation_value),
        float(eps),
        flip,
    )
    # upload in the image's own dtype (uint16 detector frames ship half the
    # bytes); the program casts on device
    from ..ops.uploadcache import device_resident

    dev_img = image if is_device else device_resident(np.ascontiguousarray(image))
    raw = jax.device_get(program(dev_img))

    if is_device:
        if "amplitude" in groups and not np.isfinite(
            float(raw["full"]["amplitude"]["visibility"])
        ):
            raise ValueError("Mean intensity must be positive and finite.")
        if "stats" in groups and not np.isfinite(float(raw["full"]["stats"]["mean"])):
            raise ValueError("distribution_moments received no finite values.")

    out: dict = {
        "meta": {
            "kind": "speckles",
            "display_origin": display_origin,
            "input_shape": (int(h), int(w)),
            "requested_groups": sorted(groups),
            "units": _SPECKLE_UNITS,
        },
        "full": {},
    }

    full = raw["full"]
    if "amplitude" in groups:
        out["full"]["amplitude"] = {k: float(v) for k, v in full["amplitude"].items()}
    if "grain" in groups:
        from ..geometry.masks import square_embed_slices
        from ..signal.common import lag_axis_from_step
        from ..utils.lazy import LazyMap

        g = full["grain"]
        _, _, N = square_embed_slices((int(h), int(w)))

        # Lazy map leaf that pins NOTHING on the device: first access
        # re-derives the autocorrelation from the caller's raw image
        # (display flip applied on device). Upload rides the
        # content-addressed cache, so it is free when the frame's buffer
        # is still live.
        def _fetch_map(img=image, flip=flip):
            from ..ops.uploadcache import device_resident

            prog = _grain_map_program(flip)
            return np.asarray(
                prog(img if isinstance(img, jax.Array)
                     else device_resident(np.ascontiguousarray(img))),
                dtype=np.float64,
            )

        lag = lag_axis_from_step(N, 1.0)
        out["full"]["grain"] = {
            "lx": float(g["lx"]),
            "ly": float(g["ly"]),
            "leq": float(g["leq"]),
            "r": float(g["r"]),
            "autocorr": LazyMap((N, N), np.float64, _fetch_map),
            "xlag": lag,
            "ylag": lag.copy(),
        }
    if "stats" in groups:
        out["full"]["stats"] = {k: float(v) for k, v in full["stats"].items()}
    if "bandwidth" in groups:
        out["full"]["bandwidth"] = {k: float(v) for k, v in full["bandwidth"].items()}

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
    if "amplitude" in full:
        a = full["amplitude"]
        logger.info("> visibility: %.2f | contrast: %.2f", a["visibility"], a["contrast"])
    if "grain" in full:
        g = full["grain"]
        logger.info(
            "> grain: lx=%.2f | ly=%.2f | lx/ly=%.2f | leq=%.2f ",
            g["lx"], g["ly"], g["r"], g["leq"],
        )
    if "stats" in full:
        m = full["stats"]
        logger.info(
            "> moments: mean=%.0f | std=%.0f | var=%.0f | skew=%.2f | kurt=%.2f | SNR=%.2f dB | zero=%.6f | sat=%.6f",
            m["mean"], m["std"], m["variance"], m["skewness"], m["kurtosis"],
            m["SNRdB"], m["frac_zero"], m["frac_sat"],
        )
    if "bandwidth" in full:
        b = full["bandwidth"]
        logger.info(
            "> bandwidth: fx=%.4f | fy=%.4f | fx/fy=%.2f | feq=%.4f | f95=%.4f | spr=%.0f",
            b["sig_fx"], b["sig_fy"], b["rf"], b["feq"], b["f95"], b["spr"],
        )


# ---------------------------------------------------------------------------
# stack aggregator (per-frame metrics + translation tracking)
# ---------------------------------------------------------------------------

def tracking_grid_from_frame0(
    stack, *, roi_grain_factor: float = 3.0, roi_step_factor: float = 0.5
):
    """Static 3x3 tracking-ROI geometry sized from frame-0 grain:
    (grid_slices, grid_labels, roi_side, step, grain0).

    Reference phase 2 hoisted (metrics/speckles.py:332-345): the fused
    chunk program needs the ROI geometry up front. The map-free grain
    program returns just the four scalars — no (N, N) autocorr download
    for a geometry decision — and runs on the host CPU backend: frame 0
    is host-resident anyway, and the result only sizes static shapes, so
    a one-frame sizing pass does not justify compiling a dedicated
    accelerator executable.
    """
    T, H, W = (int(s) for s in stack.shape)
    frame0 = np.asarray(stack[0, :, :])
    with jax.default_device(jax.devices("cpu")[0]):
        g0 = _grain_jit(float(1.0 / np.e), "interpolated", False)(
            jnp.asarray(frame0, dtype=jnp.promote_types(frame0.dtype, jnp.float32))
        )
        grain0 = {k: float(g0[k]) for k in ("lx", "ly", "leq", "r")}

    l = float(
        np.nanmax([grain0.get("lx", np.nan), grain0.get("ly", np.nan), grain0.get("leq", np.nan)])
    )
    if not np.isfinite(l) or l <= 0:
        raise ValueError("Could not infer a valid grain size from frame 0 (lx/ly/leq).")

    roi_side = odd_size(int(np.ceil(roi_grain_factor * l)))
    step = int(max(1, round(roi_step_factor * roi_side)))
    grid_slices, grid_labels = roi_grid_3x3(
        (H, W), (roi_side, roi_side), (step, step), center_yx=None
    )
    return grid_slices, grid_labels, roi_side, step, grain0


def speckle_stack_stats(
    stack,
    *,
    metrics: str | Sequence[str] = "all",
    tiles: bool = True,
    display_origin: Literal["upper", "lower"] = "lower",
    roi_grain_factor: float = 3.0,
    roi_step_factor: float = 0.5,
    tracking_method: str = "template",
    tracking_backend: Literal["internal", "skimage", "opencv"] = "skimage",
    subpixel: bool = True,
    saturation_value: float | None = 65535.0,
    eps: float = 1e-6,
    verbose: bool = True,
    parallel: bool = True,
    n_jobs: int | None = None,
    frame_chunk: int = 4,
    mesh=None,
    checkpoint_dir=None,
    grain_maps: bool = True,
    tracking_search_radius: float | None = None,
) -> dict:
    """Per-frame speckle metrics stacked over time plus abs/inc translation
    tracking from a central 3x3 ROI grid.

    ``parallel``/``n_jobs`` are accepted for API parity; on the device the frame
    axis is batched on-device in chunks of ``frame_chunk`` frames (the
    device-native analogue of the reference's joblib thread pool,
    metrics/speckles.py:296-325). Metrics and tracking run as ONE fused
    program per chunk: each chunk uploads once in its original dtype and the
    incremental-tracking tail stays device-resident (metrics/stack_fused.py).

    ``tracking_search_radius`` (px, opt-in, beyond the reference): restrict
    each template correlation to a window of that radius around the tile's
    home position instead of the reference's full-frame search
    (metrics/speckles.py:347-386). Identical displacements whenever the
    physical drift stays within the radius — NCC values don't depend on the
    window, so the argmax and subpixel refinement match — at a small
    fraction of the FFT cost on large frames. Template method only.
    """
    from .stack_fused import run_fused_speckle_stack

    t0 = now()

    if not isinstance(stack, (np.ndarray, jax.Array)):
        # a device-resident jax.Array takes the few-dispatch superchunk
        # path (stack_fused._run_resident_stack) — the serving pattern;
        # host arrays keep the upload-overlapped chunk loop
        raise TypeError(
            "speckle_stack_stats expects a numpy.ndarray or jax.Array"
        )
    if stack.ndim != 3:
        raise ValueError(
            f"stack must be a 3D array with shape (T, H, W); got ndim={stack.ndim}"
        )
    T, H, W = (int(s) for s in stack.shape)
    if T < 1:
        raise ValueError("stack must contain at least one frame.")

    serial_mode = (not parallel) or (n_jobs is not None and int(n_jobs) <= 1)

    groups = normalize_groups(
        metrics, all_groups=_ALL_SPECKLE_GROUPS, context="speckles", param_name="metrics"
    )
    if "grain" in groups and min(H, W) < _GRAIN_MIN_PX:
        raise ValueError("image too small for speckle grain metrics (min dimension < 128).")

    method_norm = str(tracking_method).strip().lower()
    if method_norm not in ("template", "phase"):
        raise ValueError(f"Unsupported tracking method for stacks: {tracking_method!r}")

    search_px: int | None = None
    if tracking_search_radius is not None:
        if method_norm != "template":
            raise ValueError(
                "tracking_search_radius requires tracking_method='template' "
                "(windowed phase correlation would change its spectral "
                "normalization semantics)."
            )
        if float(tracking_search_radius) < 1:
            raise ValueError("tracking_search_radius must be >= 1 px.")
        search_px = int(np.ceil(float(tracking_search_radius)))

    mode, _tile_shape = choose_tiling_mode(H, W, tiles=tiles, min_tile_px=MIN_TILE_PX)

    grid_slices, grid_labels, roi_side, step, grain0 = tracking_grid_from_frame0(
        stack, roi_grain_factor=roi_grain_factor, roi_step_factor=roi_step_factor
    )

    ckpt = None
    if checkpoint_dir is not None:
        from ..utils.checkpoint import ChunkStore

        config = {
            "kind": "speckle_stack_fused", "shape": (T, H, W),
            "groups": sorted(groups), "mode": mode, "sat": saturation_value,
            "eps": eps, "origin": display_origin, "chunk": frame_chunk,
            "roi": roi_side, "step": step, "method": tracking_method,
            "subpixel": bool(subpixel), "grain_maps": bool(grain_maps),
            "search": search_px,
            "maps": "lazy-v2",  # maps left the chunk payload in round 2
            # the EFFECTIVE chunk layout (ramp knob/mesh aware): chunks
            # saved under one layout must never resume under another
            "schedule": chunk_layout_signature(T, frame_chunk, mesh),
        }
        ckpt = ChunkStore(checkpoint_dir, "speckle_fused", config)

    # ---- fused metrics + tracking over device-resident chunks ----
    raw_metrics, track = run_fused_speckle_stack(
        stack,
        grid_slices,
        groups=groups,
        mode=mode,
        sat=None if saturation_value is None else float(saturation_value),
        eps=float(eps),
        flip=(display_origin == "lower"),
        method=str(tracking_method).strip().lower(),
        subpixel=bool(subpixel),
        track_eps=1e-9,
        frame_chunk=frame_chunk,
        mesh=mesh,
        checkpoint=ckpt,
        verbose=verbose,
        # Maps never ride the chunk pipeline: when requested they attach as
        # lazy per-frame leaves below (re-derived on device only on access),
        # so the hot loop's device->host traffic is scalars regardless of
        # link bandwidth.
        full_maps=False,
        search_radius=search_px,
    )
    out_full, out_tiles = _assemble_stack_output(raw_metrics, mode)
    if "grain" in groups and grain_maps:
        _attach_lazy_grain_maps(
            out_full["grain"], stack, T, H, W,
            flip=(display_origin == "lower"),
        )
    dx_abs_tiles, dy_abs_tiles, dx_inc_tiles, dy_inc_tiles = track

    # ---- phase 4: temporal aggregation ----
    r_abs_tiles = np.sqrt(dx_abs_tiles**2 + dy_abs_tiles**2)
    r_inc_tiles = np.sqrt(dx_inc_tiles**2 + dy_inc_tiles**2)

    def _agg(a):
        return (
            np.nanmean(a, axis=(1, 2)).astype(np.float32),
            np.nanstd(a, axis=(1, 2)).astype(np.float32),
        )

    dx_abs, std_dx_abs = _agg(dx_abs_tiles)
    dy_abs, std_dy_abs = _agg(dy_abs_tiles)
    r_abs, std_r_abs = _agg(r_abs_tiles)
    dx_inc, std_dx_inc = _agg(dx_inc_tiles)
    dy_inc, std_dy_inc = _agg(dy_inc_tiles)
    r_inc, std_r_inc = _agg(r_inc_tiles)

    temporal = {
        "abs": {
            "dx": dx_abs, "dy": dy_abs, "r": r_abs,
            "std_dx": std_dx_abs, "std_dy": std_dy_abs, "std_r": std_r_abs,
        },
        "inc": {
            "dx": dx_inc, "dy": dy_inc, "r": r_inc,
            "std_dx": std_dx_inc, "std_dy": std_dy_inc, "std_r": std_r_inc,
        },
        "qc": {"roi_grid_shape": (3, 3)},
    }

    meta: dict = {
        "kind": "speckle_stack_stats",
        "input_shape": (H, W),
        "stack_shape": (T, H, W),
        "n_frames": T,
        "display_origin": display_origin,
        "units": _SPECKLE_UNITS,
        "grain0": {k: grain0.get(k) for k in ("lx", "ly", "leq", "r")},
        "tracking": {
            "method": str(tracking_method),
            "backend": str(tracking_backend),
            "subpixel": bool(subpixel),
            "peak_mode": "abs",
            # same fit condition as stack_fused._search_windows: an
            # oversized window silently falls back to the full search, and
            # the provenance record must say what actually ran
            "search_area": (
                f"window_r{search_px}px"
                if search_px is not None
                and roi_side + 2 * search_px < min(H, W)
                else "full_frame"
            ),
            "normalization": {"template": "zscore_local", "search": "zscore_global"},
            "roi_grain_factor": float(roi_grain_factor),
            "roi_size_yx": (int(roi_side), int(roi_side)),
            "roi_step_factor": float(roi_step_factor),
            "roi_step_yx": (int(step), int(step)),
            "roi_labels": grid_labels,
            "roi_order": "row-major",
        },
        "parallel": {
            "enabled": bool(not serial_mode),
            "device_batched": True,
            "frame_chunk": int(frame_chunk),
        },
    }

    out: dict = {"meta": meta, "full": out_full, "temporal": temporal}
    if out_tiles is not None:
        out["tiles"] = out_tiles

    if verbose:
        logger.info(
            "> speckle_stack_stats | frames=%d | roi=%dx%d | step=%d | parallel=%s | n_jobs=%s | elapsed=%s s",
            T,
            roi_side,
            roi_side,
            step,
            "yes" if not serial_mode else "no",
            "1" if serial_mode else str(n_jobs),
            int(elapsed_time(t0, verbose=False)),
        )

    return out
