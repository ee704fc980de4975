# SPDX-License-Identifier: CECILL-2.1
"""Dense speckle-tracking displacement fields + wavefront reconstruction.

Extension beyond the reference: barc4dip tracks one 3x3 ROI grid
(metrics/speckles.py:332-386) — enough for beam-position stability, not for
wavefront sensing. X-ray speckle tracking (XST, Berujon et al. 2012 /
Zdora 2018 review) compares a sample image against a reference speckle
image over a DENSE sub-aperture grid: each local displacement is
proportional to the local wavefront slope, and integrating the slope
field gives the wavefront.

The tracking core (ops/densetrack.py) runs every sub-aperture's windowed
ZNCC in one jitted program — both frames upload once, patches gather
in-program, thousands of correlations batch through one rfft2 — so this
path is bound by device compute rather than by transfers.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..maths.integrate import integrate_gradients
from ..ops.densetrack import dense_track_program, resolve_track_method

__all__ = [
    "track_displacement_field",
    "track_displacement_stack",
    "wavefront_from_displacements",
]


def track_displacement_field(
    img,
    ref,
    *,
    tile_size: int = 33,
    step: int = 16,
    search_radius: int = 10,
    subpixel: bool = True,
    eps: float = 1e-9,
    method: str = "auto",
) -> dict:
    """Dense (dy, dx) displacement field of ``img`` relative to ``ref``.

    For every node of a regular grid, the ``tile_size``-square patch of
    ``ref`` is located inside the corresponding ``img`` search window
    (``tile_size + 2*search_radius`` square) by zero-normalised
    cross-correlation with optional Newton subpixel refinement — the same
    estimator as the stack tracker, batched over the whole grid in one
    device program.

    Returns a dict:

    - ``dy``, ``dx``: (gy, gx) float32 displacement maps [px],
    - ``peak``: (gy, gx) NCC peak values (tracking quality, 1.0 = perfect),
    - ``y``, ``x``: grid node centres [px] in image coordinates,
    - ``meta``: geometry record (tile/step/search/grid shape).
    """
    img = np.asarray(img) if not hasattr(img, "devices") else img
    ref = np.asarray(ref) if not hasattr(ref, "devices") else ref
    if img.ndim != 2 or ref.ndim != 2 or img.shape != ref.shape:
        raise ValueError(
            f"img and ref must be equal-shape 2D images; got "
            f"{getattr(img, 'shape', None)} vs {getattr(ref, 'shape', None)}"
        )
    H, W = (int(v) for v in img.shape)

    method = resolve_track_method(str(method))  # resolved once: meta records
    program, (y0s, x0s) = dense_track_program(  # the kernel that actually ran
        H, W, int(tile_size), int(search_radius), int(step), bool(subpixel),
        method,
    )
    dy, dx, peak = program(
        jnp.asarray(img), jnp.asarray(ref), jnp.asarray(eps, jnp.float32)
    )

    half = (int(tile_size) - 1) / 2.0
    return {
        "dy": np.asarray(dy, np.float32),
        "dx": np.asarray(dx, np.float32),
        "peak": np.asarray(peak, np.float32),
        "y": np.asarray(y0s, np.float64) + half,
        "x": np.asarray(x0s, np.float64) + half,
        "meta": {
            "kind": "displacement_field",
            "input_shape": (H, W),
            "tile_size": int(tile_size),
            "step": int(step),
            "search_radius": int(search_radius),
            "subpixel": bool(subpixel),
            "method": method,
            "grid_shape": (len(y0s), len(x0s)),
            "units": {"dy": "px", "dx": "px", "peak": "1"},
        },
    }


def track_displacement_stack(
    stack,
    ref=None,
    *,
    tile_size: int = 33,
    step: int = 16,
    search_radius: int = 10,
    subpixel: bool = True,
    eps: float = 1e-9,
    method: str = "auto",
    mesh=None,
) -> dict:
    """Dense displacement fields for every frame of a (T, H, W) stack.

    Each frame is tracked with one compiled program reused across the
    scan, the device running one frame ahead of the host pull. With
    ``mesh``, frames round-robin across the mesh's devices (the reference
    image is placed once per device) and the per-frame programs execute
    concurrently — frames are independent, so this is plain data
    parallelism with no cross-device communication. Returns the same dict
    as :func:`track_displacement_field` with a leading T axis on
    ``dy``/``dx``/``peak``.
    """
    import jax

    if not hasattr(stack, "ndim"):  # keep lazy frame views lazy
        stack = np.asarray(stack)
    if stack.ndim != 3:
        raise ValueError(f"stack must be 3D (T, H, W); got ndim={stack.ndim}")
    T, H, W = (int(v) for v in stack.shape)
    ref = stack[0] if ref is None else ref
    ref = np.asarray(ref) if not hasattr(ref, "devices") else ref
    if ref.shape != (H, W):
        raise ValueError(f"ref shape {ref.shape} != frame shape {(H, W)}")

    resolved = resolve_track_method(str(method))
    program, (y0s, x0s) = dense_track_program(
        H, W, int(tile_size), int(search_radius), int(step), bool(subpixel),
        resolved,
    )
    eps_dev = jnp.asarray(eps, jnp.float32)

    if mesh is None:
        devices = [None]
        refs = [jnp.asarray(ref)]
    else:
        devices = list(np.asarray(mesh.devices).ravel())
        refs = [jax.device_put(np.asarray(ref), d) for d in devices]

    def _put(frame, slot):
        arr = np.asarray(frame)
        return jnp.asarray(arr) if devices[slot] is None else jax.device_put(
            arr, devices[slot]
        )

    dys, dxs, peaks = [], [], []
    # dispatch up to one frame per device before collecting (mesh) /
    # one-behind on a single device
    window = max(1, len(devices))
    pending: list = []
    for t in range(T):
        out = program(_put(stack[t], t % window), refs[t % window], eps_dev)
        pending.append(out)
        if len(pending) > window:
            dy, dx, pk = (np.asarray(a, np.float32) for a in pending.pop(0))
            dys.append(dy); dxs.append(dx); peaks.append(pk)
    for out in pending:
        dy, dx, pk = (np.asarray(a, np.float32) for a in out)
        dys.append(dy); dxs.append(dx); peaks.append(pk)

    half = (int(tile_size) - 1) / 2.0
    return {
        "dy": np.stack(dys),
        "dx": np.stack(dxs),
        "peak": np.stack(peaks),
        "y": np.asarray(y0s, np.float64) + half,
        "x": np.asarray(x0s, np.float64) + half,
        "meta": {
            "kind": "displacement_stack",
            "stack_shape": (T, H, W),
            "tile_size": int(tile_size),
            "step": int(step),
            "search_radius": int(search_radius),
            "subpixel": bool(subpixel),
            "method": resolved,
            "grid_shape": (len(y0s), len(x0s)),
            "units": {"dy": "px", "dx": "px", "peak": "1"},
        },
    }


def wavefront_from_displacements(
    field: dict,
    *,
    pixel_size: float,
    distance: float,
    wavelength: float | None = None,
) -> dict:
    """Integrate a dense displacement field into a wavefront surface.

    XST relation (Berujon et al. 2012): a transverse speckle displacement
    ``d`` [px] observed at propagation ``distance`` corresponds to a local
    wavefront slope ``d * pixel_size / distance``. The slope field
    integrates (Frankot-Chellappa least squares, maths.integrate) into the
    wavefront height ``W`` [same unit as pixel_size]; with ``wavelength``
    the phase map ``2*pi/lambda * W`` [rad] is also returned.

    Parameters
    ----------
    field : dict from :func:`track_displacement_field`.
    pixel_size : detector pixel size (e.g. metres).
    distance : speckle-generator-to-detector propagation distance (same unit).
    wavelength : optional photon wavelength (same unit) for the phase map.

    Returns
    -------
    dict with ``wavefront`` (gy, gx) [pixel_size unit], optional ``phase``
    [rad], the slope maps, and a meta record.
    """
    if pixel_size <= 0 or distance <= 0:
        raise ValueError("pixel_size and distance must be positive.")
    slope_y = np.asarray(field["dy"], np.float64) * pixel_size / distance
    slope_x = np.asarray(field["dx"], np.float64) * pixel_size / distance
    grid_step = float(field["meta"]["step"]) * pixel_size

    if slope_y.ndim == 3:  # displacement_stack: integrate per frame
        surface = np.stack(
            [
                np.asarray(
                    integrate_gradients(gy, gx, dy=grid_step, dx=grid_step)
                )
                for gy, gx in zip(slope_y, slope_x)
            ]
        )
    else:
        surface = np.asarray(
            integrate_gradients(slope_y, slope_x, dy=grid_step, dx=grid_step)
        )
    out = {
        "wavefront": surface,
        "slope_y": slope_y,
        "slope_x": slope_x,
        "meta": {
            "kind": "wavefront",
            "pixel_size": float(pixel_size),
            "distance": float(distance),
            "grid_step": grid_step,
            "units": {"wavefront": "pixel_size unit", "slope": "rad (small-angle)"},
        },
    }
    if wavelength is not None:
        if wavelength <= 0:
            raise ValueError("wavelength must be positive.")
        out["phase"] = 2.0 * np.pi / wavelength * surface
        out["meta"]["wavelength"] = float(wavelength)
        out["meta"]["units"]["phase"] = "rad"
    return out
