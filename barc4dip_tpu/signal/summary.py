# SPDX-License-Identifier: CECILL-2.1
"""Fused spectral-analysis program: the whole Fourier quick-look in ONE
executable.

The interactive workflow the reference examples walk through (ex_03 /
SURVEY §6 Config C) is psd2d + autocorr2d + radial means — four dependent
kernel launches when composed from the public signal/maths calls, each
with its own upload and pull. ``spectral_summary`` runs
the entire workload as one jitted program from one upload: PSD, peak-
normalized autocorrelation, and both radial-mean profiles of the
autocorrelation come back together; the two big maps stay device-resident
(materialise via :func:`barc4dip_tpu.signal.pull_centrosymmetric`).

Reference parity sources: signal/fft.py:261 (psd2d), signal/corr.py:256
(autocorr2d), maths/radial.py:38,101 (radial means).
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.corrcore import autocorr2d_core
from ..ops.uploadcache import device_resident
from ..ops.fftcore import psd2d_core
from ..ops.radialcore import (
    binned_geometry,
    interpolated_geometry,
    radial_mean_binned_core,
    radial_mean_interpolated_core,
)
from .common import lag_axis_from_step, resolve_steps_2d
from .fft import freq_axes2d

__all__ = ["spectral_summary", "spectral_summary_stack"]


@lru_cache(maxsize=32)
def _summary_program(shape: tuple, step_x: float, step_y: float, scale: bool):
    def program(img):
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        P = psd2d_core(img, step_x=step_x, step_y=step_y, scale=scale)
        ac = autocorr2d_core(
            img, remove_mean=True, standardize=False, normalize="peak"
        )
        rad_b, _ = radial_mean_binned_core(ac)
        rad_i, _ = radial_mean_interpolated_core(ac)
        return {"psd": P, "autocorr": ac, "radial_binned": rad_b,
                "radial_interpolated": rad_i}

    return jax.jit(program)


def spectral_summary(
    image,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    scale: bool = True,
):
    """One-program spectral quick-look of a 2D image.

    Returns a dict with device-resident maps and host axes:

    - ``psd`` (N0, N1) shifted PSD, ``fx``/``fy`` frequency axes;
    - ``autocorr`` (N0, N1) peak-normalized circular autocorrelation,
      ``xlag``/``ylag`` lag axes;
    - ``radial_binned`` / ``radial_interpolated`` radial-mean profiles of
      the autocorrelation (host NumPy), with ``r_binned`` /
      ``r_interpolated`` radius axes in pixel units.

    Results match the separate ``psd2d`` / ``autocorr2d`` /
    ``maths.radial_mean_*`` calls; only the launch structure differs.
    """
    img = device_resident(image)
    if img.ndim != 2:
        raise ValueError("image must be a 2D array.")
    if jnp.issubdtype(img.dtype, jnp.complexfloating):
        # the fused program's float32 cast would silently drop the
        # imaginary part; the separate calls handle complex fields properly
        raise ValueError(
            "spectral_summary expects a real-valued image; for complex "
            "fields use signal.psd2d / signal.autocorr2d directly."
        )
    ny, nx = (int(s) for s in img.shape)
    step_x, step_y = resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)

    out = _summary_program((ny, nx), float(step_x), float(step_y), bool(scale))(img)

    fx, fy = freq_axes2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)
    *_, r_b = binned_geometry((ny, nx), None, 1.0)
    *_, r_i = interpolated_geometry((ny, nx), None, None, None)
    return {
        "psd": out["psd"],
        "fx": fx,
        "fy": fy,
        "autocorr": out["autocorr"],
        "xlag": lag_axis_from_step(nx, step_x),
        "ylag": lag_axis_from_step(ny, step_y),
        "radial_binned": np.asarray(out["radial_binned"]),
        "r_binned": np.asarray(r_b),
        "radial_interpolated": np.asarray(out["radial_interpolated"]),
        "r_interpolated": np.asarray(r_i),
    }


@lru_cache(maxsize=16)
def _summary_stack_program(step_x: float, step_y: float):
    """vmapped radial-curves-only variant: (B, H, W) -> curves with a
    leading B axis. The big per-frame PSD/autocorr maps are deliberately
    NOT returned — at stack scale they would dominate transfer and
    memory; use :func:`spectral_summary` on a single frame for maps."""

    def per_frame(img):
        if img.dtype not in (jnp.float32, jnp.float64):
            img = img.astype(jnp.float32)
        ac = autocorr2d_core(
            img, remove_mean=True, standardize=False, normalize="peak"
        )
        rad_b, _ = radial_mean_binned_core(ac)
        rad_i, _ = radial_mean_interpolated_core(ac)
        return {"radial_binned": rad_b, "radial_interpolated": rad_i}

    return jax.jit(jax.vmap(per_frame))


def spectral_summary_stack(
    stack,
    *,
    x: np.ndarray | None = None,
    y: np.ndarray | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
    frame_chunk: int = 8,
    mesh=None,
):
    """Per-frame radial autocorrelation profiles of a (T, H, W) stack.

    The scan-series form of :func:`spectral_summary`: each frame's
    peak-normalized autocorrelation reduces to its binned and
    interpolated radial means ON DEVICE, and only the (T, nbins)/(T, nr)
    curves come back — the per-frame maps never ride the wire. Frames
    run through the shared ramped chunk pipeline (prefetch-overlapped
    uploads; ``mesh`` shards the frame axis).

    Returns {"radial_binned": (T, nbins), "r_binned": (nbins,),
    "radial_interpolated": (T, nr), "r_interpolated": (nr,)} as NumPy.
    Reference parity sources: signal/corr.py:256, maths/radial.py:38,101
    applied per frame (the reference would loop host-side).
    """
    from ..metrics.common import run_stack_program

    arr = stack if hasattr(stack, "ndim") else np.asarray(stack)
    if arr.ndim != 3:
        raise ValueError(f"stack must be 3D (T, H, W); got ndim={arr.ndim}")
    T, ny, nx = (int(v) for v in arr.shape)
    step_x, step_y = resolve_steps_2d(shape=(ny, nx), x=x, y=y, dx=dx, dy=dy)

    program = _summary_stack_program(float(step_x), float(step_y))
    # integer (detector) stacks ride the wire raw — half the bytes of the
    # float32 default — and cast on device inside the program; a stack
    # that is already a jax.Array never touches the host at all
    # (upload_padded_chunk slices it on device)
    wire_dtype = arr.dtype if np.issubdtype(arr.dtype, np.integer) else None
    out = run_stack_program(
        arr, program, frame_chunk=frame_chunk, mesh=mesh, dtype=wire_dtype
    )

    *_, r_b = binned_geometry((ny, nx), None, 1.0)
    *_, r_i = interpolated_geometry((ny, nx), None, None, None)
    return {
        "radial_binned": np.asarray(out["radial_binned"]),
        "r_binned": np.asarray(r_b),
        "radial_interpolated": np.asarray(out["radial_interpolated"]),
        "r_interpolated": np.asarray(r_i),
    }
