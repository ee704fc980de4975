# SPDX-License-Identifier: CECILL-2.1
"""Fused full+tiles speckle metric device program (shared by the single-image
aggregator, the chunked stack path and the fused stack pipeline)."""
from __future__ import annotations

from .common import subtile_grids_to_3x3_device, tiled_scalar_fields_device
from .estimators import (
    amplitude_core,
    bandwidth_core,
    distribution_moments_core,
    grain_core,
)

__all__ = ["int_value_hint", "speckle_device_fn"]


def int_value_hint(dtype):
    """(lo, hi) integer-value contract for a float image converted from an
    integer dtype (uint16 detector frames), or None. Resolved at trace
    time from the RAW input dtype — halves the amplitude percentile
    search's counting passes (ops/quantile.py::_order_stats_int)."""
    import jax.numpy as jnp

    if jnp.issubdtype(jnp.dtype(dtype), jnp.integer):
        info = jnp.iinfo(dtype)
        if info.max - info.min < (1 << 24) and abs(int(info.min)) < (1 << 24):
            return (int(info.min), int(info.max))
    return None


def speckle_device_fn(
    groups: frozenset, mode: str, sat: float | None, eps: float,
    full_maps: bool = True,
):
    """Build the fused full+tiles program for one static configuration.

    ``full_maps=False`` drops the (N, N) autocorrelation map and lag axes
    from the full-frame grain block — a large-transfer opt-out for stack
    runs (the map dominates device->host traffic at 2k^2).

    Grain and bandwidth run their own forward FFTs rather than sharing one
    power spectrum (the saved rfft2 costs less than materializing the
    shared half-spectrum for two consumers plus its Hermitian mirror).
    """

    def make_tile_fn(int_range):
        def tile_fn(tile):
            vals: dict = {}
            if "amplitude" in groups:
                vals["amplitude"] = amplitude_core(tile, integer_range=int_range)
            if "grain" in groups:
                vals["grain"] = grain_core(tile, with_map=False)
            if "stats" in groups:
                vals["stats"] = distribution_moments_core(
                    tile, saturation_value=sat, eps=eps
                )
            if "bandwidth" in groups:
                vals["bandwidth"] = bandwidth_core(tile)
            # flatten to "group/field" for the generic executor
            return {f"{g}/{k}": v for g, d in vals.items() for k, v in d.items()}

        return tile_fn

    def fn(img, int_range=None):
        # int_range: static (lo, hi) hint that the float image holds only
        # integer values (uint16 provenance) — see amplitude_core
        tile_fn = make_tile_fn(int_range)
        out: dict = {"full": {}}
        if "amplitude" in groups:
            out["full"]["amplitude"] = amplitude_core(img, integer_range=int_range)
        if "grain" in groups:
            out["full"]["grain"] = grain_core(img, with_map=full_maps)
        if "stats" in groups:
            out["full"]["stats"] = distribution_moments_core(
                img, saturation_value=sat, eps=eps
            )
        if "bandwidth" in groups:
            out["full"]["bandwidth"] = bandwidth_core(img)

        if mode == "subtiles_9x9":
            grids = tiled_scalar_fields_device(img, n=9, compute_fn=tile_fn)
            out["tiles"] = subtile_grids_to_3x3_device(grids)
        elif mode == "tiles_3x3":
            grids = tiled_scalar_fields_device(img, n=3, compute_fn=tile_fn)
            out["tiles"] = {k: {"mean": v} for k, v in grids.items()}
        return out

    return fn
