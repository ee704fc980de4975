# SPDX-License-Identifier: CECILL-2.1
"""Shared metric machinery: display origin, tiling policy + batched executor,
time-series stacking, group selection.

Parity with reference metrics/common.py:12-464 for policy and schema. The
execution model is device-first: where the reference re-invokes each estimator
in an 81-iteration Python loop (metrics/common.py:363-371), here tiles are
extracted with static slices, grouped into equal-shape buckets (split_edges
yields at most 2 distinct heights x 2 widths) and evaluated with ``vmap`` —
the whole 9x9 fan-out is one fused device program.
"""
from __future__ import annotations

import warnings
from functools import lru_cache
from typing import Callable, Literal, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "TILE_GRID_SHAPE_3X3",
    "TILE_ORDER",
    "TILE_LABELS_3X3",
    "normalize_display_origin",
    "apply_display_origin",
    "split_edges",
    "choose_tiling_mode",
    "tiles_meta",
    "nan_std_grid_3x3",
    "pack_mean_std",
    "aggregate_subtiles_9x9_to_3x3",
    "tile_plan",
    "tiled_scalar_fields_device",
    "tiled_scalar_fields",
    "stack_time_series",
    "normalize_groups",
]

TILE_GRID_SHAPE_3X3: tuple[int, int] = (3, 3)
TILE_ORDER: str = "row-major"
TILE_LABELS_3X3: np.ndarray = np.array(
    [["NW", "N", "NE"], ["W", "C", "E"], ["SW", "S", "SE"]], dtype=object
)


def normalize_display_origin(display_origin: str) -> Literal["upper", "lower"]:
    origin = str(display_origin).strip().lower()
    if origin not in ("upper", "lower"):
        raise ValueError("display_origin must be 'upper' or 'lower'.")
    return origin


def apply_display_origin(image, *, display_origin: str):
    """Row-flip for origin="lower" (detector convention); view/no-copy."""
    if image.ndim != 2:
        raise ValueError(f"apply_display_origin expects a 2D array, got ndim={image.ndim}")
    origin = normalize_display_origin(display_origin)
    if origin == "lower":
        return image[::-1, :]
    return image


def split_edges(length: int, n_parts: int) -> list[tuple[int, int]]:
    """Split [0, length) into n_parts contiguous (start, stop) pairs via
    rounded linspace; the last part is forced to end at ``length``."""
    if length < 1:
        raise ValueError("length must be >= 1.")
    if n_parts < 1:
        raise ValueError("n_parts must be >= 1.")

    edges = np.linspace(0, length, n_parts + 1)
    out: list[tuple[int, int]] = []
    for i in range(n_parts):
        a = int(round(float(edges[i])))
        b = int(round(float(edges[i + 1])))
        b = max(b, a + 1)
        out.append((a, b))
    out[-1] = (out[-1][0], length)
    return out


def choose_tiling_mode(
    h: int, w: int, *, tiles: bool = False, min_tile_px: int = 128
) -> tuple[Literal["off", "tiles_3x3", "subtiles_9x9"], tuple[int, int] | None]:
    """Tiling policy: prefer 9x9 subtiles when (h//9, w//9) >= min_tile_px,
    fall back to direct 3x3, else warn and disable."""
    if h < 1 or w < 1:
        raise ValueError("Invalid image shape (h and w must be >= 1).")
    if min_tile_px < 1:
        raise ValueError("min_tile_px must be >= 1.")

    if not bool(tiles):
        return "off", None
    if (h // 9) >= min_tile_px and (w // 9) >= min_tile_px:
        return "subtiles_9x9", (h // 9, w // 9)
    if (h // 3) >= min_tile_px and (w // 3) >= min_tile_px:
        return "tiles_3x3", (h // 3, w // 3)

    warnings.warn(
        f"Image too small for tiling: shape=({h}, {w}), min_tile_px={min_tile_px}.",
        RuntimeWarning,
        stacklevel=2,
    )
    return "off", None


def tiles_meta(
    h: int,
    w: int,
    *,
    tile_mode: Literal["off", "tiles_3x3", "subtiles_9x9"],
    tile_shape_px: tuple[int, int] | None = None,
) -> dict:
    meta: dict = {"tile_mode": tile_mode}
    if tile_mode == "off":
        return meta
    if tile_shape_px is None:
        raise ValueError("tile_shape_px must be provided when tile_mode is not 'off'.")
    meta.update(
        {
            "tile_grid_shape": TILE_GRID_SHAPE_3X3,
            "tile_labels": TILE_LABELS_3X3,
            "tile_order": TILE_ORDER,
            "tile_shape_px": (int(tile_shape_px[0]), int(tile_shape_px[1])),
            "used_subtiles": bool(tile_mode == "subtiles_9x9"),
        }
    )
    return meta


def nan_std_grid_3x3() -> np.ndarray:
    return np.full((3, 3), np.nan, dtype=float)


def pack_mean_std(mean, std) -> dict:
    return {"mean": np.asarray(mean, dtype=float), "std": np.asarray(std, dtype=float)}


def aggregate_subtiles_9x9_to_3x3(sub) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate a 9x9 grid into 3x3 mean/std blocks (population std)."""
    arr = np.asarray(sub, dtype=float)
    if arr.shape != (9, 9):
        raise ValueError("Expected subtiles grid of shape (9, 9).")
    blocks = arr.reshape(3, 3, 3, 3).transpose(0, 2, 1, 3).reshape(3, 3, 9)
    return blocks.mean(axis=-1), blocks.std(axis=-1, ddof=0)


# ---------------------------------------------------------------------------
# Batched tile executor
# ---------------------------------------------------------------------------

@lru_cache(maxsize=256)
def tile_plan(h: int, w: int, n: int):
    """Host-side plan for an n x n tiling of an (h, w) image.

    Returns a list of buckets; each bucket is
    ``(tile_h, tile_w, [(row, col, y0, x0), ...])`` grouping grid positions
    whose tiles share a shape (at most 4 buckets since split_edges produces
    at most two distinct sizes per axis).
    """
    y_edges = split_edges(h, n)
    x_edges = split_edges(w, n)
    buckets: dict[tuple[int, int], list[tuple[int, int, int, int]]] = {}
    for r, (y0, y1) in enumerate(y_edges):
        for c, (x0, x1) in enumerate(x_edges):
            key = (y1 - y0, x1 - x0)
            buckets.setdefault(key, []).append((r, c, y0, x0))
    return tuple(
        (th, tw, tuple(pos)) for (th, tw), pos in sorted(buckets.items())
    )


def tiled_scalar_fields_device(
    image,
    *,
    n: int,
    compute_fn: Callable[[jnp.ndarray], dict],
) -> dict:
    """Evaluate ``compute_fn`` on every tile of an n x n grid, batched.

    Runs inside jit: tiles are extracted with static slices, stacked per
    shape-bucket and evaluated under ``vmap``; results scatter into (n, n)
    grids by static indices. Returns {field: (n, n) array}.
    """
    h, w = (int(s) for s in image.shape[-2:])
    plan = tile_plan(h, w, n)

    grids: dict[str, jnp.ndarray] = {}
    for th, tw, positions in plan:
        batch = jnp.stack(
            [image[y0 : y0 + th, x0 : x0 + tw] for (_, _, y0, x0) in positions]
        )
        vals = jax.vmap(compute_fn)(batch)  # {field: (B,)}
        rows = np.array([p[0] for p in positions])
        cols = np.array([p[1] for p in positions])
        for k, v in vals.items():
            if k not in grids:
                grids[k] = jnp.full((n, n), jnp.nan, dtype=v.dtype)
            grids[k] = grids[k].at[rows, cols].set(v)
    return grids


def subtile_grids_to_3x3_device(grids: dict) -> dict:
    """(9, 9) field grids -> {field: {"mean": (3,3), "std": (3,3)}} in-program."""
    out = {}
    for k, g in grids.items():
        blocks = g.reshape(3, 3, 3, 3).transpose(0, 2, 1, 3).reshape(3, 3, 9)
        out[k] = {"mean": blocks.mean(axis=-1), "std": blocks.std(axis=-1, ddof=0)}
    return out


def tiled_scalar_fields(
    image,
    *,
    tile_mode: Literal["tiles_3x3", "subtiles_9x9"],
    compute_fn: Callable[[np.ndarray], dict[str, float]],
) -> dict[str, dict[str, np.ndarray]]:
    """Host-facing generic tiling executor (reference-compatible signature).

    ``compute_fn`` receives a JAX tile array and must return a dict of scalar
    arrays; it is vmapped across tiles. Returns
    ``{field: {"mean": grid3x3, "std": grid3x3}}`` as NumPy.
    """
    img = jnp.asarray(image)
    if img.ndim != 2:
        raise ValueError(f"tiled_scalar_fields expects a 2D array, got ndim={img.ndim}")

    if tile_mode == "tiles_3x3":
        grids = tiled_scalar_fields_device(img, n=3, compute_fn=compute_fn)
        nan_std = nan_std_grid_3x3()
        return {k: pack_mean_std(np.asarray(v), nan_std) for k, v in grids.items()}

    if tile_mode == "subtiles_9x9":
        grids = tiled_scalar_fields_device(img, n=9, compute_fn=compute_fn)
        out = {}
        for k, sub in grids.items():
            mean3, std3 = aggregate_subtiles_9x9_to_3x3(np.asarray(sub))
            out[k] = pack_mean_std(mean3, std3)
        return out

    raise ValueError("tile_mode must be 'tiles_3x3' or 'subtiles_9x9'.")


# ---------------------------------------------------------------------------
# Chunked stack execution
# ---------------------------------------------------------------------------

_PREFETCHER = None


def upload_padded_chunk(source, c0: int, B: int, T: int, put, dtype=None):
    """Slice frames [c0, min(c0+B, T)) from ``source`` (optionally cast),
    pad the tail by repeating the last frame so every chunk shares one
    compiled shape, upload via ``put`` and wait for residency.

    The single implementation behind every chunked loop's prefetch stage
    (run_stack_program, the fused speckle stack, host-side deconvolution).
    Returns (device_array, nbytes, (io_start, io_end)) — the transfer's
    wall-clock interval, so concurrent upload streams can be merged into
    true wire-busy time rather than double-counted.

    A ``source`` that is ALREADY device-resident (a ``jax.Array``) is
    sliced/cast/padded with device ops — no host round trip. The naive
    path would ``np.asarray`` the slice (download) and re-upload it: a
    a full download and re-upload per chunk. Reported nbytes is 0 for device slices (nothing
    rides the wire); a mesh ``put`` may still relayout across devices.
    """
    import time as _time

    c1 = min(c0 + B, T)
    if isinstance(source, jax.Array):
        chunk = source[c0:c1]
        if dtype is not None and chunk.dtype != np.dtype(dtype):
            chunk = chunk.astype(dtype)
        if c1 - c0 < B:
            chunk = jnp.concatenate(
                [chunk, jnp.repeat(chunk[-1:], B - (c1 - c0), axis=0)],
                axis=0,
            )
        t0 = _time.perf_counter()
        dev = put(chunk)
        dev.block_until_ready()
        return dev, 0, (t0, _time.perf_counter())
    chunk = source[c0:c1]
    if dtype is not None:
        chunk = np.asarray(chunk, dtype=dtype)
    if c1 - c0 < B:
        chunk = np.concatenate(
            [chunk, np.repeat(chunk[-1:], B - (c1 - c0), axis=0)], axis=0
        )
    t0 = _time.perf_counter()
    dev = put(chunk)
    try:
        dev.block_until_ready()
    except AttributeError:
        pass
    return dev, chunk.nbytes, (t0, _time.perf_counter())


def chunk_schedule(T: int, B: int, *, ramp: bool = True):
    """[(c0, n_real, padded_width), ...] covering [0, T) in chunks.

    With ``ramp`` (single-device runs), the first chunk is 2 frames, and a
    tail of <= 2 real frames pads to width 2 instead of B (larger tails
    stay at width B): device compute starts after a fraction of the first
    upload and the drain shrinks when the tail is short. Padded widths stay in {2, B} so at most two program shapes compile.
    BARC4DIP_TPU_RAMP=0 forces uniform chunks.
    """
    import os

    ramp = (
        ramp
        and B >= 4
        and T > 2 * B
        and os.environ.get("BARC4DIP_TPU_RAMP", "1").strip().lower()
        not in ("0", "false", "no", "off")
    )
    schedule: list[tuple[int, int, int]] = []
    c = 0
    if ramp:
        schedule.append((0, 2, 2))
        c = 2
    while c < T:
        n_real = min(B, T - c)
        width = 2 if (ramp and n_real <= 2) else B
        schedule.append((c, n_real, width))
        c += n_real
    return schedule


def chunk_layout_signature(T: int, frame_chunk: int, mesh=None) -> tuple:
    """Chunk-start tuple of the layout a stack loop will actually use —
    goes into checkpoint config hashes so a resume under a different
    effective schedule (BARC4DIP_TPU_RAMP toggled, mesh on/off) can never
    load chunks with mismatched frame counts."""
    B = max(1, min(int(frame_chunk), max(1, int(T))))
    if mesh is not None:
        B = max(1, -(-B // mesh.size)) * mesh.size
    return tuple(c0 for c0, _n, _w in chunk_schedule(int(T), B, ramp=mesh is None))


def upload_streams() -> int:
    """Parallel host->device upload streams (BARC4DIP_TPU_UPLOAD_STREAMS).

    Default 1: in the chunk PIPELINE two fair-sharing streams finish each
    chunk later and delay its dependent compute. Not yet measured on the
    GPU. The knob
    stays for link conditions where parallel streams win."""
    import os

    try:
        n = int(os.environ.get("BARC4DIP_TPU_UPLOAD_STREAMS", "1"))
    except ValueError:
        n = 1
    return max(1, min(n, 8))


def loop_prefetcher():
    """Process-wide pool for chunk preparation + upload
    (:func:`upload_streams` workers).

    A singleton (not per-call) so an exception mid-pipeline never strands
    fresh threads, and the stream count stays bounded even with concurrent
    stack runs.  Used by every chunked stack loop (run_stack_program,
    stack_fused) to hide transfer time — and, for lazy file-backed stacks,
    decode time — behind device compute."""
    global _PREFETCHER
    if _PREFETCHER is None:
        from concurrent.futures import ThreadPoolExecutor

        _PREFETCHER = ThreadPoolExecutor(
            max_workers=upload_streams(), thread_name_prefix="barc4dip-upload"
        )
    return _PREFETCHER


def run_stack_program(
    stack: np.ndarray, program, *, frame_chunk: int = 4, dtype=None, mesh=None,
    checkpoint=None,
):
    """Run a vmapped per-frame metric program over a (T, H, W) stack in
    fixed-size chunks (one compiled shape; tail padded and discarded).

    With ``mesh`` (a 1-D device mesh), each chunk's frame axis is sharded
    across the mesh — frames process data-parallel across chips with no
    cross-device communication (GSPMD propagates the batch sharding).

    Returns the program's output pytree with a leading T axis, as NumPy.
    """
    T = int(stack.shape[0])
    B = max(1, min(int(frame_chunk), T))
    if dtype is None:
        dtype = np.float64 if stack.dtype == np.float64 else np.float32

    put = jnp.asarray
    if mesh is not None:
        from ..parallel.mesh import frames_sharding

        n_dev = mesh.size
        B = max(1, -(-B // n_dev)) * n_dev  # round chunk up to mesh multiple
        sharding = frames_sharding(mesh)
        put = lambda a: jax.device_put(jnp.asarray(a), sharding)  # noqa: E731

    # One-behind pipeline: dispatch chunk k+1 (async) before pulling chunk k,
    # overlapping device compute with host transfers. Keeps at most 2 chunk outputs live.
    # Chunk k+1's slice/decode + upload run on the prefetch thread while the
    # host waits on chunk k. With a ChunkStore, completed chunks are
    # persisted and skipped on resume.
    pieces: list = []
    pending = None  # (device_output, n_valid, chunk_start, piece_index)

    def _collect(raw, pn, c0, slot):
        raw = jax.device_get(raw)
        piece = jax.tree_util.tree_map(lambda a: np.asarray(a)[:pn], raw)
        if checkpoint is not None:
            checkpoint.save(c0, piece)
        pieces[slot] = piece

    schedule = chunk_schedule(T, B, ramp=mesh is None)
    widths = {c0: w for c0, _n, w in schedule}

    def _prepare(c0: int):
        dev, _, _io = upload_padded_chunk(
            stack, c0, widths[c0], T, put, dtype=dtype
        )
        return dev

    prefetch = loop_prefetcher()
    uploads: dict = {}
    for sched_i, (c0, n, _w) in enumerate(schedule):
        c1 = c0 + n
        pieces.append(None)
        slot = len(pieces) - 1

        if checkpoint is not None and checkpoint.has(c0):
            pieces[slot] = checkpoint.load(c0)
            continue

        fut = uploads.pop(c0, None)
        if fut is None:
            fut = prefetch.submit(_prepare, c0)
        out = program(fut.result())
        # lookahead matches the stream count: up to upload_streams()
        # transfers ride the link while the host waits below
        for nxt, _nn, _nw in schedule[sched_i + 1 : sched_i + 1 + upload_streams()]:
            if nxt not in uploads and not (
                checkpoint is not None and checkpoint.has(nxt)
            ):
                uploads[nxt] = prefetch.submit(_prepare, nxt)
        if pending is not None:
            _collect(*pending)
        pending = (out, n, c0, slot)
    if pending is not None:
        _collect(*pending)

    return jax.tree_util.tree_map(lambda *xs: np.concatenate(xs, axis=0), *pieces)


# ---------------------------------------------------------------------------
# Time series stacking and group selection (host-side)
# ---------------------------------------------------------------------------

def stack_time_series(values: list):
    """Stack per-frame outputs along a new leading time axis (recursive for
    dicts; arrays via np.stack; scalars into a 1D array)."""
    if not values:
        raise ValueError("No values provided for stacking.")

    v0 = values[0]
    if isinstance(v0, dict):
        return {k: stack_time_series([v[k] for v in values]) for k in v0.keys()}
    if isinstance(v0, (np.ndarray, jnp.ndarray)):
        return np.stack([np.asarray(v) for v in values], axis=0)
    if isinstance(v0, (float, int, np.floating, np.integer, bool, np.bool_)):
        return np.asarray(values)
    return list(values)


def normalize_groups(
    groups: str | Sequence[str],
    *,
    all_groups: set[str],
    context: str,
    param_name: str = "metrics",
) -> set[str]:
    """Parse "all" / comma-string / sequence group selectors with validation."""
    if isinstance(groups, str):
        keys = {g.strip() for g in groups.split(",")} if "," in groups else {groups.strip()}
    elif isinstance(groups, Sequence):
        keys = set()
        for g in groups:
            if not isinstance(g, str):
                raise TypeError(f"{context}: {param_name} must be str or a sequence of str")
            keys.add(g.strip())
    else:
        raise TypeError(f"{context}: {param_name} must be str or a sequence of str")

    if "all" in keys:
        return set(all_groups)

    unknown = sorted(k for k in keys if k not in all_groups)
    if unknown:
        allowed = ", ".join(sorted(all_groups))
        bad = ", ".join(unknown)
        raise ValueError(
            f"{context}: unknown {param_name} group(s): {bad}. Allowed: {allowed}"
        )
    return keys
