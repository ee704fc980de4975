# SPDX-License-Identifier: CECILL-2.1
"""Fused stack pipeline: per-frame metrics + tracking in ONE chunk program.

Transfer-optimal execution of ``speckle_stack_stats`` (the SURVEY §7 goal of
"the whole per-frame pipeline as one fused program with no host round-trips
per frame"):

- each chunk of raw frames is uploaded ONCE in its original dtype (uint16
  detector frames stay uint16 on the wire — half the bytes) and cast/flipped
  on device;
- per-frame metrics (full + tiles) and abs/inc tracking evaluate in the same
  XLA program against that single copy;
- the chunk's last frame stays device-resident as the next chunk's
  incremental-tracking tail (no host round-trip for the t-1 dependency);
- chunk k+1 dispatches before chunk k's results are pulled (one-behind);
- chunk k+1's upload runs on a prefetch thread while the host waits on
  chunk k's results, so transfer time hides behind device compute.
"""
from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ncc as ncc_ops
from ..ops import phasecorr as pc_ops
from ..utils import progress_done, progress_update
from .common import loop_prefetcher, upload_padded_chunk
from .speckles_device import int_value_hint, speckle_device_fn
from .tracking_batch import _extract_tiles, _grid_geometry

__all__ = ["run_fused_speckle_stack", "device_compute_probe", "LAST_RUN_PERF"]

#: Per-stage attribution of the most recent :func:`run_fused_speckle_stack`
#: call: seconds spent uploading chunks / dispatching programs / waiting on
#: results, plus bytes moved each way. Read by bench.py so a throughput
#: swing is self-explaining (upload-bound vs compute-bound vs pull-bound).
LAST_RUN_PERF: dict = {}


def _to_compute(x):
    if x.dtype in (jnp.float32, jnp.float64):
        return x
    return x.astype(jnp.float32)


def _search_windows(H, W, s, starts, search: int):
    """Static per-tile search-window geometry: each tile's correlations run
    inside a (w, w) window centred on the tile's home position, w = s + 2r,
    clamped to stay in-frame (full frame if the window doesn't fit)."""
    w = s + 2 * int(search)
    if w >= min(H, W):
        return None  # window would cover the frame — use the full search
    wy0 = np.clip(starts[:, 0] - int(search), 0, H - w).astype(np.int32)
    wx0 = np.clip(starts[:, 1] - int(search), 0, W - w).astype(np.int32)
    return wy0, wx0, int(w)


def _make_track_frame_fn(H, W, s, starts, subpixel, method, search=None):
    centers_y = (starts[:, 0] + (s - 1) / 2.0).astype(np.float64)
    centers_x = (starts[:, 1] + (s - 1) / 2.0).astype(np.float64)

    def taylor(corr, i, j, bounds=None):
        if subpixel:
            return pc_ops.subpixel_taylor(
                corr, i, j, convention="newton", bounds=bounds
            )
        zero = jnp.zeros((), corr.dtype)
        return zero, zero

    def peak_of(corr):
        i, j = pc_ops.argmax2d(corr)
        di, dj = taylor(corr, i, j)
        return i.astype(corr.dtype) + di, j.astype(corr.dtype) + dj

    windows = (
        _search_windows(H, W, s, starts, search)
        if (method == "template" and search is not None)
        else None
    )

    if method == "template" and windows is not None:
        # Windowed search (opt-in, beyond the reference): NCC runs only in a
        # per-tile window around the template's home position — identical
        # output to the full-frame search whenever the physical displacement
        # stays within ``search`` px (NCC values are window-independent; the
        # global argmax lands in-window), at a fraction of the FFT cost.
        wy0s, wx0s, w = windows

        def frame_fn(img, prev, tpl_arg, eps):
            wins = jnp.stack(
                [img[y0 : y0 + w, x0 : x0 + w] for y0, x0 in zip(wy0s, wx0s)]
            )

            def prep_arrays(win):
                # array leaves only: the static shape/hw ints must not ride
                # through vmap (they'd become tracers and break the FFT size)
                p = ncc_ops.zncc_prepare_image(win, s, s, eps=eps)
                return {k: v for k, v in p.items() if k not in ("shape", "hw")}

            def with_shape(p):
                return {**p, "shape": (w, w), "hw": (s, s)}

            preps = jax.vmap(prep_arrays)(wins)
            tpl_inc = _extract_tiles(prev, starts, s)

            def run_abs(prep, tp):
                return peak_of(
                    ncc_ops.ncc_valid_from_preps(with_shape(prep), tp, eps=eps)
                )

            def run_inc(prep, tpl):
                return peak_of(
                    ncc_ops.ncc_valid_from_prepared(with_shape(prep), tpl, eps=eps)
                )

            py_a, px_a = jax.vmap(run_abs)(preps, tpl_arg)
            py_i, px_i = jax.vmap(run_inc)(preps, tpl_inc)

            half = (s - 1) / 2.0
            cy = jnp.asarray(centers_y, dtype=img.dtype)
            cx = jnp.asarray(centers_x, dtype=img.dtype)
            oy = jnp.asarray(wy0s, dtype=img.dtype)
            ox = jnp.asarray(wx0s, dtype=img.dtype)
            return (
                py_a + oy + half - cy, px_a + ox + half - cx,
                py_i + oy + half - cy, px_i + ox + half - cx,
            )

        return frame_fn

    if method == "template":
        def frame_fn(img, prev, tpl_arg, eps):
            prep = ncc_ops.zncc_prepare_image(img, s, s, eps=eps)

            tpl_inc = _extract_tiles(prev, starts, s)
            inc_bank = jax.vmap(
                lambda t: ncc_ops.prep_template(t, H, W)
            )(tpl_inc)

            # whole banks at once; only the 3x3 subpixel neighbourhoods
            # touch the maps after the per-map argmax
            def bank_peaks(bank):
                maps, iy, ix, vb = ncc_ops.ncc_bank_masked_peaks(
                    prep, bank, eps=eps
                )

                def pk(c, i, j):
                    di, dj = taylor(c, i, j, vb)
                    return i.astype(c.dtype) + di, j.astype(c.dtype) + dj

                return jax.vmap(pk)(maps, iy, ix)

            py_a, px_a = bank_peaks(tpl_arg)
            py_i, px_i = bank_peaks(inc_bank)

            half = (s - 1) / 2.0
            cy = jnp.asarray(centers_y, dtype=img.dtype)
            cx = jnp.asarray(centers_x, dtype=img.dtype)
            return (
                py_a + half - cy, px_a + half - cx,
                py_i + half - cy, px_i + half - cx,
            )

        return frame_fn

    # phase correlation
    def frame_fn(img, prev, tpl_arg, eps):
        img_z = pc_ops.zscore2d(img, eps=eps)
        Fi = jnp.fft.rfft2(img_z)

        def peak_shift(Ft):
            prod = Fi * jnp.conj(Ft)
            cps = prod / (jnp.abs(prod) + eps)
            corr = jnp.fft.irfft2(cps, s=(H, W))
            mag = jnp.abs(jnp.fft.fftshift(corr, axes=(-2, -1)))
            i, j = pc_ops.argmax2d(mag)
            di, dj = taylor(mag, i, j)
            dy = (i - H // 2).astype(mag.dtype) + di
            dx = (j - W // 2).astype(mag.dtype) + dj
            return dy, dx

        tiles_prev = _extract_tiles(prev, starts, s)
        tiles_prev_z = jax.vmap(lambda t: pc_ops.zscore2d(t, eps=eps))(tiles_prev)
        Ft_inc = jnp.fft.rfft2(_embed_tiles(tiles_prev_z, starts, s, H, W, img.dtype))

        dy_a, dx_a = jax.vmap(peak_shift)(tpl_arg)
        dy_i, dx_i = jax.vmap(peak_shift)(Ft_inc)
        return dy_a, dx_a, dy_i, dx_i

    return frame_fn


# Metrics and tracking run as TWO programs per chunk sharing the same
# device-resident float chunk (frame-0 templates are rebuilt in-program
# from the float frame), and the tracker sees at most _TRACK_SUB frames per
# program — larger frame chunks run the metrics program at full width and
# slice the same device chunk for tracking. Both splits worked around
# miscompiles of an earlier accelerator backend; they are correct on the
# GPU and stay until a measurement there shows fusing them pays.
# BARC4DIP_TPU_TRACK_SUB overrides the cap.
_TRACK_SUB = int(os.environ.get("BARC4DIP_TPU_TRACK_SUB", "4"))


@lru_cache(maxsize=64)
def _metrics_chunk_program(
    groups: tuple, mode: str, sat: float | None, eps: float, flip: bool,
    full_maps: bool,
):
    metric_fn = speckle_device_fn(frozenset(groups), mode, sat, eps, full_maps)

    def per_frame(img):
        hint = int_value_hint(img.dtype)  # static: raw chunk dtype
        img = _to_compute(img)
        return metric_fn(img[::-1, :] if flip else img, int_range=hint)

    return jax.jit(jax.vmap(per_frame))


@lru_cache(maxsize=16)
def _metrics_stack_program(
    groups: tuple, mode: str, sat: float | None, eps: float, flip: bool,
    full_maps: bool, slab: int = 4, packed: bool = False,
):
    """Superchunk metrics program: ONE executable processes a whole
    (T_exec, H, W) batch by ``lax.map`` over ``slab``-wide sub-batches.

    Identical per-frame math to :func:`_metrics_chunk_program` (the map
    body IS that program's vmapped frame function at the same width, so
    per-iteration buffer sizes match the chunk path) — processing T frames
    in one dispatch instead of T/slab removes the per-dispatch cost from
    device-resident runs. ``T_exec`` must be a multiple of ``slab``.
    """
    metric_fn = speckle_device_fn(frozenset(groups), mode, sat, eps, full_maps)

    def per_frame(img):
        hint = int_value_hint(img.dtype)  # static: raw chunk dtype
        img = _to_compute(img)
        return metric_fn(img[::-1, :] if flip else img, int_range=hint)

    slab_fn = jax.vmap(per_frame)

    @jax.jit
    def run(stack_dev):
        T = stack_dev.shape[0]
        slabs = stack_dev.reshape((T // slab, slab) + stack_dev.shape[1:])
        out = jax.lax.map(slab_fn, slabs)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((T,) + a.shape[2:]), out
        )

    if not packed:
        return run

    # Packed output: every leaf ravelled into ONE flat float vector so the
    # host pull is a single transfer instead of one per leaf (~60). Exact:
    # leaves are cast (loss-free) to the widest float dtype present and
    # restored by unpack_metrics.
    @jax.jit
    def run_packed(stack_dev):
        out = run(stack_dev)
        leaves = jax.tree_util.tree_leaves(out)
        if not all(jnp.issubdtype(l.dtype, jnp.floating) for l in leaves):
            raise TypeError("packed metrics require all-float leaves")
        wide = jnp.result_type(*[l.dtype for l in leaves])
        return jnp.concatenate([jnp.ravel(l).astype(wide) for l in leaves])

    return run_packed


def metrics_pack_spec(prog_unpacked, stack_shape, dtype):
    """(treedef, [(shape, dtype), ...]) for unpacking a packed metrics
    vector — derived by abstract evaluation of the UNPACKED program at the
    same input shape (no compile, no device work)."""
    out = jax.eval_shape(
        prog_unpacked, jax.ShapeDtypeStruct(tuple(stack_shape), dtype)
    )
    leaves, treedef = jax.tree_util.tree_flatten(out)
    return treedef, [(tuple(l.shape), l.dtype) for l in leaves]


def unpack_metrics(flat_np, treedef, shapes):
    """Inverse of the packed-output concatenation (host-side, exact)."""
    flat_np = np.asarray(flat_np)
    out, off = [], 0
    for shp, dt in shapes:
        n = int(np.prod(shp)) if shp else 1
        out.append(flat_np[off : off + n].reshape(shp).astype(dt, copy=False))
        off += n
    return jax.tree_util.tree_unflatten(treedef, out)


@lru_cache(maxsize=16)
def _track_stack_program(
    method: str, subpixel: bool, H: int, W: int, s: int, starts_key: tuple,
    search: int | None = None, slab: int = 4,
):
    """Superchunk tracking program: ONE executable tracks a whole
    (T_exec, H, W) batch by ``lax.scan`` over ``slab``-wide sub-batches,
    carrying the incremental-tracking tail frame through the scan.

    The scan body is exactly the ``_TRACK_SUB``-wide tracker the chunked
    path runs (same vmapped frame function, same per-iteration buffer
    sizes; scan reuses the body's buffers across iterations).
    ``T_exec`` must be a multiple of ``slab``. Returns
    ({dy_a, dx_a, dy_i, dx_i} with leading T_exec axis, tail_frame).
    """
    starts = np.asarray(starts_key, np.int32).reshape(-1, 2)
    track_fn = _make_track_frame_fn(H, W, s, starts, subpixel, method, search)
    windows = (
        _search_windows(H, W, s, starts, search)
        if (method == "template" and search is not None)
        else None
    )
    corr_w = windows[2] if windows is not None else None

    @jax.jit
    def run(stack_raw, prev_tail, frame0, track_eps):
        tpl_arg = _build_tpl0(frame0, starts, s, H, W, method, track_eps, corr_w)
        T = stack_raw.shape[0]
        slabs = stack_raw.reshape(T // slab, slab, H, W)

        def body(prev, slab_raw):
            slab_frames = _to_compute(slab_raw)
            prevs = jnp.concatenate([prev[None], slab_frames[:-1]], axis=0)
            dy_a, dx_a, dy_i, dx_i = jax.vmap(
                lambda im, pr: track_fn(im, pr, tpl_arg, track_eps)
            )(slab_frames, prevs)
            return slab_frames[-1], {
                "dy_a": dy_a, "dx_a": dx_a, "dy_i": dy_i, "dx_i": dx_i
            }

        tail, outs = jax.lax.scan(body, _to_compute(prev_tail), slabs)
        outs = jax.tree_util.tree_map(
            lambda a: a.reshape((T,) + a.shape[2:]), outs
        )
        return outs, tail

    return run


@lru_cache(maxsize=64)
def _track_chunk_program(
    method: str, subpixel: bool, H: int, W: int, s: int, starts_key: tuple,
    search: int | None = None,
):
    starts = np.asarray(starts_key, np.int32).reshape(-1, 2)
    track_fn = _make_track_frame_fn(H, W, s, starts, subpixel, method, search)
    windows = (
        _search_windows(H, W, s, starts, search)
        if (method == "template" and search is not None)
        else None
    )
    corr_w = windows[2] if windows is not None else None

    @jax.jit
    def chunk(chunk_raw, prev_tail, frame0, track_eps):
        frames = _to_compute(chunk_raw)
        tpl_arg = _build_tpl0(frame0, starts, s, H, W, method, track_eps, corr_w)
        prevs = jnp.concatenate([prev_tail[None], frames[:-1]], axis=0)
        dy_a, dx_a, dy_i, dx_i = jax.vmap(
            lambda im, pr: track_fn(im, pr, tpl_arg, track_eps)
        )(frames, prevs)
        return (
            {"dy_a": dy_a, "dx_a": dx_a, "dy_i": dy_i, "dx_i": dx_i},
            frames[-1],
        )

    return chunk


def device_compute_probe(
    stack,
    grid_slices,
    *,
    groups: set,
    mode: str,
    sat: float | None,
    eps: float,
    flip: bool,
    method: str = "template",
    subpixel: bool = True,
    track_eps: float = 1e-9,
    frame_chunk: int = 4,
    search_radius: int | None = None,
) -> dict:
    """Pure device-compute throughput of the fused stack programs.

    The probed stack is uploaded and forced to residency FIRST; the timed
    region then runs the superchunk metrics+tracking programs (the same
    per-slab math and widths as production: ``frame_chunk``-wide metrics
    sub-batches, ``_TRACK_SUB``-wide tracking sub-batches — see
    :func:`_metrics_stack_program` / :func:`_track_stack_program`, the
    device-resident path of :func:`run_fused_speckle_stack`) and the
    scalar result pulls: what the device sustains when the transfers are
    free. Returns {"elapsed_s", "frames", "mpix_s"}.
    """
    import time as _time

    T, H, W = (int(v) for v in stack.shape)
    starts, _centers, s = _grid_geometry(grid_slices)
    starts_key = tuple(int(v) for v in starts.ravel())
    compute_dtype = np.float64 if stack.dtype == np.float64 else np.float32
    B = max(1, min(int(frame_chunk), T))

    # The probe holds the whole probed stack device-resident; cap the
    # probed frame count at ~2 GB of resident frames so a production-size
    # stack leaves headroom for program temporaries.
    frame_bytes = H * W * np.dtype(compute_dtype).itemsize
    cap = max(B, int((2 << 30) // max(frame_bytes, 1)) // B * B)
    if T > cap:
        stack = stack[:cap]
        T = cap

    # Superchunk programs: the whole probed stack runs through TWO
    # executables (metrics lax.map + tracking lax.scan) instead of
    # 2*ceil(T/B), so dispatch cost stays out of a device-compute number.
    track_slab = min(_TRACK_SUB, B)
    import math as _math

    step = _math.lcm(B, track_slab)
    if T >= step:
        T = T // step * step
        stack = stack[:T]
    else:
        stack = np.concatenate(
            [stack, np.repeat(stack[-1:], step - T, axis=0)], axis=0
        )
        T = step

    metrics_prog = _metrics_stack_program(
        tuple(sorted(groups)), mode, sat, eps, bool(flip), False,
        B, True,  # packed: one-pull scalar vector
    )
    track_prog = _track_stack_program(
        method, bool(subpixel), H, W, s, starts_key,
        None if search_radius is None else int(search_radius), track_slab,
    )
    stack_dev = jnp.asarray(np.ascontiguousarray(stack))
    # chunk-0 semantics: the prev of frame 0 is frame 0 itself, so the
    # initial incremental tail IS the abs-tracking reference frame
    frame0_dev = stack_dev[0]
    eps_t = jnp.asarray(track_eps, dtype=compute_dtype)

    def run_all(*, metrics=True, tracking=True):
        m = metrics_prog(stack_dev) if metrics else None
        t = (
            track_prog(stack_dev, frame0_dev, frame0_dev, eps_t)[0]
            if tracking
            else None
        )
        # realise everything (scalar leaves force the device work)
        return jax.device_get((m, t))

    run_all()  # compile + warm (also forces the stack upload to residency)

    def timed(**kw):
        t0 = _time.perf_counter()
        out = run_all(**kw)
        return _time.perf_counter() - t0, out

    elapsed, out = timed()
    metrics_s, _ = timed(tracking=False)
    tracking_s, _ = timed(metrics=False)
    if not np.all(np.isfinite(out[1]["dy_a"])):
        # explicit raise (not assert: a no-op under python -O) — a probe
        # that produced non-finite tracking must not report a throughput
        raise RuntimeError(
            "device_compute_probe: non-finite tracking output"
        )
    return {
        "elapsed_s": elapsed,
        "metrics_only_s": metrics_s,
        "tracking_only_s": tracking_s,
        "frames": T,
        "mpix_s": (T * H * W / 1e6) / elapsed if elapsed > 0 else float("inf"),
    }


def _build_tpl0(frame0, starts, s, H, W, method, eps, corr_w=None):
    """Frame-0 template bank (template: NCC preps; phase: whitened spectra),
    built in-program from the float frame.  ``corr_w`` sizes the template
    spectra for windowed search (correlations run at (corr_w, corr_w))."""
    frame0 = _to_compute(frame0)
    tiles = _extract_tiles(frame0, starts, s)
    if method == "template":
        fft_h = H if corr_w is None else corr_w
        fft_w = W if corr_w is None else corr_w
        return jax.vmap(lambda t: ncc_ops.prep_template(t, fft_h, fft_w))(tiles)
    tiles_z = jax.vmap(lambda t: pc_ops.zscore2d(t, eps=eps))(tiles)
    return jnp.fft.rfft2(_embed_tiles(tiles_z, starts, s, H, W, frame0.dtype))


def _embed_tiles(tiles, starts, s, H, W, dtype):
    """Each (s, s) tile zero-padded into an (H, W) frame at its static
    in-frame offset (phase-correlation templates)."""
    return jnp.stack(
        [
            jnp.pad(
                tiles[k].astype(jnp.float32).astype(dtype),
                ((y0, H - y0 - s), (x0, W - x0 - s)),
            )
            for k, (y0, x0) in enumerate(starts)
        ]
    )


def run_fused_speckle_stack(
    stack: np.ndarray,
    grid_slices,
    *,
    groups: set,
    mode: str,
    sat: float | None,
    eps: float,
    flip: bool,
    method: str = "template",
    subpixel: bool = True,
    track_eps: float = 1e-9,
    frame_chunk: int = 4,
    mesh=None,
    checkpoint=None,
    verbose: bool = False,
    full_maps: bool = True,
    search_radius: int | None = None,
):
    """Run the fused metrics+tracking pipeline over a (T, H, W) stack.

    Returns (metrics_pytree_with_T_axis, (dx_abs, dy_abs, dx_inc, dy_inc)
    each (T, 3, 3) float32).

    A stack that is ALREADY device-resident (a ``jax.Array``) takes the
    few-dispatch superchunk path (:func:`_run_resident_stack`): there is
    no upload to overlap, so the chunked loop's 2*ceil(T/B) dispatches
    would buy nothing. Mesh/checkpoint runs keep the chunked loop (their semantics are
    chunk-layout-keyed).
    """
    if (
        mesh is None
        and checkpoint is None
        and isinstance(stack, jax.Array)
        and getattr(stack, "ndim", 0) == 3
    ):
        return _run_resident_stack(
            stack, grid_slices, groups=groups, mode=mode, sat=sat, eps=eps,
            flip=flip, method=method, subpixel=subpixel, track_eps=track_eps,
            frame_chunk=frame_chunk, verbose=verbose,
            search_radius=search_radius,
        )
    T, H, W = (int(v) for v in stack.shape)
    starts, _centers, s = _grid_geometry(grid_slices)
    starts_key = tuple(int(v) for v in starts.ravel())

    compute_dtype = np.float64 if stack.dtype == np.float64 else np.float32
    B = max(1, min(int(frame_chunk), T))

    put_frames = jnp.asarray
    put_repl = jnp.asarray
    if mesh is not None:
        from ..parallel.mesh import frames_sharding, replicated_sharding

        B = max(1, -(-B // mesh.size)) * mesh.size
        fsh = frames_sharding(mesh)
        rsh = replicated_sharding(mesh)
        put_frames = lambda a: jax.device_put(jnp.asarray(a), fsh)  # noqa: E731
        put_repl = lambda a: jax.device_put(jnp.asarray(a), rsh)  # noqa: E731

    eps_t = jnp.asarray(track_eps, dtype=compute_dtype)
    frame0_dev = put_repl(np.asarray(stack[0], dtype=compute_dtype))

    metrics_prog = _metrics_chunk_program(
        tuple(sorted(groups)), mode, sat, eps, bool(flip), bool(full_maps),
    )
    track_prog = _track_chunk_program(
        method, bool(subpixel), H, W, s, starts_key,
        None if search_radius is None else int(search_radius),
    )

    dy_abs = np.empty((T, 9), np.float32)
    dx_abs = np.empty((T, 9), np.float32)
    dy_inc = np.empty((T, 9), np.float32)
    dx_inc = np.empty((T, 9), np.float32)
    metric_pieces: list = []

    import time as _time

    perf = {
        "upload_s": 0.0, "dispatch_s": 0.0, "pull_wait_s": 0.0,
        "upload_io_s": 0.0, "upload_bytes": 0, "pull_bytes": 0, "chunks": 0,
    }
    io_intervals: list = []

    # Chunk schedule: ramped first/tail chunks on single-device runs
    # (see common.chunk_schedule; mesh runs keep uniform chunks because
    # B is rounded to a mesh multiple)
    from .common import chunk_schedule

    schedule = chunk_schedule(T, B, ramp=mesh is None)
    widths = {c0: w for c0, _n, w in schedule}

    def _prepare_chunk(c0: int) -> tuple:
        """Pad + upload one chunk (original dtype — half the wire bytes for
        uint16 detector frames). Runs on the prefetch thread."""
        return upload_padded_chunk(stack, c0, widths[c0], T, put_frames)

    def _collect(out_dev, c0, c1, slot):
        t0 = _time.perf_counter()
        raw = jax.device_get(out_dev)
        perf["pull_wait_s"] += _time.perf_counter() - t0
        perf["pull_bytes"] += sum(
            a.nbytes for a in jax.tree_util.tree_leaves(raw)
        )
        n = c1 - c0
        piece = jax.tree_util.tree_map(lambda a: np.asarray(a)[:n], raw)
        if checkpoint is not None:
            checkpoint.save(c0, piece)
        metric_pieces[slot] = piece["metrics"]
        tr = piece["track"]
        dy_abs[c0:c1] = tr["dy_a"]
        dx_abs[c0:c1] = tr["dx_a"]
        dy_inc[c0:c1] = tr["dy_i"]
        dx_inc[c0:c1] = tr["dx_i"]

    pending = None
    prev_tail = None
    last = -1
    uploads: dict[int, object] = {}
    prefetch = loop_prefetcher()
    from .common import upload_streams

    _streams = upload_streams()
    for sched_i, (c0, n, Bc) in enumerate(schedule):
        if verbose:
            last = progress_update("Speckle stack loop", c0, T, last)
        c1 = c0 + n
        metric_pieces.append(None)
        slot = len(metric_pieces) - 1

        if checkpoint is not None and checkpoint.has(c0):
            piece = checkpoint.load(c0)
            metric_pieces[slot] = piece["metrics"]
            tr = piece["track"]
            dy_abs[c0:c1] = tr["dy_a"]
            dx_abs[c0:c1] = tr["dx_a"]
            dy_inc[c0:c1] = tr["dy_i"]
            dx_inc[c0:c1] = tr["dx_i"]
            prev_tail = None  # force re-derivation from host for next chunk
            continue

        if prev_tail is None:
            # chunk 0: prev of frame c0 is frame max(c0-1, 0)
            prev_tail = put_repl(
                np.asarray(stack[max(c0 - 1, 0)], dtype=compute_dtype)
            )

        # ONE upload per chunk; metrics and tracking consume the same
        # device-resident array through two executables (see backend note).
        # The upload usually started on the prefetch thread while the host
        # was waiting on the previous chunk's results — upload_s records the
        # residual blocking wait, upload_io_s the actual transfer time.
        t_up = _time.perf_counter()
        fut = uploads.pop(c0, None)
        if fut is None:
            fut = prefetch.submit(_prepare_chunk, c0)
        chunk_dev, nbytes, io_iv = fut.result()
        perf["upload_s"] += _time.perf_counter() - t_up
        io_intervals.append(io_iv)
        perf["upload_bytes"] += nbytes
        perf["chunks"] += 1
        t_disp = _time.perf_counter()
        metrics_dev = metrics_prog(chunk_dev)
        # tracker width is capped at _TRACK_SUB frames per executable (see
        # backend note). Under a mesh the cap applies PER DEVICE — the
        # miscompile lives in the per-device program, and the fake CPU mesh
        # being clean at any width proves nothing about real chips — so a
        # sharded chunk is sliced once each device's local share would
        # exceed _TRACK_SUB frames.
        n_dev = 1 if mesh is None else int(mesh.size)
        track_sub = min(Bc, _TRACK_SUB * n_dev)
        if track_sub >= Bc:
            track_dev, tail = track_prog(chunk_dev, prev_tail, frame0_dev, eps_t)
        else:
            sub_outs = []
            sub_tail = prev_tail
            for s0 in range(0, Bc, track_sub):
                sub_out, sub_tail = track_prog(
                    chunk_dev[s0 : min(s0 + track_sub, Bc)],
                    sub_tail, frame0_dev, eps_t,
                )
                sub_outs.append(sub_out)
            track_dev = jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0), *sub_outs
            )
            tail = sub_tail
        perf["dispatch_s"] += _time.perf_counter() - t_disp
        out_dev = {"metrics": metrics_dev, "track": track_dev}
        # start the next uploads now: they ride the link (up to
        # upload_streams() concurrent transfers) while the host blocks
        # below on this/previous chunk's device compute
        for nxt_c0, _nn, _nw in schedule[sched_i + 1 : sched_i + 1 + _streams]:
            if nxt_c0 not in uploads and not (
                checkpoint is not None and checkpoint.has(nxt_c0)
            ):
                uploads[nxt_c0] = prefetch.submit(_prepare_chunk, nxt_c0)
        if pending is not None:
            _collect(*pending)
        pending = (out_dev, c0, c1, slot)
        # the padded tail repeats the last real frame, so frames[-1] is
        # correct even for the padded final chunk
        prev_tail = tail if n == Bc else None

    if pending is not None:
        _collect(*pending)
    if verbose:
        progress_done("Speckle stack loop")

    # wire-busy time: union of the (possibly overlapping) stream intervals
    edge = -np.inf
    for lo, hi in sorted(io_intervals):
        lo = max(lo, edge)
        if hi > lo:
            perf["upload_io_s"] += hi - lo
        edge = max(edge, hi)
    LAST_RUN_PERF.clear()
    LAST_RUN_PERF.update(perf)

    metrics_tree = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=0), *metric_pieces
    )
    return metrics_tree, (
        dx_abs.reshape(T, 3, 3),
        dy_abs.reshape(T, 3, 3),
        dx_inc.reshape(T, 3, 3),
        dy_inc.reshape(T, 3, 3),
    )


def _run_resident_stack(
    stack,
    grid_slices,
    *,
    groups: set,
    mode: str,
    sat: float | None,
    eps: float,
    flip: bool,
    method: str = "template",
    subpixel: bool = True,
    track_eps: float = 1e-9,
    frame_chunk: int = 4,
    verbose: bool = False,
    full_maps: bool = False,
    search_radius: int | None = None,
):
    """Few-dispatch pipeline for an ALREADY device-resident (jax.Array)
    stack — the serving pattern, and the workload the device-compute
    probe reports.

    The chunked loop exists to overlap uploads with compute; with a
    resident stack there is nothing to overlap, so the stack runs through
    two superchunk executables per up-to-``BARC4DIP_TPU_STACK_EXEC`` frames
    (default 64): metrics as ``lax.map`` over ``frame_chunk``-wide slabs,
    tracking as ``lax.scan`` over ``_TRACK_SUB``-wide slabs. Per-slab
    math, widths and buffer sizes are identical to the chunked loop
    (tests assert exact output equality), only the dispatch count drops
    from 2*ceil(T/frame_chunk) to 2*ceil(T/64).
    """
    import math as _math
    import time as _time

    T, H, W = (int(v) for v in stack.shape)
    starts, _centers, s = _grid_geometry(grid_slices)
    starts_key = tuple(int(v) for v in starts.ravel())
    compute_dtype = (
        np.float64 if stack.dtype == jnp.float64 else np.float32
    )

    B = max(1, min(int(frame_chunk), T))
    track_slab = min(_TRACK_SUB, B)
    step = _math.lcm(B, track_slab)
    sc_env = max(step, int(os.environ.get("BARC4DIP_TPU_STACK_EXEC", "64")))
    SC = min(sc_env // step * step, -(-T // step) * step)

    # all-scalar output trees (full_maps=False) pull as ONE packed vector:
    # a single transfer instead of ~60 per-leaf pulls
    margs = (
        tuple(sorted(groups)), mode, sat, eps, bool(flip), bool(full_maps), B,
    )
    use_packed = not full_maps
    metrics_prog = _metrics_stack_program(*margs, use_packed)
    if use_packed:
        pack_spec = metrics_pack_spec(
            _metrics_stack_program(*margs), (SC, H, W), stack.dtype
        )
    track_prog = _track_stack_program(
        method, bool(subpixel), H, W, s, starts_key,
        None if search_radius is None else int(search_radius), track_slab,
    )

    frame0_dev = stack[0]
    # chunk-0 semantics: the prev of frame 0 is frame 0 itself
    prev_tail = frame0_dev
    eps_t = jnp.asarray(track_eps, dtype=compute_dtype)

    dy_abs = np.empty((T, 9), np.float32)
    dx_abs = np.empty((T, 9), np.float32)
    dy_inc = np.empty((T, 9), np.float32)
    dx_inc = np.empty((T, 9), np.float32)
    metric_pieces: list = []

    perf = {
        "upload_s": 0.0, "dispatch_s": 0.0, "pull_wait_s": 0.0,
        "upload_io_s": 0.0, "upload_bytes": 0, "pull_bytes": 0,
        "chunks": 0, "resident": True,
    }

    last = -1
    for c0 in range(0, T, SC):
        if verbose:
            last = progress_update("Speckle stack loop", c0, T, last)
        c1 = min(c0 + SC, T)
        n = c1 - c0
        t_disp = _time.perf_counter()
        sub = stack[c0:c1]
        if n < SC:
            # pad the tail by repeating the last frame (same contract as
            # upload_padded_chunk; the padded tail keeps frames[-1] valid)
            sub = jnp.concatenate(
                [sub, jnp.repeat(sub[-1:], SC - n, axis=0)], axis=0
            )
        metrics_dev = metrics_prog(sub)
        track_dev, tail = track_prog(sub, prev_tail, frame0_dev, eps_t)
        prev_tail = stack[c1 - 1] if n < SC else tail
        perf["dispatch_s"] += _time.perf_counter() - t_disp
        t_pull = _time.perf_counter()
        raw = jax.device_get({"metrics": metrics_dev, "track": track_dev})
        perf["pull_wait_s"] += _time.perf_counter() - t_pull
        perf["pull_bytes"] += sum(
            a.nbytes for a in jax.tree_util.tree_leaves(raw)
        )
        perf["chunks"] += 1
        metrics_np = raw["metrics"]
        if use_packed:
            metrics_np = unpack_metrics(metrics_np, *pack_spec)
        metric_pieces.append(
            jax.tree_util.tree_map(lambda a: np.asarray(a)[:n], metrics_np)
        )
        tr = raw["track"]
        dy_abs[c0:c1] = tr["dy_a"][:n]
        dx_abs[c0:c1] = tr["dx_a"][:n]
        dy_inc[c0:c1] = tr["dy_i"][:n]
        dx_inc[c0:c1] = tr["dx_i"][:n]
    if verbose:
        progress_done("Speckle stack loop")

    LAST_RUN_PERF.clear()
    LAST_RUN_PERF.update(perf)

    metrics_tree = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=0), *metric_pieces
    )
    return metrics_tree, (
        dx_abs.reshape(T, 3, 3),
        dy_abs.reshape(T, 3, 3),
        dx_inc.reshape(T, 3, 3),
        dy_inc.reshape(T, 3, 3),
    )
