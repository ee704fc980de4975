#!/usr/bin/env python
# SPDX-License-Identifier: CECILL-2.1
"""Smoke test of the main path on one NVIDIA GPU: Config D end to end.

Config D is ``speckle_stack_stats`` with every metric group, 9x9-subtile
tiles, abs/inc template tracking with subpixel refinement, on 64 frames of
2048 x 2048 uint16 speckle under a known spiral motion. The phases run in
order and the first failure ends the run with a non-zero exit code:

1. device: JAX version, devices and the card's name and power limit; the
   default platform must be ``gpu``;
2. compile: the Config D metrics and tracking programs, with their
   ``memory_analysis()`` and compile seconds;
3. NumPy input (the chunked upload path): tracking error against the
   known motion <= 0.05 px, and every full and tile metric leaf of the
   first K frames within 1e-4 of the same public call run in float64 on
   the CPU (f95, a quantized statistic, within one frequency bin);
4. device-resident input (a ``jax.Array``): every leaf equal to phase 3
   within 1e-5;
5. ``sharpness_stack_stats`` on the same K frames against the float64 CPU
   run at 1e-4;
6. off the main path, at 2048²: flat-field bad-pixel repair against
   ``scipy.ndimage.median_filter``, ``register_stack`` on known shifts
   (<= 0.05 px), and the dense XST field (``method="auto"``) against the
   ``"fft"`` method in float64 on the CPU.

The float64 CPU reference runs in a child process started with
``JAX_PLATFORMS=cpu``, so only this process opens the card. A leaf's
error is its normalized inf-norm difference, max|a - b| / max|b|.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
timings and gate values go on earlier lines.

Usage:
    python chip_smoke.py                # one GPU, every phase above
    python chip_smoke.py --four-cards   # only the frame mesh over four GPUs,
                                        # compared with one GPU
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import barc4dip_tpu as dip
from barc4dip_tpu.config import platform
from barc4dip_tpu.utils import speckle_stack
from barc4dip_tpu.utils.lazy import LazyMapStack
from barc4dip_tpu.utils.synthetic import spiral_motion

import jax
import jax.numpy as jnp

FRAMES = 64
SIDE = 2048
K = 4                   # frames compared with the float64 CPU run
SEED = 1234
TRACK_TOL_PX = 0.05
CPU_RTOL = 1e-4         # float32 on the card vs float64 on the CPU
RESIDENT_RTOL = 1e-5    # resident vs NumPy input, both on the card
FLAT_RTOL = 1e-5
XST_TOL_PX = 0.01
F95_TOL_BINS = 1.0      # f95 is quantized: see f95_error

STACK_KW = dict(metrics="all", tiles=True, tracking_method="template",
                subpixel=True, verbose=False, frame_chunk=4)
SHARP_KW = dict(metrics="all", tiles=True, verbose=False)


class GateError(RuntimeError):
    """A phase's result is outside its limit."""


def log(msg: str) -> None:
    print(msg, flush=True)


def gate(name: str, value: float, limit: float) -> None:
    ok = bool(value <= limit)
    log(f"gate {name}: {value:.3e} (limit {limit:g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise GateError(f"{name}: {value!r} > {limit!r}")


def last_line(devices) -> str:
    """The result line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def require_gpu() -> None:
    if platform() != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX's default platform is {platform()!r}"
        )


def card_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# leaves and their comparison
# ---------------------------------------------------------------------------

def leaves(out: dict, sections=("full", "tiles"), k: int | None = K) -> dict:
    """{dotted.path: float64 array} of a stats result's numeric leaves.

    ``k`` keeps the first k frames of every leaf (all frames when None);
    lazy per-frame maps are always limited to their first ``K`` frames so
    a comparison never pulls a whole stack of maps."""
    flat: dict = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key, v in node.items():
                walk(f"{path}.{key}", v)
            return
        if isinstance(node, LazyMapStack):
            n = min(K if k is None else k, len(node))
            flat[path] = np.stack([np.asarray(node[t], np.float64)
                                   for t in range(n)])
            return
        arr = np.asarray(node)
        if arr.dtype.kind not in "fiu":
            return
        arr = arr.astype(np.float64)
        flat[path] = arr[:k] if (k is not None and arr.ndim) else arr

    for section in sections:
        if section in out:
            walk(section, out[section])
    return flat


def leaf_error(a, b, *, absolute: bool = False) -> float:
    """max|a - b| over max(|a|, |b|) (absolute when ``absolute``); inf when
    the shapes or the finite masks differ."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return float("inf")
    if not fa.any():
        return 0.0
    d = float(np.max(np.abs(a[fa] - b[fb])))
    if absolute:
        return d
    scale = max(float(np.max(np.abs(a[fa]))), float(np.max(np.abs(b[fb]))))
    return d / scale if scale > 0 else 0.0


def _scale(arrs) -> float:
    fin = [np.abs(a[np.isfinite(a)]) for a in arrs if a is not None]
    return max((float(f.max()) for f in fin if f.size), default=0.0)


def _spread_parent(path: str) -> str | None:
    """The leaf a spread leaf is taken over: ``x.std`` -> ``x.mean`` (tile
    grids), ``a.std_dx`` -> ``a.dx`` (tracking over the ROI grid)."""
    if path.endswith(".std"):
        return path[: -len(".std")] + ".mean"
    head, _, name = path.rpartition(".")
    return f"{head}.{name[4:]}" if name.startswith("std_") else None


def leaf_errors(got: dict, want: dict) -> dict:
    """{path: error} over two leaf dicts; a leaf present on one side only
    is an infinite error.

    Two leaf kinds are normalized by what they measure: a dB leaf compares
    absolutely, scaled to the relative error of the underlying ratio
    (ln(10)/20 per dB), since its own value passes through zero; a spread
    leaf (the std of nine near-equal tiles or ROI displacements) is
    normalized by the scale of the values it is taken over, since an error
    in the spread cannot exceed the error in those values."""
    errs = {path: float("inf") for path in set(got) ^ set(want)}
    for path in set(got) & set(want):
        if ".SNRdB" in path:
            err = leaf_error(got[path], want[path], absolute=True)
            err *= np.log(10.0) / 20.0
        else:
            err = leaf_error(got[path], want[path])
            parent = _spread_parent(path)
            if parent in want and parent in got and np.isfinite(err):
                own = _scale([got[path], want[path]])
                par = _scale([got[parent], want[parent]])
                if par > own > 0.0:
                    err *= own / par
        errs[path] = err
    return errs


def compare(got: dict, want: dict) -> tuple[str | None, float]:
    """(worst leaf, its error); see :func:`leaf_errors`."""
    errs = leaf_errors(got, want)
    if not errs:
        return None, 0.0
    path = max(sorted(errs), key=lambda p: errs[p])
    return path, errs[path]


def f95_error(got: dict, want: dict, H: int, W: int) -> float:
    """Largest f95 difference in frequency bins of its (sub)frame's grid.

    f95 is the smallest integer-radius frequency class whose cumulative
    PSD mass reaches 0.95, so it moves in steps of one class (~1e-3 of its
    value on a 227-px subtile) whenever the mass sits within float32
    rounding of 0.95: float32 and float64 runs legitimately differ by one
    class there. It is gated in bins (one bin = 1/N of the padded
    (sub)frame side) instead of relatively."""
    from barc4dip_tpu.config import MIN_TILE_PX
    from barc4dip_tpu.metrics.common import choose_tiling_mode

    _, tile = choose_tiling_mode(H, W, tiles=True, min_tile_px=MIN_TILE_PX)
    worst = 0.0
    for path in want:
        if ".bandwidth.f95" not in path:
            continue
        if path not in got:
            return float("inf")
        n = max(H, W) if path.startswith("full.") else max(tile)
        worst = max(worst, n * leaf_error(got[path], want[path], absolute=True))
    return worst


def without_f95(flat: dict) -> dict:
    return {p: v for p, v in flat.items() if ".bandwidth.f95" not in p}


def gate_leaves(name: str, got: dict, want: dict, limit: float) -> None:
    errs = leaf_errors(got, want)
    worst = sorted(errs, key=lambda p: -errs[p])[:3]
    log(f"{name}: {len(errs)} leaves, worst "
        + ", ".join(f"{p} {errs[p]:.2e}" for p in worst))
    gate(name, compare(got, want)[1], limit)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def make_stack(frames: int = FRAMES, side: int = SIDE) -> np.ndarray:
    dys, dxs = spiral_motion(frames)
    return speckle_stack(
        frames, (side, side), grain_px=8.0, mean_counts=8000.0,
        dys=dys, dxs=dxs, seed=np.random.default_rng(SEED), dtype=np.uint16,
    )


def make_flat(side: int):
    """A smooth positive flat with ~0.1% dead pixels (zero response)."""
    rng = np.random.default_rng(SEED + 1)
    yy, xx = np.mgrid[0:side, 0:side] / side
    flat = (2000.0 * (1.0 + 0.2 * np.cos(3 * yy) * np.sin(2 * xx))
            + rng.normal(0.0, 20.0, (side, side))).astype(np.float32)
    flat[rng.random((side, side)) < 1e-3] = 0.0
    return flat


def flat_field_reference(img, flat):
    """Flat-field correction with dead-pixel repair in NumPy/SciPy: divide,
    scale by the median of the valid flat, then replace each dead pixel by
    the 3x3 median (``mode="reflect"``) of the corrected frame."""
    from scipy import ndimage

    img = img.astype(np.float64)
    den = flat.astype(np.float64)
    med = np.median(den)
    bad = den <= (1e-6 * med if med > 0 else 1e-6)
    out = img / np.where(bad, 1.0, den) * np.median(den[~bad])
    out[bad] = 0.0
    repaired = ndimage.median_filter(out, size=3, mode="reflect")
    return np.where(bad, repaired, out)


# ---------------------------------------------------------------------------
# the float64 CPU reference (child process)
# ---------------------------------------------------------------------------

def cpu_reference(workdir: str) -> int:
    """Child entry: the same public calls in float64 on the CPU."""
    jax.config.update("jax_enable_x64", True)
    if platform() != "cpu":
        raise SystemExit("the CPU reference must run with JAX_PLATFORMS=cpu")
    frames = np.load(os.path.join(workdir, "frames.npy")).astype(np.float64)
    xst = np.load(os.path.join(workdir, "xst.npy")).astype(np.float64)
    out = {}
    t0 = time.perf_counter()
    speck = dip.speckle_stack_stats(frames, **STACK_KW)
    out.update({f"speckle:{p}": v for p, v in leaves(speck).items()})
    sharp = dip.sharpness_stack_stats(frames, **SHARP_KW)
    out.update({f"sharpness:{p}": v for p, v in leaves(sharp).items()})
    field = dip.signal.track_displacement_field(xst[0], xst[1], method="fft")
    out.update({f"xst:{p}": field[p] for p in ("dy", "dx", "peak")})
    np.savez(os.path.join(workdir, "reference.npz"), **out)
    print(f"cpu reference: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def start_cpu_reference(workdir: str, stack: np.ndarray, xst: np.ndarray):
    np.save(os.path.join(workdir, "frames.npy"), stack[:K])
    np.save(os.path.join(workdir, "xst.npy"), xst)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference", workdir],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
    )


def wait_cpu_reference(proc, workdir: str) -> dict:
    t0 = time.perf_counter()
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"the float64 CPU reference exited with {rc}")
    log(f"waited {time.perf_counter() - t0:.1f} s for the CPU reference")
    with np.load(os.path.join(workdir, "reference.npz")) as z:
        ref = {k: z[k] for k in z.files}
    split: dict = {}
    for key, v in ref.items():
        kind, path = key.split(":", 1)
        split.setdefault(kind, {})[path] = v
    return split


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(n_cards: int = 1) -> list:
    log(f"jax {jax.__version__}")
    devices = jax.devices()
    log(f"devices: {devices}")
    log(f"platform: {platform()}, device_kind: {devices[0].device_kind}, "
        f"count: {len(devices)}")
    require_gpu()
    log(f"card (name, power limit): {card_name_power()}")
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found {len(devices)}")
    return devices


def phase_compile(stack: np.ndarray) -> None:
    """Compile the Config D chunk programs once, with their memory use."""
    from barc4dip_tpu.config import MIN_TILE_PX
    from barc4dip_tpu.metrics import stack_fused
    from barc4dip_tpu.metrics.common import choose_tiling_mode, normalize_groups
    from barc4dip_tpu.metrics.speckles import (
        _ALL_SPECKLE_GROUPS,
        tracking_grid_from_frame0,
    )

    _, H, W = stack.shape
    groups = normalize_groups("all", all_groups=_ALL_SPECKLE_GROUPS,
                              context="speckles", param_name="metrics")
    mode, _ = choose_tiling_mode(H, W, tiles=True, min_tile_px=MIN_TILE_PX)
    chunk = jax.ShapeDtypeStruct((STACK_KW["frame_chunk"], H, W), stack.dtype)
    frame = jax.ShapeDtypeStruct((H, W), jnp.float32)
    eps = jax.ShapeDtypeStruct((), jnp.float32)

    grid, *_ = tracking_grid_from_frame0(stack)
    starts, _c, s = stack_fused._grid_geometry(grid)
    programs = {
        "metrics": (stack_fused._metrics_chunk_program(
            tuple(sorted(groups)), mode, 65535.0, 1e-6, True, False), (chunk,)),
        "tracking": (stack_fused._track_chunk_program(
            "template", True, H, W, s, tuple(int(v) for v in starts.ravel()),
            None), (chunk, frame, frame, eps)),
    }
    for name, (prog, args) in programs.items():
        t0 = time.perf_counter()
        compiled = prog.lower(*args).compile()
        log(f"compile {name} program ({mode}, roi {s} px): "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"  memory_analysis: {compiled.memory_analysis()}")


def tracking_errors(out: dict, T: int) -> tuple[float, float]:
    """Max abs and inc tracking error [px] against the known motion."""
    dys, dxs = spiral_motion(T)
    ab, inc = out["temporal"]["abs"], out["temporal"]["inc"]
    err_abs = np.hypot(ab["dy"] - dys, ab["dx"] - dxs)
    ddy = np.diff(dys, prepend=dys[0])
    ddx = np.diff(dxs, prepend=dxs[0])
    err_inc = np.hypot(inc["dy"] - ddy, inc["dx"] - ddx)
    return float(np.nanmax(err_abs)), float(np.nanmax(err_inc))


def timed(label: str, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


def phase_stack(stack: np.ndarray, label: str, **kw) -> dict:
    out = timed(label, dip.speckle_stack_stats, stack, **STACK_KW, **kw)
    e_abs, e_inc = tracking_errors(out, stack.shape[0])
    gate(f"{label} tracking abs max error [px]", e_abs, TRACK_TOL_PX)
    gate(f"{label} tracking inc max error [px]", e_inc, TRACK_TOL_PX)
    return out


def phase_flat_field(frame: np.ndarray) -> None:
    from barc4dip_tpu.preprocessing import flat_field_correction

    flat = make_flat(frame.shape[-1])
    got = timed("flat_field_correction", flat_field_correction, frame,
                flats=flat, bad_pixel_removal=True)
    want = flat_field_reference(frame, flat)
    gate("flat-field vs scipy median repair", leaf_error(got, want), FLAT_RTOL)


def phase_register(side: int) -> None:
    from barc4dip_tpu.preprocessing import register_stack

    dys = np.array([0.0, 1.3, -3.45, 6.2])
    dxs = np.array([0.0, -2.6, 4.75, -0.8])
    frames = speckle_stack(4, (side, side), grain_px=6.0, dys=dys, dxs=dxs,
                           seed=SEED + 2)
    _aligned, shifts = timed("register_stack", register_stack, frames,
                             reference="first")
    err = np.hypot(shifts["dy"] - dys, shifts["dx"] - dxs)
    gate("register_stack max error [px]", float(err.max()), TRACK_TOL_PX)


def phase_xst(xst: np.ndarray) -> dict:
    field = timed("track_displacement_field (auto)",
                  dip.signal.track_displacement_field, xst[0], xst[1])
    log(f"  method {field['meta']['method']}, grid {field['meta']['grid_shape']}")
    return field


def run_single_card(stack: np.ndarray) -> None:
    """Phases 2-6 on the default device (a GPU, or the CPU in tests)."""
    T, H, W = stack.shape
    xst = np.stack([stack[min(5, T - 1)], stack[0]])
    with tempfile.TemporaryDirectory() as workdir:
        child = start_cpu_reference(workdir, stack, xst)
        try:
            phase_compile(stack)
            out_np = phase_stack(stack, "numpy input")
            out_dev = phase_stack(jnp.asarray(stack), "resident input")
            gate_leaves("resident vs numpy input",
                        leaves(out_dev, ("full", "tiles", "temporal"), None),
                        leaves(out_np, ("full", "tiles", "temporal"), None),
                        RESIDENT_RTOL)
            sharp = timed("sharpness_stack_stats", dip.sharpness_stack_stats,
                          stack[:K], **SHARP_KW)
            phase_flat_field(stack[1])
            phase_register(W)
            field = phase_xst(xst)
            ref = wait_cpu_reference(child, workdir)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    got, want = leaves(out_np), ref["speckle"]
    gate_leaves("speckle metrics vs float64 CPU (f95 aside)",
                without_f95(got), without_f95(want), CPU_RTOL)
    gate("speckle f95 vs float64 CPU [frequency bins]",
         f95_error(got, want, H, W), F95_TOL_BINS)
    gate_leaves("sharpness metrics vs float64 CPU", leaves(sharp),
                ref["sharpness"], CPU_RTOL)
    for key in ("dy", "dx"):
        gate(f"xst {key} vs float64 CPU fft [px]",
             float(np.max(np.abs(field[key] - ref["xst"][key]))), XST_TOL_PX)
    gate("xst peak vs float64 CPU fft",
         leaf_error(field["peak"], ref["xst"]["peak"]), CPU_RTOL)


def run_four_cards(stack: np.ndarray, devices, *, check_spread: bool = True) -> None:
    """The frame mesh over four devices against one device, leaf by leaf."""
    from barc4dip_tpu.parallel.mesh import frame_mesh

    mesh = frame_mesh(devices[:4])
    single = timed("one device", dip.speckle_stack_stats, stack, **STACK_KW)
    before = [_peak_bytes(d) for d in devices[1:4]]
    meshed = timed("four-device mesh", dip.speckle_stack_stats, stack,
                   mesh=mesh, **STACK_KW)
    e_abs, e_inc = tracking_errors(meshed, stack.shape[0])
    gate("mesh tracking abs max error [px]", e_abs, TRACK_TOL_PX)
    gate("mesh tracking inc max error [px]", e_inc, TRACK_TOL_PX)
    gate_leaves("four-device mesh vs one device",
                leaves(meshed, ("full", "tiles", "temporal"), None),
                leaves(single, ("full", "tiles", "temporal"), None),
                RESIDENT_RTOL)
    if check_spread:
        # the mesh run must have used devices 1-3, not only device 0
        after = [_peak_bytes(d) for d in devices[1:4]]
        log(f"peak bytes on devices 1-3: before {before}, after {after}")
        frame_bytes = stack[0].nbytes
        for d, b in zip(devices[1:4], after):
            if b is None or b < frame_bytes:
                raise GateError(f"device {d} held < one frame during the mesh run")


def _peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the frame mesh over four GPUs vs one GPU")
    ap.add_argument("--cpu-reference", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        return cpu_reference(args.cpu_reference)

    t_start = time.perf_counter()
    devices = phase_device(4 if args.four_cards else 1)
    stack = timed(f"generate {FRAMES} x {SIDE}² uint16 frames", make_stack)
    if args.four_cards:
        run_four_cards(stack, devices)
        devices = devices[:4]
    else:
        run_single_card(stack)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(last_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
