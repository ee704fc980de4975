# SPDX-License-Identifier: CECILL-2.1
"""Device-resident superchunk path vs the upload-chunked loop.

The resident path (metrics lax.map / tracking lax.scan superchunk
programs, stack_fused._run_resident_stack) must produce EXACTLY what the
chunked loop produces — it is the same per-slab math at the same widths,
only the dispatch structure differs. Mirrors the honesty contract of the
bench's device_compute probe, which reports throughput of these programs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from barc4dip_tpu.metrics import stack_fused
from barc4dip_tpu.metrics.speckles import speckle_stack_stats
from tests.conftest import make_speckle


def _shifted_frame(field, dy, dx):
    ny, nx = field.shape
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    return np.real(
        np.fft.ifft2(np.fft.fft2(field) * np.exp(-2j * np.pi * (fy * dy + fx * dx)))
    )


@pytest.fixture()
def spiral_stack():
    rng = np.random.default_rng(77)
    base = make_speckle(rng, shape=(160, 160), grain_px=5.0)
    ts = np.arange(7)
    dys = 0.7 * ts * np.cos(ts * 0.8)
    dxs = 0.7 * ts * np.sin(ts * 0.8)
    return np.stack(
        [_shifted_frame(base, dy, dx) for dy, dx in zip(dys, dxs)]
    ).astype(np.float32)


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resident_matches_chunked_full_pipeline(spiral_stack, monkeypatch):
    """speckle_stack_stats on a jax.Array == on numpy, leaf for leaf,
    across an odd T that forces a padded tail superchunk and multiple
    superchunks (BARC4DIP_TPU_STACK_EXEC=4, frame_chunk=2)."""
    monkeypatch.setenv("BARC4DIP_TPU_STACK_EXEC", "4")
    kw = dict(
        metrics="all", tiles=False, verbose=False, frame_chunk=2,
        grain_maps=False,
    )
    host = speckle_stack_stats(spiral_stack, **kw)
    resident = speckle_stack_stats(jnp.asarray(spiral_stack), **kw)
    assert stack_fused.LAST_RUN_PERF.get("resident") is True
    assert stack_fused.LAST_RUN_PERF["chunks"] == 2  # ceil(7/4)
    host.pop("meta"), resident.pop("meta")  # timings differ; data must not
    _leaves_equal(host, resident)


def test_resident_single_superchunk_exact(spiral_stack):
    """T == one superchunk (no padding): same equality, default env."""
    kw = dict(
        metrics="amplitude,stats", tiles=False, verbose=False,
        frame_chunk=4, grain_maps=False,
    )
    sub = spiral_stack[:4]
    host = speckle_stack_stats(sub, **kw)
    resident = speckle_stack_stats(jnp.asarray(sub), **kw)
    host.pop("meta"), resident.pop("meta")
    _leaves_equal(host, resident)


def test_stack_programs_match_chunk_programs_with_tiles():
    """Program-level: the lax.map metrics superchunk program equals the
    vmapped chunk program run slab by slab, including 3x3 tiling."""
    rng = np.random.default_rng(5)
    stack = rng.normal(size=(6, 96, 96)).astype(np.float32)
    groups = ("amplitude", "stats")
    args = (groups, "3x3", 65535.0, 1e-12, True, False)
    chunk_prog = stack_fused._metrics_chunk_program(*args)
    stack_prog = stack_fused._metrics_stack_program(*args, slab=2)
    expected = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=0),
        *[jax.device_get(chunk_prog(jnp.asarray(stack[i : i + 2])))
          for i in range(0, 6, 2)],
    )
    got = jax.device_get(stack_prog(jnp.asarray(stack)))
    _leaves_equal(expected, got)


def test_track_stack_program_matches_chunked(spiral_stack):
    """The lax.scan tracking superchunk program equals the chunked tracker
    chained through prev_tail, bit for bit."""
    from barc4dip_tpu.geometry.roi import roi_grid_3x3

    stack = spiral_stack[:6]
    T, H, W = stack.shape
    s = 31
    grid, _ = roi_grid_3x3((H, W), (s, s), (16, 16), center_yx=None)
    starts, _c, ss = stack_fused._grid_geometry(grid)
    starts_key = tuple(int(v) for v in starts.ravel())
    eps = jnp.asarray(1e-9, jnp.float32)
    f0 = jnp.asarray(stack[0])

    chunk_prog = stack_fused._track_chunk_program(
        "template", True, H, W, ss, starts_key, None
    )
    stack_prog = stack_fused._track_stack_program(
        "template", True, H, W, ss, starts_key, None, slab=2
    )

    outs = []
    prev = f0
    for i in range(0, T, 2):
        out, prev = chunk_prog(jnp.asarray(stack[i : i + 2]), prev, f0, eps)
        outs.append(jax.device_get(out))
    expected = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=0), *outs
    )
    got, tail = stack_prog(jnp.asarray(stack), f0, f0, eps)
    _leaves_equal(expected, jax.device_get(got))
    np.testing.assert_array_equal(np.asarray(tail), stack[-1])


def test_device_compute_probe_superchunk_path(spiral_stack):
    """The rewritten probe runs end-to-end and reports sane numbers."""
    from barc4dip_tpu.geometry.roi import roi_grid_3x3

    H, W = spiral_stack.shape[1:]
    grid, _ = roi_grid_3x3((H, W), (31, 31), (16, 16), center_yx=None)
    out = stack_fused.device_compute_probe(
        spiral_stack, grid,
        groups={"amplitude", "stats"}, mode="off", sat=65535.0, eps=1e-12,
        flip=True, frame_chunk=2,
    )
    assert out["frames"] >= 4
    assert np.isfinite(out["mpix_s"]) and out["mpix_s"] > 0
    assert out["metrics_only_s"] > 0 and out["tracking_only_s"] > 0
