# SPDX-License-Identifier: CECILL-2.1
"""Dense speckle-tracking displacement fields + wavefront integration.

Ground truth strategy: synthetic speckle warped by a KNOWN displacement
field (scipy map_coordinates, no wrap-around), tracked on the grid, and —
for the wavefront chain — integrated and compared against the analytic
surface that generated the displacements.
"""
import numpy as np
import pytest
from scipy.ndimage import map_coordinates

from tests.conftest import make_speckle
from barc4dip_tpu.maths import integrate_gradients
from barc4dip_tpu.signal import (
    track_displacement_field,
    wavefront_from_displacements,
)


def _warp(img, dy_map, dx_map):
    """Sample img at (y - dy, x - dx): a feature at p moves to p + d."""
    ny, nx = img.shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    return map_coordinates(
        img, [yy - dy_map, xx - dx_map], order=3, mode="reflect"
    )


def test_uniform_shift_recovered(rng):
    base = make_speckle(rng, shape=(256, 256), grain_px=3.0)
    img = _warp(base, np.full(base.shape, 1.6), np.full(base.shape, -2.4))
    out = track_displacement_field(
        img, base, tile_size=33, step=16, search_radius=6
    )
    assert out["dy"].shape == out["meta"]["grid_shape"]
    np.testing.assert_allclose(out["dy"], 1.6, atol=0.1)
    np.testing.assert_allclose(out["dx"], -2.4, atol=0.1)
    # cubic-warp resampling slightly decorrelates fine grains: still high NCC
    assert float(out["peak"].min()) > 0.8


def test_smooth_field_recovered_at_nodes(rng):
    base = make_speckle(rng, shape=(320, 320), grain_px=3.0)
    ny, nx = base.shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    dy_map = 2.0 * np.sin(2 * np.pi * xx / nx)
    dx_map = 2.0 * np.cos(2 * np.pi * yy / ny)
    img = _warp(base, dy_map, dx_map)

    out = track_displacement_field(
        img, base, tile_size=33, step=16, search_radius=6
    )
    Y, X = np.meshgrid(out["y"], out["x"], indexing="ij")
    want_dy = 2.0 * np.sin(2 * np.pi * X / nx)
    want_dx = 2.0 * np.cos(2 * np.pi * Y / ny)
    # a 33-px tile averages the field over its support: compare loosely
    assert np.abs(out["dy"] - want_dy).max() < 0.3
    assert np.abs(out["dx"] - want_dx).max() < 0.3


def test_displacement_field_validation(rng):
    a = rng.normal(size=(64, 64))
    with pytest.raises(ValueError, match="equal-shape"):
        track_displacement_field(a, rng.normal(size=(64, 32)))
    with pytest.raises(ValueError, match="too small"):
        track_displacement_field(a, a, tile_size=48, search_radius=16)
    with pytest.raises(ValueError, match="search_radius"):
        track_displacement_field(a, a, tile_size=9, search_radius=0)


def test_integrate_gradients_periodic_exact():
    ny, nx = 48, 64
    y = np.arange(ny)[:, None]
    x = np.arange(nx)[None, :]
    z = np.cos(2 * np.pi * y / ny) * np.sin(4 * np.pi * x / nx)
    gy = -2 * np.pi / ny * np.sin(2 * np.pi * y / ny) * np.sin(4 * np.pi * x / nx)
    gx = np.cos(2 * np.pi * y / ny) * 4 * np.pi / nx * np.cos(4 * np.pi * x / nx)
    zr = np.asarray(integrate_gradients(gy, gx))
    np.testing.assert_allclose(zr, z - z.mean(), atol=1e-6)


def test_integrate_gradients_anisotropic_spacing():
    """Non-unit, unequal dy/dx spacings scale the reconstruction correctly."""
    ny, nx = 40, 56
    dy, dx = 0.5, 2.0
    y = (np.arange(ny) * dy)[:, None]
    x = (np.arange(nx) * dx)[None, :]
    Ly, Lx = ny * dy, nx * dx
    z = np.sin(2 * np.pi * y / Ly) * np.cos(2 * np.pi * x / Lx)
    gy = 2 * np.pi / Ly * np.cos(2 * np.pi * y / Ly) * np.cos(2 * np.pi * x / Lx)
    gx = -np.sin(2 * np.pi * y / Ly) * 2 * np.pi / Lx * np.sin(2 * np.pi * x / Lx)
    zr = np.asarray(integrate_gradients(gy, gx, dy=dy, dx=dx))
    np.testing.assert_allclose(zr, z - z.mean(), atol=1e-6)


def test_integrate_gradients_validation():
    with pytest.raises(ValueError, match="equal-shape"):
        integrate_gradients(np.zeros((4, 4)), np.zeros((4, 5)))
    with pytest.raises(ValueError, match="positive"):
        integrate_gradients(np.zeros((4, 4)), np.zeros((4, 4)), dy=0.0)


def test_wavefront_end_to_end(rng):
    """Full XST chain: parabolic wavefront -> displacement warp -> dense
    tracking -> slope integration recovers the parabola (up to piston)."""
    base = make_speckle(rng, shape=(384, 384), grain_px=3.0)
    ny, nx = base.shape
    pixel = 1.0e-6     # 1 um pixels
    dist = 0.5         # 0.5 m propagation
    R = 40.0           # 40 m wavefront curvature radius

    # spherical (parabolic) wavefront: W = r^2 / (2R); slope = r/R;
    # displacement [px] = slope * dist / pixel
    yy = (np.arange(ny) - ny / 2)[:, None] * pixel
    xx = (np.arange(nx) - nx / 2)[None, :] * pixel
    dy_map = (yy / R) * dist / pixel * np.ones((1, nx))
    dx_map = (xx / R) * dist / pixel * np.ones((ny, 1))
    img = _warp(base, dy_map, dx_map)

    field = track_displacement_field(
        img, base, tile_size=33, step=16, search_radius=8
    )
    wf = wavefront_from_displacements(
        field, pixel_size=pixel, distance=dist, wavelength=1e-10
    )

    Y, X = np.meshgrid(field["y"], field["x"], indexing="ij")
    want = ((Y - ny / 2) ** 2 + (X - nx / 2) ** 2) * pixel**2 / (2 * R)
    want = want - want.mean()
    got = wf["wavefront"]

    # least-squares periodic integration of a non-periodic surface: compare
    # on the interior (boundary rows absorb the periodicity mismatch)
    sl = (slice(2, -2), slice(2, -2))
    scale = np.abs(want[sl]).max()
    assert scale > 0
    rel = np.abs(got[sl] - want[sl]).max() / scale
    assert rel < 0.15, f"wavefront relative error {rel:.3f}"
    assert wf["phase"].shape == got.shape
    assert wf["meta"]["units"]["phase"] == "rad"


def test_wavefront_validation(rng):
    field = {"dy": np.zeros((4, 4)), "dx": np.zeros((4, 4)),
             "meta": {"step": 16}}
    with pytest.raises(ValueError, match="positive"):
        wavefront_from_displacements(field, pixel_size=0.0, distance=1.0)
    with pytest.raises(ValueError, match="positive"):
        wavefront_from_displacements(
            field, pixel_size=1e-6, distance=1.0, wavelength=-1.0
        )


def test_all_methods_agree(rng):
    """The grouped-conv path and the batched-FFT path compute the same NCC
    field (tiny grid so CPU's per-group conv lowering stays fast); the
    removed "pallas" method is refused with the list of valid ones."""
    base = make_speckle(rng, shape=(96, 96), grain_px=3.0)
    img = _warp(base, np.full(base.shape, 0.8), np.full(base.shape, -0.6))
    kw = dict(tile_size=17, step=24, search_radius=4)
    a = track_displacement_field(img, base, method="fft", **kw)
    for method in ("conv", "auto"):
        b = track_displacement_field(img, base, method=method, **kw)
        np.testing.assert_allclose(b["dy"], a["dy"], rtol=0, atol=5e-4,
                                   err_msg=method)
        np.testing.assert_allclose(b["dx"], a["dx"], rtol=0, atol=5e-4,
                                   err_msg=method)
        np.testing.assert_allclose(b["peak"], a["peak"], rtol=0, atol=1e-4,
                                   err_msg=method)
    for bad in ("bogus", "pallas"):
        with pytest.raises(ValueError, match="'auto', 'conv' or 'fft'"):
            track_displacement_field(img, base, method=bad, **kw)


def test_displacement_stack_matches_per_frame(rng):
    """track_displacement_stack equals per-frame track_displacement_field,
    and the stacked result integrates per frame."""
    from barc4dip_tpu.signal import track_displacement_stack

    base = make_speckle(rng, shape=(160, 160), grain_px=3.0)
    shifts = [(0.0, 0.0), (1.2, -0.7), (-0.8, 1.5)]
    stack = np.stack([_warp(base, np.full(base.shape, sy), np.full(base.shape, sx))
                      for sy, sx in shifts])
    kw = dict(tile_size=25, step=16, search_radius=5)
    out = track_displacement_stack(stack, **kw)
    assert out["dy"].shape[0] == 3
    for t in range(3):
        single = track_displacement_field(stack[t], stack[0], **kw)
        np.testing.assert_allclose(out["dy"][t], single["dy"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["dx"][t], single["dx"], rtol=0, atol=1e-6)
    wf = wavefront_from_displacements(out, pixel_size=1e-6, distance=0.5)
    assert wf["wavefront"].shape == out["dy"].shape

    with pytest.raises(ValueError, match="3D"):
        track_displacement_stack(base, **kw)
    with pytest.raises(ValueError, match="ref shape"):
        track_displacement_stack(stack, ref=base[:80, :80], **kw)


def test_dense_tracking_tolerates_dead_pixels(rng):
    """NaN dead pixels don't poison the displacement field (nan-aware
    z-score fills them with the neutral global mean)."""
    base = make_speckle(rng, shape=(192, 192), grain_px=3.0)
    img = _warp(base, np.full(base.shape, 1.0), np.full(base.shape, -1.0))
    img = img.copy()
    base = base.copy()
    dead = rng.random(base.shape) < 0.001
    img[dead] = np.nan
    base[rng.random(base.shape) < 0.001] = np.nan
    out = track_displacement_field(img, base, tile_size=25, step=16,
                                   search_radius=5)
    assert np.isfinite(out["dy"]).all() and np.isfinite(out["dx"]).all()
    np.testing.assert_allclose(np.median(out["dy"]), 1.0, atol=0.1)
    np.testing.assert_allclose(np.median(out["dx"]), -1.0, atol=0.1)
