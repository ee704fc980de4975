# SPDX-License-Identifier: CECILL-2.1
"""Aggregator tests: schema parity, tiling correctness (batched executor vs
per-tile evaluation), display-origin handling, stack pipelines."""
import numpy as np
import pytest

from barc4dip_tpu.metrics import (
    amplitude,
    bandwidth,
    distribution_moments,
    sharpness_stack_stats,
    sharpness_stats,
    speckle_stack_stats,
    speckle_stats,
    tenengrad,
)
from barc4dip_tpu.metrics.common import split_edges
from tests.conftest import make_speckle


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(21)
    return make_speckle(rng, shape=(400, 448), grain_px=5.0)


def test_speckle_stats_schema(field):
    out = speckle_stats(field, verbose=False)
    assert out["meta"]["kind"] == "speckles"
    assert out["meta"]["input_shape"] == (400, 448)
    assert set(out["full"].keys()) == {"amplitude", "grain", "stats", "bandwidth"}
    assert out["meta"]["tile_mode"] == "tiles_3x3"  # 400//9 < 128, 400//3 >= 128
    for group, fields in out["tiles"].items():
        for f, ms in fields.items():
            assert ms["mean"].shape == (3, 3)
            assert ms["std"].shape == (3, 3)
            assert np.all(np.isnan(ms["std"]))  # direct 3x3 -> NaN std
    g = out["full"]["grain"]
    assert g["autocorr"].shape == (448, 448)


def test_speckle_stats_group_selection(field):
    out = speckle_stats(field, metrics="amplitude,stats", tiles=False, verbose=False)
    assert set(out["full"].keys()) == {"amplitude", "stats"}
    assert "tiles" not in out
    with pytest.raises(ValueError):
        speckle_stats(field, metrics="bogus", verbose=False)
    with pytest.raises(TypeError):
        speckle_stats([[1.0, 2.0]], verbose=False)


def test_speckle_tiles_match_per_tile_eval(field):
    """The batched tile executor must reproduce per-tile estimator calls on
    the exact split_edges extents (display_origin='upper' to keep orientation
    trivial)."""
    out = speckle_stats(field, display_origin="upper", verbose=False)
    h, w = field.shape
    y_edges = split_edges(h, 3)
    x_edges = split_edges(w, 3)
    for r in range(3):
        for c in range(3):
            tile = field[y_edges[r][0] : y_edges[r][1], x_edges[c][0] : x_edges[c][1]]
            a = amplitude(tile)
            assert out["tiles"]["amplitude"]["visibility"]["mean"][r, c] == pytest.approx(
                a["visibility"], rel=1e-6
            )
            assert out["tiles"]["amplitude"]["contrast"]["mean"][r, c] == pytest.approx(
                a["contrast"], rel=1e-6
            )
            b = bandwidth(tile)
            assert out["tiles"]["bandwidth"]["feq"]["mean"][r, c] == pytest.approx(
                b["feq"], rel=1e-6
            )
            m = distribution_moments(tile)
            assert out["tiles"]["stats"]["mean"]["mean"][r, c] == pytest.approx(
                m["mean"], rel=1e-9
            )


def test_display_origin_flip(field):
    up = speckle_stats(field, display_origin="upper", verbose=False)
    lo = speckle_stats(field, display_origin="lower", verbose=False)
    # full-frame scalars are flip-invariant
    assert up["full"]["amplitude"]["visibility"] == pytest.approx(
        lo["full"]["amplitude"]["visibility"], rel=1e-9
    )
    # tile rows are flipped: NW row of "lower" equals SW row of "upper"
    np.testing.assert_allclose(
        lo["tiles"]["amplitude"]["visibility"]["mean"][0],
        up["tiles"]["amplitude"]["visibility"]["mean"][2],
        rtol=1e-7,
    )


def test_subtiles_9x9_mode():
    rng = np.random.default_rng(22)
    big = make_speckle(rng, shape=(1160, 1200), grain_px=6.0)
    out = speckle_stats(big, metrics="amplitude,stats", verbose=False)
    assert out["meta"]["tile_mode"] == "subtiles_9x9"
    assert out["meta"]["used_subtiles"] is True
    vis = out["tiles"]["amplitude"]["visibility"]
    assert np.all(np.isfinite(vis["mean"]))
    assert np.all(np.isfinite(vis["std"]))  # 9x9 aggregation gives real std

    # center 3x3 block of subtiles must aggregate to the (1,1) cell
    h, w = big.shape
    y_edges = split_edges(h, 9)
    x_edges = split_edges(w, 9)
    vals = []
    for r in range(3, 6):
        for c in range(3, 6):
            tile = big[y_edges[r][0] : y_edges[r][1], x_edges[c][0] : x_edges[c][1]]
            vals.append(amplitude(tile)["visibility"])
    assert vis["mean"][1, 1] == pytest.approx(np.mean(vals), rel=1e-6)
    assert vis["std"][1, 1] == pytest.approx(np.std(vals), rel=1e-5, abs=1e-9)


def test_tiling_off_warns():
    rng = np.random.default_rng(23)
    small = make_speckle(rng, shape=(200, 200), grain_px=5.0)
    with pytest.warns(RuntimeWarning, match="too small for tiling"):
        out = speckle_stats(small, verbose=False)
    # reference omits tiling metadata entirely when tiling is off
    assert "tile_mode" not in out["meta"]
    assert "tiles" not in out


def test_sharpness_stats_schema(field):
    out = sharpness_stats(field, verbose=False)
    assert out["meta"]["kind"] == "sharpness"
    assert set(out["full"].keys()) == {
        "stats",
        "gradient",
        "laplacian",
        "spectral",
        "autocorrelation",
        "eigenvalues",
    }
    assert out["tiles"]["gradient"]["tenengrad"]["mean"].shape == (3, 3)


def test_sharpness_tiles_match_per_tile_eval(field):
    out = sharpness_stats(
        field, metrics="gradient", display_origin="upper", verbose=False
    )
    h, w = field.shape
    y_edges = split_edges(h, 3)
    x_edges = split_edges(w, 3)
    for r in range(3):
        for c in range(3):
            tile = field[y_edges[r][0] : y_edges[r][1], x_edges[c][0] : x_edges[c][1]]
            t = tenengrad(tile)
            assert out["tiles"]["gradient"]["tenengrad"]["mean"][r, c] == pytest.approx(
                t["tenengrad"], rel=1e-6
            )


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------

def _shifted_frame(field, dy, dx):
    ny, nx = field.shape
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    return np.real(
        np.fft.ifft2(np.fft.fft2(field) * np.exp(-2j * np.pi * (fy * dy + fx * dx)))
    )


def test_speckle_stack_stats_tracks_spiral():
    """ex_04 semantics: known spiral motion recovered by abs/inc tracking."""
    rng = np.random.default_rng(31)
    base = make_speckle(rng, shape=(256, 256), grain_px=6.0)
    T = 6
    ts = np.arange(T)
    dys = 0.8 * ts * np.cos(ts * 0.9)
    dxs = 0.8 * ts * np.sin(ts * 0.9)
    stack = np.stack([_shifted_frame(base, dy, dx) for dy, dx in zip(dys, dxs)])

    out = speckle_stack_stats(
        stack.astype(np.float64),
        metrics="amplitude,stats",
        tiles=False,
        verbose=False,
    )
    assert out["meta"]["kind"] == "speckle_stack_stats"
    assert out["meta"]["n_frames"] == T
    assert out["full"]["amplitude"]["visibility"].shape == (T,)

    np.testing.assert_allclose(out["temporal"]["abs"]["dy"], dys, atol=0.25)
    np.testing.assert_allclose(out["temporal"]["abs"]["dx"], dxs, atol=0.25)
    # incremental shifts approximate frame-to-frame deltas
    inc_dy_expected = np.diff(np.concatenate([[0.0], dys]))
    np.testing.assert_allclose(out["temporal"]["inc"]["dy"], inc_dy_expected, atol=0.3)
    # tracking metadata recorded
    tr = out["meta"]["tracking"]
    assert tr["method"] == "template"
    assert tr["roi_size_yx"][0] % 2 == 1


def test_speckle_stack_stats_phase_method():
    rng = np.random.default_rng(32)
    base = make_speckle(rng, shape=(256, 256), grain_px=6.0)
    stack = np.stack([base, _shifted_frame(base, 3.0, -2.0)])
    # phase correlation needs ROIs well above the grain scale to lock on
    # (the reference defaults stacks to template matching for this reason)
    out = speckle_stack_stats(
        stack,
        metrics="stats",
        tiles=False,
        tracking_method="phase",
        roi_grain_factor=12.0,
        verbose=False,
    )
    assert out["temporal"]["abs"]["dy"][1] == pytest.approx(3.0, abs=0.5)
    assert out["temporal"]["abs"]["dx"][1] == pytest.approx(-2.0, abs=0.5)


def test_sharpness_stack_stats_focus_scan():
    """ex_01 semantics: best-focus frame via argmax of tenengrad."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(33)
    base = make_speckle(rng, shape=(256, 256), grain_px=4.0)
    sigmas = [3.0, 1.5, 0.0, 1.0, 2.0]
    stack = np.stack([gaussian_filter(base, s) for s in sigmas])

    out = sharpness_stack_stats(stack, metrics="gradient,laplacian", tiles=False, verbose=False)
    ten = out["full"]["gradient"]["tenengrad"]
    assert ten.shape == (5,)
    assert int(np.argmax(ten)) == 2
    lap = out["full"]["laplacian"]["laplacian_variance"]
    assert int(np.argmax(lap)) == 2
    assert out["meta"]["kind"] == "sharpness_stack_stats"


def test_sharpness_stack_device_resident_matches_numpy():
    # a jax.Array stack goes through the chunked pipeline via on-device
    # slicing (upload_padded_chunk's jax.Array branch) — results must
    # equal the numpy-input path exactly, incl. the padded tail chunk
    import jax.numpy as jnp

    rng = np.random.default_rng(35)
    base = make_speckle(rng, shape=(160, 160), grain_px=4.0).astype(np.float32)
    stack = np.stack([base * (1 + 0.05 * t) for t in range(5)])

    host = sharpness_stack_stats(stack, metrics="gradient,spectral",
                                 tiles=False, verbose=False, frame_chunk=2)
    dev = sharpness_stack_stats(jnp.asarray(stack), metrics="gradient,spectral",
                                tiles=False, verbose=False, frame_chunk=2)
    for group, fields in host["full"].items():
        for name, val in fields.items():
            np.testing.assert_array_equal(
                val, dev["full"][group][name], err_msg=f"{group}.{name}"
            )


def test_speckle_stack_grain_maps_opt_out():
    rng = np.random.default_rng(34)
    base = make_speckle(rng, shape=(160, 160), grain_px=6.0)
    stack = np.stack([base, base * 1.01, base * 0.99])
    full = speckle_stack_stats(stack, tiles=False, verbose=False)
    slim = speckle_stack_stats(stack, tiles=False, verbose=False, grain_maps=False)
    assert "autocorr" in full["full"]["grain"]
    assert "autocorr" not in slim["full"]["grain"]
    for k in ("lx", "ly", "leq", "r"):
        np.testing.assert_allclose(slim["full"]["grain"][k], full["full"]["grain"][k])


def test_device_array_input_matches_numpy(field):
    """Aggregators accept device arrays (preprocessing chains without a host
    round-trip) and produce identical results."""
    import jax.numpy as jnp

    from barc4dip_tpu.preprocessing import flat_field_correction

    flat = np.full(field.shape, 2000.0, np.float32) + np.random.default_rng(0).normal(
        0, 10, field.shape
    ).astype(np.float32)

    corr_np = flat_field_correction(field.astype(np.float32), flats=flat)
    corr_dev = flat_field_correction(field.astype(np.float32), flats=flat, as_numpy=False)
    assert not isinstance(corr_dev, np.ndarray)

    a = speckle_stats(corr_np, metrics="amplitude,stats", tiles=False, verbose=False)
    b = speckle_stats(corr_dev, metrics="amplitude,stats", tiles=False, verbose=False)
    for g in a["full"]:
        for k in a["full"][g]:
            assert b["full"][g][k] == pytest.approx(a["full"][g][k], rel=1e-6, nan_ok=True)

    sa = sharpness_stats(corr_np, metrics="gradient", tiles=False, verbose=False)
    sb = sharpness_stats(corr_dev, metrics="gradient", tiles=False, verbose=False)
    assert sb["full"]["gradient"]["tenengrad"] == pytest.approx(
        sa["full"]["gradient"]["tenengrad"], rel=1e-6
    )


def test_windowed_search_matches_full_frame():
    """Opt-in tracking_search_radius reproduces the full-frame search
    exactly while the physical drift stays inside the window — including
    tiles whose window clamps at the frame edge."""
    rng = np.random.default_rng(77)
    base = make_speckle(rng, shape=(160, 160), grain_px=5.0)
    T = 5
    ts = np.arange(T)
    dys = 1.1 * ts * np.cos(ts)
    dxs = 1.1 * ts * np.sin(ts)
    stack = np.stack(
        [_shifted_frame(base, dy, dx) for dy, dx in zip(dys, dxs)]
    ).astype(np.float64)

    kw = dict(metrics="amplitude,stats", tiles=False, verbose=False)
    full = speckle_stack_stats(stack, **kw)
    # radius 24 on a 160-px frame clamps the outer tiles' windows at the
    # frame boundary (window side = roi + 48), exercising the clip path
    win = speckle_stack_stats(stack, tracking_search_radius=24, **kw)

    for blk in ("abs", "inc"):
        for comp in ("dy", "dx"):
            np.testing.assert_allclose(
                win["temporal"][blk][comp], full["temporal"][blk][comp],
                rtol=0, atol=1e-5,
            )
    assert win["meta"]["tracking"]["search_area"] == "window_r24px"
    assert full["meta"]["tracking"]["search_area"] == "full_frame"


def test_windowed_search_validation():
    rng = np.random.default_rng(5)
    stack = np.abs(rng.normal(1000, 100, size=(3, 160, 160))).astype(np.float32)
    with pytest.raises(ValueError, match="template"):
        speckle_stack_stats(
            stack, metrics="stats", tiles=False, verbose=False,
            tracking_method="phase", tracking_search_radius=16,
        )
    with pytest.raises(ValueError, match=">= 1"):
        speckle_stack_stats(
            stack, metrics="stats", tiles=False, verbose=False,
            tracking_search_radius=0.2,
        )


def test_stack_edge_dtypes_and_single_frame():
    """uint8 detector data and a single-frame stack run the full pipeline
    (casts happen on-device; T=1 has no incremental motion to speak of)."""
    from barc4dip_tpu.utils import speckle_stack

    u8 = speckle_stack(3, (160, 160), grain_px=5.0, mean_counts=120.0,
                       dtype=np.uint8)
    out = speckle_stack_stats(u8, metrics="amplitude,stats", tiles=False,
                              verbose=False, frame_chunk=2)
    assert np.isfinite(out["temporal"]["abs"]["r"]).all()

    one = speckle_stack(1, (160, 160), grain_px=5.0, dys=[0.0], dxs=[0.0],
                        dtype=np.float32)
    out = speckle_stack_stats(one, metrics="amplitude,stats", tiles=False,
                              verbose=False)
    assert out["meta"]["n_frames"] == 1
    assert out["temporal"]["abs"]["dx"].shape == (1,)
    np.testing.assert_allclose(out["temporal"]["abs"]["r"][0], 0.0, atol=0.05)


def test_ramped_chunk_schedule_matches_single_chunk():
    """T > 2*frame_chunk triggers the ramped (2, B, ..., tail) schedule;
    results must equal the single-chunk run exactly."""
    rng = np.random.default_rng(23)
    base = make_speckle(rng, shape=(160, 160), grain_px=5.0).astype(np.float32)
    T = 12
    stack = np.stack([np.roll(base, (t, -t), axis=(0, 1)) for t in range(T)])

    kwargs = dict(metrics="amplitude,stats", tiles=False, verbose=False)
    ramped = speckle_stack_stats(stack, frame_chunk=4, **kwargs)
    single = speckle_stack_stats(stack, frame_chunk=T, **kwargs)

    for g in ramped["full"]:
        for k, v in ramped["full"][g].items():
            np.testing.assert_allclose(
                v, single["full"][g][k], rtol=1e-12, atol=1e-12, err_msg=f"{g}.{k}"
            )
    for blk in ("abs", "inc"):
        for k in ("dx", "dy", "r"):
            np.testing.assert_allclose(
                ramped["temporal"][blk][k], single["temporal"][blk][k],
                rtol=1e-6, atol=1e-6, err_msg=f"{blk}.{k}",
            )
