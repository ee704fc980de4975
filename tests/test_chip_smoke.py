# SPDX-License-Identifier: CECILL-2.1
"""The testable parts of chip_smoke.py: the result line, the leaf
extraction and comparison, the NumPy flat-field reference, and the refusal
to run without a GPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from barc4dip_tpu.utils.lazy import LazyMapStack

REPO = Path(__file__).resolve().parents[1]


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_format(count):
    line = cs.last_line([_Dev()] * count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_refuses_cpu_with_nonzero_exit_and_no_result():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_refuses_cpu_in_process():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu()


def test_leaf_error_semantics():
    a = np.array([1.0, 2.0, np.nan])
    assert cs.leaf_error(a, a) == 0.0
    assert cs.leaf_error(a, a * (1 + 1e-5)) == pytest.approx(1e-5, rel=1e-4)
    assert cs.leaf_error(a, a[:2]) == float("inf")              # shape
    assert cs.leaf_error(a, np.array([1.0, np.nan, 3.0])) == float("inf")
    assert cs.leaf_error(np.zeros(3), np.zeros(3)) == 0.0
    assert cs.leaf_error([1.0, 3.0], [1.5, 3.0], absolute=True) == 0.5


def test_compare_reports_worst_leaf_and_missing():
    want = {"full.a": np.array([1.0, 2.0]), "full.b": np.array([10.0])}
    got = {"full.a": np.array([1.0, 2.0]), "full.b": np.array([10.01])}
    path, err = cs.compare(got, want)
    assert path == "full.b" and err == pytest.approx(1e-3, rel=1e-3)
    assert cs.compare(want, want) == ("full.a", 0.0)
    assert cs.compare({"full.a": want["full.a"]}, want) == ("full.b", float("inf"))


def test_compare_db_and_std_normalization():
    # a dB value near zero: judged by the underlying ratio's error
    want = {"full.stats.SNRdB": np.array([0.05])}
    got = {"full.stats.SNRdB": np.array([0.05 + 1e-4])}
    _, err = cs.compare(got, want)
    assert err == pytest.approx(1e-4 * np.log(10) / 20, rel=1e-6)
    # a tile std is judged against the scale of its mean
    want = {"tiles.g.f.mean": np.array([100.0]), "tiles.g.f.std": np.array([0.01])}
    got = {"tiles.g.f.mean": np.array([100.0]), "tiles.g.f.std": np.array([0.011])}
    path, err = cs.compare(got, want)
    assert path == "tiles.g.f.std"
    assert err == pytest.approx(0.001 / 100.0, rel=1e-3)
    # and the spread of ROI displacements against the displacements
    want = {"temporal.abs.dx": np.array([20.0]), "temporal.abs.std_dx": np.array([0.02])}
    got = {"temporal.abs.dx": np.array([20.0]), "temporal.abs.std_dx": np.array([0.0201])}
    path, err = cs.compare(got, want)
    assert path == "temporal.abs.std_dx"
    assert err == pytest.approx(1e-4 / 20.0, rel=1e-3)


def test_leaves_limits_frames_and_lazy_maps():
    fetched = []

    def fetch(t):
        fetched.append(t)
        return np.full((2, 2), float(t))

    out = {"full": {"g": {"x": np.arange(10.0), "map": LazyMapStack(10, (2, 2), np.float64, fetch)}},
           "tiles": {"g": {"x": {"mean": np.ones((10, 3, 3))}}},
           "meta": {"ignored": np.ones(3)}}
    flat = cs.leaves(out, k=3)
    assert set(flat) == {"full.g.x", "full.g.map", "tiles.g.x.mean"}
    np.testing.assert_array_equal(flat["full.g.x"], [0.0, 1.0, 2.0])
    assert flat["full.g.map"].shape == (3, 2, 2)
    assert flat["tiles.g.x.mean"].shape == (3, 3, 3)
    every = cs.leaves(out, k=None)
    assert every["full.g.x"].shape == (10,)
    assert every["full.g.map"].shape == (cs.K, 2, 2)   # maps stay capped
    assert max(fetched) == cs.K - 1


def test_tracking_errors_against_known_motion():
    dys, dxs = cs.spiral_motion(6)
    out = {"temporal": {
        "abs": {"dy": dys.copy(), "dx": dxs.copy()},
        "inc": {"dy": np.diff(dys, prepend=0.0), "dx": np.diff(dxs, prepend=0.0)},
    }}
    assert cs.tracking_errors(out, 6) == (0.0, 0.0)
    out["temporal"]["abs"]["dy"][3] += 0.03
    e_abs, e_inc = cs.tracking_errors(out, 6)
    assert e_abs == pytest.approx(0.03) and e_inc == 0.0


def test_gate_raises_above_limit():
    cs.gate("fine", 0.01, 0.05)
    with pytest.raises(cs.GateError):
        cs.gate("too big", 0.06, 0.05)
    with pytest.raises(cs.GateError):
        cs.gate("nan", float("nan"), 0.05)


def test_flat_field_reference_matches_library(rng):
    """The smoke test's NumPy/SciPy flat-field reference and the library
    agree (float64 on the CPU), dead pixels repaired by the 3x3 median."""
    from barc4dip_tpu.preprocessing import flat_field_correction

    img = (rng.random((64, 80)) * 1000.0 + 500.0).astype(np.float32)
    flat = cs.make_flat(80)[:64].copy()
    flat[10, 10] = flat[40, 70] = 0.0
    got = flat_field_correction(img, flats=flat, bad_pixel_removal=True)
    want = cs.flat_field_reference(img, flat)
    assert cs.leaf_error(got, want) < 1e-6


def test_make_stack_follows_spiral_motion():
    stack = cs.make_stack(3, 64)
    assert stack.shape == (3, 64, 64) and stack.dtype == np.uint16
    np.testing.assert_array_equal(stack, cs.make_stack(3, 64))


def test_f95_gated_in_frequency_bins():
    """f95 leaves leave the relative comparison and are measured in bins
    of their own grid: 1/2048 for the full frame, 1/227 for a 9x9 subtile
    of a 2048² frame."""
    want = {"full.bandwidth.f95": np.array([0.1]),
            "tiles.bandwidth.f95.mean": np.array([0.2]),
            "full.bandwidth.feq": np.array([0.3])}
    got = {"full.bandwidth.f95": np.array([0.1 + 0.5 / 2048]),
           "tiles.bandwidth.f95.mean": np.array([0.2 + 0.25 / 227]),
           "full.bandwidth.feq": np.array([0.3])}
    assert set(cs.without_f95(want)) == {"full.bandwidth.feq"}
    assert cs.f95_error(got, want, 2048, 2048) == pytest.approx(0.5)
    got["tiles.bandwidth.f95.mean"] = np.array([0.2 + 2.0 / 227])
    assert cs.f95_error(got, want, 2048, 2048) == pytest.approx(2.0)
    del got["full.bandwidth.f95"]
    assert cs.f95_error(got, want, 2048, 2048) == float("inf")
