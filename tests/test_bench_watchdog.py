# SPDX-License-Identifier: CECILL-2.1
"""Driver-proofing tests for bench.py.

A benchmark killed by its time limit must still leave output: the
watchdog must guarantee a valid JSON line on stdout no matter which stage
stalls. The
forced-stall path is exercised for real here via BENCH_SELFTEST_STALL.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "bench.py"


def _run_bench(env_extra: dict, timeout: float = 180.0):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(
        JAX_PLATFORMS="cpu",
        **env_extra,
    )
    return subprocess.run(
        [sys.executable, str(BENCH)], capture_output=True, text=True,
        env=env, timeout=timeout, cwd=REPO,
    )


def _parse_stdout(proc, expect_lines: int = 1) -> dict:
    """Every stdout line must be valid JSON; the driver grades the LAST."""
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == expect_lines, (
        f"expected {expect_lines} stdout line(s), got: {lines!r}"
    )
    parsed = [json.loads(ln) for ln in lines]
    return parsed[-1]


@pytest.mark.slow
def test_watchdog_emits_valid_json_on_stall():
    """A stage stall must produce a degraded-but-parseable artifact, not
    silence: stall deliberately at 'warmup', budget 12 s."""
    proc = _run_bench(
        {
            "BENCH_SELFTEST_STALL": "warmup",
            "BENCH_BUDGET_S": "30",
            "BENCH_HARD_EXIT_S": "40",
            "BENCH_T": "4",
            "BENCH_SIZE": "256",
        }
    )
    # three artifacts: the startup liveness snapshot, the budget-expiry
    # checkpoint, then the hard-deadline final emitted from CURRENT state
    # (each supersedes the previous — the driver parses the last JSON line)
    out = _parse_stdout(proc, expect_lines=3)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out["degraded"] is True
    assert out["checkpoint"] is False
    assert out["gate_failed"] is False
    assert out["detail"]["gate_checked"] is False
    assert out["detail"]["stage_reached"] == "warmup"
    assert out["metric"] == "speckle_stack_pipeline_throughput"
    # the first line is the pre-block startup snapshot: even a driver
    # timeout shorter than the watchdog budget finds a parseable artifact
    first = json.loads([ln for ln in proc.stdout.splitlines() if ln.strip()][0])
    assert first["checkpoint"] is True
    assert first["detail"]["stage_reached"] == "init"
    # heartbeats must make the stall diagnosable from stderr alone
    assert "stage: warmup" in proc.stderr
    assert "WATCHDOG" in proc.stderr
    assert "hard deadline" in proc.stderr


def test_emit_prefers_timed_run_and_reports_rooflines(capsys, monkeypatch):
    """emit() arithmetic on a fabricated STATE: top-level value,
    pct_of_upload_roofline and device_compute_mpix_s (VERDICT r3 weak #2)."""
    import importlib

    import bench

    importlib.reload(bench)  # fresh STATE/_EMITTED
    bench.STATE.update(
        side=2048,
        frames=16,
        cpu_sec_per_frame=8.0,
        cpu_baseline_source="cache",
        warmup_s=30.0,
        warmup_frames=9,
        device_compute={"compute_mpix_s": 43.0},
        runs=[
            {
                "elapsed_s": 4.0,
                "frames": 16,
                "track_err_px": 0.01,
                "stages": {"upload_io_s": 3.2},
            }
        ],
    )
    rc = bench.emit(degraded=False)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    mpix = 16 * 2048 * 2048 / 1e6
    assert out["value"] == pytest.approx(mpix / 4.0, rel=1e-3)
    assert out["pct_of_upload_roofline"] == pytest.approx(
        100 * 3.2 / 4.0, rel=1e-3
    )
    assert out["device_compute_mpix_s"] == 43.0
    assert out["vs_baseline"] == pytest.approx(
        (mpix / 4.0) / (2048 * 2048 / 1e6 / 8.0), rel=1e-3
    )
    assert out["detail"]["value_source"] == "timed_run"
    # second emission (watchdog/main race) must be suppressed
    assert bench.emit(degraded=True) == 0
    assert capsys.readouterr().out == ""


def test_emit_falls_back_to_warmup_then_zero(capsys):
    import importlib

    import bench

    importlib.reload(bench)
    bench.STATE.update(side=1024, frames=8, warmup_s=10.0, warmup_frames=5)
    rc = bench.emit(degraded=True)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["degraded"] is True
    assert out["value"] == pytest.approx(5 * 1024 * 1024 / 1e6 / 10.0, rel=1e-3)
    assert out["detail"]["value_source"] == "warmup_incl_compile"
    assert out["gate_failed"] is False

    importlib.reload(bench)
    bench.STATE.update(side=1024, frames=8)
    rc = bench.emit(degraded=True)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["value"] == 0.0
    assert out["detail"]["value_source"] == "none_completed"


def test_emit_gate_fails_only_on_completed_bad_measurement(capsys):
    import importlib

    import bench

    importlib.reload(bench)
    bench.STATE.update(
        side=512, frames=4,
        runs=[{"elapsed_s": 1.0, "frames": 4, "track_err_px": 0.3,
               "stages": {}}],
    )
    rc = bench.emit(degraded=False)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1
    assert out["gate_failed"] is True
    assert out["detail"]["gate_checked"] is True


def test_fast_crash_still_emits_json():
    """A raised exception (not a stall) must also leave a parseable
    degraded artifact: the round-3 failure mode was silence, and a crash
    is just the fast version of it."""
    proc = _run_bench({"BENCH_SELFTEST_CRASH": "warmup", "BENCH_T": "4",
                       "BENCH_SIZE": "256"})
    out = _parse_stdout(proc, expect_lines=2)  # startup snapshot + final
    assert proc.returncode == 1
    assert out["degraded"] is True
    assert out["detail"]["stage_reached"] == "warmup"
    # no timed run completed, so the gate cannot have been checked/failed
    assert out["gate_failed"] is False


def test_device_compute_cache_roundtrip_and_fallback(tmp_path, capsys):
    """The chip rate is wire-independent: when a degraded link skips the
    probe, the last measured value must surface top-level with an explicit
    source='cache(...)' marker instead of null (round-4 hardening)."""
    import importlib

    import bench

    importlib.reload(bench)
    bench.DEVCOMPUTE_CACHE = tmp_path / "devcache.json"
    bench.STATE.update(
        device_compute={"compute_mpix_s": 51.8, "compute_s_total": 5.2},
        device_compute_source="measured",
    )
    bench.write_device_compute_cache(2048, 4)
    entry = json.loads(bench.DEVCOMPUTE_CACHE.read_text())["2048x2048-chunk4"]
    assert entry["compute_mpix_s"] == 51.8
    assert "measured_utc" in entry and "git_rev" in entry

    # fresh process state: probe skipped, cache redeems
    importlib.reload(bench)
    bench.DEVCOMPUTE_CACHE = tmp_path / "devcache.json"
    bench.read_device_compute_cache(2048, 4)
    assert bench.STATE["device_compute"]["compute_mpix_s"] == 51.8
    assert bench.STATE["device_compute_source"].startswith("cache(")

    bench.STATE.update(side=2048, frames=4)
    bench.emit(degraded=True)
    out = json.loads(capsys.readouterr().out.strip())
    assert out["device_compute_mpix_s"] == 51.8
    assert out["device_compute_source"].startswith("cache(")

    # a key mismatch (different shape/chunk) must NOT redeem
    importlib.reload(bench)
    bench.DEVCOMPUTE_CACHE = tmp_path / "devcache.json"
    bench.read_device_compute_cache(1024, 4)
    assert bench.STATE["device_compute"] is None

    # a live measurement always supersedes the cached value
    importlib.reload(bench)
    bench.DEVCOMPUTE_CACHE = tmp_path / "devcache.json"
    bench.read_device_compute_cache(2048, 4)
    bench.STATE.update(
        device_compute={"compute_mpix_s": 60.0},
        device_compute_source="measured",
    )
    bench.STATE.update(side=2048, frames=4)
    bench.emit(degraded=False)
    out = json.loads(capsys.readouterr().out.strip())
    assert out["device_compute_mpix_s"] == 60.0
    assert out["device_compute_source"] == "measured"


def test_emit_metric_value_gate_fails_artifact(capsys):
    # the metric-VALUE hardware gate (run-1 leaves vs host-f64 golden)
    # must fail the artifact even when the tracking gate is clean
    import importlib

    import bench

    importlib.reload(bench)
    bench.STATE.update(
        side=512, frames=4,
        runs=[{"elapsed_s": 1.0, "frames": 4, "track_err_px": 0.01,
               "stages": {}}],
        metric_gate={"checked": True, "max_rel_err": 4e-3,
                     "worst_leaf": "full.grain.lx", "rtol": 1e-4},
    )
    rc = bench.emit(degraded=False)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1
    assert out["gate_failed"] is True
    assert out["metrics_max_rel_err"] == 4e-3


def test_emit_sharpness_gate_fails_artifact(capsys):
    # the sharpness value gate must fail the artifact on its own, even
    # when the tracking gate AND the speckle metric gate are both clean —
    # it covers kernels (ops/eig.py subspace iteration, fused stencils)
    # that no other hardware check executes
    import importlib

    import bench

    importlib.reload(bench)
    bench.STATE.update(
        side=512, frames=4,
        runs=[{"elapsed_s": 1.0, "frames": 4, "track_err_px": 0.01,
               "stages": {}}],
        metric_gate={"checked": True, "max_rel_err": 2e-6,
                     "worst_leaf": "full.grain.lx", "rtol": 1e-4},
        sharpness_gate={"checked": True, "max_rel_err": 5e-3,
                        "worst_leaf": "full.eigenvalues.e1", "rtol": 1e-4},
    )
    rc = bench.emit(degraded=False)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1
    assert out["gate_failed"] is True
    # the top-level number is the max over BOTH value gates
    assert out["metrics_max_rel_err"] == 5e-3
    assert out["detail"]["sharpness_gate"]["worst_leaf"] == (
        "full.eigenvalues.e1"
    )


def test_emit_sharpness_gate_skip_does_not_fail(capsys):
    # an explicitly skipped (unchecked) sharpness gate must neither fail
    # the artifact nor pollute metrics_max_rel_err
    import importlib

    import bench

    importlib.reload(bench)
    bench.STATE.update(
        side=512, frames=4,
        runs=[{"elapsed_s": 1.0, "frames": 4, "track_err_px": 0.01,
               "stages": {}}],
        metric_gate={"checked": True, "max_rel_err": 2e-6,
                     "worst_leaf": "full.grain.lx", "rtol": 1e-4},
        sharpness_gate={"checked": False,
                        "note": "skipped (budget or degraded link)"},
    )
    rc = bench.emit(degraded=False)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["gate_failed"] is False
    assert out["metrics_max_rel_err"] == 2e-6
    assert out["detail"]["sharpness_gate"]["note"].startswith("skipped")


def test_leaf_rel_err_semantics():
    import importlib

    import numpy as np

    import bench

    importlib.reload(bench)
    a = np.array([1.0, 2.0, 4.0])
    assert bench._leaf_rel_err(a, a) == 0.0
    # normalized inf-norm against the leaf's own scale
    b = a.copy(); b[2] = 4.0 + 4e-4
    assert abs(bench._leaf_rel_err(a, b) - 1e-4) < 1e-7
    # shape mismatch and finiteness mismatch are unconditional failures
    assert bench._leaf_rel_err(a, a[:2]) >= 1e29
    c = a.copy(); c[0] = np.nan
    assert bench._leaf_rel_err(a, c) >= 1e29
    # matching NaN patterns compare the finite part only
    d = a.copy(); d[0] = np.nan
    assert bench._leaf_rel_err(c, d) == 0.0
    # all-zero leaves compare equal
    z = np.zeros(3)
    assert bench._leaf_rel_err(z, z) == 0.0


def test_resolve_golden_keys_speckle_and_sharpness_separately(tmp_path):
    # the two value gates share one cache file; the kind suffix must keep
    # their entries from shadowing each other
    import importlib
    import json

    import numpy as np

    import bench

    importlib.reload(bench)
    bench.METRIC_GOLDEN_CACHE = tmp_path / "golden.json"
    stack = np.arange(2 * 8 * 8, dtype=np.uint16).reshape(2, 8, 8)
    key = bench._stack_golden_key(stack, bench.GOLDEN_K)
    bench.METRIC_GOLDEN_CACHE.write_text(json.dumps({
        key: {"leaves": {"full.grain.lx": [1.0, 2.0]},
              "git_rev": "aaa", "computed_utc": "t1"},
        key + "-sharpness": {"leaves": {"full.gradient.tenengrad": [3.0, 4.0]},
                             "git_rev": "bbb", "computed_utc": "t2"},
    }))
    g_s, src_s = bench._resolve_golden(stack, 2, "speckle")
    g_h, src_h = bench._resolve_golden(stack, 2, "sharpness")
    assert list(g_s) == ["full.grain.lx"] and "aaa" in src_s
    assert list(g_h) == ["full.gradient.tenengrad"] and "bbb" in src_h
    # a different stack content misses both
    other = stack + 1
    bench.STATE["link_degraded"] = True  # forbid a recompute attempt
    assert bench._resolve_golden(other, 2, "speckle") == (None, None)


def test_compare_leaves_snrdb_uses_log_unit_semantics():
    # SNRdB legitimately passes through zero (mean == std), so normalizing
    # its error by its own magnitude amplifies benign f32 scatter; the
    # comparison must gate the absolute dB difference converted to the
    # linear ratio's relative error (ln10/20 per dB) instead
    import importlib

    import numpy as np

    import bench

    importlib.reload(bench)
    golden = {"full.stats.SNRdB": np.array([0.05])}   # near-zero dB value
    run = {"full.stats.SNRdB": np.array([0.05 + 2e-5])}  # tiny abs scatter
    (path, err), missing = bench._compare_leaves(run, golden)
    assert not missing
    # own-scale normalization would read 2e-5/0.05 = 4e-4 (a false trip);
    # log-unit semantics read 2e-5 * ln10/20 ≈ 2.3e-6
    assert err < 1e-5
    # a REAL bf16-scale demotion (~4e-3 of a ~10 dB value) still trips
    golden2 = {"tiles.stats.SNRdB.mean": np.array([10.0])}
    run2 = {"tiles.stats.SNRdB.mean": np.array([10.0 + 0.04])}
    (_, err2), _ = bench._compare_leaves(run2, golden2)
    assert err2 > bench.METRIC_GATE_RTOL


def test_metric_leaves_samples_big_maps_deterministically():
    import importlib

    import numpy as np

    import bench

    importlib.reload(bench)
    rng = np.random.default_rng(0)
    big = rng.normal(size=(3, 128, 128))  # > 8192 elements
    out = {"full": {"grain": {"autocorr": big, "lx": np.array([1.0, 2.0, 3.0])}},
           "tiles": {}}
    leaves = bench.metric_leaves(out, 2)
    assert "full.grain.autocorr.sample4096" in leaves
    assert leaves["full.grain.autocorr.sample4096"].shape == (4096,)
    assert "full.grain.autocorr.summary" in leaves
    # k-frame head slicing on the leading axis
    np.testing.assert_array_equal(leaves["full.grain.lx"], [1.0, 2.0])
    # deterministic: same input -> identical sample
    again = bench.metric_leaves(out, 2)
    np.testing.assert_array_equal(
        leaves["full.grain.autocorr.sample4096"],
        again["full.grain.autocorr.sample4096"],
    )
