#!/usr/bin/env python
# SPDX-License-Identifier: CECILL-2.1
"""North-star benchmark: full speckle-stack pipeline throughput per chip.

Config D (SURVEY §6): ``speckle_stack_stats`` over a synthetic detector
stack — per-frame speckle metrics (all groups, full + tiles) plus abs/inc
translation tracking. The same call is measured on the CPU reference
(mounted at /root/reference, tracking backend "opencv") to produce
``vs_baseline``; the CPU number is cached in .bench_baseline.json because it
is orders of magnitude slower.

Prints JSON lines to stdout (the driver grades the LAST one):
    {"metric": ..., "value": N, "unit": "MP/s/chip", "vs_baseline": N,
     "pct_of_upload_roofline": N, "device_compute_mpix_s": N, ...}

Driver-proofing (round 4 — BENCH_r03 was an rc=124 timeout with zero
output): the benchmark can no longer die mute.

* A **startup liveness line** (value 0, stage 'init') prints before
  anything can block, so even a driver timeout shorter than the watchdog
  budget finds a parseable artifact; every later emission supersedes it.
* A **watchdog thread** with a budget (``BENCH_BUDGET_S``, default 240 s —
  the healthy path takes ~60-90 s) prints a *checkpoint* JSON line with
  whatever has been measured so far (``"degraded": true`` + the stage
  reached) when the budget expires, then lets the run continue: the driver
  parses the LAST JSON line, so a recovered run's final line supersedes
  the checkpoint, while a permanently stuck run still has a parseable
  artifact on stdout. A hard deadline (``BENCH_HARD_EXIT_S``, default 3x
  budget) emits a fresh final line from the current state (the checkpoint
  may be stale by then) and force-exits with a clean rc.
* **Timestamped heartbeats** go to stderr at every stage boundary and
  every 30 s, so a future timeout tail is a diagnosis, not a mystery. The
  first device program (terminal claim + handshake) runs concurrently with
  stack generation and its duration is reported explicitly.
* **Collapsed-link degradation**: a 1 MB canary runs before the full link
  probe; below ~5 MB/s the run shrinks to T=4 and skips the second timed
  run + device-compute probe — a small true number beats a timeout.
* Optional stages (second timed run, device probe, CPU re-measure) are
  skipped when the remaining budget cannot cover them.
* ``BENCH_SELFTEST_STALL=<stage>`` deliberately hangs at that stage so the
  watchdog path itself is testable (tests/test_bench_watchdog.py).

Environment knobs: BENCH_T (device frames, default 64 — fixed costs amortize,
and the budget fit shrinks congested runs), BENCH_SIZE (frame side,
default 2048), BENCH_CHUNK (frames per device chunk, default 4 — the
measured optimum with prefetch-overlapped uploads), BENCH_CPU_T (baseline
frames, default 2), BENCH_FORCE_BASELINE=1 re-measures the CPU baseline,
BENCH_BUDGET_S (watchdog budget), BENCH_STACK_CACHE=0 disables the on-disk
synthetic-stack cache. The compilation cache follows the package rule
(``barc4dip_tpu.config``: ``JAX_COMPILATION_CACHE_DIR`` if set, else the
checkout's ``.jax_cache``).

Every rate is printed beside the device it was measured on: the final
JSON line carries ``device`` (platform, ``device_kind``, count and the
card's name and power limit from ``nvidia-smi``).

Stage order puts the cheap, wire-independent measurements first: warmup →
device-compute probe (frame count fitted to the budget) → timed run 1 →
metric-value gate → sharpness value gate → optional run 2 → optional CPU
baseline. Round 4's
headline kernel number reached the driver only as a cache entry because
the probe ran last; it cannot happen again.

The run FAILS (exit 1, "gate_failed": true in the JSON) when any
hardware gate trips: the tracking error against the known synthetic
motion exceeds 0.05 px, or the metric VALUES (full + tiles leaves of the
first GOLDEN_K frames) differ from the host-CPU golden of the same code
by more than METRIC_GATE_RTOL (normalized inf-norm per leaf) — a
throughput number from numerically wrong hardware output must not read
as a win, and a silent bf16 demotion (~4e-3) is invisible to the argmax
gate alone. The value gate runs twice: on the speckle pipeline run 1
already computed, and on ``sharpness_stack_stats`` over the same leading
frames — the sharpness family (Sobel/Laplace stencils, spectral entropy,
inverse autocorrelation widths, and above all the subspace-iteration
eigenvalues kernel in ``ops/eig.py``, a matmul-based kernel squarely in
the reduced-precision (TF32/bf16) failure class) is otherwise absent
from the benched pipeline and would never be value-checked on hardware.
A degraded (watchdog/collapsed-link) run only fails the gate if a
completed measurement actually violated it.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BASELINE_CACHE = REPO / ".bench_baseline.json"
# Last measured device-compute probe, keyed by shape+chunk+git rev. The
# quantity is wire-independent: when a degraded link forces the probe to be
# skipped, the cached value (explicitly marked "cache") is still the truth
# about the chip, unlike the link-hostage MP/s headline.
DEVCOMPUTE_CACHE = REPO / ".bench_device_compute.json"
# Host-CPU golden metric leaves (same code, CPU backend, same uint16
# frames): the reference values for the hardware metric-value gate. Keyed
# by frame geometry + a content hash of the compared frames, so a changed
# generator or stack invalidates it. Committed like .bench_baseline.json —
# the golden is a property of the DATA and the metric definitions, and
# recomputing it costs CPU minutes the driver budget cannot spare.
METRIC_GOLDEN_CACHE = REPO / ".bench_metric_golden.json"
# frames compared by the metric-value gate (per-frame metrics depend only
# on their own frame, so k frames of the golden match the first k of any
# longer run over the same cached synthetic stack)
GOLDEN_K = 2
# f32 pipeline vs an independent f32 execution of the same math on the CPU
# backend: reduction orders and FFT engines differ (XLA CPU FFT vs
# cuFFT), giving ~1e-6 legitimate scatter on 4 MP reductions. The known
# silent hardware failure mode — a float32 matmul demoted to TF32/bf16 —
# shows up at ~1e-3, an order above the gate.
METRIC_GATE_RTOL = 1e-4
T0 = time.perf_counter()

# Shared mutable record of everything measured so far. Stages write into it
# as they COMPLETE, so the watchdog can serialise a truthful partial result
# at any instant. (dict ops are GIL-atomic; no further locking needed.)
STATE: dict = {
    "stage": "start",
    "side": None,
    "frames": None,
    "link": None,
    "link_degraded": False,
    "warmup_s": None,
    "warmup_frames": None,
    "runs": [],            # [{"elapsed_s":, "track_err_px":, "stages": {...}}]
    "device_compute": None,
    "device_compute_source": None,   # "measured" | "cache" | None
    "cpu_sec_per_frame": None,
    "cpu_baseline_source": None,
    "handshake_s": None,
    "metric_gate": None,   # {"checked", "max_rel_err", "worst_leaf", ...}
    "sharpness_gate": None,  # same schema, sharpness_stack_stats leaves
    "last_rc": 0,
    "device": None,        # device_info(), recorded once the backend is up
}
_RUN1_LEAVES: dict = {}   # device leaves captured from the first timed run
_DONE = threading.Event()
_EMIT_LOCK = threading.Lock()
_EMITTED_KINDS: set = set()
_HANDSHAKE: dict = {"thread": None, "elapsed_s": None, "err": None}


def log(msg: str) -> None:
    print(f"# [{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def stage(name: str) -> None:
    STATE["stage"] = name
    log(f"stage: {name}")
    if os.environ.get("BENCH_SELFTEST_STALL") == name:
        log(f"selftest: deliberate stall at stage '{name}'")
        time.sleep(10_000)
    if os.environ.get("BENCH_SELFTEST_CRASH") == name:
        raise RuntimeError(f"selftest: deliberate crash at stage '{name}'")


def budget_s() -> float:
    return float(os.environ.get("BENCH_BUDGET_S", 240))


def remaining_s() -> float:
    return budget_s() - (time.perf_counter() - T0)


def device_info() -> dict:
    """The device every rate of this run was measured on: JAX's view
    (platform, device_kind, count) plus the card's name and power limit as
    ``nvidia-smi`` reports them (a card below its maximum power limit runs
    slower under load)."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip() or None
    except FileNotFoundError:
        smi = None
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "name_power_limit": smi}


def _card() -> str:
    dev = STATE["device"] or {}
    return str(dev.get("name_power_limit") or dev.get("kind"))


def best_run() -> dict | None:
    runs = STATE["runs"]
    return min(runs, key=lambda r: r["elapsed_s"]) if runs else None


def emit(degraded: bool, kind: str = "final") -> int:
    """Serialise whatever STATE holds into a stdout JSON line.

    Three kinds: a "startup" liveness snapshot printed before anything can
    block (so even a driver timeout shorter than the watchdog budget finds
    a parseable line), the watchdog's budget-expiry "checkpoint" (partial
    result, printed so a later hard kill still leaves a parseable
    artifact) and the "final" line. The driver parses the LAST JSON line
    on stdout, so each emission supersedes the previous; at most one of
    each kind is ever printed, and nothing prints after a final. Returns
    the exit code.
    """
    with _EMIT_LOCK:
        if "final" in _EMITTED_KINDS or kind in _EMITTED_KINDS:
            # duplicate emission: keep the exit code already decided by the
            # emission that actually printed (a gate failure must not be
            # laundered into rc=0 by a defensive re-emit)
            return STATE["last_rc"]
        _EMITTED_KINDS.add(kind)

        side = STATE["side"]
        T = STATE["frames"]
        run = best_run()
        mpix_frame = (side * side / 1e6) if side else None

        value = None
        value_source = None
        elapsed = None
        stages_detail = None
        track_err = None
        if run is not None:
            elapsed = run["elapsed_s"]
            T = run["frames"]
            value = T * mpix_frame / elapsed
            value_source = "timed_run"
            stages_detail = run["stages"]
            # the gate covers EVERY completed run, not just the fastest:
            # a run that violated 0.05 px must fail the artifact even if
            # the other run was both faster and clean
            errs = [
                r["track_err_px"] for r in STATE["runs"]
                if r.get("track_err_px") is not None
            ]
            track_err = max(errs) if errs else None
        elif STATE["warmup_s"] and STATE["warmup_frames"]:
            # Honest fallback: the warmup run IS a full pipeline execution,
            # it just includes compile time — pessimistic but real.
            elapsed = STATE["warmup_s"]
            T = STATE["warmup_frames"]  # keep frames/ms-per-frame consistent
            value = T * mpix_frame / elapsed
            value_source = "warmup_incl_compile"
        else:
            value = 0.0
            value_source = "none_completed"

        # Gate semantics: only a completed measurement can fail the gate.
        # Two hardware gates: the tracking peak vs the known synthetic
        # motion (argmax-level), and the metric VALUES vs the host-CPU
        # golden (precision-level — an on-chip bf16 demotion passes the
        # argmax gate but not this one).
        mg = STATE["metric_gate"] or {}
        sg = STATE["sharpness_gate"] or {}
        gate_checked = track_err is not None
        gate_failed = bool(gate_checked and not (track_err <= 0.05))
        for vg in (mg, sg):
            if vg.get("checked"):
                gate_checked = True
                gate_failed = gate_failed or not (
                    vg["max_rel_err"] <= vg["rtol"]
                )
        value_gate_errs = [vg["max_rel_err"] for vg in (mg, sg)
                           if vg.get("checked")]

        cpu_spf = STATE["cpu_sec_per_frame"]
        vs_baseline = None
        if cpu_spf and value:
            vs_baseline = value / (mpix_frame / cpu_spf)

        upload_io_s = (stages_detail or {}).get("upload_io_s")
        roofline = None
        pct_roofline = None
        if upload_io_s and run is not None:
            roofline = T * mpix_frame / upload_io_s
            pct_roofline = 100.0 * value / roofline

        dc = STATE["device_compute"]
        out = {
            "metric": "speckle_stack_pipeline_throughput",
            "gate_failed": gate_failed,
            "value": round(value, 3),
            "unit": "MP/s/chip",
            "vs_baseline": round(vs_baseline, 3) if vs_baseline else None,
            # Link-independent numbers promoted to the graded surface: the
            # wire drifts run to run, these do not.
            "pct_of_upload_roofline": round(pct_roofline, 1)
            if pct_roofline else None,
            "device_compute_mpix_s": dc.get("compute_mpix_s") if dc else None,
            "device_compute_source": STATE["device_compute_source"],
            "metrics_max_rel_err": max(value_gate_errs)
            if value_gate_errs else None,
            "device": STATE["device"],
            "degraded": degraded,
            "checkpoint": kind in ("startup", "checkpoint"),
            "detail": {
                "frames": T,
                "frame": f"{side}x{side}" if side else None,
                "value_source": value_source,
                "stage_reached": STATE["stage"],
                "budget_s": budget_s(),
                "elapsed_total_s": round(time.perf_counter() - T0, 1),
                "device_elapsed_s": round(elapsed, 3) if elapsed else None,
                "device_ms_per_frame": round(1e3 * elapsed / T, 1)
                if (elapsed and T) else None,
                "cpu_ref_s_per_frame": round(cpu_spf, 3) if cpu_spf else None,
                "cpu_baseline_source": STATE["cpu_baseline_source"],
                "gate_checked": gate_checked,
                "tracking_max_err_px": round(track_err, 4)
                if track_err is not None else None,
                "metric_gate": STATE["metric_gate"],
                "sharpness_gate": STATE["sharpness_gate"],
                "stages": stages_detail,
                "backend_handshake_s": STATE["handshake_s"],
                "link": STATE["link"],
                "link_degraded": STATE["link_degraded"],
                "upload_roofline_mpix_s": round(roofline, 2)
                if roofline else None,
                "device_compute": dc,
                "pipeline": "speckle_stack_stats: all metric groups + tiles "
                            "+ abs/inc tracking",
            },
        }
        print(json.dumps(out), flush=True)
        STATE["last_rc"] = 1 if gate_failed else 0
        return STATE["last_rc"]


def watchdog_main() -> None:
    """Budget expiry: print a checkpoint artifact, then let the run keep
    going — a stalled stage can still recover, and a later 'final' line
    supersedes the checkpoint (the driver parses the last JSON line). A
    second, hard deadline (BENCH_HARD_EXIT_S, default 3x budget) force-
    exits so a permanently stuck C call still ends with a clean rc and the
    checkpoint on stdout rather than the driver's mute rc=124. (Even if
    the driver kills us first, the checkpoint is already on stdout — the
    longer window only adds recovery chances.)"""
    if _DONE.wait(budget_s()):
        return
    log(f"WATCHDOG: budget {budget_s():.0f}s expired at stage "
        f"'{STATE['stage']}' - emitting checkpoint result, continuing")
    rc = emit(degraded=True, kind="checkpoint")
    sys.stdout.flush()
    sys.stderr.flush()
    hard_s = float(os.environ.get("BENCH_HARD_EXIT_S", 3 * budget_s()))
    if _DONE.wait(max(hard_s - budget_s(), 1.0)):
        return
    log(f"WATCHDOG: hard deadline {hard_s:.0f}s expired at stage "
        f"'{STATE['stage']}' - emitting final state, exiting")
    # The 240s checkpoint can be stale by now (e.g. warmup completed in the
    # meantime, providing an honest compile-inclusive throughput): emit a
    # fresh final line from the CURRENT state so the driver's last-JSON-line
    # parse sees everything measured, not the budget-expiry snapshot.
    rc = emit(degraded=True, kind="final")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)  # the main thread is stuck in a C call; exit hard


def heartbeat_main() -> None:
    """Periodic liveness line so a driver-timeout tail always shows WHERE
    time went, even mid-stall inside a single blocking call."""
    while not _DONE.wait(30.0):
        log(f"heartbeat: in stage '{STATE['stage']}'")


def start_backend_handshake() -> None:
    """Fire the first device program on a side thread so the terminal
    claim + remote-compile handshake (0.5 s healthy, minutes during
    congestion episodes) overlaps stack generation, and so its duration is
    measured explicitly."""
    def _run() -> None:
        t0 = time.perf_counter()
        try:
            import jax
            import jax.numpy as jnp

            float(jax.jit(lambda x: x.sum())(jnp.ones(8, jnp.float32)))
            _HANDSHAKE["elapsed_s"] = time.perf_counter() - t0
        except Exception as exc:  # pragma: no cover
            _HANDSHAKE["err"] = repr(exc)
            _HANDSHAKE["elapsed_s"] = time.perf_counter() - t0

    th = threading.Thread(target=_run, daemon=True, name="bench-handshake")
    th.start()
    _HANDSHAKE["thread"] = th


def wait_backend_handshake() -> None:
    th = _HANDSHAKE["thread"]
    if th is None:
        return
    while th.is_alive():
        th.join(15.0)
        if th.is_alive():
            log("still waiting for backend handshake (terminal claim / "
                "remote compile)...")
    if _HANDSHAKE["err"]:
        log(f"backend handshake failed: {_HANDSHAKE['err']}")
    else:
        log(f"backend handshake: {_HANDSHAKE['elapsed_s']:.1f}s")
    STATE["handshake_s"] = round(_HANDSHAKE["elapsed_s"] or 0.0, 1)


def make_stack(T: int, side: int, grain_px: float = 8.0) -> np.ndarray:
    """Synthetic speckle stack with spiral motion (ex_04-style workload).

    Detector-realistic uint16 counts (what beamline cameras emit); both
    implementations cast to float internally, and the device path ships half
    the bytes per frame over the host->device link. Same generator as the
    public ``barc4dip_tpu.utils.speckle_stack`` (fixed seed: the cached
    CPU baseline is keyed to this data).

    The generated stack is cached on disk (gitignored, like .jax_cache):
    generation costs ~1-2 s/frame of host FFTs — measured eating 30-200+ s
    of the watchdog budget on a contended host — while a cached load is
    an mmap. Frame t depends only on t (one shared base field + per-frame
    Fourier shift), so a longer cached stack serves any shorter request
    by slicing.
    """
    cache_ok = os.environ.get("BENCH_STACK_CACHE", "1") == "1"
    if cache_ok:
        best = None
        for p in REPO.glob(f".bench_stack_{side}_T*_v2.npy"):
            try:
                tc = int(p.stem.split("_T")[1].split("_")[0])
            except (IndexError, ValueError):
                continue
            if tc >= T and (best is None or tc < best[0]):
                best = (tc, p)
        if best is not None:
            try:
                arr = np.load(best[1], mmap_mode="r")
                if (arr.dtype == np.uint16 and arr.shape[0] >= T
                        and arr.shape[1:] == (side, side)):
                    log(f"stack cache hit: {best[1].name} [:{T}]")
                    return arr[:T]
            except Exception as exc:
                log(f"stack cache unreadable ({exc!r}); regenerating")

    from barc4dip_tpu.utils import speckle_stack
    from barc4dip_tpu.utils.synthetic import spiral_motion

    def gen(lo: int, hi: int) -> np.ndarray:
        # frames [lo:hi) only: the fixed seed rebuilds the shared base
        # field and the per-frame motion depends on t alone, so
        # gen(0, a) == gen(0, b)[:a] and tails concatenate exactly — the
        # same identity the on-disk cache slicing relies on
        dys, dxs = spiral_motion(hi)
        return speckle_stack(
            hi - lo, (side, side), grain_px=grain_px, mean_counts=8000.0,
            dys=dys[lo:], dxs=dxs[lo:],
            seed=np.random.default_rng(1234), dtype=np.uint16,
        )

    # Budget-aware generation (cold cache + throttled host = ~0.8-2
    # s/frame, measured eating half the watchdog budget at T=64): probe
    # with a few frames, project, and shrink the stack rather than let
    # generation starve the timed run. Only the generated count shrinks —
    # frame t is identical at any T.
    probe_T = min(T, 4)
    t0 = time.perf_counter()
    stack = gen(0, probe_T)
    probe_s = time.perf_counter() - t0
    if T > probe_T:
        # the generator farms frames to a thread pool: scale the projection
        # by the parallelism each phase actually gets, or a 4-frame probe on
        # a many-core host overestimates the full run by up to 2x
        pool = min(8, os.cpu_count() or 1)
        par_probe = min(probe_T, pool)

        def projected_s(n_more: int) -> float:
            par_full = min(max(n_more, 1), pool)
            return probe_s * (n_more / probe_T) * (par_probe / par_full)

        allowed = 0.35 * max(remaining_s(), 0.0)
        if projected_s(T - probe_T) > allowed:
            per_frame = probe_s / probe_T * (par_probe / pool)
            T_fit = probe_T + int(allowed / max(per_frame, 1e-3))
            T_fit = max(probe_T, min(T, T_fit))
            log(f"stack gen budget fit: {probe_T} frames took {probe_s:.1f}s; "
                f"generating {T_fit} of {T} requested")
            T = T_fit
        if T > probe_T:
            # only the missing tail is generated (exact: per-frame
            # independence), so the probe frames are never paid for twice
            stack = np.concatenate([stack, gen(probe_T, T)], axis=0)
    assert stack.shape == (T, side, side)
    if cache_ok:
        try:
            path = REPO / f".bench_stack_{side}_T{T}_v2.npy"
            tmp = path.with_suffix(".tmp.npy")
            np.save(tmp, stack)
            os.replace(tmp, path)
            log(f"stack cache written: {path.name}")
        except Exception as exc:  # cache is best-effort
            log(f"stack cache write failed: {exc!r}")
    return stack


def measure_link_mbps(nbytes: int = 8 << 20, down_nbytes: int = 2 << 20) -> dict:
    """Measure effective host<->device link bandwidth (MB/s, one round).

    Reporting it alongside throughput makes vs_baseline swings
    attributable to link state rather than code.

    Transfers on this backend are DEFERRED: ``device_put`` (and even
    ``block_until_ready`` on an idle device) can return before the bytes
    moved, so a naive probe reads 200+ MB/s while the pipeline's true wire
    rate is ~40-50 MB/s. The probe therefore times upload-until-CONSUMED
    (a jitted sum whose result is pulled forces residency; the sum itself
    is sub-ms).

    A 1 MB canary runs FIRST. Its first call is timed separately as
    ``first_program_s`` (compile + first transfer). Its
    second call (same shape, fresh bytes → cached program) times the wire
    alone. Below 2 MB/s wire the probe returns ``"collapsed": true`` and
    nothing larger is attempted — on a ~0.1 MB/s collapsed link the full
    8 MB probe would alone eat the watchdog budget.
    """
    import jax
    import jax.numpy as jnp

    consume = jax.jit(lambda x: x.astype(jnp.uint32).sum())
    # incompressible payload: an all-zeros buffer would let any compression
    # on the link would report fantasy bandwidth vs the real speckle data
    rng = np.random.default_rng(0)

    canary_n = 1 << 20
    t0 = time.perf_counter()
    float(consume(jnp.asarray(rng.integers(0, 256, canary_n).astype(np.uint8))))
    first_program_s = time.perf_counter() - t0
    log(f"first program (compile+handshake+1MB wire): {first_program_s:.1f}s")

    t0 = time.perf_counter()
    float(consume(jnp.asarray(rng.integers(0, 256, canary_n).astype(np.uint8))))
    canary_rate = canary_n / (time.perf_counter() - t0) / 1e6
    log(f"link canary (wire only): {canary_rate:.1f} MB/s")
    if canary_rate < 2.0:
        return {"up_MBps": round(canary_rate, 2), "down_MBps": None,
                "first_program_s": round(first_program_s, 1),
                "collapsed": True}

    buf = rng.integers(0, 256, nbytes).astype(np.uint8)
    float(consume(jnp.asarray(buf)))  # warm: wire + compile at probe shape
    t0 = time.perf_counter()
    dev = jnp.asarray(buf)
    float(consume(dev))
    up = nbytes / (time.perf_counter() - t0) / 1e6

    small = jnp.asarray(buf[:down_nbytes])
    float(consume(small))  # ensure the buffer is genuinely device-resident
    t0 = time.perf_counter()
    np.asarray(small)
    down = down_nbytes / (time.perf_counter() - t0) / 1e6
    return {"up_MBps": round(up, 1), "down_MBps": round(down, 1),
            "first_program_s": round(first_program_s, 1),
            "collapsed": False}


def pipeline_kwargs(frame_chunk: int) -> dict:
    return dict(
        metrics="all",
        tiles=True,
        tracking_method="template",
        tracking_backend="opencv",
        verbose=False,
        frame_chunk=frame_chunk,
    )


def warmup_pipeline(stack: np.ndarray, frame_chunk: int) -> None:
    """Compile every program shape the real run uses.

    The ramped schedule adds 2-frame chunk programs on top of the
    frame_chunk-wide ones (the tracking ROI derives from frame-0 grain, so
    shapes match the real run). When the real run cannot ramp
    (T <= 2*frame_chunk) one chunk suffices. The warmup elapsed time is
    recorded so a watchdog emission can fall back to it as an honest
    (compile-inclusive) throughput number.
    """
    import barc4dip_tpu as dip

    T_all = stack.shape[0]
    if T_all > 2 * frame_chunk:
        warm_T = min(T_all, 2 * frame_chunk + 1)
    else:
        warm_T = min(T_all, max(2, frame_chunk))
    t0 = time.perf_counter()
    dip.speckle_stack_stats(stack[:warm_T], **pipeline_kwargs(frame_chunk))
    STATE["warmup_s"] = time.perf_counter() - t0
    STATE["warmup_frames"] = warm_T
    log(f"warmup: {warm_T} frames in {STATE['warmup_s']:.1f}s "
        f"(incl. compile)")


def timed_run(stack: np.ndarray, frame_chunk: int) -> None:
    """One timed full-pipeline run; appends its record to STATE["runs"]."""
    import barc4dip_tpu as dip
    from barc4dip_tpu.metrics import stack_fused

    t0 = time.perf_counter()
    out = dip.speckle_stack_stats(stack, **pipeline_kwargs(frame_chunk))
    elapsed = time.perf_counter() - t0
    perf = dict(stack_fused.LAST_RUN_PERF)

    if not _RUN1_LEAVES:
        # capture the hardware metric VALUES of the first run's leading
        # frames (already on host — the pipeline returns NumPy) for the
        # metric-value gate; slicing is free, outside the timed region
        _RUN1_LEAVES.update(metric_leaves(out, GOLDEN_K))

    # Per-stage attribution (upload / dispatch / wait) makes a throughput
    # swing self-explaining. JAX dispatch is asynchronous: upload_s /
    # dispatch_s measure the (mostly synchronous-transfer) enqueue side,
    # while device COMPUTE time is realised inside pull_wait_s when results
    # are fetched. The split distinguishes link-bound (upload_s or
    # upload_eff_MBps collapse) from compute-bound (pull_wait_s dominates
    # with tiny pull_MB) regimes.
    stages_d = {
        "upload_s": round(perf.get("upload_s", 0.0), 3),
        "upload_io_s": round(perf.get("upload_io_s", 0.0), 3),
        "dispatch_s": round(perf.get("dispatch_s", 0.0), 3),
        "pull_wait_s": round(perf.get("pull_wait_s", 0.0), 3),
        "other_s": round(
            elapsed
            - perf.get("upload_s", 0.0)
            - perf.get("dispatch_s", 0.0)
            - perf.get("pull_wait_s", 0.0),
            3,
        ),
        "upload_MB": round(perf.get("upload_bytes", 0) / 1e6, 1),
        "pull_MB": round(perf.get("pull_bytes", 0) / 1e6, 3),
        "note": (
            "pull_wait_s includes device compute (async dispatch); upload_s "
            "is the residual blocking wait (transfers run on a prefetch "
            "thread, actual wire time = upload_io_s)"
        ),
    }
    if perf.get("upload_io_s"):
        stages_d["upload_eff_MBps"] = round(
            perf["upload_bytes"] / 1e6 / perf["upload_io_s"], 1
        )

    # hardware-level correctness gate: the synthetic stack's motion is known
    T = stack.shape[0]
    ts = np.arange(T)
    dys = 0.35 * ts * np.cos(ts * 0.7)
    dxs = 0.35 * ts * np.sin(ts * 0.7)
    err = np.hypot(
        out["temporal"]["abs"]["dy"] - dys, out["temporal"]["abs"]["dx"] - dxs
    )
    track_err = float(np.nanmax(err))
    STATE["runs"].append(
        {"elapsed_s": elapsed, "frames": T, "track_err_px": track_err,
         "stages": stages_d}
    )
    log(f"run: {elapsed:.2f}s ({T * stack.shape[1] * stack.shape[2] / 1e6 / elapsed:.1f} "
        f"MP/s on {_card()}), track_err {track_err:.4f} px")


def metric_leaves(out: dict, k: int) -> dict:
    """Flatten the ``full`` + ``tiles`` numeric leaves of a
    ``speckle_stack_stats`` result to {dotted.path: float64 array}, keeping
    only the first ``k`` frames of each leading axis. Per-frame metrics
    depend only on their own frame, so these are directly comparable
    between a k-frame golden run and the head of a longer run.

    Map-sized leaves (the grain autocorrelation, (k, H, W)) are reduced to
    a deterministic strided sample of 4096 values plus their global
    mean/L2/max — an element-wise check on a fixed subset of the map (the
    same pixels both sides), which catches a precision regression anywhere
    the FFT path touches without shipping megabytes into the committed
    golden cache."""
    leaves: dict = {}

    def walk(path: str, node) -> None:
        if isinstance(node, dict):
            for key, v in node.items():
                walk(f"{path}.{key}", v)
            return
        arr = np.asarray(node)
        if arr.dtype.kind not in "fiu":
            return
        if arr.ndim >= 1 and arr.shape[0] >= k:
            arr = arr[:k]
        arr = np.asarray(arr, np.float64)
        if arr.size > 8192:
            flat = arr.ravel()
            idx = np.linspace(0, flat.size - 1, 4096).astype(np.int64)
            finite = flat[np.isfinite(flat)]
            summary = np.array([
                finite.mean() if finite.size else np.nan,
                np.sqrt(np.mean(finite**2)) if finite.size else np.nan,
                np.max(np.abs(finite)) if finite.size else np.nan,
            ])
            leaves[path + ".sample4096"] = flat[idx]
            leaves[path + ".summary"] = summary
            return
        leaves[path] = arr

    for section in ("full", "tiles"):
        if section in out:
            walk(section, out[section])
    return leaves


def _leaf_rel_err(a: np.ndarray, b: np.ndarray,
                  absolute: bool = False) -> float:
    """Normalized inf-norm difference of one leaf: max|a-b| over the
    leaf's own magnitude scale. Zero-valued leaves compare absolutely
    (denominator = the larger side's scale); a finiteness mismatch is an
    unconditional failure (inf). ``absolute=True`` skips the scale
    normalization (used for leaves in logarithmic units, where the
    absolute difference is already a relative measure)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return 1e30  # sentinel, not inf: the artifact must stay strict JSON
    fa, fb = np.isfinite(a), np.isfinite(b)
    if not np.array_equal(fa, fb):
        return 1e30
    if not fa.any():
        return 0.0
    a, b = a[fa], b[fb]
    if absolute:
        return float(np.max(np.abs(a - b)))
    denom = max(float(np.max(np.abs(a))), float(np.max(np.abs(b))))
    if denom == 0.0:
        return 0.0
    return float(np.max(np.abs(a - b))) / denom


def _stack_golden_key(stack: np.ndarray, k: int) -> str:
    import hashlib

    h = hashlib.sha256(np.ascontiguousarray(stack[:k]).tobytes())
    return (f"{stack.shape[1]}x{stack.shape[2]}-k{k}"
            f"-{stack.dtype.name}-{h.hexdigest()[:16]}")


def compute_metric_golden(stack: np.ndarray, k: int, frame_chunk: int,
                          kind: str = "speckle") -> dict | None:
    """Run the SAME pipeline (``kind`` ∈ {"speckle", "sharpness"}) on the
    host CPU backend in a subprocess and return its metric leaves. An
    independent execution of the same math — different backend, different
    FFT engine (XLA CPU vs cuFFT), different reduction orders — so
    agreement bounds the hardware path's numeric error. The child runs
    with ``JAX_PLATFORMS=cpu`` in its environment, so it never opens the
    GPU this process holds."""
    import subprocess
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".npy", delete=False) as f:
        in_npy = f.name
    out_json = in_npy + ".golden.json"
    try:
        np.save(in_npy, np.ascontiguousarray(stack[:k]))
        proc = subprocess.run(
            [sys.executable, str(REPO / "bench.py"), "--make-golden",
             in_npy, out_json, str(frame_chunk), kind],
            cwd=str(REPO), capture_output=True, text=True,
            timeout=max(remaining_s() - 30.0, 60.0),
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        if proc.returncode != 0:
            log(f"golden subprocess failed rc={proc.returncode}: "
                f"{proc.stderr[-400:]}")
            return None
        leaves = json.loads(Path(out_json).read_text())
        return {p: np.asarray(v, np.float64) for p, v in leaves.items()}
    except Exception as exc:
        log(f"golden computation failed: {exc!r}")
        return None
    finally:
        for p in (in_npy, out_json):
            try:
                os.unlink(p)
            except OSError:
                pass


def golden_main(in_npy: str, out_json: str, frame_chunk: str,
                kind: str = "speckle") -> int:
    """Subprocess entry (``bench.py --make-golden``): CPU-backend golden
    run, started with ``JAX_PLATFORMS=cpu`` by :func:`compute_metric_golden`."""
    import barc4dip_tpu as dip

    stack = np.load(in_npy)
    if kind == "sharpness":
        out = dip.sharpness_stack_stats(
            stack, **sharpness_kwargs(stack.shape[0])
        )
    else:
        out = dip.speckle_stack_stats(
            stack, **pipeline_kwargs(int(frame_chunk))
        )
    leaves = metric_leaves(out, stack.shape[0])
    Path(out_json).write_text(
        json.dumps({p: v.tolist() for p, v in leaves.items()})
    )
    return 0


def sharpness_kwargs(frame_chunk: int) -> dict:
    return dict(metrics="all", tiles=True, verbose=False,
                frame_chunk=frame_chunk)


def _resolve_golden(stack: np.ndarray, frame_chunk: int,
                    kind: str) -> tuple[dict | None, str | None]:
    """(golden leaves, source) for a value gate. Reads the committed
    cache keyed by frame content (+ pipeline kind); on a miss, recomputes
    on the CPU backend if the budget allows — CPU-minutes the driver's
    budget usually cannot spare, which is why the cache ships with the
    repo."""
    key = _stack_golden_key(stack, GOLDEN_K)
    if kind != "speckle":
        key += f"-{kind}"
    cache: dict = {}
    if METRIC_GOLDEN_CACHE.exists():
        try:
            cache = json.loads(METRIC_GOLDEN_CACHE.read_text())
        except Exception as exc:
            log(f"golden cache unreadable: {exc!r}")
    entry = cache.get(key)
    if entry:
        golden = {p: np.asarray(v, np.float64)
                  for p, v in entry["leaves"].items()}
        return golden, (f"cache({entry.get('git_rev', '?')} "
                        f"{entry.get('computed_utc', '?')})")
    if remaining_s() > 120 and not STATE["link_degraded"]:
        log(f"golden cache miss ({kind}): computing CPU-backend golden "
            f"({GOLDEN_K} frames) in a subprocess")
        golden = compute_metric_golden(stack, GOLDEN_K, frame_chunk, kind)
        if golden is not None:
            cache[key] = {
                "leaves": {p: v.tolist() for p, v in golden.items()},
                "git_rev": _git_rev(),
                "computed_utc": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "backend": "cpu (same code, f32 compute, XLA CPU FFTs)",
            }
            try:
                METRIC_GOLDEN_CACHE.write_text(json.dumps(cache, indent=1))
            except Exception as exc:
                log(f"golden cache write failed: {exc!r}")
            return golden, "measured"
    return None, None


def _compare_leaves(run_leaves: dict, golden: dict):
    """((worst_path, worst_err), missing_paths) over matching leaves."""
    worst = (None, -1.0)
    per_leaf_missing = [p for p in golden if p not in run_leaves]
    per_leaf_missing += [p for p in run_leaves if p not in golden]

    def _scale(path: str) -> float:
        vals = [v for v in (golden.get(path), run_leaves.get(path))
                if v is not None]
        fin = [np.abs(v[np.isfinite(v)]) for v in vals]
        return max((float(f.max()) for f in fin if f.size), default=0.0)

    for path, gval in golden.items():
        if path not in run_leaves:
            continue
        err = _leaf_rel_err(run_leaves[path], gval)
        if ".SNRdB" in path and err < 1e29:
            # dB is a LOGARITHMIC unit: the absolute dB difference is
            # already a relative measure of the underlying linear ratio
            # (Δr/r = ln(10)/20 · ΔdB). Normalizing by the dB value's own
            # magnitude — which legitimately passes through zero at
            # mean == std — amplifies benign f32 scatter unboundedly
            # (measured 9.8e-5 on full.stats.SNRdB, hardware vs CPU, both
            # f32-clean, value scale ~1 dB). Gate the ratio's rel err.
            err = (_leaf_rel_err(run_leaves[path], gval, absolute=True)
                   * (np.log(10.0) / 20.0))
        elif path.endswith(".std") and err < 1e29:
            # a ``.std`` leaf is a cancellation-amplified derivative of its
            # sibling ``.mean`` values (std of 9 near-equal tiles): its own
            # scale can be 1e3x smaller than the quantity it derives from,
            # so benign f32 scatter reads as ~1e-3 against it (measured
            # 5.4e-4 on tiles.amplitude.contrast.std, hardware vs CPU,
            # both f32-clean). Error in a std cannot exceed error in the
            # underlying values — normalize by the PARENT scale instead.
            parent = _scale(path[: -len(".std")] + ".mean")
            own = _scale(path)
            if parent > own > 0.0:
                err *= own / parent
        if err > worst[1]:
            worst = (path, err)
    return worst, per_leaf_missing


def _record_value_gate(gate_key: str, name: str, run_leaves: dict,
                       golden: dict, source: str | None) -> None:
    worst, per_leaf_missing = _compare_leaves(run_leaves, golden)
    STATE[gate_key] = {
        "checked": True,
        "max_rel_err": round(worst[1], 10),
        "worst_leaf": worst[0],
        "rtol": METRIC_GATE_RTOL,
        "frames_compared": GOLDEN_K,
        "leaves_compared": len(golden) - len(per_leaf_missing),
        "schema_mismatches": per_leaf_missing or None,
        "golden_source": source,
    }
    if per_leaf_missing:
        # a leaf present on only one side is a schema divergence — fail
        STATE[gate_key]["max_rel_err"] = 1e30
    log(f"{name}: max_rel_err={worst[1]:.3e} on '{worst[0]}' "
        f"(rtol {METRIC_GATE_RTOL:g}, golden {source})")


def check_hardware_metrics(stack: np.ndarray, frame_chunk: int) -> None:
    """The metric-VALUE hardware gate: compare run 1's
    full+tiles leaves for the first GOLDEN_K frames against the host-CPU
    golden at METRIC_GATE_RTOL."""
    if not _RUN1_LEAVES:
        STATE["metric_gate"] = {"checked": False,
                                "note": "no run-1 leaves captured"}
        return
    golden, source = _resolve_golden(stack, frame_chunk, "speckle")
    if golden is None:
        STATE["metric_gate"] = {
            "checked": False,
            "note": "golden unavailable (cache miss and no budget to "
                    "compute it)",
        }
        return
    _record_value_gate("metric_gate", "metric gate", _RUN1_LEAVES,
                       golden, source)


def check_hardware_sharpness(stack: np.ndarray) -> None:
    """Value-gate the sharpness family on hardware. The benched pipeline
    is speckle-only, so without this stage the sharpness estimators —
    fused Sobel/Laplace stencils, spectral entropy, inverse autocorrelation
    widths, and the subspace-iteration eigenvalues kernel
    (``ops/eig.py``), a matmul-based kernel in exactly the silent
    reduced-precision failure class — would never be value-checked on the
    chip. Runs ``sharpness_stack_stats`` over the stack's first GOLDEN_K
    frames on the device and compares every full+tiles leaf
    against the host-CPU golden (reference estimator definitions:
    /root/reference/src/barc4dip/metrics/sharpness.py:405-861)."""
    if STATE["link_degraded"] or remaining_s() < 75:
        STATE["sharpness_gate"] = {
            "checked": False,
            "note": "skipped (budget or degraded link)",
        }
        return
    import barc4dip_tpu as dip

    # resolve the golden FIRST (a cache-file read when it hits): on a miss
    # with too little budget to recompute, the ~10 s device run below would
    # be spent for a gate that can only report "golden unavailable"
    golden, source = _resolve_golden(stack, GOLDEN_K, "sharpness")
    if golden is None:
        STATE["sharpness_gate"] = {
            "checked": False,
            "note": "golden unavailable (cache miss and no budget to "
                    "compute it)",
        }
        return

    try:
        t0 = time.perf_counter()
        out = dip.sharpness_stack_stats(stack[:GOLDEN_K],
                                        **sharpness_kwargs(GOLDEN_K))
        run_leaves = metric_leaves(out, GOLDEN_K)
        log(f"sharpness gate: device run of {GOLDEN_K} frames in "
            f"{time.perf_counter() - t0:.1f}s")
    except Exception as exc:
        # only a COMPLETED measurement may fail the gate (same rule as the
        # tracking gate): an exception here is infrastructure (compile,
        # OOM), not measured-wrong numerics — record it loudly as
        # unchecked rather than flipping the whole artifact to gate_failed
        STATE["sharpness_gate"] = {
            "checked": False,
            "note": f"device sharpness run raised: {exc!r}"[:300],
        }
        log(f"sharpness gate: device run RAISED (gate unchecked): {exc!r}")
        return
    _record_value_gate("sharpness_gate", "sharpness gate", run_leaves,
                       golden, source)


def estimate_pipeline_flops_per_frame(H: int, W: int) -> float:
    """Estimated *algorithmic* FLOPs of one frame's fused metrics+tracking
    programs (the MFU convention: useful work, counting every FFT at the
    textbook 5·N·log2(N)).

    Terms (all groups, tiles on = 9 subtiles, template tracking, 9 ROIs):

    - full-frame grain autocorrelation: rfft2 + irfft2 (= one complex-FFT
      equivalent) + pointwise |.|², radial gather, percentile/moment
      reductions (~30 flops/px across the stats/amplitude/bandwidth
      groups' fused reductions);
    - the same chain on 9 subtiles of N/9 pixels each;
    - tracking: 2 full-frame forward transforms per frame (abs + inc
      chains), 18 correlation inverses (9 ROIs x abs/inc) each preceded by
      a pointwise complex product (~8 flops/px) and followed by the fused
      NCC epilogue (~12 flops/px: divide, wrap mask, peak reduction).
    """
    import math

    N = H * W
    fft2 = 5.0 * N * math.log2(N)     # complex 2-D FFT equivalent
    rfft2 = 0.5 * fft2
    metrics = 2 * rfft2 + 30.0 * N
    n_sub = N / 9.0
    metrics += 9 * (2 * (2.5 * n_sub * math.log2(n_sub)) + 30.0 * n_sub)
    tracking = 2 * rfft2 + 18 * (rfft2 + 8.0 * N + 12.0 * N)
    return metrics + tracking


# Published peaks of each supported device, keyed by ``device_kind``.
# Source: NVIDIA H100 data sheet, SXM part, dense rates, 700 W power limit.
# A device missing from the table is an error, not a silent ``None``.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "fp32_tflops": 67.0, "hbm_tb_s": 3.35,
        "source": "NVIDIA H100 data sheet (SXM, dense)",
    },
}


def device_peaks(kind: str) -> dict:
    """Published peaks for ``device_kind`` (see :data:`DEVICE_PEAKS`)."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}: add a row to "
            "bench.DEVICE_PEAKS"
        ) from None


def fit_probe_frames(T: int, frame_bytes: int, reserve_s: float) -> int:
    """Shrink the device-probe stack to what the remaining budget can
    upload (the probe pays its own wire: ``jnp.asarray`` of the probed
    frames), keeping ``reserve_s`` for the stages after it. More frames =
    better amortization of the 2-dispatch program tax, so take the most
    the budget affords — quantized to powers-of-two frame counts so the
    superchunk program SHAPES recur across runs and stay in the
    persistent compile cache (an arbitrary fitted T would be a fresh
    remote compile on every congested day), floor 4."""
    up = (STATE["link"] or {}).get("up_MBps") or 30.0
    allow_s = remaining_s() - reserve_s
    # upload + ~3 timed executions (~2-6 s) + slack for the scalar pulls
    fit = int((allow_s - 8.0) * up * 1e6 / max(frame_bytes, 1))
    best = 4
    while best * 2 <= min(T, fit):
        best *= 2
    return max(4, min(T, best))


def measure_device_compute(stack: np.ndarray, frame_chunk: int,
                           reserve_s: float = 0.0) -> None:
    """Wire-independent device-compute throughput of the fused programs
    (frames pre-uploaded): what the chip could sustain on a healthy link.
    Runs right after warmup, so the cheap, wire-independent number reaches
    the artifact even on a starved budget, with the probed frame count
    fitted to the budget while reserving ``reserve_s`` for the timed runs
    behind it. A failure here raises: a probe error on the card must not
    read as a missing number."""
    from barc4dip_tpu.metrics.common import choose_tiling_mode, normalize_groups
    from barc4dip_tpu.metrics.speckles import (
        _ALL_SPECKLE_GROUPS,
        tracking_grid_from_frame0,
    )
    from barc4dip_tpu.metrics.stack_fused import device_compute_probe

    T, H, W = stack.shape
    probe_T = fit_probe_frames(T, stack[0].nbytes, reserve_s)
    if probe_T < T:
        log(f"device probe budget fit: {probe_T} of {T} frames")
        stack = stack[:probe_T]
    groups = normalize_groups(
        "all", all_groups=_ALL_SPECKLE_GROUPS, context="speckles",
        param_name="metrics",
    )
    mode, _ = choose_tiling_mode(H, W, tiles=True, min_tile_px=128)
    grid_slices, _labels, _roi, _step, _g0 = tracking_grid_from_frame0(stack)
    probe = device_compute_probe(
        stack, grid_slices, groups=groups, mode=mode, sat=65535.0,
        eps=1e-6, flip=True, method="template", subpixel=True,
        frame_chunk=frame_chunk,
    )
    gflops_frame = estimate_pipeline_flops_per_frame(H, W) / 1e9
    frames_per_s = probe["mpix_s"] / (H * W / 1e6)
    est_gflops = gflops_frame * frames_per_s
    kind = STATE["device"]["kind"]
    peak = device_peaks(kind)["bf16_tflops"]
    STATE["device_compute"] = {
        "compute_mpix_s": round(probe["mpix_s"], 2),
        "compute_s_total": round(probe["elapsed_s"], 3),
        "metrics_only_s": round(probe["metrics_only_s"], 3),
        "tracking_only_s": round(probe["tracking_only_s"], 3),
        "frames_probed": int(probe["frames"]),
        "est_gflops": round(est_gflops, 1),
        "est_gflops_per_frame": round(gflops_frame, 2),
        "device_kind": kind,
        "pct_of_bf16_peak": round(100.0 * est_gflops / (peak * 1e3), 4),
        "device": STATE["device"],
        "note": "frames pre-uploaded; fused metrics+tracking programs "
                "+ scalar pulls only (the wire-independent chip rate). "
                "est_gflops counts algorithmic (5NlogN FFT-equivalent) "
                "work; the pipeline is HBM-bound, so a tiny fraction "
                "of matmul peak is expected and fine",
    }
    STATE["device_compute_source"] = "measured"
    write_device_compute_cache(stack.shape[1], frame_chunk)
    log(f"device compute: {probe['mpix_s']:.1f} MP/s "
        f"(~{est_gflops:.0f} GFLOP/s algorithmic) on {_card()}")




def _git_rev() -> str:
    try:
        import subprocess

        return subprocess.run(
            ["git", "-C", str(REPO), "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _devcompute_key(side: int, frame_chunk: int) -> str:
    return f"{side}x{side}-chunk{frame_chunk}"


def write_device_compute_cache(side: int, frame_chunk: int) -> None:
    try:
        cache = {}
        if DEVCOMPUTE_CACHE.exists():
            cache = json.loads(DEVCOMPUTE_CACHE.read_text())
        entry = dict(STATE["device_compute"])
        entry["git_rev"] = _git_rev()
        entry["measured_utc"] = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        cache[_devcompute_key(side, frame_chunk)] = entry
        DEVCOMPUTE_CACHE.write_text(json.dumps(cache, indent=2))
    except Exception as exc:  # cache is best-effort
        log(f"device-compute cache write failed: {exc!r}")


def read_device_compute_cache(side: int, frame_chunk: int) -> None:
    """Fallback when the probe is skipped (degraded link / budget): the
    chip rate does not change with the wire, so the last measured value —
    explicitly marked source='cache' with its git rev and date — is more
    informative than null. Only used if the probe never ran this process;
    a measurement always supersedes it."""
    if STATE["device_compute"] is not None:
        return
    try:
        if not DEVCOMPUTE_CACHE.exists():
            return
        cache = json.loads(DEVCOMPUTE_CACHE.read_text())
        entry = cache.get(_devcompute_key(side, frame_chunk))
        if not entry:
            return
        STATE["device_compute"] = entry
        STATE["device_compute_source"] = (
            f"cache({entry.get('git_rev', '?')} "
            f"{entry.get('measured_utc', '?')})")
        log(f"device compute from cache: {entry.get('compute_mpix_s')} "
            f"MP/s ({STATE['device_compute_source']})")
    except Exception as exc:
        log(f"device-compute cache read failed: {exc!r}")


def read_baseline_cache(side: int) -> None:
    """Load the committed CPU baseline early so even a degraded emission
    carries vs_baseline."""
    key = f"{side}x{side}-u16"
    if BASELINE_CACHE.exists():
        try:
            cache = json.loads(BASELINE_CACHE.read_text())
            if key in cache:
                STATE["cpu_sec_per_frame"] = float(cache[key]["sec_per_frame"])
                STATE["cpu_baseline_source"] = "cache"
        except Exception:
            pass


def measure_cpu_baseline(side: int, cpu_T: int) -> None:
    """Per-frame seconds of the reference pipeline on CPU (expensive)."""
    try:
        sys.path.insert(0, "/root/reference/src")
        import barc4dip as ref

        stack = make_stack(cpu_T, side)
        t0 = time.perf_counter()
        ref.speckle_stack_stats(
            stack, metrics="all", tiles=True, tracking_backend="opencv",
            verbose=False, parallel=True, n_jobs=-1,
        )
        sec_per_frame = (time.perf_counter() - t0) / cpu_T
    except Exception as exc:  # baseline is best-effort
        log(f"baseline measurement failed: {exc!r}")
        return
    STATE["cpu_sec_per_frame"] = sec_per_frame
    STATE["cpu_baseline_source"] = "measured"
    cache = {}
    if BASELINE_CACHE.exists():
        try:
            cache = json.loads(BASELINE_CACHE.read_text())
        except Exception:
            cache = {}
    cache[f"{side}x{side}-u16"] = {
        "sec_per_frame": sec_per_frame,
        "frames_measured": cpu_T,
        "backend": "cpu reference (joblib threads, opencv tracking)",
    }
    BASELINE_CACHE.write_text(json.dumps(cache, indent=2))


def main() -> int:
    threading.Thread(target=watchdog_main, daemon=True,
                     name="bench-watchdog").start()
    threading.Thread(target=heartbeat_main, daemon=True,
                     name="bench-heartbeat").start()
    stage("init")
    # 64-frame default: fixed costs (first-chunk fill, drain, scalar pulls)
    # amortize with T — measured 23.25 MP/s at T=64 vs 17.5 at T=16, both
    # ~90% of the same upload roofline. The budget fit below shrinks the
    # run when warmup/congestion ate the budget, so a larger default only
    # helps the healthy path.
    T = int(os.environ.get("BENCH_T", 64))
    side = int(os.environ.get("BENCH_SIZE", 2048))
    cpu_T = int(os.environ.get("BENCH_CPU_T", 2))
    # 4-frame chunks measured fastest with prefetch-overlapped uploads
    # (finer chunks overlap transfers with compute better than the launch
    # floor costs); also matches the 4-frame tracker sub-program cap
    # (metrics/stack_fused.py backend note)
    frame_chunk = int(os.environ.get("BENCH_CHUNK", 4))
    STATE["side"] = side
    read_baseline_cache(side)
    # cached chip rate available from the very first (checkpoint) emission;
    # a live probe later this run overwrites it with source="measured"
    read_device_compute_cache(side, frame_chunk)
    # Liveness line FIRST: round 3's graded artifact was rc=124 with an
    # empty stdout. If the driver's timeout is shorter than even the
    # watchdog budget, this startup snapshot (value 0, stage 'init') is
    # still a parseable artifact; any later checkpoint/final supersedes it
    # (the driver grades the last JSON line).
    emit(degraded=True, kind="startup")
    start_backend_handshake()

    stage("make_stack")
    stack = make_stack(T, side)
    T = stack.shape[0]  # may be budget-fitted on a cold stack cache

    stage("handshake_wait")
    wait_backend_handshake()
    STATE["device"] = device_info()
    log(f"device: {STATE['device']}")

    stage("link_probe")
    try:
        link = measure_link_mbps()
    except Exception as exc:  # link probe is best-effort
        log(f"link probe failed: {exc!r}")
        link = None
    STATE["link"] = link

    if link is not None and (link.get("collapsed")
                             or (link.get("up_MBps") or 1e9) < 5.0):
        log("collapsed link: shrinking to T<=4, skipping run 2 + device "
            "probe (a small true number beats a timeout)")
        STATE["link_degraded"] = True
        T = min(T, 4)
        stack = stack[:T]
    STATE["frames"] = T

    stage("warmup")
    warmup_pipeline(stack, frame_chunk)

    # Fit the timed run to the remaining budget: a congestion episode
    # (first_program_s of minutes) can leave too little budget for the
    # full T — a smaller true number beats the watchdog's value=0. Two
    # estimates of the marginal per-frame cost, take the smaller:
    # - warmup-based (0.8x) is always an OVERestimate when the compile
    #   cache was cold (compile time dominates the warmup);
    # - wire-based (frame bytes / measured link + device cushion) tracks
    #   the true wire-bound cost (~0.35 s/frame at 45 MB/s) and scales
    #   with a degraded link.
    # Underestimating is survivable: the watchdog checkpoint (with the
    # warmup-fallback value) still lands at budget expiry.
    est_warm = 0.8 * STATE["warmup_s"] / max(STATE["warmup_frames"], 1)
    est_spf = est_warm
    up = (link or {}).get("up_MBps")
    if up:
        est_wire = stack[0].nbytes / 1e6 / up + 0.25
        est_spf = min(est_warm, est_wire)
    fit_T = int((remaining_s() - 20.0) / max(est_spf, 1e-3))
    if fit_T < T:
        T_run = max(2, fit_T)
        log(f"budget fit: shrinking timed run {T} -> {T_run} frames "
            f"({remaining_s():.0f}s left, est {est_spf:.2f}s/frame)")
        stack = stack[:T_run]
        T = T_run
        STATE["frames"] = T

    # Device-compute probe FIRST among the measurement stages (round 4
    # item 1: round 4's headline kernel number reached the driver only as a
    # cache entry because the probe was sequenced after the optional run 2
    # and a 143 s handshake ate the budget). It is wire-independent and
    # cheap — programs warm from the warmup, frame count fitted to the
    # budget while reserving the timed run's cost — so even a starved run
    # carries device_compute_source="measured".
    # the probe's minimum cost (4 frames: ~1 s wire + ~3 short executions)
    # is small — only a genuinely exhausted budget skips it
    if not STATE["link_degraded"] and remaining_s() > est_spf * T + 20:
        stage("device_probe")
        measure_device_compute(stack, frame_chunk,
                               reserve_s=est_spf * T + 12.0)
    else:
        log("skipping device-compute probe (budget or degraded link)")

    stage("run1")
    timed_run(stack, frame_chunk)
    run1_s = STATE["runs"][0]["elapsed_s"]

    # metric-VALUE hardware gate: run 1's leaves vs the host-CPU golden
    # (cache hit = instant; only a cache miss spends budget here)
    stage("metric_gate")
    check_hardware_metrics(stack, frame_chunk)

    # sharpness value gate: covers the estimator family the benched
    # pipeline never executes (incl. the matmul-based eigenvalues kernel).
    # Cheap with a warm compile cache (~10 s incl. a GOLDEN_K-frame
    # upload); self-skips with an explicit note when the budget is gone.
    stage("sharpness_gate")
    check_hardware_sharpness(stack)

    # best of two timed runs: a few seconds each now, and the shared
    # host can hiccup mid-run — one retry de-noises the record.
    # LAST optional stage: everything above it matters more than variance
    # de-noising when the budget is starved.
    if not STATE["link_degraded"] and remaining_s() > 1.5 * run1_s + 30:
        stage("run2")
        timed_run(stack, frame_chunk)
    else:
        log("skipping run 2 (budget or degraded link)")

    force = os.environ.get("BENCH_FORCE_BASELINE") == "1"
    if (STATE["cpu_sec_per_frame"] is None or force) and remaining_s() > 90:
        stage("baseline_measure")
        measure_cpu_baseline(side, cpu_T)

    stage("emit")
    rc = emit(degraded=False)
    _DONE.set()
    return rc


def main_guarded() -> int:
    """A fast crash must not die mute any more than a stall may: any
    exception out of the stage sequence still emits a parseable (degraded)
    JSON line with whatever was measured, then exits 1."""
    try:
        return main()
    except BaseException as exc:  # noqa: BLE001 - last-resort artifact guard
        log(f"FATAL in stage '{STATE['stage']}': {exc!r}")
        try:
            emit(degraded=True)
        finally:
            _DONE.set()
        if isinstance(exc, KeyboardInterrupt):
            raise
        return 1


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--make-golden":
        raise SystemExit(golden_main(*sys.argv[2:6]))
    raise SystemExit(main_guarded())
