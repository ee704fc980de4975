# SPDX-License-Identifier: CECILL-2.1
"""Multi-host wiring: parallel.init_distributed over a real 2-process job.

The multi-host path is the one SURVEY component with no single-process
test: here two OS processes rendezvous through a localhost coordinator
(`jax.distributed.initialize`), build the shared frame mesh across both
processes' CPU devices, and run one jitted cross-process computation.
This validates the multi-host wiring contract end-to-end minus the
actual cluster:
process_count, global device visibility, global-array construction from
per-process shards, and a cross-process collective reduction.

Skips (with the reason) when the runner forbids localhost sockets or the
rendezvous cannot complete.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax

    jax.config.update("jax_platforms", "cpu")

    port, pid = sys.argv[1], int(sys.argv[2])

    from barc4dip_tpu.parallel import (
        frame_mesh, frames_sharding, init_distributed, replicated_sharding,
    )

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == 2 * n_local, (n_global, n_local)

    import jax.numpy as jnp

    mesh = frame_mesh()  # spans BOTH processes' devices
    frames = np.arange(
        n_global * 2 * 8 * 8, dtype=np.float32
    ).reshape(n_global * 2, 8, 8)

    # global sharded array assembled from per-process local shards
    arr = jax.make_array_from_callback(
        frames.shape, frames_sharding(mesh), lambda idx: frames[idx]
    )

    # per-frame reduction (data-parallel) + a cross-process global mean
    per_frame = jax.jit(
        lambda x: jnp.mean(x, axis=(1, 2)),
        out_shardings=frames_sharding(mesh),
    )(arr)
    total = jax.jit(
        lambda x: jnp.mean(x), out_shardings=replicated_sharding(mesh)
    )(arr)

    np.testing.assert_allclose(
        float(total), float(frames.mean()), rtol=1e-6
    )
    local = jax.device_get(
        [s.data for s in per_frame.addressable_shards]
    )
    assert all(np.all(np.isfinite(x)) for x in local)
    print(f"WORKER_OK pid={pid} global_devices={n_global}")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_two_process_mesh(tmp_path):
    # bounded by the 150 s communicate() timeout below (pytest-timeout is
    # not installed in this environment)
    try:
        port = _free_port()
    except OSError as e:  # pragma: no cover - locked-down runner
        pytest.skip(f"runner forbids localhost sockets: {e}")

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    # CPU only in the workers: a worker must never open the GPU beside
    # its parent (each JAX process reserves most of a card's memory)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(port), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=str(REPO),
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip(
            "2-process rendezvous did not complete in 150s — runner likely "
            "blocks the localhost coordinator socket"
        )

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "WORKER_OK" in out, out[-3000:]
