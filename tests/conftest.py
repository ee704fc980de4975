# SPDX-License-Identifier: CECILL-2.1
"""Test configuration: CPU backend with 8 virtual devices and x64 enabled.

- JAX_PLATFORMS=cpu + xla_force_host_platform_device_count=8 gives a fake
  8-device mesh for multi-device sharding tests (the standard fake-backend
  trick; no GPUs needed).
- x64 lets golden tests compare against float64 NumPy/SciPy references at
  tight tolerances; GPU runs use float32 (covered by dtype-specific tests).
- Tests marked ``gpu`` need a card: they decide inside the ``gpu`` fixture
  whether one is present and skip here with the reason.
"""
import os

# CPU unless the caller names platforms (the GPU tests run with
# JAX_PLATFORMS=cuda,cpu on a machine with a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import re

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" in flags:
    # an inherited count != 8 would fail every mesh test confusingly:
    # replace it rather than keeping the stale value
    os.environ["XLA_FLAGS"] = re.sub(
        r"--xla_force_host_platform_device_count=\d+",
        "--xla_force_host_platform_device_count=8",
        flags,
    )
else:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in os.environ["XLA_FLAGS"]:
    # 8 fake devices time-slice the host's real cores (1 on the CI VM):
    # barrier skew can exceed XLA:CPU's default 40 s rendezvous deadline,
    # which F-checks the whole process (seen at production-geometry
    # shapes). Unbounded skew is legitimate on an oversubscribed mesh.
    os.environ["XLA_FLAGS"] += (
        " --xla_cpu_collective_call_terminate_timeout_seconds=3600"
    )

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture()
def gpu():
    """The first GPU. Whether there is one is decided here, when a test
    asks, never at import or collection time; without one the test skips
    with the reason."""
    from barc4dip_tpu.config import platform

    if platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return jax.devices()[0]


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def make_speckle(rng, shape=(256, 256), grain_px=6.0, dtype=np.float64):
    """Synthetic speckle field with a known Gaussian correlation length
    (delegates to the public generator, barc4dip_tpu.utils.speckle_field).

    precision="double" pins the generator's original bit-exact float64
    path so committed golden values stay stable across rounds regardless
    of the generator's default (single) precision."""
    from barc4dip_tpu.utils import speckle_field

    return speckle_field(
        shape, grain_px=grain_px, seed=rng, dtype=dtype, precision="double"
    )


@pytest.fixture()
def speckle(rng):
    return make_speckle(rng)


def pytest_collection_modifyitems(config, items):
    """Fast tier (VERDICT r4 item 5): tests listed in tests/slow_tests.txt
    (generated from a measured --durations run on the 1-core CI host) are
    auto-marked ``slow`` so ``pytest -m "not slow"`` is a ~2-3 minute
    pre-commit tier. CI and the round driver still run everything.
    Regenerate the list with tests/make_slow_list.py after a full
    --durations=0 run."""
    from pathlib import Path

    listing = Path(__file__).parent / "slow_tests.txt"
    if not listing.exists():
        return
    slow_ids = {
        line.strip()
        for line in listing.read_text().splitlines()
        if line.strip() and not line.startswith("#")
    }
    marker = pytest.mark.slow
    for item in items:
        if item.nodeid in slow_ids:
            item.add_marker(marker)
