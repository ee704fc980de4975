# SPDX-License-Identifier: CECILL-2.1
"""The one platform decision (config.platform) and the compile-cache rule.

No code path branches on the accelerator any more; these tests pin that
under a mocked GPU platform every core takes the same plain-XLA path it
takes on the CPU, that the removed Pallas kernels stay removed, and where
the persistent compilation cache goes.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from barc4dip_tpu import config
from barc4dip_tpu.ops import ncc
from barc4dip_tpu.ops.corrcore import autocorr2d_core
from barc4dip_tpu.ops.densetrack import resolve_track_method
from barc4dip_tpu.ops.rank import median_filter2d

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def mocked_gpu(monkeypatch):
    """The process default backend reads as "gpu" (no card needed)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_platform_is_cpu_here():
    assert config.platform() == "cpu"


def test_platform_reads_mocked_gpu_backend(mocked_gpu):
    assert config.platform() == "gpu"


@pytest.mark.parametrize("device", ["cpu", "cpu-device"])
def test_default_device_context_wins(mocked_gpu, device):
    """Host-side work pinned with jax.default_device(cpu) (the frame-0
    grain sizing) sees "cpu" even when the process default is the GPU."""
    dev = "cpu" if device == "cpu" else jax.devices("cpu")[0]
    with jax.default_device(dev):
        assert config.platform() == "cpu"
    assert config.platform() == "gpu"


@pytest.mark.parametrize(
    "module", ["mxufft", "pallas_fftp", "pallas_median"]
)
def test_removed_kernels_are_gone(module):
    with pytest.raises(ImportError):
        importlib.import_module(f"barc4dip_tpu.ops.{module}")


def test_package_imports_no_pallas():
    """No module imports Pallas or passes an ``interpret`` flag: every
    device path is plain XLA."""
    import ast

    for path in (REPO / "barc4dip_tpu").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert "pallas" not in (node.module or ""), path
            elif isinstance(node, ast.Import):
                assert not any("pallas" in a.name for a in node.names), path
            elif isinstance(node, ast.keyword):
                assert node.arg != "interpret", path


def test_cores_identical_under_mocked_gpu(rng, monkeypatch):
    """The NCC bank, the autocorrelation and the 3x3 median trace the same
    program whether the platform reads cpu or gpu."""
    img = jnp.asarray(rng.normal(size=(64, 72)))
    tiles = jnp.asarray(rng.normal(size=(2, 9, 9)))

    def run():
        prep = ncc.zncc_prepare_image(img, 9, 9)
        bank = jax.vmap(lambda t: ncc.prep_template(t, 64, 72))(tiles)
        maps, iy, ix, _ = ncc.ncc_bank_masked_peaks(prep, bank)
        return (np.asarray(maps), np.asarray(iy), np.asarray(ix),
                np.asarray(autocorr2d_core(img)),
                np.asarray(median_filter2d(img)))

    on_cpu = run()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    on_gpu = run()
    for a, b in zip(on_cpu, on_gpu):
        np.testing.assert_array_equal(a, b)


def test_xst_auto_resolves_to_fft_on_every_platform(monkeypatch):
    assert resolve_track_method("auto") == "fft"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_track_method("auto") == "fft"
    assert resolve_track_method("conv") == "conv"


def test_xst_pallas_method_is_refused():
    with pytest.raises(ValueError, match="'auto', 'conv' or 'fft'"):
        resolve_track_method("pallas")


def test_cache_defaults_to_checkout(monkeypatch):
    calls = {}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    config._setup_compilation_cache()
    assert calls["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")
    assert config.CACHE_DIR == REPO / ".jax_cache"


def test_cache_env_set_means_no_setter(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    config._setup_compilation_cache()
    assert calls == {}


def test_cache_env_reaches_jax_in_a_fresh_process(tmp_path):
    """End to end: importing the package leaves JAX's own reading of
    JAX_COMPILATION_CACHE_DIR in place."""
    code = ("import barc4dip_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
