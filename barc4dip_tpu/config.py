# SPDX-License-Identifier: CECILL-2.1
"""Global configuration for barc4dip_tpu.

Precision policy
----------------
All device kernels compute in the dtype of their input (promoted to at least
float32).  On CPU with ``jax_enable_x64`` this gives float64 bit-parity with
the NumPy/SciPy formulations; on the GPU the production dtype is float32
(float64 runs natively there when explicitly requested).

``default_float()`` is used when a function has to materialise constants
(frequency axes, radial grids, ...) whose dtype is not implied by an input.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

__all__ = [
    "default_float",
    "is_x64_enabled",
    "platform",
    "MIN_TILE_PX",
    "SATURATION_VALUE",
]

# Policy constants shared across metric aggregators (reference:
# metrics/speckles.py:192, metrics/sharpness.py:213 hardcode MIN_TILE_PX=128;
# saturation 65535 in metrics/statistics.py:17).
MIN_TILE_PX: int = 128
SATURATION_VALUE: float = 65535.0


def is_x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def default_float() -> jnp.dtype:
    """Widest float available under the current x64 setting."""
    return jnp.float64 if is_x64_enabled() else jnp.float32


def platform() -> str:
    """Platform of the effective default device: ``"cpu"`` or ``"gpu"``.

    The one platform decision of the package. An enclosing
    ``jax.default_device(...)`` wins over the process default backend, so
    host-side work pinned to the CPU (the frame-0 grain sizing in
    ``metrics.speckles``) sees ``"cpu"`` even when the process runs on a
    GPU. Not cached: the answer can change inside a ``default_device``
    block."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")



def _setup_debug_mode() -> None:
    """BARC4DIP_TPU_DEBUG=1 enables the numerical sanitizer: jax debug-nans
    aborts with a traceback at the first NaN-producing primitive (the
    device analogue of a sanitizer run; the reference has none).

    Caveat: some legitimate outputs are NaN by contract (frac_sat with
    ``saturation_value=None``, degenerate-tile fallbacks) — use this mode to
    localise *unexpected* NaNs in kernel work, not in production runs."""
    if not _env_flag("BARC4DIP_TPU_DEBUG", False):
        return
    jax.config.update("jax_debug_nans", True)


_setup_debug_mode()


#: Persistent compilation cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: not set: a fixed directory in the checkout (gitignored), so every process
#: of this checkout shares one cache.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def _setup_compilation_cache() -> None:
    """The fused metric programs are large (tens of seconds to compile a
    2048² full+tiles program) but fully reusable across processes. When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    here touches the cache settings."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_setup_compilation_cache()
