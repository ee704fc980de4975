# SPDX-License-Identifier: CECILL-2.1
"""barc4dip_tpu — accelerator-native (JAX) digital image processing for beam diagnostics.

A ground-up JAX/XLA rebuild of the barc4dip capability set: speckle and
sharpness metrics for 2D detector images and (T, H, W) stacks, FFT/PSD and
correlation analysis, translation tracking, preprocessing, reporting, and a
data-parallel device-mesh path for large stacks.

Public API parity with the reference package ``barc4dip`` (__init__.py:6-38):
namespaces plus the curated top-level functions.
"""
from ._version import __version__
from . import geometry, maths, ops, signal, utils

# Subpackages built on the numeric core; imported lazily so partial
# installations (and docs builds) keep working.
import importlib as _importlib

_LAZY_SUBMODULES = ("io", "metrics", "preprocessing", "plotting", "report", "parallel", "models")
_LAZY_FUNCTIONS = {
    "read_image": "barc4dip_tpu.io",
    "write_image": "barc4dip_tpu.io",
    "speckle_stats": "barc4dip_tpu.metrics",
    "speckle_stack_stats": "barc4dip_tpu.metrics",
    "sharpness_stats": "barc4dip_tpu.metrics",
    "sharpness_stack_stats": "barc4dip_tpu.metrics",
    "distribution_moments": "barc4dip_tpu.metrics",
    "logbook_report": "barc4dip_tpu.report",
}

__all__ = [
    "__version__",
    "geometry",
    "maths",
    "ops",
    "signal",
    "utils",
    *_LAZY_SUBMODULES,
    *_LAZY_FUNCTIONS,
]


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        return _importlib.import_module(f"barc4dip_tpu.{name}")
    if name in _LAZY_FUNCTIONS:
        mod = _importlib.import_module(_LAZY_FUNCTIONS[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'barc4dip_tpu' has no attribute {name!r}")


def __dir__():
    # advertise the lazy names: dir()/tab completion must show the same
    # surface the reference package shows eagerly
    return sorted(set(globals()) | set(__all__))
