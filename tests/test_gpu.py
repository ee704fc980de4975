# SPDX-License-Identifier: CECILL-2.1
"""The device path on an NVIDIA GPU against the same calls on the CPU.

Marked ``gpu``: each test asks for the ``gpu`` fixture, which skips with
the reason where no card is present. On a machine with one:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

Both sides run the production float32 path (uint16 frames) with different
FFT engines and reduction orders, so leaves agree to ~1e-6 and the gates
sit at 1e-4 (normalized inf-norm per leaf, chip_smoke.compare).
"""
import jax
import numpy as np
import pytest

import barc4dip_tpu as dip
import chip_smoke as cs

pytestmark = pytest.mark.gpu


def _on_cpu(fn, *args, **kw):
    with jax.default_device(jax.devices("cpu")[0]):
        return fn(*args, **kw)


def test_speckle_stack_stats_gpu_matches_cpu(gpu):
    stack = cs.make_stack(8, 384)
    kw = dict(cs.STACK_KW)
    on_gpu = dip.speckle_stack_stats(stack, **kw)
    resident = dip.speckle_stack_stats(jax.device_put(stack, gpu), **kw)
    on_cpu = _on_cpu(dip.speckle_stack_stats, stack, **kw)
    sections = ("full", "tiles", "temporal")
    got = cs.leaves(on_gpu, sections, None)
    want = cs.leaves(on_cpu, sections, None)
    _, err = cs.compare(cs.without_f95(got), cs.without_f95(want))
    assert err <= cs.CPU_RTOL
    assert cs.f95_error(got, want, 384, 384) <= cs.F95_TOL_BINS
    _, err = cs.compare(cs.leaves(resident, sections, None),
                        cs.leaves(on_gpu, sections, None))
    assert err <= cs.RESIDENT_RTOL
    e_abs, e_inc = cs.tracking_errors(on_gpu, 8)
    assert max(e_abs, e_inc) <= cs.TRACK_TOL_PX


def test_sharpness_stack_stats_gpu_matches_cpu(gpu):
    stack = cs.make_stack(4, 384)
    on_gpu = dip.sharpness_stack_stats(stack, **cs.SHARP_KW)
    on_cpu = _on_cpu(dip.sharpness_stack_stats, stack, **cs.SHARP_KW)
    _, err = cs.compare(cs.leaves(on_gpu), cs.leaves(on_cpu))
    assert err <= cs.CPU_RTOL


def test_preprocessing_and_xst_on_gpu(gpu):
    from barc4dip_tpu.preprocessing import flat_field_correction, register_stack

    stack = cs.make_stack(6, 256)
    flat = cs.make_flat(256)
    got = flat_field_correction(stack[1], flats=flat, bad_pixel_removal=True)
    assert cs.leaf_error(got, cs.flat_field_reference(stack[1], flat)) <= cs.FLAT_RTOL

    dys, dxs = np.array([0.0, 1.3, -2.45]), np.array([0.0, -0.7, 3.15])
    frames = dip.utils.speckle_stack(3, (256, 256), grain_px=6.0, dys=dys,
                                     dxs=dxs, seed=5)
    _, shifts = register_stack(frames, reference="first")
    assert np.hypot(shifts["dy"] - dys, shifts["dx"] - dxs).max() <= cs.TRACK_TOL_PX

    field = dip.signal.track_displacement_field(stack[5], stack[0])
    ref = _on_cpu(dip.signal.track_displacement_field, stack[5], stack[0],
                  method="fft")
    assert field["meta"]["method"] == "fft"
    for key in ("dy", "dx"):
        assert np.max(np.abs(field[key] - ref[key])) <= cs.XST_TOL_PX
