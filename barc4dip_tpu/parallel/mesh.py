# SPDX-License-Identifier: CECILL-2.1
"""Device-mesh data parallelism over the frame axis.

The reference's only parallelism is a joblib thread pool over stack frames
(reference metrics/speckles.py:296-325, SURVEY §2.10). The device-native
equivalent is a 1-D ``jax.sharding.Mesh`` over the frame axis: per-frame
metric and tracking programs are embarrassingly parallel, so sharding the
batch axis distributes them across chips with zero collectives on the hot
path (temporal reductions happen on tiny host arrays afterwards).

Multi-host stacks would extend the same mesh across DCN via
``jax.distributed.initialize``; single-host multi-chip works out of the box.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "FRAME_AXIS",
    "frame_mesh",
    "frames_sharding",
    "replicated_sharding",
    "shard_frames",
    "init_distributed",
]

FRAME_AXIS = "frames"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialise multi-host JAX before building meshes.

    Thin wrapper over ``jax.distributed.initialize``: on a multi-host GPU
    cluster each process calls this first, after which :func:`frame_mesh`
    spans every GPU in the job (frames shard across hosts over the network,
    across the GPUs of one host over NVLink). Where no cluster manager
    (e.g. SLURM) is detected, pass ``coordinator_address``
    (``"host:port"``), ``num_processes`` and ``process_id`` explicitly.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def frame_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name "frames"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


def frames_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (frame) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(FRAME_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())



def shard_frames(arr, mesh: Mesh):
    """Place a (T, ...) array on the mesh, frame axis sharded."""
    return jax.device_put(arr, frames_sharding(mesh))
