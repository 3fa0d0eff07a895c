"""Mesh construction and sharding helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
DB_AXIS = "db"


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              devices=None) -> Mesh:
    """Create a mesh over the available devices.

    Defaults to a 1-D data-parallel mesh over all devices. The device
    order comes from ``mesh_utils`` when it can derive one.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),)
    assert int(np.prod(shape)) == len(devices), (shape, len(devices))
    try:
        from jax.experimental import mesh_utils

        dev_array = mesh_utils.create_device_mesh(shape, devices=devices)
    except Exception:
        dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dimension across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, array, axis: str = DATA_AXIS):
    """Place a host batch on the mesh, sharded along dim 0."""
    return jax.device_put(array, batch_sharding(mesh, axis))


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (parameters, optimizer state) across the mesh."""
    sh = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)
