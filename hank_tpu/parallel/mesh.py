"""Device mesh and sharding layer.

The reference has NO distributed machinery (SURVEY §2.10); this module is the
communication backend the new framework supplies: a
`jax.sharding.Mesh` over the devices with NamedShardings, letting XLA insert
all collectives. The primary data-parallel axis is the shock-path ensemble
(BASELINE config 5: 1024 simultaneous T=300 paths); the household state axis
is available as a second ("state") axis for very large grids.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("dp",)) -> Mesh:
    """1-D (default) or n-D mesh over the first `n_devices` devices.

    For multi-axis meshes the device count must factor accordingly; with the
    default single "dp" axis all devices line up on the ensemble axis.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if len(axis_names) == 1:
        arr = np.array(devices)
    else:
        # Balanced 2-D factorization for ("dp", "state")-style meshes.
        n = len(devices)
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        arr = np.array(devices).reshape(a, n // a)
    return Mesh(arr, axis_names)


def ensemble_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (ensemble/batch) axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
