"""Device mesh management and table partitioning.

The distributed layer the reference lacks (its parallelism is a shared-memory
thread pool, reference src/parallel/task_scheduler.cpp): base tables and
bitmap indexes are hash/row partitioned across a 1-D "d" mesh axis spanning
the devices; operators run under shard_map with XLA collectives, which NCCL
carries over NVLink (psum for aggregates, all_to_all for radix exchange).
Every card reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "d"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_shards(arr: jnp.ndarray, n: int):
    rows = arr.shape[0]
    rem = rows % n
    if rem == 0:
        return arr
    pad = n - rem
    return jnp.concatenate([arr, jnp.repeat(arr[-1:], pad, axis=0)], axis=0)


def shard_rows(arr: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Row-partition an array across the mesh (pads to divisible length)."""
    n = mesh.devices.size
    return jax.device_put(pad_to_shards(arr, n), row_sharding(mesh))


def shard_arrays(arrays: dict, mesh: Mesh, valid_rows: int) -> tuple[dict, jnp.ndarray]:
    """Shard a column dict plus a validity mask for the padded tail."""
    n = mesh.devices.size
    first = next(iter(arrays.values()))
    rows = first.shape[0]
    padded_rows = (rows + n - 1) // n * n
    mask = jnp.arange(padded_rows) < valid_rows
    out = {k: shard_rows(v, mesh) for k, v in arrays.items()}
    return out, jax.device_put(mask, row_sharding(mesh))
