"""Grouped aggregation kernels.

Analog of the reference's aggregate hash tables (reference
src/execution/aggregate_hashtable.cpp GroupedAggregateHashTable,
radix_partitioned_hashtable.cpp, perfect_aggregate_hashtable.cpp).  XLA has
no CAS-based insert, so the design picks between:

 - **dense path** (analog of PhysicalPerfectHashAggregate): when group codes
   live in a small known domain (dictionary codes, mixed-radix composites,
   join build-row ids), aggregate directly with deterministic scatter-add —
   integer adds are order-independent, so no atomics semantics are needed;

 - **sort path** (general GROUP BY): sort rows by key (lax.sort, multi-key),
   derive dense group ids from run boundaries with a prefix sum, then
   scatter-add into a bounded group table.  This replaces the reference's
   linear-probing + salt inserts with a deterministic two-phase plan, the
   same trade the radix-partitioned table makes at finalize time.

DECIMAL sums use the split (hi, lo) exact representation from kernels.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import kernels


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GroupedKeys:
    """Result of generic key grouping."""
    group_ids: jnp.ndarray      # (n,) int32 dense ids, invalid rows -> 0
    valid: jnp.ndarray          # (n,) bool
    num_groups: jnp.ndarray     # device scalar
    rep_rows: jnp.ndarray       # (capacity,) int32 a representative row per group


def mixed_radix_codes(code_arrays: list, sizes: list[int]):
    """Combine small per-column codes into one dense group code."""
    total = 1
    code = None
    for arr, size in zip(code_arrays, sizes):
        c = arr.astype(jnp.int32)
        code = c if code is None else code * size + c
        total *= size
    return code, total


@functools.partial(jax.jit, static_argnames=("capacity",))
def group_by_sort(keys: tuple, valid: jnp.ndarray, capacity: int) -> GroupedKeys:
    """Dense group ids for an arbitrary int-key tuple via multi-key sort.

    A leading validity key (not a key-value sentinel) pushes masked rows to
    the end: sentinels collide with monotone-encoded float keys, where a
    double 2.0 bitcasts to exactly 2**62."""
    n = keys[0].shape[0]
    lead = (~valid).astype(jnp.int64)
    skeys = (lead,) + tuple(k.astype(jnp.int64) for k in keys)
    rows = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort(skeys + (rows,), num_keys=len(skeys))
    sk, srows = out[:-1], out[-1]
    changed = jnp.zeros(n, jnp.bool_).at[0].set(True)
    for k in sk:
        changed = changed | jnp.concatenate(
            [jnp.ones(1, jnp.bool_), k[1:] != k[:-1]])
    svalid = sk[0] == 0
    first = changed & svalid
    gid_sorted = jnp.cumsum(first.astype(jnp.int32)) - 1
    num_groups = jnp.maximum(gid_sorted[-1] + 1, 0) if n else jnp.int32(0)
    num_groups = jnp.where(jnp.any(svalid), jnp.max(jnp.where(svalid, gid_sorted, -1)) + 1, 0)
    gid_sorted = jnp.where(svalid, gid_sorted, 0)
    # map back to input row order
    gids = jnp.zeros(n, jnp.int32).at[srows].set(gid_sorted)
    rep = jnp.full(capacity, -1, jnp.int32).at[
        jnp.where(first, gid_sorted, capacity)].set(srows, mode="drop")
    return GroupedKeys(gids, valid, num_groups, rep)
