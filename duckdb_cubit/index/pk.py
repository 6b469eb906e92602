"""Direct-address primary-key index.

The analog of the reference's ART primary-key index feeding join builds
(reference src/execution/index/art/): TPC-H keys are dense (or near-dense,
e.g. sparse order keys at 4x density), so key -> row resolves with a single
int32 lookup array built once at ingest.  PK-FK hash joins then skip the
whole build phase (sort + insert loops) and probe with one gather, with the
build side's filter mask applied through the looked-up row.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class DirectPKIndex:
    def __init__(self, column: str, lut: jnp.ndarray, max_key: int):
        self.column = column
        self.lut = lut          # (max_key+1,) int32 row id, -1 = absent
        self.max_key = max_key

    @classmethod
    def build(cls, column: str, keys: np.ndarray, num_rows: int,
              density_limit: float = 8.0) -> "DirectPKIndex | None":
        """Build from host key values; returns None if keys are unsuitable
        (duplicates, negatives, or too sparse to justify the array)."""
        keys = np.asarray(keys[:num_rows], dtype=np.int64)
        if num_rows == 0:
            return None
        max_key = int(keys.max())
        if keys.min() < 0 or max_key + 1 > density_limit * num_rows:
            return None
        lut = np.full(max_key + 1, -1, np.int32)
        lut[keys] = np.arange(num_rows, dtype=np.int32)
        if (lut[keys] != np.arange(num_rows)).any():
            return None  # duplicate keys
        return cls(column, jnp.asarray(lut), max_key)


def probe(lut: jnp.ndarray, max_key: int, probe_keys: jnp.ndarray,
          probe_valid: jnp.ndarray, build_mask: jnp.ndarray):
    """Direct-address probe: one gather into the key-space lut, then one
    into the build side's liveness mask.  Keys need no order.
    -> (build row per probe row or -1, found mask)."""
    k = probe_keys.astype(jnp.int64)
    in_range = (k >= 0) & (k <= max_key) & probe_valid
    row = lut[jnp.clip(k, 0, max_key)]
    alive = build_mask[jnp.maximum(row, 0)]
    found = in_range & (row >= 0) & alive
    return jnp.where(found, row, -1), found
