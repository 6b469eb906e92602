"""Low-level device kernels shared by the operator library.

These are the engine's analogs of the reference's VectorOperations /
row_operations primitives (reference src/common/vector_operations/,
vector_hash.cpp): hashing, masked reductions, and exact (overflow-proof)
grouped sums.

Exactness note: DECIMAL aggregates must be exact at SF100 where a single
group's sum of scale-6 values exceeds int64.  Every int64 sum is therefore
computed as a split (hi, lo) pair — lo sums the low 32 bits, hi the
arithmetically-shifted high 32 bits — and recombined host-side as Python
bigints: (hi << 32) + lo.  Each part stays far below 2**63 for any
realistic row count (~2**31 rows x 2**32 max magnitude), the split sum is
order-independent integer arithmetic, and the recombination is exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# ----------------------------------------------------------------- hashing

_GOLDEN64 = np.uint64(0x9E3779B97F4A7C15)


def hash64(keys: jnp.ndarray) -> jnp.ndarray:
    """64-bit avalanche hash (splitmix64 finalizer) of an int key column.

    Analog of reference VectorOperations::Hash (vector_hash.cpp); used for
    hash-table slots and radix partitioning, so it must mix low bits well.
    """
    x = keys.astype(jnp.uint64)
    x = x + _GOLDEN64
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return x


def hash_combine(h: jnp.ndarray, other: jnp.ndarray) -> jnp.ndarray:
    """Combine hashes of multiple key columns."""
    return hash64(h ^ (other + _GOLDEN64 + (h << np.uint64(6)) + (h >> np.uint64(2))))


# -------------------------------------------------- order-preserving keys

_SIGN_LOW = jnp.int64(0x7FFFFFFFFFFFFFFF)


def monotone_i64(array: jnp.ndarray) -> jnp.ndarray:
    """Order- and equality-preserving int64 key for any numeric column.

    Floats bitcast to int64 with the low 63 bits flipped for negatives —
    the standard IEEE-754 total-order trick (the analog of the reference's
    byte-comparable radix-key encoding, src/common/sort/row_radix_scatter
    .cpp, which flips sign/exponent bits for the same reason).  -0.0 is
    normalized to +0.0 first so SQL equality/grouping sees one zero.  The
    transform is an involution on the int64 bit pattern (the sign bit is
    preserved), so `monotone_i64_inverse` recovers exact float values.
    """
    if jnp.issubdtype(array.dtype, jnp.floating):
        a = array.astype(jnp.float64)
        a = jnp.where(a == 0, jnp.float64(0.0), a)
        bits = jax.lax.bitcast_convert_type(a, jnp.int64)
        return bits ^ ((bits >> jnp.int64(63)) & _SIGN_LOW)
    return array.astype(jnp.int64)


def monotone_i64_inverse(keys: jnp.ndarray, floating: bool) -> jnp.ndarray:
    """Invert monotone_i64 (float64 out when `floating`)."""
    if floating:
        bits = keys ^ ((keys >> jnp.int64(63)) & _SIGN_LOW)
        return jax.lax.bitcast_convert_type(bits, jnp.float64)
    return keys


# ------------------------------------------------------------- exact sums


def _split_hi_lo(values: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    lo = values & jnp.int64(0xFFFFFFFF)  # [0, 2**32)
    hi = values >> jnp.int64(32)  # arithmetic shift keeps sign
    return hi, lo


def masked_sum_exact(values: jnp.ndarray, mask: jnp.ndarray):
    """Exact masked int64 sum -> (hi, lo) device scalars."""
    hi, lo = _split_hi_lo(jnp.where(mask, values, jnp.int64(0)))
    return jnp.sum(hi), jnp.sum(lo)


def combine_hi_lo(hi, lo) -> int:
    """Host-side exact recombination of a split sum."""
    return (int(hi) << 32) + int(lo)


# below this group count, grouped reductions unroll into per-group masked
# reduces (XLA fuses them into a few passes over the data) instead of a
# scatter with colliding indices
SMALL_GROUP_LIMIT = 32


def group_sum_exact(codes: jnp.ndarray, values: jnp.ndarray, mask: jnp.ndarray,
                    num_groups: int, small_limit: int = SMALL_GROUP_LIMIT):
    """Exact grouped int64 sum -> (hi, lo) arrays.

    Integer adds are order-independent, so both strategies (unrolled masked
    reduces for small domains, scatter-add otherwise) are deterministic.
    `codes` must be in [0, num_groups); masked-out rows are dropped.
    """
    hi, lo = _split_hi_lo(jnp.where(mask, values, jnp.int64(0)))
    if num_groups <= small_limit:
        ghi = jnp.stack([jnp.sum(jnp.where(codes == g, hi, jnp.int64(0)))
                         for g in range(num_groups)])
        glo = jnp.stack([jnp.sum(jnp.where(codes == g, lo, jnp.int64(0)))
                         for g in range(num_groups)])
        return ghi, glo
    safe_codes = jnp.where(mask, codes, 0)
    ghi = jnp.zeros(num_groups, jnp.int64).at[safe_codes].add(hi)
    glo = jnp.zeros(num_groups, jnp.int64).at[safe_codes].add(lo)
    return ghi, glo


def group_count(codes: jnp.ndarray, mask: jnp.ndarray, num_groups: int,
                small_limit: int = SMALL_GROUP_LIMIT):
    if num_groups <= small_limit:
        return jnp.stack([
            jnp.sum(jnp.where(mask & (codes == g), jnp.int64(1), jnp.int64(0)))
            for g in range(num_groups)])
    safe_codes = jnp.where(mask, codes, 0)
    ones = jnp.where(mask, jnp.int64(1), jnp.int64(0))
    return jnp.zeros(num_groups, jnp.int64).at[safe_codes].add(ones)


def group_min(codes, values, mask, num_groups, sentinel,
              small_limit: int = SMALL_GROUP_LIMIT):
    vals = jnp.where(mask, values, sentinel)
    if num_groups <= small_limit:
        return jnp.stack([jnp.min(jnp.where(codes == g, vals, sentinel))
                          for g in range(num_groups)])
    safe_codes = jnp.where(mask, codes, 0)
    return jnp.full(num_groups, sentinel, values.dtype).at[safe_codes].min(vals)


def group_max(codes, values, mask, num_groups, sentinel,
              small_limit: int = SMALL_GROUP_LIMIT):
    vals = jnp.where(mask, values, sentinel)
    if num_groups <= small_limit:
        return jnp.stack([jnp.max(jnp.where(codes == g, vals, sentinel))
                          for g in range(num_groups)])
    safe_codes = jnp.where(mask, codes, 0)
    return jnp.full(num_groups, sentinel, values.dtype).at[safe_codes].max(vals)


# ----------------------------------------------------- sorted segment ops
#
# A scatter-add with many colliding indices contends on the same slots,
# while lax.sort / cumsum run as bandwidth-bound passes.  Grouped reductions
# over large group domains are therefore computed in GROUP-SORTED order: sort rows by group id once, then
# every aggregate is a cumsum + two boundary gathers (the reference's
# radix-partitioned aggregate, radix_partitioned_hashtable.cpp, makes the
# same trade: partition first so the per-partition reduce is contention-free).


def sort_by_group(gids: jnp.ndarray, valid: jnp.ndarray):
    """Sort row ids by group id; invalid rows sort last.

    Returns (gid_sorted, srows) where gid_sorted is non-decreasing and
    invalid rows carry gid = 2**31 - 1 (past any real group).
    """
    n = gids.shape[0]
    key = jnp.where(valid, gids.astype(jnp.int32), jnp.int32(2**31 - 1))
    rows = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.sort((key, rows), num_keys=1)


def segment_bounds(gid_sorted: jnp.ndarray, num_groups: int):
    """(start, end) row ranges per group id in [0, num_groups)."""
    edges = jnp.searchsorted(
        gid_sorted, jnp.arange(num_groups + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    return edges[:-1], edges[1:]


def _segment_sum_from_cumsum(csum, start, end):
    """Per-group sums from an inclusive cumsum (int64-safe boundary diff)."""
    has = end > start
    top = jnp.where(has, csum[jnp.maximum(end - 1, 0)], 0)
    base = jnp.where(start > 0, csum[jnp.maximum(start - 1, 0)], 0)
    return jnp.where(has, top - base, 0)


def segment_sum_exact(v_sorted: jnp.ndarray, valid_sorted: jnp.ndarray,
                      start: jnp.ndarray, end: jnp.ndarray):
    """Exact grouped int64 sum over group-sorted rows -> (hi, lo) arrays.

    Same split-sum exactness contract as group_sum_exact: lo sums 32-bit
    halves (cumsum stays < 2**55 for any realistic row count), recombined
    as (hi << 32) + lo.
    """
    hi, lo = _split_hi_lo(jnp.where(valid_sorted, v_sorted, jnp.int64(0)))
    chi = jnp.cumsum(hi)
    clo = jnp.cumsum(lo)
    return (_segment_sum_from_cumsum(chi, start, end),
            _segment_sum_from_cumsum(clo, start, end))


def segment_count(valid_sorted: jnp.ndarray, start, end):
    c = jnp.cumsum(valid_sorted.astype(jnp.int64))
    return _segment_sum_from_cumsum(c, start, end)


def segment_minmax(gids, values, valid, num_groups: int, sentinel,
                   want_max: bool):
    """Grouped min/max via a (gid, value) sort + boundary gather."""
    key = jnp.where(valid, gids.astype(jnp.int64), jnp.int64(num_groups))
    v = values.astype(jnp.int64)
    vkey = jnp.where(valid, jnp.where(want_max, -v, v), jnp.int64(2**62))
    gk, vk = jax.lax.sort((key, vkey), num_keys=2)
    start, end = segment_bounds(gk.astype(jnp.int32), num_groups)
    has = end > start
    best = vk[jnp.minimum(start, vk.shape[0] - 1)]
    best = jnp.where(want_max, -best, best)
    return jnp.where(has, best, sentinel)


# ------------------------------------------------------------- compaction


def mask_to_indices(mask: jnp.ndarray, capacity: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Selection-vector materialization: row ids of set mask bits.

    Returns (indices[capacity], count); padding slots hold len(mask) (an
    out-of-range sentinel).  This is the analog of the reference's
    sel-vector production in filter kernels (column_segment.cpp:262) and of
    the CUBIT bitvector->rowid decode.

    Implemented as a stable sort on the inverted mask (selected rows first,
    in row order) rather than jnp.nonzero's sized lowering.
    """
    n = mask.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    inv = (~mask).astype(jnp.int32)
    _, perm = jax.lax.sort((inv, rows), num_keys=1, is_stable=True)
    count = jnp.sum(mask.astype(jnp.int64))
    if capacity > n:
        perm = jnp.concatenate(
            [perm, jnp.full(capacity - n, n, jnp.int32)])
    take = perm[:capacity].astype(jnp.int64)
    idx = jnp.where(jnp.arange(capacity) < count, take, n)
    return idx, count


def gather_columns(arrays: dict, indices: jnp.ndarray) -> dict:
    """Probe columns through a selection vector (clipped; caller keeps count)."""
    out = {}
    for name, arr in arrays.items():
        out[name] = jnp.take(arr, jnp.minimum(indices, arr.shape[0] - 1), axis=0)
    return out
