"""Hash join kernels: vectorized open-addressing build + probe.

Analog of the reference's JoinHashTable (reference
src/execution/join_hashtable.cpp): the reference builds a pointer table of
atomic (salt | 48-bit pointer) entries with CAS inserts (:559-668) and probes
with salt-prefiltered linear chains (:206-316).  XLA has no CAS, so this
design replaces racy inserts with deterministic whole-column passes:

 1. the build side is sorted by key (lax.sort), giving contiguous runs per
    key: a CSR of (unique key -> start, count) into the sorted row order —
    this subsumes the reference's in-row next-pointer chains;
 2. unique keys are inserted into a power-of-two open-addressing table with
    iterative scatter-min claim rounds (each round every still-unplaced key
    attempts its current slot; ties resolved by min row index, losers advance
    — deterministic, data-parallel, terminates in O(max probe len) rounds);
 3. probes walk the table with a vectorized linear-probe while_loop, then
    either gather the single match (PK-FK fast path) or expand variable
    match counts through prefix sums + jnp.repeat with a static capacity.

All shapes are static; "not found" is index -1 and callers carry validity
masks.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .kernels import hash64

KEY_SENTINEL = jnp.int64(-(2**62))  # never a real key (TPC-H keys positive)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass
class BuildSide:
    """Device state of a finalized build side."""
    ht_keys: jnp.ndarray      # (size,) int64, KEY_SENTINEL = empty
    ht_entry: jnp.ndarray     # (size,) int32 -> index into unique arrays
    starts: jnp.ndarray       # (ucap,) int32 offset into sorted_rows
    counts: jnp.ndarray       # (ucap,) int32 run length
    sorted_rows: jnp.ndarray  # (cap,) int32 build row ids grouped by key
    size: int
    unique_capacity: int


@functools.partial(jax.jit, static_argnames=("size", "ucap"))
def _build_kernel(keys: jnp.ndarray, valid: jnp.ndarray, size: int, ucap: int):
    """Sort-based build: sorted unique keys + CSR of per-key row runs.

    `size` is kept in the signature for compatibility; the probe is a binary
    search over the sorted unique-key array (static log2 trip count), which
    avoids dynamic-condition while_loops — those serialize catastrophically
    on the target backend, whereas large sorts are fast.
    ht_keys here IS the ascending unique-key array (big-sentinel padded).
    """
    del size
    n = keys.shape[0]
    # a leading validity key pushes masked rows past all valid ones without
    # a key-value sentinel (sentinels collide with monotone-encoded float
    # keys: a double 2.0 bitcasts to exactly 2**62); the padding sentinel
    # for empty unique slots is int64 max so ukeys stays ascending
    big = jnp.int64(jnp.iinfo(jnp.int64).max)
    lead = (~valid).astype(jnp.int64)
    rows = jnp.arange(n, dtype=jnp.int32)
    lv, sk, srows = jax.lax.sort(
        (lead, keys.astype(jnp.int64), rows), num_keys=2)
    first = jnp.concatenate([jnp.ones(1, jnp.bool_), sk[1:] != sk[:-1]])
    svalid = lv == 0
    first = first & svalid
    # dense unique ids along sorted (== ascending-key) order
    uid = jnp.cumsum(first.astype(jnp.int32)) - 1
    n_unique = jnp.where(jnp.any(svalid), uid[-1] + 1, 0)
    uid = jnp.where(svalid, uid, ucap - 1)
    # ascending unique keys (empties hold the +big sentinel => stay sorted)
    ukeys = jnp.full(ucap, big, jnp.int64).at[uid].set(
        jnp.where(svalid, sk, big))
    pos = jnp.arange(n, dtype=jnp.int32)
    starts = jnp.full(ucap, n, jnp.int32).at[uid].min(
        jnp.where(svalid, pos, jnp.int32(n)))
    counts = jnp.zeros(ucap, jnp.int32).at[uid].add(svalid.astype(jnp.int32))
    ht_entry = jnp.arange(ucap, dtype=jnp.int32)  # identity (kept for API)
    return ukeys, ht_entry, starts, counts, srows, n_unique


def build(keys: jnp.ndarray, valid: jnp.ndarray, num_rows_hint: int | None = None,
          load_factor: float = 0.5) -> BuildSide:
    n = keys.shape[0]
    size = _next_pow2(max(16, int((num_rows_hint or n) / load_factor)))
    ucap = n
    ht_keys, ht_entry, starts, counts, srows, _ = _build_kernel(
        keys, valid, size, ucap)
    return BuildSide(ht_keys, ht_entry, starts, counts, srows, size, ucap)


@functools.partial(jax.jit, static_argnames=("size",))
def _probe_kernel(ht_keys, counts, probe_keys, probe_valid, size: int):
    """Sort-merge probe: tagged sort of (build unique keys + probe keys),
    then a cummax carries each probe slot's last build entry.

    Replaces a binary-search probe: the merge phase of a sort-merge join
    in sort and scan primitives, with no per-element gathers.  Whether
    this beats jnp.searchsorted or a direct gather on the GPU is not
    measured yet (benchmarks/probe_primitives.py times the primitives).

    Sort order (key, tag) with build tag 0 < probe tag 1 puts every build
    entry before its equal probe keys; two cummax scans then carry the
    last VALID build entry's key and unique-index to each probe slot, and
    a hit is simply `carried key == probe key`.  Empty padding slots
    (count 0) are excluded from the carry, so a probe key equal to the
    padding sentinel cannot match."""
    del size
    m = ht_keys.shape[0]
    n = probe_keys.shape[0]
    pk = probe_keys.astype(jnp.int64)
    keys = jnp.concatenate([ht_keys, pk])
    tag = jnp.concatenate([jnp.zeros(m, jnp.int8), jnp.ones(n, jnp.int8)])
    idx = jnp.concatenate([jnp.arange(m, dtype=jnp.int32),
                           jnp.arange(n, dtype=jnp.int32)])
    bval = jnp.concatenate([(counts > 0), jnp.zeros(n, jnp.bool_)])
    sk, st, si, sv = jax.lax.sort((keys, tag, idx, bval), num_keys=2)
    is_build = (st == 0) & sv
    # keys are ascending, so a running max of build-slot keys IS the last
    # valid build key at or before each position (likewise its index)
    lo64 = jnp.int64(-(2**63))
    bkey_run = jax.lax.cummax(jnp.where(is_build, sk, lo64))
    bidx_run = jax.lax.cummax(jnp.where(is_build, si, -1))
    hit = (bkey_run == sk) & (st == 1)
    entry_sorted = jnp.where(hit, bidx_run, -1)
    # scatter back to probe order
    target = jnp.where(st == 1, si, jnp.int32(n))
    out = jnp.full(n + 1, -1, jnp.int32).at[target].set(
        entry_sorted, mode="drop")[:n]
    return jnp.where(probe_valid, out, -1)


def probe(bs: BuildSide, probe_keys: jnp.ndarray, probe_valid: jnp.ndarray):
    """-> (unique-entry index per probe row, -1 on miss)."""
    return _probe_kernel(bs.ht_keys, bs.counts, probe_keys, probe_valid,
                         bs.size)


def probe_single(bs: BuildSide, probe_keys, probe_valid):
    """PK-FK fast path: -> (build row id per probe row, found mask).

    Valid when build keys are unique (counts == 1), the common TPC-H case.
    """
    entry = probe(bs, probe_keys, probe_valid)
    found = entry >= 0
    safe = jnp.maximum(entry, 0)
    build_row = jnp.where(found, bs.sorted_rows[bs.starts[safe]], -1)
    return build_row, found


@functools.partial(jax.jit, static_argnames=("out_capacity", "left"))
def expand_matches(starts, counts, sorted_rows, entry, probe_valid,
                   out_capacity: int, left: bool = False):
    """General join expansion with variable match counts.

    -> (probe_row_idx[out_capacity], build_row_idx[out_capacity], out_count)
    Rows beyond out_count are padding (probe_row_idx == -1).
    With `left=True` every unmatched valid probe row still emits one output
    row with build_row_idx == -1 (LEFT OUTER semantics; callers turn the -1
    into NULL build columns via validity masks).
    """
    found = (entry >= 0) & probe_valid
    safe = jnp.maximum(entry, 0)
    cnt = jnp.where(found, counts[safe], 0)
    if left:
        cnt = jnp.where(probe_valid & ~found, 1, cnt)
    offs = jnp.cumsum(cnt) - cnt  # exclusive prefix
    total = jnp.sum(cnt)
    n = entry.shape[0]
    probe_rows = jnp.arange(n, dtype=jnp.int32)
    out_probe = jnp.full(out_capacity, -1, jnp.int32)
    active = cnt > 0
    # scatter run starts, then segment-relative offsets via cummax trick
    first_pos = jnp.where(active, offs, out_capacity)
    out_probe = out_probe.at[first_pos].set(
        jnp.where(active, probe_rows, -1), mode="drop")
    # fill runs: forward-fill the last set value.  The scattered values
    # (probe row ids) strictly increase with output position, so the fill is
    # exactly a running max — lax.cummax is one fused scan primitive,
    # whereas lax.associative_scan unrolls log2(n) slice/pad levels that
    # take minutes to compile at SF1 shapes.
    filled = jax.lax.cummax(out_probe, axis=0)
    valid_out = jnp.arange(out_capacity) < total
    out_probe = jnp.where(valid_out, filled, -1)
    # per-output offset within its run
    run_start_pos = jnp.zeros(out_capacity, jnp.int32).at[first_pos].set(
        first_pos.astype(jnp.int32), mode="drop")
    run_start_filled = jax.lax.cummax(run_start_pos, axis=0)
    within = jnp.arange(out_capacity, dtype=jnp.int32) - run_start_filled
    safe_probe = jnp.maximum(out_probe, 0)
    row_entry = entry[safe_probe]
    bstart = starts[jnp.maximum(row_entry, 0)]
    build_ok = valid_out if not left else (valid_out & (row_entry >= 0))
    out_build = jnp.where(build_ok, sorted_rows[
        jnp.minimum(bstart + within, sorted_rows.shape[0] - 1)], -1)
    return out_probe, out_build, total


def semi_mask(bs: BuildSide, probe_keys, probe_valid, anti: bool = False):
    entry = probe(bs, probe_keys, probe_valid)
    found = entry >= 0
    m = ~found if anti else found
    return m & probe_valid
