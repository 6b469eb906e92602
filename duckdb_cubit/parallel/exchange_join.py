"""Explicit radix-exchange hash join: the engine's distributed join lowering.

The analog of the reference's radix-partitioned hash join
(reference src/execution/operator/join/physical_hash_join.cpp:373
HashJoinRepartitionTask + join_hashtable.cpp:1370-1400 repartitioning),
re-architected for a device mesh: instead of threads CAS-inserting into one
shared table, each device OWNS the hash partitions `hash(key) % n == rank`
of both sides.  One `all_to_all` per side routes rows to their owners
(NCCL over NVLink), the local join is the engine's sort-CSR build/probe
(ops/join.py), and the joined output stays row-sharded for downstream
operators.  Build-side rows are never replicated — per-device build memory
is `n_build / n + skew slack`, vs. a broadcast/all-gather join's full copy.

Capacity discipline (static shapes): per-destination bucket quotas and the
local expansion capacity are host-chosen; overflow counts come back as
deferred device scalars, and the staged executor doubles the failing
quota/capacity and retries the stage — the skew-aware requota of
SetRepartitionRadixBits applied inside the engine's recovery machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ops import join as join_ops
from .exchange import (_pack_buckets, default_quota,
                       histogram_quota)
from .mesh import DATA_AXIS


def eligible(op, ctx, probe_rel_cap: int, build_rows: int) -> bool:
    """Host decision: does this join lower to the explicit exchange?"""
    cfg = ctx.config
    mesh = getattr(ctx.catalog, "mesh", None)
    if mesh is None or cfg is None or not cfg.explicit_exchange:
        return False
    if op.join_type not in ("inner", "left"):
        return False
    if len(op.probe_keys) > 2:        # key packing must stay exact
        return False
    if build_rows < cfg.exchange_min_build_rows:
        return False
    n = mesh.devices.size
    return probe_rel_cap % n == 0 and build_rows % n == 0


def execute(ctx, op, probe_rel, build_rel, pkey, bkey):
    """Run the exchange join; returns the output Relation.

    pkey/bkey: combined int64 key columns (collision-free for <=2 key
    columns via exact packing).
    """
    from ..plan.physical import RelColumn, Relation
    from ..storage.table import pad_count

    mesh = ctx.catalog.mesh
    n = mesh.devices.size
    cfg = ctx.config
    slack = cfg.exchange_quota_slack if cfg is not None else 2.0
    left = op.join_type == "left"

    pcap, bcap = probe_rel.capacity, build_rel.capacity
    # quotas from the actual per-destination histograms when the inputs are
    # concrete (staged execution: stage boundaries ARE materialized); traced
    # values fall back to the slack*mean guess + requota retries
    bq = getattr(op, "_exq_build", None)
    pq = getattr(op, "_exq_probe", None)
    import jax.core as _jc
    concrete = not (isinstance(bkey, _jc.Tracer)
                    or isinstance(pkey, _jc.Tracer))
    if bq is None:
        bq = (histogram_quota(mesh, bkey, build_rel.mask, n) if concrete
              else default_quota(bcap // n, n, slack))
    if pq is None:
        pq = (histogram_quota(mesh, pkey, probe_rel.mask, n) if concrete
              else default_quota(pcap // n, n, slack))
    # record the quotas actually used so the retry handler can double them,
    # and the exchange traffic (host-static model) for the scaling report
    op._exq_build, op._exq_probe = bq, pq
    row_bytes_p = 9 + sum(int(jnp.dtype(c.array.dtype).itemsize)
                          for c in probe_rel.columns.values())
    row_bytes_b = 9 + sum(int(jnp.dtype(c.array.dtype).itemsize)
                          for c in build_rel.columns.values())
    op._exchange_bytes = n * n * (pq * row_bytes_p + bq * row_bytes_b)
    cap = getattr(op, "_cap_override", None) or op.out_capacity
    if cap is None:
        factor = cfg.join_expansion_factor if cfg is not None else 1.0
        cap = pad_count(int(pcap * factor))
    cap_local = max(8192, -(-cap // n))

    pnames = list(probe_rel.columns.keys())
    bnames = [nm for nm in build_rel.columns
              if op.build_prefix + nm not in probe_rel.columns]

    def flatten(rel, names):
        arrs, has_valid = [], []
        for nm in names:
            c = rel.columns[nm]
            arrs.append(c.array)
            has_valid.append(c.valid is not None)
            if c.valid is not None:
                arrs.append(c.valid)
        return arrs, has_valid

    parrs, pvalid_flags = flatten(probe_rel, pnames)
    barrs, bvalid_flags = flatten(build_rel, bnames)
    np_arr, nb_arr = len(parrs), len(barrs)

    size = 1
    while size < 2 * n * bq:
        size *= 2

    def local(pk, pm, bk, bm, *cols):
        pcols = list(cols[:np_arr])
        bcols = list(cols[np_arr:])
        # route both sides to their hash owners
        bk2, bp, bv, bovf = _pack_buckets(bk, bcols, bm, n, bq)
        bk2 = jax.lax.all_to_all(bk2, DATA_AXIS, 0, 0).reshape(-1)
        bp = [jax.lax.all_to_all(c, DATA_AXIS, 0, 0).reshape(
            (-1,) + c.shape[2:]) for c in bp]
        bv = jax.lax.all_to_all(bv, DATA_AXIS, 0, 0).reshape(-1)
        pk2, pp, pv, povf = _pack_buckets(pk, pcols, pm, n, pq)
        pk2 = jax.lax.all_to_all(pk2, DATA_AXIS, 0, 0).reshape(-1)
        pp = [jax.lax.all_to_all(c, DATA_AXIS, 0, 0).reshape(
            (-1,) + c.shape[2:]) for c in pp]
        pv = jax.lax.all_to_all(pv, DATA_AXIS, 0, 0).reshape(-1)
        # local sort-CSR join over the owned partition
        ht_keys, _, starts, counts, srows, _ = join_ops._build_kernel(
            bk2, bv, size, bk2.shape[0])
        bs_counts = counts
        pos = jnp.searchsorted(ht_keys, pk2, side="left").astype(jnp.int32)
        safe = jnp.minimum(pos, ht_keys.shape[0] - 1)
        hit = pv & (ht_keys[safe] == pk2) & (bs_counts[safe] > 0)
        entry = jnp.where(hit, safe, -1)
        out_probe, out_build, total = join_ops.expand_matches(
            starts, counts, srows, entry, pv, cap_local, left=left)
        valid = jnp.arange(cap_local) < total
        matched = out_build >= 0
        safe_p = jnp.clip(out_probe, 0, pk2.shape[0] - 1)
        safe_b = jnp.clip(out_build, 0, bk2.shape[0] - 1)
        outs = [jnp.take(c, safe_p, axis=0) for c in pp]
        outs += [jnp.take(c, safe_b, axis=0) for c in bp]
        ovf = jax.lax.psum(bovf + povf, DATA_AXIS)
        over_cap = jax.lax.psum((total > cap_local).astype(jnp.int32),
                                DATA_AXIS)
        return (valid, matched, ovf, over_cap, *outs)

    spec = P(DATA_AXIS)
    out_specs = (spec, spec, P(), P()) + (spec,) * (np_arr + nb_arr)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(spec,) * (4 + np_arr + nb_arr),
                   out_specs=out_specs, check_vma=False)
    res = fn(pkey, probe_rel.mask, bkey, build_rel.mask, *parrs, *barrs)
    valid, matched, ovf, over_cap = res[0], res[1], res[2], res[3]
    outs = list(res[4:])
    ctx.add_check(op, "exq", ovf == 0)
    ctx.add_check(op, "expansion", over_cap == 0, cap_local * n)

    out_cap = n * cap_local
    cols: dict = {}
    i = 0
    for nm, hv in zip(pnames, pvalid_flags):
        c = probe_rel.columns[nm]
        arr = outs[i]
        i += 1
        v = None
        if hv:
            v = outs[i]
            i += 1
        cols[nm] = RelColumn(arr, c.dtype, c.dictionary, c.domain, v)
    for nm, hv in zip(bnames, bvalid_flags):
        c = build_rel.columns[nm]
        arr = outs[i]
        i += 1
        v = None
        if hv:
            v = outs[i]
            i += 1
        if left:
            v = matched if v is None else (v & matched)
        cols[op.build_prefix + nm] = RelColumn(arr, c.dtype, c.dictionary,
                                               c.domain, v)
    if left and op.found_column:
        # decorrelated EXISTS rewrites (binder.py:965) filter on this flag;
        # mirror the standard path's emission (plan/physical.py:729)
        from ..types import BOOL

        cols[op.found_column] = RelColumn(matched & valid, BOOL, None)
    return Relation(cols, valid, out_cap)
