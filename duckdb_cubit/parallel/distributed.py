"""Distributed query steps: sharded scan/filter/aggregate/join pipelines.

The multi-chip execution strategy (BASELINE.json north star): base tables and
CUBIT bitmaps are row-partitioned across the mesh; filters and bitmap AND/OR
run shard-locally; grouped aggregates compute shard-local partials and
combine with psum over the interconnect (NCCL over NVLink); joins route both sides through the radix
exchange so each device owns its hash partitions (replacing the reference's
CAS-based shared hash table with deterministic partition ownership).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ops import bitmap as bm
from ..ops import join as join_ops
from .mesh import DATA_AXIS


def make_q6_step(mesh):
    """Distributed bitmap scan + exact masked sum (the Q6 shape).

    Inputs (sharded on rows/words): predicate words (3 columns' AND input),
    eprice, disc.  Output: replicated (hi, lo) exact revenue sum.
    """

    def local(words_a, words_b, words_c, eprice, disc, valid):
        words = words_a & words_b & words_c
        mask = bm.expand(words, eprice.shape[0]) & valid
        val = (eprice * disc).astype(jnp.int64)
        lo = jnp.sum(jnp.where(mask, val & jnp.int64(0xFFFFFFFF), 0))
        hi = jnp.sum(jnp.where(mask, val >> jnp.int64(32), 0))
        return (jax.lax.psum(hi, DATA_AXIS), jax.lax.psum(lo, DATA_AXIS))

    spec = P(DATA_AXIS)
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec),
        out_specs=(P(), P()),
        check_vma=False))


def make_grouped_agg_step(mesh, num_groups: int):
    """Distributed dense grouped aggregate (the Q1 shape).

    Shard-local scatter-add partials + psum: the analog of the reference's
    thread-local hash tables merged in finalize
    (radix_partitioned_hashtable.cpp), with the merge as one collective.
    """

    def local(codes, values, valid):
        safe = jnp.where(valid, codes, 0)
        v = jnp.where(valid, values.astype(jnp.int64), jnp.int64(0))
        lo = jnp.zeros(num_groups, jnp.int64).at[safe].add(v & jnp.int64(0xFFFFFFFF))
        hi = jnp.zeros(num_groups, jnp.int64).at[safe].add(v >> jnp.int64(32))
        cnt = jnp.zeros(num_groups, jnp.int64).at[safe].add(
            valid.astype(jnp.int64))
        return (jax.lax.psum(hi, DATA_AXIS), jax.lax.psum(lo, DATA_AXIS),
                jax.lax.psum(cnt, DATA_AXIS))

    spec = P(DATA_AXIS)
    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=(P(), P(), P()), check_vma=False))


def make_pipelined_join_step(mesh, build_quota: int, probe_quota: int,
                             n_chunks: int):
    """Distributed hash join with DOUBLE-BUFFERED probe exchange.

    The probe side is split into n_chunks equal chunks and software-
    pipelined: while chunk i is probed against the local hash table, chunk
    i+1's all_to_all is already issued — the two have no data dependence,
    so XLA's async collectives overlap the NVLink transfer with the probe
    compute.  This is the analog of the reference overlapping scan
    prefetch with compute (row_group.cpp:487-505) applied to the exchange,
    and the BASELINE.json "double-buffered exchange" requirement.

    Semantics identical to make_partitioned_join_step (sum of
    probe_value * build_value over matches, plus total overflow).
    """
    from .exchange import _pack_buckets

    n = mesh.devices.size

    def local(bkeys, bvals, bvalid, pkeys, pvals, pvalid):
        bk, bp, bv, bovf = _pack_buckets(bkeys, [bvals], bvalid, n,
                                         build_quota)
        bk = jax.lax.all_to_all(bk, DATA_AXIS, 0, 0).reshape(-1)
        bval = jax.lax.all_to_all(bp[0], DATA_AXIS, 0, 0).reshape(-1)
        bvld = jax.lax.all_to_all(bv, DATA_AXIS, 0, 0).reshape(-1)
        size = 1
        while size < 2 * bk.shape[0]:
            size *= 2
        ht_keys, ht_entry, starts, counts, srows, _ = join_ops._build_kernel(
            bk, bvld, size, bk.shape[0])

        def exchange_chunk(k, v, vd):
            ck, cp, cv, ovf = _pack_buckets(k, [v], vd, n, probe_quota)
            ck = jax.lax.all_to_all(ck, DATA_AXIS, 0, 0).reshape(-1)
            cval = jax.lax.all_to_all(cp[0], DATA_AXIS, 0, 0).reshape(-1)
            cvld = jax.lax.all_to_all(cv, DATA_AXIS, 0, 0).reshape(-1)
            return ck, cval, cvld, ovf

        def probe_chunk(ek, ev, evd):
            entry = join_ops._probe_kernel(ht_keys, counts, ek, evd, size)
            found = entry >= 0
            safe = jnp.maximum(entry, 0)
            joined = jnp.where(found, bval[srows[starts[safe]]], 0)
            return jnp.sum(jnp.where(found, ev * joined, 0))

        pk_c = pkeys.reshape(n_chunks, -1)
        pv_c = pvals.reshape(n_chunks, -1)
        pvd_c = pvalid.reshape(n_chunks, -1)
        # prologue: exchange chunk 0; steady state: exchange i+1 || probe i
        buf = exchange_chunk(pk_c[0], pv_c[0], pvd_c[0])

        def step(carry, xs):
            (ek, ev, evd, povf), (nk, nv, nvd) = carry, xs
            nxt = exchange_chunk(nk, nv, nvd)   # in flight during probe
            partial = probe_chunk(ek, ev, evd)
            return ((*nxt[:3], povf + nxt[3]), partial)

        # feed chunks 1.. plus one all-invalid epilogue chunk
        xs = (jnp.concatenate([pk_c[1:], pk_c[:1]]),
              jnp.concatenate([pv_c[1:], pv_c[:1]]),
              jnp.concatenate([pvd_c[1:],
                               jnp.zeros_like(pvd_c[:1])]))
        carry0 = (buf[0], buf[1], buf[2], buf[3])
        (_, _, _, povf), partials = jax.lax.scan(step, carry0, xs)
        total = jax.lax.psum(jnp.sum(partials), DATA_AXIS)
        ovf = jax.lax.psum(bovf + povf, DATA_AXIS)
        return total, ovf

    spec = P(DATA_AXIS)
    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec,) * 6, out_specs=(P(), P()),
        check_vma=False))


def make_partitioned_join_step(mesh, build_quota: int, probe_quota: int):
    """Distributed hash join: radix-exchange both sides, then local joins.

    Each device owns hash(key) % n partitions of both sides (deterministic
    ownership instead of a shared CAS table); the local join is the
    vectorized open-addressing build/probe from ops.join.
    """
    from .exchange import _pack_buckets

    n = mesh.devices.size

    def local(bkeys, bvals, bvalid, pkeys, pvals, pvalid):
        bk, bp, bv, bovf = _pack_buckets(bkeys, [bvals], bvalid, n, build_quota)
        pk, pp, pv, povf = _pack_buckets(pkeys, [pvals], pvalid, n, probe_quota)
        bk = jax.lax.all_to_all(bk, DATA_AXIS, 0, 0).reshape(-1)
        bval = jax.lax.all_to_all(bp[0], DATA_AXIS, 0, 0).reshape(-1)
        bvld = jax.lax.all_to_all(bv, DATA_AXIS, 0, 0).reshape(-1)
        pk2 = jax.lax.all_to_all(pk, DATA_AXIS, 0, 0).reshape(-1)
        pval = jax.lax.all_to_all(pp[0], DATA_AXIS, 0, 0).reshape(-1)
        pvld = jax.lax.all_to_all(pv, DATA_AXIS, 0, 0).reshape(-1)
        size = 1
        while size < 2 * bk.shape[0]:
            size *= 2
        ht_keys, ht_entry, starts, counts, srows, _ = join_ops._build_kernel(
            bk, bvld, size, bk.shape[0])
        entry = join_ops._probe_kernel(ht_keys, counts, pk2, pvld, size)
        found = entry >= 0
        safe = jnp.maximum(entry, 0)
        joined_bval = jnp.where(found, bval[srows[starts[safe]]], 0)
        # revenue-style result: sum of probe value * build value over matches
        partial = jnp.sum(jnp.where(found, pval * joined_bval, 0))
        total = jax.lax.psum(partial, DATA_AXIS)
        ovf = jax.lax.psum(bovf + povf, DATA_AXIS)
        return total, ovf

    spec = P(DATA_AXIS)
    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(spec,) * 6, out_specs=(P(), P()),
        check_vma=False))
