import jax.numpy as jnp
import numpy as np

from duckdb_cubit.ops import groupby, join, kernels


def test_build_probe_unique_keys():
    rng = np.random.default_rng(10)
    keys = rng.permutation(np.arange(1, 501)).astype(np.int64)
    bs = join.build(jnp.asarray(keys), jnp.ones(500, bool))
    probe_keys = np.array([1, 250, 500, 777, 3], dtype=np.int64)
    rows, found = join.probe_single(bs, jnp.asarray(probe_keys),
                                    jnp.ones(5, bool))
    rows, found = np.asarray(rows), np.asarray(found)
    assert list(found) == [True, True, True, False, True]
    for pk, r, f in zip(probe_keys, rows, found):
        if f:
            assert keys[r] == pk


def test_probe_masked_rows_miss():
    keys = jnp.asarray(np.array([7, 8, 9], dtype=np.int64))
    bs = join.build(keys, jnp.ones(3, bool))
    pv = jnp.asarray(np.array([True, False]))
    rows, found = join.probe_single(
        bs, jnp.asarray(np.array([8, 8], np.int64)), pv)
    assert list(np.asarray(found)) == [True, False]


def test_build_with_padding_rows():
    keys = jnp.asarray(np.array([5, 6, 7, 999, 999], dtype=np.int64))
    valid = jnp.asarray(np.array([True, True, True, False, False]))
    bs = join.build(keys, valid)
    rows, found = join.probe_single(
        bs, jnp.asarray(np.array([999, 6], np.int64)), jnp.ones(2, bool))
    assert list(np.asarray(found)) == [False, True]


def test_expand_matches_duplicates():
    # build side with duplicate keys: key 10 x3, key 20 x1
    keys = jnp.asarray(np.array([10, 20, 10, 10], dtype=np.int64))
    bs = join.build(keys, jnp.ones(4, bool))
    probe_keys = jnp.asarray(np.array([20, 10, 30], dtype=np.int64))
    entry = join.probe(bs, probe_keys, jnp.ones(3, bool))
    op, ob, total = join.expand_matches(
        bs.starts, bs.counts, bs.sorted_rows, entry, jnp.ones(3, bool), 16)
    op, ob, total = np.asarray(op), np.asarray(ob), int(total)
    assert total == 4
    pairs = sorted((int(a), int(b)) for a, b in zip(op[:total], ob[:total]))
    assert pairs == [(0, 1), (1, 0), (1, 2), (1, 3)]


def test_semi_anti():
    keys = jnp.asarray(np.array([1, 2, 3], dtype=np.int64))
    bs = join.build(keys, jnp.ones(3, bool))
    probe = jnp.asarray(np.array([2, 5, 1], dtype=np.int64))
    m = join.semi_mask(bs, probe, jnp.ones(3, bool))
    assert list(np.asarray(m)) == [True, False, True]
    a = join.semi_mask(bs, probe, jnp.ones(3, bool), anti=True)
    assert list(np.asarray(a)) == [False, True, False]


def test_group_by_sort():
    rng = np.random.default_rng(11)
    k1 = rng.integers(0, 5, size=300).astype(np.int64)
    k2 = rng.integers(0, 3, size=300).astype(np.int64)
    valid = rng.random(300) < 0.8
    gk = groupby.group_by_sort((jnp.asarray(k1), jnp.asarray(k2)),
                               jnp.asarray(valid), 300)
    want_groups = {(a, b) for a, b, v in zip(k1, k2, valid) if v}
    assert int(gk.num_groups) == len(want_groups)
    # group ids must be consistent: same (k1,k2) -> same id
    gids = np.asarray(gk.group_ids)
    seen = {}
    for a, b, v, g in zip(k1, k2, valid, gids):
        if not v:
            continue
        key = (a, b)
        assert seen.setdefault(key, g) == g
    # aggregate through the ids and cross-check one group
    vals = rng.integers(0, 1000, size=300, dtype=np.int64)
    hi, lo = kernels.group_sum_exact(
        gk.group_ids, jnp.asarray(vals), gk.valid, 300)
    cnt = kernels.group_count(gk.group_ids, gk.valid, 300)
    some_key = next(iter(want_groups))
    sel = (k1 == some_key[0]) & (k2 == some_key[1]) & valid
    gid = seen[some_key]
    assert kernels.combine_hi_lo(hi[gid], lo[gid]) == int(vals[sel].sum())
    assert int(np.asarray(cnt)[gid]) == int(sel.sum())
