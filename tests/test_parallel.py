import jax
import jax.numpy as jnp
import numpy as np

from duckdb_cubit.parallel import distributed, exchange, mesh as M


def test_radix_exchange_routes_and_conserves():
    m = M.make_mesh(8)
    rng = np.random.default_rng(0)
    keys = jnp.asarray(rng.integers(1, 10**6, size=800).astype(np.int64))
    vals = jnp.asarray(rng.integers(0, 1000, size=800).astype(np.int64))
    fn = exchange.make_radix_exchange(m, quota=40, n_payload=1)
    k2, v2, ovf, p2 = fn(M.shard_rows(keys, m),
                         M.shard_rows(jnp.ones(800, bool), m),
                         M.shard_rows(vals, m))
    assert int(ovf) == 0
    k2n, v2n, p2n = np.asarray(k2), np.asarray(v2), np.asarray(p2)
    per_dev = k2n.shape[0] // 8
    for d in range(8):
        live = k2n[d * per_dev : (d + 1) * per_dev][v2n[d * per_dev : (d + 1) * per_dev]]
        dest = np.asarray(exchange.partition_ids(jnp.asarray(live), 8))
        assert (dest == d).all()
    # key multiset conserved, payload stays attached
    np.testing.assert_array_equal(np.sort(k2n[v2n]), np.sort(np.asarray(keys)))
    pairs_in = set(zip(np.asarray(keys).tolist(), np.asarray(vals).tolist()))
    pairs_out = set(zip(k2n[v2n].tolist(), p2n[v2n].tolist()))
    assert pairs_in == pairs_out


def test_distributed_q6_matches_local():
    m = M.make_mesh(8)
    rng = np.random.default_rng(1)
    n_rows, n_words = 2048, 64
    words = [rng.integers(0, 2**32, size=n_words, dtype=np.uint32)
             for _ in range(3)]
    eprice = rng.integers(90000, 10**7, size=n_rows).astype(np.int64)
    disc = rng.integers(0, 11, size=n_rows).astype(np.int64)
    fn = distributed.make_q6_step(m)
    hi, lo = fn(*[M.shard_rows(jnp.asarray(w), m) for w in words],
                M.shard_rows(jnp.asarray(eprice), m),
                M.shard_rows(jnp.asarray(disc), m),
                M.shard_rows(jnp.ones(n_rows, bool), m))
    got = (int(hi) << 32) + int(lo)
    wmask = words[0] & words[1] & words[2]
    bits = np.unpackbits(wmask.view(np.uint8), bitorder="little")[:n_rows]
    want = int((eprice * disc)[bits.astype(bool)].sum())
    assert got == want


def test_distributed_grouped_agg_matches_local():
    m = M.make_mesh(8)
    rng = np.random.default_rng(2)
    n = 4096
    codes = rng.integers(0, 8, size=n).astype(np.int32)
    vals = rng.integers(0, 10**9, size=n).astype(np.int64)
    fn = distributed.make_grouped_agg_step(m, num_groups=8)
    ghi, glo, gcnt = fn(M.shard_rows(jnp.asarray(codes), m),
                        M.shard_rows(jnp.asarray(vals), m),
                        M.shard_rows(jnp.ones(n, bool), m))
    for g in range(8):
        want = int(vals[codes == g].sum())
        got = (int(ghi[g]) << 32) + int(glo[g])
        assert got == want
        assert int(gcnt[g]) == int((codes == g).sum())


def test_distributed_join_matches_local():
    m = M.make_mesh(8)
    rng = np.random.default_rng(3)
    n = 1024
    bkeys = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
    bvals = rng.integers(1, 100, size=n).astype(np.int64)
    pkeys = rng.integers(1, n + 1, size=n).astype(np.int64)
    pvals = rng.integers(1, 100, size=n).astype(np.int64)
    fn = distributed.make_partitioned_join_step(m, n // 8, n // 8)
    total, ovf = fn(M.shard_rows(jnp.asarray(bkeys), m),
                    M.shard_rows(jnp.asarray(bvals), m),
                    M.shard_rows(jnp.ones(n, bool), m),
                    M.shard_rows(jnp.asarray(pkeys), m),
                    M.shard_rows(jnp.asarray(pvals), m),
                    M.shard_rows(jnp.ones(n, bool), m))
    assert int(ovf) == 0
    lookup = {k: v for k, v in zip(bkeys, bvals)}
    want = int(sum(pv * lookup[pk] for pk, pv in zip(pkeys, pvals)))
    assert int(total) == want


def test_exchange_requota_on_90pct_skew():
    """90%-one-key build side: the initial quota overflows, the host doubles
    it and re-runs (analog of SetRepartitionRadixBits, VERDICT item 8)."""
    m = M.make_mesh(8)
    rng = np.random.default_rng(4)
    n = 4096
    keys = np.full(n, 7, dtype=np.int64)          # 90% one hot key
    cold = rng.integers(100, 10**6, size=n // 10).astype(np.int64)
    keys[: n // 10] = cold
    rng.shuffle(keys)
    vals = rng.integers(0, 1000, size=n).astype(np.int64)
    k2, v2, (p2,), quota, rounds = exchange.exchange_with_requota(
        m, M.shard_rows(jnp.asarray(keys), m),
        M.shard_rows(jnp.ones(n, bool), m),
        [M.shard_rows(jnp.asarray(vals), m)])
    assert rounds > 1                 # the skew actually forced a requota
    start = exchange.default_quota(n // 8, 8)
    assert quota == start * 2 ** (rounds - 1)
    k2n, v2n, p2n = np.asarray(k2), np.asarray(v2), np.asarray(p2)
    np.testing.assert_array_equal(np.sort(k2n[v2n]), np.sort(keys))
    assert (sorted(zip(k2n[v2n].tolist(), p2n[v2n].tolist()))
            == sorted(zip(keys.tolist(), vals.tolist())))


def test_requota_uniform_keys_single_round():
    m = M.make_mesh(8)
    rng = np.random.default_rng(5)
    n = 4096
    keys = jnp.asarray(rng.integers(1, 10**9, size=n).astype(np.int64))
    k2, v2, _, quota, rounds = exchange.exchange_with_requota(
        m, M.shard_rows(keys, m), M.shard_rows(jnp.ones(n, bool), m), [])
    assert rounds == 1
    np.testing.assert_array_equal(np.sort(np.asarray(k2)[np.asarray(v2)]),
                                  np.sort(np.asarray(keys)))


def test_pipelined_join_matches_unpipelined():
    """Double-buffered (chunked, overlapped-exchange) join == one-shot join."""
    m = M.make_mesh(8)
    rng = np.random.default_rng(6)
    n = 2048
    bkeys = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
    bvals = rng.integers(1, 100, size=n).astype(np.int64)
    pkeys = rng.integers(1, n + 1, size=n).astype(np.int64)
    pvals = rng.integers(1, 100, size=n).astype(np.int64)
    args = (M.shard_rows(jnp.asarray(bkeys), m),
            M.shard_rows(jnp.asarray(bvals), m),
            M.shard_rows(jnp.ones(n, bool), m),
            M.shard_rows(jnp.asarray(pkeys), m),
            M.shard_rows(jnp.asarray(pvals), m),
            M.shard_rows(jnp.ones(n, bool), m))
    ref_fn = distributed.make_partitioned_join_step(m, n // 8, n // 8)
    pipe_fn = distributed.make_pipelined_join_step(m, n // 8, n // 8,
                                                   n_chunks=4)
    want, ovf_a = ref_fn(*args)
    got, ovf_b = pipe_fn(*args)
    assert int(ovf_a) == 0 and int(ovf_b) == 0
    assert int(got) == int(want)
    lookup = {k: v for k, v in zip(bkeys, bvals)}
    assert int(got) == int(sum(pv * lookup[pk]
                               for pk, pv in zip(pkeys, pvals)))
