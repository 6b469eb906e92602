import jax.numpy as jnp
import numpy as np

from duckdb_cubit.ops import kernels


def test_masked_sum_exact_large_values():
    rng = np.random.default_rng(0)
    vals = rng.integers(-(10**17), 10**17, size=5000, dtype=np.int64)
    mask = rng.random(5000) < 0.7
    hi, lo = kernels.masked_sum_exact(jnp.asarray(vals), jnp.asarray(mask))
    got = kernels.combine_hi_lo(hi, lo)
    want = int(sum(int(v) for v, m in zip(vals, mask) if m))
    assert got == want


def test_group_sum_exact_matches_numpy():
    rng = np.random.default_rng(1)
    n, g = 10000, 17
    codes = rng.integers(0, g, size=n).astype(np.int32)
    vals = rng.integers(-(10**12), 10**12, size=n, dtype=np.int64)
    mask = rng.random(n) < 0.9
    ghi, glo = kernels.group_sum_exact(
        jnp.asarray(codes), jnp.asarray(vals), jnp.asarray(mask), g)
    for gi in range(g):
        want = int(vals[(codes == gi) & mask].sum())
        assert kernels.combine_hi_lo(ghi[gi], glo[gi]) == want


def test_group_count_min_max():
    codes = jnp.asarray(np.array([0, 1, 1, 2, 2, 2], dtype=np.int32))
    vals = jnp.asarray(np.array([5, 3, 9, -2, 7, 1], dtype=np.int64))
    mask = jnp.asarray(np.array([True, True, True, True, False, True]))
    cnt = kernels.group_count(codes, mask, 3)
    assert list(np.asarray(cnt)) == [1, 2, 2]
    mn = kernels.group_min(codes, vals, mask, 3, jnp.int64(2**62))
    mx = kernels.group_max(codes, vals, mask, 3, jnp.int64(-(2**62)))
    assert list(np.asarray(mn)) == [5, 3, -2]
    assert list(np.asarray(mx)) == [5, 9, 1]


def test_mask_to_indices():
    mask = jnp.asarray(np.array([False, True, True, False, True]))
    idx, count = kernels.mask_to_indices(mask, 8)
    assert int(count) == 3
    assert list(np.asarray(idx)[:3]) == [1, 2, 4]
    assert all(np.asarray(idx)[3:] == 5)


def test_hash64_mixes():
    keys = jnp.arange(1024, dtype=jnp.int64)
    h = kernels.hash64(keys)
    low = np.asarray(h & jnp.uint64(255))
    # every low byte bucket should be hit at least once for sequential keys
    assert len(np.unique(low)) > 200
