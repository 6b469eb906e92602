import jax.numpy as jnp
import numpy as np

from duckdb_cubit.index.cubit import CubitIndex
from duckdb_cubit.ops import bitmap as bm


def _mk(codes, n_bins, capacity=None, num_rows=None):
    capacity = capacity or len(codes)
    num_rows = num_rows if num_rows is not None else len(codes)
    return CubitIndex.build("t", np.asarray(codes, np.int32), capacity,
                            num_rows, n_bins)


def test_build_eq_count():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 11, size=1000).astype(np.int32)
    idx = _mk(codes, 11)
    for v in (0, 5, 10):
        words = idx.query_eq(v)
        assert idx.count(words) == int((codes == v).sum())


def test_range_and_expand():
    rng = np.random.default_rng(3)
    n = 2048
    codes = rng.integers(0, 50, size=n).astype(np.int32)
    idx = _mk(codes, 50)
    res = idx.query_range(5, 23)
    assert res.exact
    mask = bm.expand(res.words, n)
    want = (codes >= 5) & (codes <= 23)
    np.testing.assert_array_equal(np.asarray(mask), want)


def test_and_across_columns():
    rng = np.random.default_rng(4)
    n = 4096
    a = rng.integers(0, 11, size=n).astype(np.int32)
    b = rng.integers(0, 50, size=n).astype(np.int32)
    ia, ib = _mk(a, 11), _mk(b, 50)
    words = ia.query_range(5, 7).words & ib.query_range(None, 23).words
    want = ((a >= 5) & (a <= 7)) & (b <= 23)
    assert int(bm.popcount(words)) == int(want.sum())
    np.testing.assert_array_equal(np.asarray(bm.expand(words, n)), want)


def test_padding_rows_excluded():
    codes = np.array([1, 1, 1, 0], dtype=np.int32)
    idx = CubitIndex.build("t", codes, capacity=64, num_rows=4, n_bins=2)
    assert idx.count(idx.query_eq(1)) == 3
    assert idx.count(idx.query_eq(0)) == 1


def test_binned_range_exact_and_refine():
    vals = np.arange(100, dtype=np.int64)  # values 0..99
    edges = np.arange(0, 101, 10)  # bins [0,10) [10,20)...
    idx = CubitIndex.build("t", vals, 128, 100, 10, bin_edges=edges[:-1])
    res = idx.query_range(20, None, hi_inclusive=True)
    assert res.exact  # 20 is an edge
    assert idx.count(res.words) == 80
    res2 = idx.query_range(25, 74)
    assert not res2.exact  # mid-bin endpoints
    # candidate superset covers bins [20,80)
    assert idx.count(res2.words) == 60


def test_update_merge_mvcc():
    codes = np.array([0, 1, 2, 1, 0], dtype=np.int32)
    idx = _mk(codes, 3)
    old_words = idx.words
    idx.update(0, 0, 2)
    idx.delete(3, 1)
    idx.insert(5, 1)  # row 5 was padding
    assert idx.pending_updates == 3
    epoch = idx.merge()
    assert epoch == 1 and idx.pending_updates == 0
    assert idx.count(idx.query_eq(0)) == 1
    assert idx.count(idx.query_eq(1)) == 2  # lost row 3, gained row 5
    assert idx.count(idx.query_eq(2)) == 2
    # old epoch snapshot unchanged (functional MVCC)
    assert int(bm.popcount(old_words[0])) == 2


def test_pack_mask_roundtrip():
    rng = np.random.default_rng(5)
    mask = rng.random(1000) < 0.3
    words = bm.pack_mask(jnp.asarray(mask), bm.num_words(1000))
    back = bm.expand(words, 1000)
    np.testing.assert_array_equal(np.asarray(back), mask)
