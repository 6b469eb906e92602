import jax.numpy as jnp
import numpy as np

from duckdb_cubit.ops import window as W


def _ref_row_number(part, order):
    out = np.zeros(len(part), np.int64)
    for p in np.unique(part):
        idx = np.where(part == p)[0]
        perm = idx[np.argsort(order[idx], kind="stable")]
        out[perm] = np.arange(1, len(perm) + 1)
    return out


def test_row_number():
    rng = np.random.default_rng(0)
    part = rng.integers(0, 5, 200).astype(np.int64)
    order = rng.integers(0, 50, 200).astype(np.int64)
    valid = jnp.ones(200, bool)
    got = np.asarray(W.row_number((jnp.asarray(part),), (jnp.asarray(order),),
                                  valid))
    # same partition+order value rows may tie-break differently; compare
    # per-(part, order) sorted multisets of row numbers
    want = _ref_row_number(part, order)
    for p in np.unique(part):
        sel = part == p
        assert sorted(got[sel]) == sorted(want[sel])


def test_rank_ties():
    part = np.zeros(6, np.int64)
    order = np.array([10, 10, 20, 20, 20, 30], np.int64)
    got = np.asarray(W.rank((jnp.asarray(part),), (jnp.asarray(order),),
                            jnp.ones(6, bool)))
    assert sorted(got) == [1, 1, 3, 3, 3, 6]


def test_running_sum():
    part = np.array([0, 0, 0, 1, 1], np.int64)
    order = np.array([1, 2, 3, 1, 2], np.int64)
    vals = np.array([5, 7, 1, 10, 20], np.int64)
    got = np.asarray(W.running_sum(
        (jnp.asarray(part),), (jnp.asarray(order),), jnp.asarray(vals),
        jnp.ones(5, bool)))
    np.testing.assert_array_equal(got, [5, 12, 13, 10, 30])


def test_partition_total():
    part = np.array([0, 1, 0, 1, 0], np.int64)
    vals = np.array([1, 2, 3, 4, 5], np.int64)
    got = np.asarray(W.partition_total((jnp.asarray(part),),
                                       jnp.asarray(vals), jnp.ones(5, bool)))
    np.testing.assert_array_equal(got, [9, 6, 9, 6, 9])


# ------------------------- sliding frames (VERDICT r4 item 5) ----------
def _brute_frame(g, k, v, lo, hi, mode, agg):
    """Numpy oracle: per row, aggregate v over the frame within its
    partition (rows ordered by k)."""
    import numpy as np
    n = len(v)
    out = [None] * n
    order = np.lexsort((k, g))
    for gi in set(g.tolist()):
        idx = [i for i in order if g[i] == gi]
        for p, i in enumerate(idx):
            if mode == "rows":
                a = 0 if lo is None else max(0, p + lo)
                b = len(idx) - 1 if hi is None else min(len(idx) - 1, p + hi)
                sel = idx[a:b + 1] if b >= a else []
            else:
                klo = -10**18 if lo is None else k[i] + lo
                khi = 10**18 if hi is None else k[i] + hi
                sel = [j for j in idx if klo <= k[j] <= khi]
            vals = [v[j] for j in sel]
            if agg == "sum":
                out[i] = sum(vals) if vals else None
            elif agg == "min":
                out[i] = min(vals) if vals else None
            elif agg == "max":
                out[i] = max(vals) if vals else None
            elif agg == "count":
                out[i] = len(vals)
    return out


def _frame_case(mode, lo, hi, agg, seed=0, n=500):
    import numpy as np
    from duckdb_cubit.api import Connection

    rng = np.random.default_rng(seed)
    g = rng.integers(0, 7, n)
    k = rng.integers(0, 50, n)
    v = rng.integers(-100, 100, n)
    conn = Connection()
    conn.register_numpy("t", {"g": g, "k": k, "v": v,
                              "rid": np.arange(n, dtype=np.int64)})
    def b(x, word):
        if x is None:
            return f"UNBOUNDED {word}"
        if x == 0:
            return "CURRENT ROW"
        return (f"{-x} PRECEDING" if x < 0 else f"{x} FOLLOWING")
    sql = (f"SELECT rid, {agg}(v) OVER (PARTITION BY g ORDER BY k "
           f"{mode.upper()} BETWEEN {b(lo, 'PRECEDING')} AND "
           f"{b(hi, 'FOLLOWING')}) AS w FROM t ORDER BY rid")
    rows = conn.sql(sql).strings()
    want = _brute_frame(g, k, v, lo, hi, mode, agg)
    got = [None if r[1] == "NULL" else int(r[1]) for r in rows]
    assert got == want, (mode, lo, hi, agg)


def test_rows_frame_sum():
    _frame_case("rows", -2, 3, "sum")


def test_rows_frame_min_max():
    _frame_case("rows", -4, 1, "min", seed=1)
    _frame_case("rows", -1, 4, "max", seed=2)


def test_rows_frame_following_only():
    # frame entirely ahead of the current row (can be empty -> NULL)
    _frame_case("rows", 1, 3, "sum", seed=3)
    _frame_case("rows", 1, 2, "min", seed=4)


def test_rows_frame_unbounded_following():
    _frame_case("rows", -1, None, "sum", seed=5)


def test_range_frame_sum():
    _frame_case("range", -5, 5, "sum", seed=6)


def test_range_frame_min():
    _frame_case("range", -10, 0, "min", seed=7)


def test_range_frame_count():
    _frame_case("range", 0, 8, "count", seed=8)


def test_rows_frame_count():
    _frame_case("rows", -3, 0, "count", seed=9)
