"""Regression tests for the round-3 advisor findings (ADVICE.md r3).

Float order/partition/group/join keys must be exact (not int64-truncated),
stddev of tiny groups is NULL (not NaN), no-ORDER-BY windows treat the whole
partition as one peer group, and last_value under an explicit ROWS frame
returns the current row.
"""

import numpy as np
import pytest

from duckdb_cubit.api import Connection


@pytest.fixture()
def conn():
    c = Connection()
    c.register_numpy("t", {
        "y": np.array([2.5, 2.4, 1.1, 2.0], np.float64),
        "g": np.array([1, 1, 2, 2], np.int64),
        "v": np.array([10, 20, 30, 40], np.int64),
    })
    return c


def test_window_float_order_key(conn):
    # ADVICE r3 (high): int64 cast made row_number() OVER (ORDER BY y) on
    # [2.5, 2.4, 1.1] return [2, 3, 1]
    rows = conn.sql("SELECT y, row_number() OVER (ORDER BY y) AS r "
                    "FROM t ORDER BY y").strings()
    assert [r[1] for r in rows] == ["1", "2", "3", "4"]
    assert [r[0] for r in rows] == ["1.1", "2.0", "2.4", "2.5"]


def test_window_float_order_key_desc(conn):
    rows = conn.sql("SELECT y, row_number() OVER (ORDER BY y DESC) AS r "
                    "FROM t ORDER BY y").strings()
    assert [r[1] for r in rows] == ["4", "3", "2", "1"]


def test_order_by_negative_floats():
    c = Connection()
    c.register_numpy("t", {"y": np.array([-2.5, 3.0, -0.5, 0.0, -2.4])})
    rows = c.sql("SELECT y, rank() OVER (ORDER BY y) AS r FROM t "
                 "ORDER BY y").strings()
    assert [r[1] for r in rows] == ["1", "2", "3", "4", "5"]
    assert rows[0][0] == "-2.5" and rows[1][0] == "-2.4"


def test_group_by_float_key(conn):
    # grouping by DOUBLE must not conflate 2.5/2.4/2.0 (int64 cast did)
    rows = conn.sql("SELECT y, count(*) AS c FROM t GROUP BY y "
                    "ORDER BY y").strings()
    assert len(rows) == 4
    assert all(r[1] == "1" for r in rows)


def test_min_max_double(conn):
    rows = conn.sql("SELECT g, min(y) AS lo, max(y) AS hi FROM t "
                    "GROUP BY g ORDER BY g").strings()
    assert rows[0][1:] == ["2.4", "2.5"]
    assert rows[1][1:] == ["1.1", "2.0"]


def test_ungrouped_min_max_double(conn):
    rows = conn.sql("SELECT min(y) AS lo, max(y) AS hi FROM t").strings()
    assert rows[0] == ["1.1", "2.5"]


def test_join_on_double_key_including_two():
    # a double key of exactly 2.0 encodes to the old 2**62 sentinel; the
    # build/probe kernels must not treat it as an empty slot
    c = Connection()
    c.register_numpy("a", {"k": np.array([2.0, 1.5, 7.25]),
                           "va": np.array([1, 2, 3], np.int64)})
    c.register_numpy("b", {"k": np.array([2.0, 7.25, 9.0]),
                           "vb": np.array([10, 20, 30], np.int64)})
    rows = c.sql("SELECT a.va, b.vb FROM a, b WHERE a.k = b.k "
                 "ORDER BY a.va").strings()
    assert rows == [["1", "10"], ["3", "20"]]


def test_range_join_double_condition():
    c = Connection()
    c.register_numpy("a", {"x": np.array([1.5, 2.05, 3.5]),
                           "ia": np.array([0, 1, 2], np.int64)})
    c.register_numpy("b", {"y": np.array([2.0, 2.1]),
                           "ib": np.array([0, 1], np.int64)})
    rows = c.sql("SELECT ia, ib FROM a, b WHERE a.x < b.y "
                 "ORDER BY ia, ib").strings()
    # 1.5 < 2.0, 1.5 < 2.1, 2.05 < 2.1 (int64 truncation would say 2.05<2.0
    # is comparable to 2<2 = false AND 3.5 < 2.1 via 3<2 false — but also
    # 2.05 vs 2.1 both truncate to 2 -> missed)
    assert rows == [["0", "0"], ["0", "1"], ["1", "1"]]


def test_stddev_single_row_is_null():
    c = Connection()
    c.register_numpy("t", {"y": np.array([4.2]),
                           "g": np.array([1], np.int64)})
    rows = c.sql("SELECT stddev(y) AS s, var_samp(y) AS v FROM t").strings()
    assert rows[0] == ["NULL", "NULL"]


def test_stddev_groups(conn):
    rows = conn.sql("SELECT g, stddev(v) AS s FROM t GROUP BY g "
                    "ORDER BY g").strings()
    # sample stddev of {10,20} and {30,40} is sqrt(50) = 7.0710678...
    assert rows[0][1].startswith("7.07106781")
    assert rows[1][1].startswith("7.07106781")


def test_var_pop_zero_rows_vs_one():
    c = Connection()
    c.register_numpy("t", {"y": np.array([4.2])})
    rows = c.sql("SELECT var_pop(y) AS v FROM t").strings()
    assert rows[0] == ["0.0"]


def test_rank_no_order_by(conn):
    # ADVICE r3: rank()/dense_rank() with PARTITION BY only -> every row 1
    rows = conn.sql("SELECT g, rank() OVER (PARTITION BY g) AS r, "
                    "dense_rank() OVER (PARTITION BY g) AS d FROM t "
                    "ORDER BY g, r").strings()
    assert all(r[1] == "1" and r[2] == "1" for r in rows)


def test_last_value_rows_frame(conn):
    # explicit ROWS ... CURRENT ROW: last_value == current row even on ties
    c = Connection()
    c.register_numpy("t", {"o": np.array([1, 1, 2], np.int64),
                           "v": np.array([10, 20, 30], np.int64)})
    rows = c.sql(
        "SELECT v, last_value(v) OVER (ORDER BY o ROWS BETWEEN UNBOUNDED "
        "PRECEDING AND CURRENT ROW) AS lv FROM t ORDER BY v").strings()
    assert [r[0] for r in rows] == [r[1] for r in rows]


def test_dense_domain_grouping_by_year():
    """Small int domains propagate through extract(year) so the aggregate
    takes the dense perfect-hash path — and results stay exact."""
    import numpy as np
    from duckdb_cubit.types import DATE

    c = Connection()
    rng = np.random.default_rng(0)
    days = rng.integers(8400, 10650, 50_000)        # ~1993-1999
    c.register_numpy("o", {"d": days, "v": rng.integers(0, 100, 50_000)},
                     schema={"d": DATE})
    rows = c.sql("SELECT y, count(*) AS n, sum(v) AS s FROM "
                 "(SELECT extract(year FROM d) AS y, v FROM o) AS t "
                 "GROUP BY y ORDER BY y").strings()
    import datetime
    years = np.array([(datetime.date(1970, 1, 1)
                       + datetime.timedelta(days=int(d))).year
                      for d in days])
    rng2 = np.random.default_rng(0)
    _ = rng2.integers(8400, 10650, 50_000)   # replay to reach v's draws
    vals = rng2.integers(0, 100, 50_000)
    got_years = [int(r[0]) for r in rows]
    assert got_years == sorted(set(years.tolist()))
    for r in rows:
        y = int(r[0])
        sel = years == y
        assert int(r[1]) == int(sel.sum())
        assert int(r[2]) == int(vals[sel].sum())


def test_stale_stats_after_dml():
    """Zone maps / domains refresh on DML: the optimizer must not prune
    with pre-mutation statistics (silent wrong results before round 4)."""
    import numpy as np

    c = Connection()
    c.register_numpy("t", {"v": np.array([1, 2, 3], np.int64)})
    assert c.sql("SELECT count(*) AS c FROM t WHERE v > 100").strings() \
        == [["0"]]
    c.sql("INSERT INTO t VALUES (200)")
    assert c.sql("SELECT count(*) AS c FROM t WHERE v > 100").strings() \
        == [["1"]]
    c.sql("UPDATE t SET v = 500 WHERE v = 2")
    assert c.sql("SELECT count(*) AS c FROM t WHERE v > 100").strings() \
        == [["2"]]
    c.sql("DELETE FROM t WHERE v = 500")
    assert c.sql("SELECT count(*) AS c FROM t WHERE v > 100").strings() \
        == [["1"]]


def test_concat_large_dict_observed_pairs():
    # cross-product dictionary would be 300*300=90000 entries (under the
    # budget) — shrink the budget to force the observed-pairs path
    from duckdb_cubit.ops.expressions import Concat
    c = Connection()
    strs = np.array([f"s{i:03d}" for i in range(300)], dtype="U8")
    rng = np.random.default_rng(0)
    c.register_numpy("t", {"a": strs[rng.integers(0, 300, 64)],
                           "b": strs[rng.integers(0, 300, 64)]})
    old = Concat.MAX_DICT
    Concat.MAX_DICT = 1000
    try:
        # eager mode (unjitted) so codes are concrete
        rows = c.sql("SELECT a || b AS ab FROM t", profile=True).strings()
    finally:
        Concat.MAX_DICT = old
    want = [r + s for r, s in zip(
        strs[rng.integers(0, 300, 0)], [])]  # recompute below instead
    got = [r[0] for r in rows]
    rng = np.random.default_rng(0)
    a = strs[rng.integers(0, 300, 64)]
    b = strs[rng.integers(0, 300, 64)]
    assert got == [x + y for x, y in zip(a, b)]


def test_greatest_least_ignore_nulls():
    # ADVICE r4 (low): Postgres semantics — NULL arguments are ignored
    from duckdb_cubit.api import Connection
    import numpy as np

    conn = Connection()
    conn.sql("CREATE TABLE gn (a INTEGER, b INTEGER)")
    # base storage is NULL-free; nullif() manufactures NULLs (0 = NULL)
    conn.sql("INSERT INTO gn VALUES (1, 0), (0, 5), (0, 0), (3, 2)")
    rows = conn.sql(
        "SELECT greatest(nullif(a, 0), nullif(b, 0)) AS g, "
        "least(nullif(a, 0), nullif(b, 0)) AS l FROM gn").strings()
    assert rows == [["1", "1"], ["5", "5"], ["NULL", "NULL"], ["3", "2"]]
    # bare NULL literal in expressions (parser + binder)
    rows = conn.sql("SELECT greatest(a, NULL) AS g FROM gn "
                    "WHERE a = 3").strings()
    assert rows == [["3"]]


def test_desc_sort_extreme_int64():
    # VERDICT r4 weak #6: DESC used arithmetic negation (-INT64_MIN UB) and
    # in-band sentinels colliding with keys >= 2^62
    from duckdb_cubit.api import Connection
    import numpy as np

    vals = np.array([-(2**63), 2**63 - 1, 0, 2**62, -(2**62), 7],
                    dtype=np.int64)
    conn = Connection()
    conn.register_numpy("ext", {"v": vals})
    rows = conn.sql("SELECT v FROM ext ORDER BY v DESC").strings()
    want = [str(v) for v in sorted(vals.tolist(), reverse=True)]
    assert [r[0] for r in rows] == want
    rows = conn.sql("SELECT v FROM ext ORDER BY v").strings()
    assert [r[0] for r in rows] == [str(v) for v in sorted(vals.tolist())]
