"""Scalar/statistical function + SQL window tests.

Covers the round-3 function-breadth requirements (reference
src/core_functions/scalar/string/, .../aggregate/distributive/stddev.cpp,
physical_window.cpp:822): string transforms on dictionary columns, date
parts, stddev/variance via exact sum-of-squares, and OVER(...) windows
through the full SQL path.
"""

import numpy as np
import pytest

from duckdb_cubit.api import Connection
from duckdb_cubit.types import DATE


@pytest.fixture()
def conn():
    c = Connection()
    c.register_numpy("t", {
        "s": np.array(["  Foo ", "bar", "BAZ", "bar"], dtype="U8"),
        "d": np.array([9496, 9527, 9558, 9586], np.int64),  # 1996-01..04
        "v": np.array([2.0, 4.0, 4.0, 6.0], np.float64),
        "g": np.array([1, 1, 2, 2], np.int64),
        "o": np.array([10, 20, 5, 1], np.int64),
        "x": np.array([5, 7, 10, 20], np.int64),
    }, schema={"d": DATE})
    return c


def test_string_functions(conn):
    rows = conn.sql("SELECT upper(s) AS u, lower(s) AS lo, trim(s) AS tr, "
                    "length(s) AS l, s || '_x' AS cx FROM t").strings()
    assert rows[0] == ["  FOO ", "  foo ", "Foo", "6", "  Foo _x"]
    assert rows[1] == ["BAR", "bar", "bar", "3", "bar_x"]
    assert rows[2] == ["BAZ", "baz", "BAZ", "3", "BAZ_x"]


def test_concat_col_col(conn):
    rows = conn.sql("SELECT trim(s) || trim(s) AS ss FROM t").strings()
    assert [r[0] for r in rows] == ["FooFoo", "barbar", "BAZBAZ", "barbar"]


def test_date_parts(conn):
    rows = conn.sql("SELECT extract(month FROM d) AS m, "
                    "date_part('day', d) AS dd, "
                    "extract(year FROM d) AS y FROM t").strings()
    assert [r[0] for r in rows] == ["1", "2", "3", "3"]
    assert rows[0] == ["1", "1", "1996"]
    assert rows[3] == ["3", "31", "1996"]


def test_stddev_variance(conn):
    rows = conn.sql("SELECT stddev(v) AS sd, var_pop(v) AS vp, "
                    "var_samp(v) AS vs FROM t").strings()
    sd, vp, vs = map(float, rows[0])
    assert abs(vs - 8.0 / 3) < 1e-9          # var of [2,4,4,6], ddof=1
    assert abs(vp - 2.0) < 1e-9
    assert abs(sd - (8.0 / 3) ** 0.5) < 1e-9


def test_stddev_grouped(conn):
    rows = conn.sql("SELECT g, round(stddev(v), 3) AS sd FROM t "
                    "GROUP BY g ORDER BY g").strings()
    assert rows == [["1", "1.414"], ["2", "1.414"]]


def test_math_functions(conn):
    rows = conn.sql("SELECT sqrt(v) AS q, abs(0 - v) AS a, floor(v / 4) AS f,"
                    " ceil(v / 4) AS c FROM t").strings()
    assert rows[0] == ["1.4142135623730951", "2.0", "0.0", "1.0"]


def test_window_sql_full(conn):
    rows = conn.sql(
        "SELECT g, o, x, "
        "row_number() OVER (PARTITION BY g ORDER BY o) AS rn, "
        "rank() OVER (PARTITION BY g ORDER BY o) AS rk, "
        "dense_rank() OVER (PARTITION BY g ORDER BY o) AS dr, "
        "sum(x) OVER (PARTITION BY g ORDER BY o) AS rs, "
        "sum(x) OVER (PARTITION BY g) AS tot, "
        "lag(x) OVER (PARTITION BY g ORDER BY o) AS lg, "
        "lead(x, 1, -1) OVER (PARTITION BY g ORDER BY o) AS ld, "
        "min(x) OVER (PARTITION BY g ORDER BY o) AS mn, "
        "avg(x) OVER (PARTITION BY g) AS av, "
        "count(*) OVER (PARTITION BY g) AS cn, "
        "first_value(x) OVER (PARTITION BY g ORDER BY o) AS fv "
        "FROM t ORDER BY g, o").strings()
    # g=1 rows: (o=10,x=5), (o=20,x=7); g=2 rows: (o=1,x=20), (o=5,x=10)
    assert rows[0] == ["1", "10", "5", "1", "1", "1", "5", "12", "NULL",
                       "7", "5", "6.0", "2", "5"]
    assert rows[1] == ["1", "20", "7", "2", "2", "2", "12", "12", "5",
                       "-1", "5", "6.0", "2", "5"]
    assert rows[2] == ["2", "1", "20", "1", "1", "1", "20", "30", "NULL",
                       "10", "20", "15.0", "2", "20"]
    assert rows[3] == ["2", "5", "10", "2", "2", "2", "30", "30", "20",
                       "-1", "10", "15.0", "2", "20"]


def test_window_range_vs_rows_frames(conn):
    # ties on the order key: RANGE (default) includes peers, ROWS does not
    c = Connection()
    c.register_numpy("u", {
        "o": np.array([1, 2, 2, 3], np.int64),
        "x": np.array([1, 10, 100, 1000], np.int64),
    })
    rows = c.sql(
        "SELECT o, x, sum(x) OVER (ORDER BY o) AS rng, "
        "sum(x) OVER (ORDER BY o ROWS BETWEEN UNBOUNDED PRECEDING AND "
        "CURRENT ROW) AS rws FROM u ORDER BY o, x").strings()
    assert [r[2] for r in rows] == ["1", "111", "111", "1111"]
    assert [r[3] for r in rows] == ["1", "11", "111", "1111"]


def test_window_over_expression_keys(conn):
    rows = conn.sql(
        "SELECT x, row_number() OVER (PARTITION BY g + 0 ORDER BY x DESC) "
        "AS rn FROM t ORDER BY x").strings()
    assert rows == [["5", "2"], ["7", "1"], ["10", "2"], ["20", "1"]]


def test_window_with_aggregate_rejected(conn):
    with pytest.raises(Exception, match="window"):
        conn.sql("SELECT g, sum(x) AS s, row_number() OVER (ORDER BY g) "
                 "AS rn FROM t GROUP BY g")


def test_window_in_subquery_over_aggregate(conn):
    rows = conn.sql(
        "SELECT g, s, rank() OVER (ORDER BY s DESC) AS rk FROM "
        "(SELECT g, sum(x) AS s FROM t GROUP BY g) AS agg "
        "ORDER BY g").strings()
    assert rows == [["1", "12", "2"], ["2", "30", "1"]]
