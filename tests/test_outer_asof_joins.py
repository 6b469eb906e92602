"""RIGHT/FULL OUTER and ASOF join tests (reference
physical_asof_join.cpp, physical_hash_join.cpp full-outer phase)."""

import numpy as np
import pytest

from duckdb_cubit.api import Connection


@pytest.fixture()
def conn():
    c = Connection()
    c.register_numpy("a", {"k": np.array([1, 2, 3, 5], np.int64),
                           "va": np.array([10, 20, 30, 50], np.int64)})
    c.register_numpy("b", {"k": np.array([2, 3, 4], np.int64),
                           "vb": np.array([200, 300, 400], np.int64)})
    return c


def test_left_join_baseline(conn):
    rows = conn.sql("SELECT a.k, vb FROM a LEFT JOIN b ON a.k = b.k "
                    "ORDER BY a.k").strings()
    assert rows == [["1", "NULL"], ["2", "200"], ["3", "300"],
                    ["5", "NULL"]]


def test_right_join(conn):
    rows = conn.sql("SELECT b.k, va FROM a RIGHT JOIN b ON a.k = b.k "
                    "ORDER BY b.k").strings()
    assert rows == [["2", "20"], ["3", "30"], ["4", "NULL"]]


def test_full_join(conn):
    rows = conn.sql(
        "SELECT va, vb FROM a FULL OUTER JOIN b ON a.k = b.k "
        "ORDER BY va, vb").strings()
    assert rows == [["10", "NULL"], ["20", "200"], ["30", "300"],
                    ["50", "NULL"], ["NULL", "400"]]


def test_full_join_where_post(conn):
    # WHERE on one side applies AFTER the full join (NULL rows filtered)
    rows = conn.sql(
        "SELECT va, vb FROM a FULL JOIN b ON a.k = b.k "
        "WHERE vb = 400 ORDER BY va").strings()
    assert rows == [["NULL", "400"]]


def test_full_join_duplicates():
    c = Connection()
    c.register_numpy("a", {"k": np.array([1, 1, 2], np.int64),
                           "va": np.array([10, 11, 20], np.int64)})
    c.register_numpy("b", {"k": np.array([1, 3, 3], np.int64),
                           "vb": np.array([100, 300, 301], np.int64)})
    rows = c.sql("SELECT va, vb FROM a FULL JOIN b ON a.k = b.k "
                 "ORDER BY va, vb").strings()
    assert rows == [["10", "100"], ["11", "100"], ["20", "NULL"],
                    ["NULL", "300"], ["NULL", "301"]]


# ------------------------------------------------------------------- ASOF
def _asof_conn():
    c = Connection()
    # trades probe into quotes build: price at the last quote <= trade time
    c.register_numpy("trades", {
        "sym": np.array([1, 1, 2, 2, 3], np.int64),
        "t": np.array([3, 10, 4, 1, 5], np.int64),
        "qty": np.array([100, 200, 300, 400, 500], np.int64)})
    c.register_numpy("quotes", {
        "sym": np.array([1, 1, 1, 2, 2], np.int64),
        "qt": np.array([1, 5, 9, 2, 4], np.int64),
        "px": np.array([11, 15, 19, 22, 24], np.int64)})
    return c


def test_asof_join_inner():
    c = _asof_conn()
    rows = c.sql(
        "SELECT qty, px FROM trades ASOF JOIN quotes "
        "ON trades.sym = quotes.sym AND trades.t >= quotes.qt "
        "ORDER BY qty").strings()
    # sym1 t3 -> qt1 px11; sym1 t10 -> qt9 px19; sym2 t4 -> qt4 px24;
    # sym2 t1 -> no quote <= 1; sym3 -> no quotes
    assert rows == [["100", "11"], ["200", "19"], ["300", "24"]]


def test_asof_join_left():
    c = _asof_conn()
    rows = c.sql(
        "SELECT qty, px FROM trades ASOF LEFT JOIN quotes "
        "ON trades.sym = quotes.sym AND trades.t >= quotes.qt "
        "ORDER BY qty").strings()
    assert rows == [["100", "11"], ["200", "19"], ["300", "24"],
                    ["400", "NULL"], ["500", "NULL"]]


def test_asof_join_strict():
    c = _asof_conn()
    rows = c.sql(
        "SELECT qty, px FROM trades ASOF JOIN quotes "
        "ON trades.sym = quotes.sym AND trades.t > quotes.qt "
        "ORDER BY qty").strings()
    # sym2 t4 strict: last qt < 4 is qt2 px22 (qt4 excluded)
    assert rows == [["100", "11"], ["200", "19"], ["300", "22"]]


def test_asof_join_reversed_direction():
    c = _asof_conn()
    # t <= qt: FIRST quote at-or-after the trade
    rows = c.sql(
        "SELECT qty, px FROM trades ASOF JOIN quotes "
        "ON trades.sym = quotes.sym AND trades.t <= quotes.qt "
        "ORDER BY qty").strings()
    # sym1 t3 -> qt5 px15; sym1 t10 -> none; sym2 t4 -> qt4 px24;
    # sym2 t1 -> qt2 px22
    assert rows == [["100", "15"], ["300", "24"], ["400", "22"]]


def test_asof_join_ties_and_equal_times():
    c = Connection()
    c.register_numpy("p", {"k": np.array([1, 1], np.int64),
                           "t": np.array([5, 4], np.int64),
                           "i": np.array([0, 1], np.int64)})
    c.register_numpy("q", {"k": np.array([1, 1], np.int64),
                           "t2": np.array([5, 5], np.int64),
                           "v": np.array([7, 8], np.int64)})
    rows = c.sql("SELECT i, v FROM p ASOF JOIN q "
                 "ON p.k = q.k AND p.t >= q.t2 ORDER BY i").strings()
    # t=5 matches one of the t2=5 rows (greatest time; tie broken
    # deterministically by sort order), t=4 matches none
    assert len(rows) == 1 and rows[0][0] == "0" and rows[0][1] in ("7", "8")
