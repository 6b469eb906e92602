"""DML + CUBIT update-conscious index maintenance tests."""

import numpy as np
import pytest

from duckdb_cubit.exec import result as R
from duckdb_cubit.exec.executor import Executor
from duckdb_cubit.index.cubit import CubitIndex
from duckdb_cubit.ops.expressions import Col
from duckdb_cubit.plan.physical import Aggregate, GroupAggregate, TableScan
from duckdb_cubit.storage import dml
from duckdb_cubit.storage.table import Catalog, from_numpy


def make_table():
    data = {
        "k": np.arange(1, 101, dtype=np.int64),
        "v": (np.arange(100) % 10).astype(np.int64),
        "s": np.array([b"aa", b"bb"] * 50, dtype="S2"),
    }
    t = from_numpy("t", data)
    t.indexes["v"] = CubitIndex.build("v", np.asarray(data["v"], np.int32),
                                      t.capacity, t.num_rows, 10)
    return t


def count_v(t, value) -> int:
    cat = Catalog()
    cat.register(t)
    ex = Executor(cat)
    plan = GroupAggregate(
        TableScan("t", filters=[Col("v") == value]),
        [], [Aggregate("count", None, "n")])
    rel = ex.execute(plan, compiled=False, optimize=True)
    return int(rel.columns["n"].array[0])


def test_delete_updates_index_and_scan():
    t = make_table()
    assert count_v(t, 3) == 10
    dml.delete_rows(t, [3, 13, 23])  # rows with v==3
    assert count_v(t, 3) == 7
    # index agrees with scan
    assert t.indexes["v"].count(t.indexes["v"].query_eq(3)) == 7


def test_update_moves_bitmap_bits():
    t = make_table()
    before_5 = t.indexes["v"].count(t.indexes["v"].query_eq(5))
    before_7 = t.indexes["v"].count(t.indexes["v"].query_eq(7))
    dml.update_column(t, "v", [5, 15], [7, 7])  # two rows 5 -> 7
    assert t.indexes["v"].count(t.indexes["v"].query_eq(5)) == before_5 - 2
    assert t.indexes["v"].count(t.indexes["v"].query_eq(7)) == before_7 + 2
    assert count_v(t, 7) == before_7 + 2


def test_append_within_capacity():
    t = make_table()
    first = dml.append_rows(t, {
        "k": np.array([101, 102], dtype=np.int64),
        "v": np.array([3, 4], dtype=np.int64),
        "s": np.array([b"cc", b"aa"], dtype="S2"),
    })
    assert first == 100
    assert t.num_rows == 102
    assert count_v(t, 3) == 11
    assert t.indexes["v"].count(t.indexes["v"].query_eq(3)) == 11
    # new dictionary entry present
    assert b"cc" in t.columns["s"].dictionary


def test_append_then_delete_consistency():
    t = make_table()
    dml.append_rows(t, {
        "k": np.array([200], dtype=np.int64),
        "v": np.array([0], dtype=np.int64),
        "s": np.array([b"aa"], dtype="S2"),
    })
    dml.delete_rows(t, [100])
    assert count_v(t, 0) == 10  # appended then deleted nets out


def test_update_of_pk_column_rebuilds_the_lut():
    from duckdb_cubit.api import Connection

    conn = Connection()
    conn.register_numpy("dim", {"k": np.arange(1, 101, dtype=np.int64),
                                "w": np.arange(1, 101, dtype=np.int64) * 10})
    conn.register_numpy("fact", {"fk": np.arange(1, 201, dtype=np.int64)})
    conn.sql("CREATE UNIQUE INDEX ON dim (k)")
    q = ("SELECT count(*) AS n, sum(w) AS s FROM fact, dim "
         "WHERE fk = k")
    assert conn.sql(q).strings() == [["100", str(sum(range(10, 1001, 10)))]]
    # move keys 1..10 to 150..159: facts 1..10 lose their match and facts
    # 150..159 gain one; a stale lut would still join the old keys
    dim = conn.catalog.table("dim")
    dml.update_column(dim, "k", np.arange(10), np.arange(150, 160))
    assert dim.pk_indexes["k"].max_key == 159
    assert conn.sql(q).strings() == [["100", str(sum(range(10, 1001, 10)))]]
    got = conn.sql("SELECT fk, w FROM fact, dim WHERE fk = k AND fk < 12 "
                   "OR fk = k AND fk > 149 ORDER BY fk").strings()
    assert got == [["11", "110"]] + [[str(150 + i), str(10 * (i + 1))]
                                     for i in range(10)]


def test_update_that_breaks_pk_density_drops_the_lut():
    t = make_table()
    from duckdb_cubit.index.pk import DirectPKIndex
    t.pk_indexes["k"] = DirectPKIndex.build("k", t.columns["k"].host, 100)
    # keys far beyond 8x the row count no longer justify a direct lut
    dml.update_column(t, "k", np.array([0]), np.array([10**6]))
    assert "k" not in t.pk_indexes
