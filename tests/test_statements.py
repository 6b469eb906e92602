"""DDL/DML/transaction statement tests (reference parity: the statement
surface of src/main/client_context.cpp + test/sql/ DDL/DML coverage)."""

import numpy as np
import pytest

from duckdb_cubit.api import Connection


@pytest.fixture()
def conn():
    c = Connection()
    c.sql("CREATE TABLE items (id INTEGER, price DECIMAL(12,2), "
          "qty BIGINT, day DATE, name VARCHAR)")
    c.sql("INSERT INTO items VALUES "
          "(1, 9.99, 5, DATE '2024-01-02', 'apple'), "
          "(2, 0.50, 100, DATE '2024-02-03', 'banana'), "
          "(3, 12.00, 7, DATE '2024-03-04', 'cherry'), "
          "(4, 3.25, 42, DATE '2024-01-20', 'banana')")
    return c


def test_create_insert_select(conn):
    rows = conn.sql("SELECT id, price, name FROM items "
                    "WHERE qty >= 7 ORDER BY id").strings()
    assert rows == [["2", "0.50", "banana"],
                    ["3", "12.00", "cherry"],
                    ["4", "3.25", "banana"]]


def test_delete(conn):
    r = conn.sql("DELETE FROM items WHERE name = 'banana'")
    assert r.status == "DELETE 2"
    rows = conn.sql("SELECT count(*) AS c FROM items").strings()
    assert rows == [["2"]]


def test_update_literal_and_expr(conn):
    conn.sql("UPDATE items SET qty = 1 WHERE id = 1")
    rows = conn.sql("SELECT qty FROM items WHERE id = 1").strings()
    assert rows == [["1"]]
    conn.sql("UPDATE items SET qty = qty + 10 WHERE id <= 2")
    rows = conn.sql("SELECT id, qty FROM items WHERE id <= 2 "
                    "ORDER BY id").strings()
    assert rows == [["1", "11"], ["2", "110"]]


def test_create_index_accelerates_and_matches(conn):
    conn.sql("CREATE INDEX ON items(qty)")
    t = conn.catalog.table("items")
    assert "qty" in t.indexes
    rows = conn.sql("SELECT id FROM items WHERE qty = 42").strings()
    assert rows == [["4"]]
    # index maintenance through DML
    conn.sql("DELETE FROM items WHERE qty = 42")
    rows = conn.sql("SELECT count(*) AS c FROM items WHERE qty = 42").strings()
    assert rows == [["0"]]


def test_transactions_rollback(conn):
    before = conn.sql("SELECT count(*) AS c FROM items").strings()
    conn.sql("BEGIN")
    conn.sql("DELETE FROM items")
    assert conn.sql("SELECT count(*) AS c FROM items").strings() == [["0"]]
    conn.sql("ROLLBACK")
    assert conn.sql("SELECT count(*) AS c FROM items").strings() == before
    # commit keeps changes
    conn.sql("BEGIN")
    conn.sql("DELETE FROM items WHERE id = 1")
    conn.sql("COMMIT")
    assert conn.sql("SELECT count(*) AS c FROM items").strings() == [["3"]]


def test_transaction_rollback_updates_and_indexes(conn):
    conn.sql("CREATE INDEX ON items(qty)")
    conn.sql("BEGIN")
    conn.sql("UPDATE items SET qty = 999 WHERE id = 2")
    assert conn.sql("SELECT qty FROM items WHERE id = 2").strings() == [["999"]]
    conn.sql("ROLLBACK")
    assert conn.sql("SELECT qty FROM items WHERE id = 2").strings() == [["100"]]
    # index answers agree with the base column after rollback
    assert conn.sql("SELECT id FROM items WHERE qty = 100").strings() == [["2"]]


def test_drop_and_set(conn):
    conn.sql("DROP TABLE items")
    assert "items" not in conn.catalog.tables
    conn.sql("DROP TABLE IF EXISTS items")
    conn.sql("SET index_scan_max_count = 4096")
    assert conn.config.index_scan_max_count == 4096
    with pytest.raises(Exception):
        conn.sql("SET no_such_setting = 1")


def test_explain(conn):
    r = conn.sql("EXPLAIN SELECT count(*) AS c FROM items WHERE qty > 5")
    text = "\n".join(line[0] for line in r.rows())
    assert "table_scan" in text and "group_aggregate" in text


def test_statement_errors(conn):
    with pytest.raises(Exception):
        conn.sql("CREATE TABLE items (id INTEGER)")  # duplicate
    with pytest.raises(Exception):
        conn.sql("INSERT INTO items VALUES (1)")  # arity
    with pytest.raises(Exception):
        conn.sql("FROBNICATE all the things")


# ----------------------- base-table NULL storage (round 5) -------------
def test_insert_null_values():
    import numpy as np
    from duckdb_cubit.api import Connection

    conn = Connection()
    conn.sql("CREATE TABLE ns (i INTEGER, s VARCHAR, d DOUBLE)")
    conn.sql("INSERT INTO ns VALUES (1, 'a', 1.5), (NULL, NULL, NULL), "
             "(3, 'c', NULL)")
    rows = conn.sql("SELECT i, s, d FROM ns ORDER BY i").strings()
    assert rows == [["1", "a", "1.5"], ["3", "c", "NULL"],
                    ["NULL", "NULL", "NULL"]]
    # aggregates skip NULLs; count(*) does not
    rows = conn.sql("SELECT count(*) AS a, count(i) AS b, sum(i) AS s, "
                    "min(s) AS m FROM ns").strings()
    assert rows == [["3", "2", "4", "a"]]
    # IS NULL / IS NOT NULL filters
    assert conn.sql("SELECT count(*) AS c FROM ns WHERE i IS NULL"
                    ).strings() == [["1"]]
    assert conn.sql("SELECT count(*) AS c FROM ns WHERE s IS NOT NULL"
                    ).strings() == [["2"]]
    # comparisons with NULL rows are UNKNOWN -> excluded
    assert conn.sql("SELECT count(*) AS c FROM ns WHERE i < 10"
                    ).strings() == [["2"]]


def test_null_survives_checkpoint(tmp_path):
    from duckdb_cubit.api import Connection
    from duckdb_cubit.storage.persist import open_database

    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    conn.sql("CREATE TABLE t (k INTEGER, v INTEGER)")
    conn.sql("INSERT INTO t VALUES (1, NULL), (2, 20)")
    conn.checkpoint()
    conn2 = open_database(db)
    assert conn2.sql("SELECT count(v) AS c, sum(v) AS s FROM t").strings() \
        == [["1", "20"]]


def test_select_without_from():
    from duckdb_cubit.api import Connection

    conn = Connection()
    assert conn.sql("SELECT 1+2 AS a, 'x' AS s").strings() == [["3", "x"]]
    assert conn.sql("SELECT NULL AS n").strings() == [["NULL"]]
    assert conn.sql("SELECT 1 AS a WHERE 1 > 2").strings() == []
