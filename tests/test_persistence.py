"""Durability tests: checkpoint + WAL replay (reference
checkpoint_manager.cpp, wal_replay.cpp)."""

import numpy as np
import pytest

from duckdb_cubit.api import Connection
from duckdb_cubit.storage.persist import open_database


def _populate(conn):
    conn.sql("CREATE TABLE t (k INTEGER, v INTEGER, s VARCHAR)")
    conn.sql("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), "
             "(3, 30, 'a')")


def test_checkpoint_roundtrip(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    conn.checkpoint()
    conn2 = open_database(db)
    rows = conn2.sql("SELECT k, v, s FROM t ORDER BY k").strings()
    assert rows == [["1", "10", "a"], ["2", "20", "b"], ["3", "30", "a"]]


def test_wal_replay_without_checkpoint(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)                       # WAL only, no checkpoint
    conn2 = open_database(db)
    rows = conn2.sql("SELECT count(*) AS c, sum(v) AS s FROM t").strings()
    assert rows == [["3", "60"]]


def test_checkpoint_plus_wal_tail(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    conn.checkpoint()
    conn.sql("INSERT INTO t VALUES (4, 40, 'c')")     # WAL tail
    conn.sql("UPDATE t SET v = 99 WHERE k = 1")
    conn2 = open_database(db)
    rows = conn2.sql("SELECT k, v FROM t ORDER BY k").strings()
    assert rows == [["1", "99"], ["2", "20"], ["3", "30"], ["4", "40"]]


def test_checkpoint_compacts_deletes(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    conn.sql("DELETE FROM t WHERE k = 2")
    conn.checkpoint()
    conn2 = open_database(db)
    assert conn2.sql("SELECT count(*) AS c FROM t").strings() == [["2"]]
    t = conn2.catalog.table("t")
    assert t.num_rows == 2 and getattr(t, "deleted", None) is None


def test_index_survives_checkpoint(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    conn.sql("CREATE INDEX it ON t (v)")
    conn.checkpoint()
    conn2 = open_database(db)
    t = conn2.catalog.table("t")
    assert "v" in t.indexes
    assert conn2.sql("SELECT count(*) AS c FROM t WHERE v = 20").strings() \
        == [["1"]]


def test_wal_truncated_by_checkpoint(tmp_path):
    import os

    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    assert os.path.exists(os.path.join(db, "wal.sql"))
    conn.checkpoint()
    assert not os.path.exists(os.path.join(db, "wal.sql"))


def test_rollback_not_resurrected_by_wal_replay(tmp_path):
    # ADVICE r4 (high): rolled-back DML must not reach the on-disk WAL
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    conn.sql("BEGIN")
    conn.sql("INSERT INTO t VALUES (9, 90, 'z')")
    conn.sql("UPDATE t SET v = 1 WHERE k = 1")
    conn.sql("ROLLBACK")
    conn2 = open_database(db)
    rows = conn2.sql("SELECT k, v FROM t ORDER BY k").strings()
    assert rows == [["1", "10"], ["2", "20"], ["3", "30"]]


def test_commit_flushes_buffered_wal(tmp_path):
    db = str(tmp_path / "db")
    conn = Connection().attach(db)
    _populate(conn)
    conn.sql("BEGIN")
    conn.sql("INSERT INTO t VALUES (4, 40, 'c')")
    conn.sql("COMMIT")
    conn2 = open_database(db)
    assert conn2.sql("SELECT count(*) AS c FROM t").strings() == [["4"]]
