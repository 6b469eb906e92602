"""Explicit radix-exchange join inside engine plans (VERDICT r3 item 4).

Runs on the virtual 8-device CPU mesh (conftest).  Asserts: answers match
single-device execution, the lowering actually took the exchange path (plan
signature flag), the build side is NOT replicated (per-device build quota
covers only a fraction of the build side), and skewed keys recover via the
quota-doubling retry (SetRepartitionRadixBits analog).
"""

import numpy as np
import pytest

from duckdb_cubit.api import Connection, connect
from duckdb_cubit.config import EngineConfig
from duckdb_cubit.parallel import mesh as M
from duckdb_cubit.plan import physical as P
from duckdb_cubit.tpch import answers

N_DEV = 8


def _mesh_conn(tables: dict, exchange: bool = True):
    cfg = EngineConfig()
    cfg.explicit_exchange = exchange
    cfg.exchange_min_build_rows = 1
    conn = Connection(config=cfg, mesh=M.make_mesh(N_DEV))
    for name, cols in tables.items():
        conn.register_numpy(name, cols)
    return conn


def _tables(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "probe": {"k": rng.integers(0, 2000, n),
                  "pv": rng.integers(0, 100, n)},
        "build": {"k": rng.integers(0, 2000, n // 2),
                  "bv": rng.integers(0, 100, n // 2)},
    }


SQL = ("SELECT sum(pv * bv) AS s, count(*) AS c FROM probe, build "
       "WHERE probe.k = build.k")


def _join_ops(conn, sql):
    plan = conn.binder.bind_sql(sql)
    from duckdb_cubit.plan import optimizer as opt
    plan = opt.optimize(plan, conn.catalog)
    rel = conn.executor.execute(plan, optimize=False)
    from duckdb_cubit.exec.result import to_strings
    return to_strings(rel), [o for o in plan.walk()
                             if isinstance(o, P.HashJoin)]


def test_exchange_join_matches_single_device():
    tables = _tables()
    want = Connection()
    for name, cols in tables.items():
        want.register_numpy(name, cols)
    expected = want.sql(SQL).strings()

    conn = _mesh_conn(tables)
    rows, joins = _join_ops(conn, SQL)
    assert rows == expected
    assert any(getattr(j, "_exchange_used", False) for j in joins), \
        "join did not take the explicit exchange lowering"
    j = next(j for j in joins if getattr(j, "_exchange_used", False))
    # build side NOT replicated: each device receives n * quota build rows,
    # a fraction of the build capacity (a broadcast join would need all)
    per_device_build = N_DEV * j._exq_build
    build_cap = conn.catalog.table("build").capacity
    assert per_device_build < build_cap, (per_device_build, build_cap)
    # signature records the exchange (plan-level assertion)
    assert "exu=True" in j._self_signature()


def test_exchange_left_join():
    tables = _tables()
    sql = ("SELECT count(*) AS c, sum(bv) AS s FROM probe "
           "LEFT JOIN build ON probe.k = build.k")
    want = Connection()
    for name, cols in tables.items():
        want.register_numpy(name, cols)
    expected = want.sql(sql).strings()
    conn = _mesh_conn(tables)
    rows, joins = _join_ops(conn, sql)
    assert rows == expected
    assert any(getattr(j, "_exchange_used", False) for j in joins)


def test_exchange_skew_requota_recovers():
    rng = np.random.default_rng(1)
    n = 20_000
    keys = rng.integers(0, 2000, n)
    keys[: n // 2] = 7            # heavy skew: half the rows on one key
    tables = {
        "probe": {"k": keys, "pv": rng.integers(0, 100, n)},
        "build": {"k": np.arange(2000, dtype=np.int64),
                  "bv": rng.integers(0, 100, 2000)},
    }
    want = Connection()
    for name, cols in tables.items():
        want.register_numpy(name, cols)
    expected = want.sql(SQL).strings()
    conn = _mesh_conn(tables)
    before = conn.executor.retry_count
    rows, joins = _join_ops(conn, SQL)
    assert rows == expected
    assert conn.executor.retry_count > before, \
        "skewed probe side should overflow the initial quota and requota"


def test_exchange_off_falls_back():
    tables = _tables(n=4000)
    conn = _mesh_conn(tables, exchange=False)
    rows, joins = _join_ops(conn, SQL)
    assert not any(getattr(j, "_exchange_used", False) for j in joins)


@pytest.mark.skipif(not answers.answers_available(),
                    reason="reference answers not mounted")
@pytest.mark.parametrize("q", [3, 7])
def test_tpch_on_mesh_with_exchange(q):
    import os
    conn = connect(sf=0.01, mesh=M.make_mesh(N_DEV))
    conn.config.explicit_exchange = True
    conn.config.exchange_min_build_rows = 1
    with open(f"/root/reference/extension/tpch/dbgen/queries/q{q:02d}.sql") as f:
        sql = f.read()
    rows = conn.sql(sql).strings()
    assert not answers.compare(rows, 0.01, q)


def test_exchange_left_join_with_found_column():
    # ADVICE r4 (medium): decorrelated correlated-COUNT subqueries lower to
    # a left join with found_column (binder.py:960); the exchange path must
    # emit the match flag or the downstream CASE on it raises KeyError
    tables = _tables()
    sql = ("SELECT count(*) AS c FROM probe WHERE "
           "(SELECT count(*) FROM build WHERE build.k = probe.k) > 3")
    want = Connection()
    for name, cols in tables.items():
        want.register_numpy(name, cols)
    expected = want.sql(sql).strings()
    conn = _mesh_conn(tables)
    rows, joins = _join_ops(conn, sql)
    assert rows == expected
    assert any(getattr(j, "_exchange_used", False) for j in joins), \
        "EXISTS join did not take the exchange lowering"
