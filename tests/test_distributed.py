"""Distributed engine execution on the virtual 8-device CPU mesh.

The real Executor over row-sharded tables (SURVEY §2.2's device equivalent of
the reference's morsel-driven shared scans, task_scheduler.cpp:31): base
columns and CUBIT bitmap words carry NamedShardings over the "d" axis and
plans GSPMD-compile with XLA-inserted collectives.  Golden answers must stay
bit-exact — the engine's integer split-sums are reduction-order independent
by design.
"""

import jax
import pytest

from duckdb_cubit.api import connect
from duckdb_cubit.exec.result import to_strings
from duckdb_cubit.parallel.mesh import make_mesh
from duckdb_cubit.tpch import answers, queries

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8 or not answers.answers_available(),
    reason="needs 8 virtual devices + reference answers")


@pytest.fixture(scope="module")
def conn():
    return connect(sf=0.01, mesh=make_mesh(8))


def test_tables_are_sharded(conn):
    col = conn.catalog.table("lineitem").columns["l_extendedprice"].data
    assert len(col.sharding.device_set) == 8
    idx = conn.catalog.table("lineitem").indexes["l_shipdate"]
    assert len(idx.words.sharding.device_set) == 8


# mix of shapes: bitmap scan + ungrouped agg (6), dense group (1), join +
# sort-group (3), left-join derived (13), mark-join EXISTS (21),
# uncorrelated scalar subquery (15 via plan API), correlated scalar (17)
@pytest.mark.parametrize("n", [1, 3, 6, 13, 17, 21])
def test_query_on_mesh_matches_golden(conn, n):
    rel = queries.run(conn.executor, n)
    problems = answers.compare(to_strings(rel), 0.01, n)
    assert not problems, f"q{n}: {problems[:5]}"


def test_sql_path_on_mesh(conn):
    rows = conn.sql(
        "SELECT l_returnflag, count(*) AS c FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag").strings()
    assert len(rows) == 3 and rows[0][0] == "A"


def test_sql_q21_on_mesh_matches_golden(conn):
    sql = open("/root/reference/extension/tpch/dbgen/queries/q21.sql").read()
    rows = conn.sql(sql).strings()
    assert not answers.compare(rows, 0.01, 21)
