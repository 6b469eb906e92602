"""Run ALL 22 reference TPC-H q*.sql files through the SQL path.

The analog of the reference's PRAGMA tpch(n) over SQL text
(reference extension/tpch/tpch_extension.cpp:167-178 running
extension/tpch/dbgen/queries/q*.sql), diffed against the golden answers
(reference test/sql/tpch/tpch_sf0.test pattern) — but through this engine's
full parse -> bind -> optimize -> compile pipeline, exercising derived
tables, correlated/uncorrelated subqueries, EXISTS/IN decorrelation, LEFT
JOIN expansion, and aggregate expressions.
"""

import glob
import os

import pytest

from duckdb_cubit.api import connect
from duckdb_cubit.tpch import answers

QUERY_DIR = "/root/reference/extension/tpch/dbgen/queries"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(QUERY_DIR) or not answers.answers_available(),
    reason="reference queries/answers not mounted")


@pytest.fixture(scope="module")
def conn():
    return connect(sf=0.01)


def _query_text(n: int) -> str:
    with open(os.path.join(QUERY_DIR, f"q{n:02d}.sql")) as f:
        return f.read()


@pytest.mark.parametrize("n", list(range(1, 23)))
def test_reference_sql_matches_golden(conn, n):
    rows = conn.sql(_query_text(n)).strings()
    problems = answers.compare(rows, 0.01, n)
    assert not problems, f"q{n}: {problems[:5]}"


def test_all_reference_queries_present():
    files = glob.glob(os.path.join(QUERY_DIR, "q*.sql"))
    assert len(files) == 22
