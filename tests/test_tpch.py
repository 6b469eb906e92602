"""TPC-H golden-answer regression (SF0.01, CPU backend).

The engine's primary correctness oracle (SURVEY.md §4.2): every implemented
query must match the reference's answer CSVs cell-for-cell (numerics within
double-formatting tolerance).
"""

import pytest

from duckdb_cubit.exec import result as R
from duckdb_cubit.exec.executor import Executor
from duckdb_cubit.tpch import answers, load, queries

pytestmark = pytest.mark.skipif(
    not answers.answers_available(), reason="reference answers not mounted")


@pytest.fixture(scope="module")
def executor():
    return Executor(load.load_catalog(0.01, disk_cache=False))


@pytest.mark.parametrize("q", sorted(queries.QUERIES))
def test_query_matches_golden_answer(executor, q):
    rel = queries.run(executor, q)
    rows = R.to_strings(rel)
    problems = answers.compare(rows, 0.01, q)
    assert not problems, problems[:5]


@pytest.mark.parametrize("q", [1, 6])
def test_query_eager_mode_matches(executor, q):
    rel = executor.execute(queries.get_query(q), compiled=False)
    rows = R.to_strings(rel)
    assert not answers.compare(rows, 0.01, q)
