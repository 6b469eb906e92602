"""Out-of-core (multi-pass) execution tests.

The analog of the reference's `SET memory_limit` / `force_external` tests
(test/sql/outofcore/, client_config.hpp:79): a stage whose working set
exceeds the budget splits its driving scan into row-range chunks, runs the
compiled stage per chunk (partial aggregates), and a merge pass
re-aggregates — results must be identical to single-pass execution.
"""

import os

import numpy as np
import pytest

from duckdb_cubit.api import Connection, connect
from duckdb_cubit.tpch import answers

QUERY_DIR = "/root/reference/extension/tpch/dbgen/queries"
tpch_available = os.path.isdir(QUERY_DIR) and answers.answers_available()


def _conn(n=50_000, seed=0):
    rng = np.random.default_rng(seed)
    c = Connection()
    c.register_numpy("t", {
        "g": rng.integers(0, 7, n),
        "v": rng.integers(-100, 1000, n),
        "d": rng.random(n),
    })
    return c


SQL = ("SELECT g, count(*) AS c, sum(v) AS s, min(v) AS lo, max(v) AS hi, "
       "avg(v) AS av, sum(d) AS sd, avg(d) AS ad FROM t GROUP BY g "
       "ORDER BY g")


def _rows_equal(got, want):
    """Exact for ints/decimals; FP sums may differ in the last ulp because
    chunked execution re-associates the addition order (reference external
    aggregates have the same property)."""
    assert len(got) == len(want)
    for gr, wr in zip(got, want):
        assert len(gr) == len(wr)
        for g, w in zip(gr, wr):
            if g == w:
                continue
            assert abs(float(g) - float(w)) <= 1e-9 * max(
                1.0, abs(float(w))), (g, w)
    return True


def test_force_external_matches_single_pass():
    conn = _conn()
    want = conn.sql(SQL).strings()
    conn.sql("SET force_external = true")
    got = conn.sql(SQL).strings()
    assert conn.executor.external_passes >= 4
    assert _rows_equal(got, want)


def test_memory_limit_triggers_chunking():
    conn = _conn()
    want = conn.sql(SQL).strings()
    # ~50k rows x 3 int64/double columns x 4 slack = ~4.8MB working set;
    # a 1MB budget must force multiple passes
    conn.sql("SET memory_limit = 1000000")
    got = conn.sql(SQL).strings()
    assert conn.executor.external_passes > 0
    assert _rows_equal(got, want)


def test_ungrouped_external():
    conn = _conn()
    q = "SELECT count(*) AS c, sum(v) AS s, avg(d) AS a FROM t WHERE v > 50"
    want = conn.sql(q).strings()
    conn.sql("SET force_external = true")
    got = conn.sql(q).strings()
    assert _rows_equal(got, want) and conn.executor.external_passes >= 4


def test_external_empty_result():
    conn = _conn()
    q = "SELECT sum(v) AS s FROM t WHERE v > 100000"
    assert conn.sql(q).strings() == []
    conn.sql("SET force_external = true")
    assert conn.sql(q).strings() == []


def test_zone_map_chunk_skip():
    """Chunks whose zone-map blocks prove the filter unsatisfiable are
    skipped entirely (multi-pass CheckZonemapSegments analog)."""
    n = 4 * 65536           # 4 zone-map blocks, clustered values
    conn = Connection()
    conn.register_numpy("t", {"v": np.arange(n, dtype=np.int64)})
    q = "SELECT count(*) AS c, sum(v) AS s FROM t WHERE v < 1000"
    want = conn.sql(q).strings()
    conn.sql("SET force_external = true")
    before_skip = getattr(conn.executor, "external_chunks_skipped", 0)
    before_pass = conn.executor.external_passes
    got = conn.sql(q).strings()
    assert got == want
    assert conn.executor.external_chunks_skipped - before_skip > 0
    assert conn.executor.external_passes - before_pass >= 1


def test_zone_map_all_chunks_skipped():
    n = 2 * 65536
    conn = Connection()
    conn.register_numpy("t", {"v": np.arange(n, dtype=np.int64)})
    q = "SELECT count(*) AS c FROM t WHERE v < 0"
    conn.sql("SET force_external = true")
    assert conn.sql(q).strings() == [["0"]]


@pytest.mark.skipif(not tpch_available, reason="reference not mounted")
@pytest.mark.parametrize("n", [1, 6])
def test_tpch_forced_external(n):
    conn = connect(sf=0.01)
    with open(os.path.join(QUERY_DIR, f"q{n:02d}.sql")) as f:
        sql = f.read()
    conn.sql("SET force_external = true")
    # q6's predicate is fully index-answered and tiny at SF0.01, which
    # takes the decode path (no chunking there) — disable decode so the
    # mask-scan pipeline is what goes external
    conn.sql("SET index_scan_max_count = 0")
    conn.sql("SET index_scan_percentage = 0.0")
    try:
        before = conn.executor.external_passes
        rows = conn.sql(sql).strings()
        passes = conn.executor.external_passes - before
    finally:
        conn.sql("SET force_external = false")
        conn.sql("SET index_scan_max_count = 16384")
        conn.sql("SET index_scan_percentage = 0.001")
    assert not answers.compare(rows, 0.01, n)
    assert passes >= 4, "forced external must run multiple passes"


def test_out_of_core_join_rooted_stage():
    """VERDICT r4 item 4: chunking extends to join-rooted aggregate
    stages — the probe scan is chunked, build sides stay resident (the
    external-join decomposition, reference join_hashtable.cpp:1312)."""
    import numpy as np

    from duckdb_cubit.api import Connection
    from duckdb_cubit.config import EngineConfig

    rng = np.random.default_rng(0)
    n = 200_000
    fk = rng.integers(0, 100, n)
    fv = rng.integers(0, 50, n)
    dw = rng.integers(1, 5, 100)
    cfg = EngineConfig()
    cfg.force_external = True
    conn = Connection(config=cfg)
    conn.register_numpy("f", {"k": fk, "v": fv})
    conn.register_numpy("d", {"k": np.arange(100, dtype=np.int64),
                              "w": dw})
    rows = conn.sql("SELECT sum(f.v * d.w) AS s, count(*) AS c "
                    "FROM f, d WHERE f.k = d.k").strings()
    assert conn.executor.external_passes >= 2, "join stage did not chunk"
    assert rows == [[str(int((fv * dw[fk]).sum())), str(n)]]
