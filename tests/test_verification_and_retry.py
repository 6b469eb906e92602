"""Round-4 VERDICT items: end-to-end capacity-retry, 3-leg verification
(including a seeded index-corruption mutation test), and concurrent-reader
epoch snapshots.

Reference analogs: SetRepartitionRadixBits regrow (join_hashtable.cpp:1370),
PRAGMA enable_verification's independent verifiers (client_verify.cpp:24-67),
row-version snapshots (row_version_manager.cpp).
"""

import os

import numpy as np
import pytest

from duckdb_cubit.api import Connection, connect
from duckdb_cubit.exec.executor import Executor
from duckdb_cubit.index.cubit import CubitIndex
from duckdb_cubit.storage import dml
from duckdb_cubit.storage.table import Catalog, from_numpy
from duckdb_cubit.tpch import answers

QUERY_DIR = "/root/reference/extension/tpch/dbgen/queries"

tpch_available = os.path.isdir(QUERY_DIR) and answers.answers_available()


def _query_text(n: int) -> str:
    with open(os.path.join(QUERY_DIR, f"q{n:02d}.sql")) as f:
        return f.read()


def _indexed_conn():
    data = {
        "k": np.arange(1, 201, dtype=np.int64),
        "v": (np.arange(200) % 10).astype(np.int64),
    }
    t = from_numpy("t", data)
    t.indexes["v"] = CubitIndex.build("v", np.asarray(data["v"], np.int32),
                                     t.capacity, t.num_rows, 10)
    cat = Catalog()
    cat.register(t)
    return Connection(cat), t


# ------------------------------------------------------- capacity retry e2e
@pytest.mark.skipif(not tpch_available, reason="reference not mounted")
def test_expansion_retry_q21_lowball_factor():
    """SET join_expansion_factor = 0.005 forces expansion capacities to
    undershoot (SF0.1 so true cardinalities exceed the 8192-row pad floor);
    the staged executor must regrow-and-retry (doubling caps) and still
    produce the exact golden answer."""
    conn = connect(sf=0.1)
    conn.sql("SET join_expansion_factor = 0.005")
    try:
        before = conn.executor.retry_count
        rows = conn.sql(_query_text(21)).strings()
        retries = conn.executor.retry_count - before
    finally:
        conn.sql("SET join_expansion_factor = 1.0")
    assert not answers.compare(rows, 0.1, 21)
    assert retries > 0, "lowball expansion factor should force regrow+retry"


def test_expansion_retry_skewed_synthetic_join():
    """A skewed many-to-many join whose output is 16x the probe capacity."""
    conn = Connection()
    n = 1 << 10
    conn.register_numpy("build", {
        "k": np.ones(n, np.int64), "bv": np.arange(n, dtype=np.int64)})
    conn.register_numpy("probe", {
        "k": np.ones(16, np.int64), "pv": np.arange(16, dtype=np.int64)})
    conn.sql("SET join_expansion_factor = 0.01")
    before = conn.executor.retry_count
    rows = conn.sql("SELECT count(*) AS c FROM probe, build "
                    "WHERE probe.k = build.k").strings()
    assert rows == [[str(16 * n)]]
    assert conn.executor.retry_count > before


def test_nonrecoverable_check_still_failstops():
    """A failed check with no registered recovery must raise, not loop."""
    ex = Executor.__new__(Executor)
    ex.retry_count = 0
    assert ex._handle_failed_checks(["join_key_pack_range[x]"], []) is False


# ------------------------------------------------- 3-leg verification + bug
def test_verification_catches_corrupted_index():
    """Seeded mutation: corrupt a CUBIT range-encoded row; the optimized
    plan (index-matched) silently returns wrong rows, and ONLY the
    unoptimized third leg catches it."""
    conn, t = _indexed_conn()
    # warm an unrelated query so later corruption can't hide in a cache
    assert conn.sql("SELECT count(*) AS c FROM t WHERE v = 2").strings() \
        == [["20"]]
    idx = t.indexes["v"]
    # corrupt: clear bin 3's bitmap words (and its cumulative encoding)
    idx.words = idx.words.at[3].set(0)
    idx._rebuild_cum()
    idx._query_cache.clear()
    # without verification: silent wrong answer through the index path
    wrong = conn.sql("SELECT count(*) AS c FROM t WHERE v = 3").strings()
    assert wrong == [["0"]]
    conn.sql("SET enable_verification = true")
    with pytest.raises(RuntimeError, match="verification failed"):
        conn.sql("SELECT count(*) AS c2 FROM t WHERE v = 3").strings()


def test_verification_passes_clean_queries():
    conn, _ = _indexed_conn()
    conn.sql("SET enable_verification = true")
    rows = conn.sql("SELECT v, count(*) AS c, min(k) AS mk FROM t "
                    "WHERE v >= 5 GROUP BY v ORDER BY v").strings()
    assert len(rows) == 5 and rows[0][0] == "5"


@pytest.mark.skipif(not tpch_available, reason="reference not mounted")
@pytest.mark.parametrize("n", [3, 6, 12, 16])
def test_verification_tpch(n):
    conn = connect(sf=0.01)
    conn.sql("SET enable_verification = true")
    try:
        rows = conn.sql(_query_text(n)).strings()
    finally:
        conn.sql("SET enable_verification = false")
    assert not answers.compare(rows, 0.01, n)


# Q2 (decimal sort keys) and Q17 (SUM over an empty input at SF0.01) are
# where the row-by-row leg used to disagree with a correct engine result
@pytest.mark.parametrize("n", [2, 17])
def test_verification_tpch_plan_builders(n):
    conn = connect(sf=0.01)
    conn.sql("SET enable_verification = true")
    rows = conn.tpch_query(n).strings()
    assert (len(rows) > 0) == (n == 2)


# --------------------------------------------------- concurrent reader MVCC
def test_reader_pinned_epoch_survives_merge():
    """A prepared query compiled against epoch N keeps answering from the
    epoch-N snapshot after DML + merge publishes N+1 (CUBIT MVCC deltas:
    functional arrays ARE the version store); a fresh prepare sees N+1."""
    from duckdb_cubit.exec.result import to_strings

    conn, t = _indexed_conn()
    prepared = conn.prepare("SELECT count(*) AS c FROM t WHERE v = 3")
    assert to_strings(prepared.execute()) == [["20"]]
    # pin the compiled triple (epoch-N words are captured in its inputs)
    ver, jitted, arrays, meta = prepared._cached
    epoch_before = t.indexes["v"].epoch

    # DML: move two rows out of bin 3, publish epoch N+1
    rows = [i for i in range(t.num_rows)
            if int(np.asarray(t.columns["v"].data[i])) == 3][:2]
    dml.update_column(t, "v", rows, [7, 7])
    assert t.indexes["v"].epoch == epoch_before + 1

    # the pinned triple still answers from the old snapshot
    old = to_strings(conn.executor._run_compiled(jitted, arrays, meta))
    assert old == [["20"]]
    # a fresh execute re-resolves against the new epoch
    assert to_strings(prepared.execute()) == [["18"]]


# -------- leg 4: independent row-by-row python executor (VERDICT r4 #8)
def test_pyverify_agrees_on_joins_and_aggregates():
    import numpy as np
    from duckdb_cubit.api import Connection
    from duckdb_cubit.config import EngineConfig

    cfg = EngineConfig()
    cfg.enable_verification = True
    conn = Connection(config=cfg)
    rng = np.random.default_rng(0)
    n = 3000
    conn.register_numpy("f", {"k": rng.integers(0, 50, n),
                              "v": rng.integers(-100, 100, n)})
    conn.register_numpy("d", {"k": np.arange(50, dtype=np.int64),
                              "w": rng.integers(0, 10, 50)})
    rows = conn.sql(
        "SELECT d.w AS w, count(*) AS c, sum(f.v) AS s FROM f, d "
        "WHERE f.k = d.k GROUP BY d.w ORDER BY w").strings()
    assert len(rows) > 0


def test_pyverify_catches_shared_kernel_bug():
    """A corrupted jnp kernel shared by legs 1-3 self-confirms there;
    only the independent python leg can catch it."""
    import numpy as np
    import pytest

    from duckdb_cubit.api import Connection
    from duckdb_cubit.config import EngineConfig
    from duckdb_cubit.ops import expressions as E

    cfg = EngineConfig()
    cfg.enable_verification = True
    conn = Connection(config=cfg)
    conn.register_numpy("m", {"a": np.arange(100, dtype=np.int64),
                              "b": np.arange(100, dtype=np.int64)})

    orig = E.Arith.eval

    def corrupted(self, ctx):
        out = orig(self, ctx)
        if self.op == "+":
            # off-by-one in every addition: legs 1-3 all run through this
            return E.Typed(out.array + 1, out.dtype, out.dictionary,
                           out.valid)
        return out

    E.Arith.eval = corrupted
    try:
        with pytest.raises(RuntimeError, match="row-by-row"):
            conn.sql("SELECT sum(a + b) AS s FROM m")
    finally:
        E.Arith.eval = orig
    # sanity: legs 1-3 alone (pyverify disabled) DO self-confirm the bug
    cfg.pyverify_max_rows = 0
    E.Arith.eval = corrupted
    try:
        rows = conn.sql("SELECT sum(a + b) AS s FROM m").strings()
        assert rows == [[str(2 * sum(range(100)) + 100)]]
    finally:
        E.Arith.eval = orig
