"""Config wiring + runtime-check tests.

Covers the round-2 requirements: session settings must be consumed by the
plan (a SET changes the plan — reference DBConfig/ClientConfig semantics,
config.hpp:246), enable_verification must cross-check compiled vs eager
(client_verify.cpp:24 analog), multi-key joins must be collision-exact
(ResolvePredicates analog, join_hashtable.cpp:768), and single-match joins
must validate their build-side uniqueness assumption at runtime.
"""

import numpy as np
import pytest

from duckdb_cubit.api import Connection
from duckdb_cubit.exec.executor import Executor
from duckdb_cubit.ops import expressions as E
from duckdb_cubit.plan import physical as P


@pytest.fixture()
def conn():
    c = Connection()
    rng = np.random.default_rng(7)
    n = 20000
    c.register_numpy("big", {
        "k": np.arange(n, dtype=np.int64),
        "v": rng.integers(0, 1000, size=n).astype(np.int64),
    })
    c.sql("CREATE INDEX ON big(v)")
    return c


def test_set_index_scan_max_count_changes_plan(conn):
    # v = 42 matches ~20 rows of 20000 (0.1%); default max_count 2^14 allows
    # the decode path.  Dropping the knob to 1 (and percentage to ~0) forces
    # the mask-based scan: the prepared decode capacity must change.
    def decode_cap():
        plan = conn.binder.bind_sql("SELECT k FROM big WHERE v = 42")
        from duckdb_cubit.plan import optimizer as opt
        plan = opt.optimize(plan, conn.catalog)
        ctx = P.ExecContext(conn.catalog, conn.executor.config)
        plan.prepare(ctx)
        scans = [op for op in plan.walk() if isinstance(op, P.TableScan)]
        return scans[0]._decode_cap

    assert decode_cap() is not None
    conn.sql("SET index_scan_max_count = 1")
    conn.sql("SET index_scan_percentage = 0.0000001")
    assert decode_cap() is None
    conn.sql("SET index_scan_max_count = 16384")
    conn.sql("SET index_scan_percentage = 0.001")
    assert decode_cap() is not None


def test_set_takes_effect_through_cached_executor(conn):
    # same SQL before and after SET must produce fresh plans (cache keys
    # include the config), and results must stay correct either way
    r1 = conn.sql("SELECT count(*) AS c FROM big WHERE v = 42").strings()
    conn.sql("SET index_scan_max_count = 1")
    conn.sql("SET index_scan_percentage = 0.0000001")
    r2 = conn.sql("SELECT count(*) AS c FROM big WHERE v = 42").strings()
    assert r1 == r2


def test_enable_verification_runs_both_paths(conn):
    conn.sql("SET enable_verification = true")
    rows = conn.sql("SELECT v, count(*) AS c FROM big WHERE v < 5 "
                    "GROUP BY v ORDER BY v").strings()
    assert [r[0] for r in rows] == ["0", "1", "2", "3", "4"]


def _exec(catalog, plan, config=None):
    ex = Executor(catalog, config)
    rel = ex.execute(plan)
    from duckdb_cubit.exec.result import materialize
    _, rows, _ = materialize(rel)
    return rows


def _three_key_catalog():
    """Engineered 3-key tables where hash-combined keys would collide only
    if the collision re-check is missing (we can't force a real 64-bit hash
    collision, so instead verify exact semantics on all join types)."""
    from duckdb_cubit.storage.table import Catalog, from_numpy

    cat = Catalog()
    cat.register(from_numpy("probe", {
        "a": np.array([1, 1, 2, 2, 3], np.int64),
        "b": np.array([10, 10, 20, 20, 30], np.int64),
        "c": np.array([5, 6, 7, 7, 9], np.int64),
        "pv": np.array([100, 200, 300, 400, 500], np.int64),
    }))
    cat.register(from_numpy("build", {
        "a": np.array([1, 2, 3], np.int64),
        "b": np.array([10, 20, 31], np.int64),
        "c": np.array([5, 7, 9], np.int64),
        "bv": np.array([7, 8, 9], np.int64),
    }))
    return cat


def test_three_key_joins_exact():
    cat = _three_key_catalog()
    keys = ["a", "b", "c"]
    # inner expansion
    plan = P.HashJoin(P.TableScan("probe"), P.TableScan("build"),
                      keys, keys, "inner", single_match=False,
                      build_prefix="b_")
    rows = _exec(cat, plan)
    got = sorted((int(r[3]), int(r[7])) for r in rows)
    assert got == [(100, 7), (300, 8), (400, 8)]
    # semi
    plan = P.HashJoin(P.TableScan("probe"), P.TableScan("build"),
                      keys, keys, "semi", single_match=False)
    rows = _exec(cat, plan)
    assert sorted(int(r[3]) for r in rows) == [100, 300, 400]
    # anti
    plan = P.HashJoin(P.TableScan("probe"), P.TableScan("build"),
                      keys, keys, "anti", single_match=False)
    rows = _exec(cat, plan)
    assert sorted(int(r[3]) for r in rows) == [200, 500]
    # single-match (build keys unique here)
    plan = P.HashJoin(P.TableScan("probe"), P.TableScan("build"),
                      keys, keys, "inner", single_match=True,
                      build_prefix="b_")
    rows = _exec(cat, plan)
    got = sorted((int(r[3]), int(r[7])) for r in rows)
    assert got == [(100, 7), (300, 8), (400, 8)]


def test_single_match_uniqueness_check_recovers_or_fires():
    """A single_match join over a NON-unique build side must never return
    silently wrong rows.  The staged executor detects the violated
    uniqueness check and falls back to the expansion join (the analog of
    the reference regrowing a too-small hash table, join_hashtable.cpp:1370);
    the whole-plan compiled path (PreparedQuery) still fail-stops."""
    from duckdb_cubit.config import EngineConfig
    from duckdb_cubit.storage.table import Catalog, from_numpy

    def cat():
        c = Catalog()
        c.register(from_numpy("p", {"k": np.array([1, 2], np.int64)}))
        c.register(from_numpy("b", {"k": np.array([1, 1, 2], np.int64),
                                    "v": np.array([5, 6, 7], np.int64)}))
        return c

    def plan():
        return P.HashJoin(P.TableScan("p"), P.TableScan("b"), ["k"], ["k"],
                          "left", single_match=True, build_prefix="b_")

    # staged (default): recovers, result is the correct expanded join
    rows = _exec(cat(), plan())
    got = sorted((int(r[0]), int(r[2])) for r in rows)
    assert got == [(1, 5), (1, 6), (2, 7)]

    # whole-plan compiled path: deferred check fail-stops at materialization
    cfg = EngineConfig(staged_execution=False)
    with pytest.raises(RuntimeError, match="unique"):
        _exec(cat(), plan(), cfg)


def test_statistics_propagation_prunes_filters(conn):
    from duckdb_cubit.plan import optimizer as opt

    # always-true conjunct dropped, always-false marks scan empty
    plan = conn.binder.bind_sql("SELECT k FROM big WHERE v >= 0")
    plan = opt.optimize(plan, conn.catalog)
    scans = [op for op in plan.walk() if isinstance(op, P.TableScan)]
    assert scans[0].filters == [] and scans[0].index_filters == []
    plan = conn.binder.bind_sql("SELECT k FROM big WHERE v > 1000")
    plan = opt.optimize(plan, conn.catalog)
    scans = [op for op in plan.walk() if isinstance(op, P.TableScan)]
    assert getattr(scans[0], "always_false", False)
    rows = conn.sql("SELECT count(*) AS c FROM big WHERE v > 1000").strings()
    assert rows == [["0"]]


def test_pack_range_check_fires_on_out_of_range_second_key():
    from duckdb_cubit.storage.table import Catalog, from_numpy

    cat = Catalog()
    cat.register(from_numpy("p", {
        "a": np.array([1, 2], np.int64),
        "b": np.array([1, -3], np.int64),   # negative second key
        "v": np.array([10, 20], np.int64)}))
    cat.register(from_numpy("b2", {
        "a": np.array([1], np.int64),
        "b": np.array([1], np.int64)}))
    plan = P.HashJoin(P.TableScan("p"), P.TableScan("b2"),
                      ["a", "b"], ["a", "b"], "semi", single_match=False)
    with pytest.raises(RuntimeError, match="join_key_pack_range"):
        _exec(cat, plan)


def test_query_timeout_guard():
    # VERDICT r4 item 10: a runaway query times out with a typed error
    # and the session stays usable (reference interrupt.cpp analog)
    import numpy as np
    import pytest

    from duckdb_cubit.api import Connection, QueryTimeoutError
    from duckdb_cubit.config import EngineConfig

    cfg = EngineConfig()
    cfg.query_timeout_s = 1.5
    conn = Connection(config=cfg)
    n = 40_000
    conn.register_numpy("big", {"k": np.arange(n, dtype=np.int64)})
    with pytest.raises(QueryTimeoutError):
        # cross product of 40K x 40K rows: 1.6B-row expansion
        conn.sql("SELECT count(*) AS c FROM big a, big b "
                 "WHERE a.k + b.k >= 0")
    cfg.query_timeout_s = 0.0
    assert conn.sql("SELECT count(*) AS c FROM big").strings() == [["40000"]]


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30}, 30 << 30),     # half the allocator limit
    (None, 12 << 30),                          # CPU: no allocator stats
    ({"bytes_in_use": 1 << 20}, 12 << 30),     # stats without a limit
])
def test_default_memory_limit_from_device(stats, want):
    from duckdb_cubit import config as C

    assert C.default_memory_limit(_FakeDevice(stats)) == want


def test_memory_limit_defaults_to_device_share_and_stays_settable():
    from duckdb_cubit.config import EngineConfig, default_memory_limit

    assert EngineConfig().memory_limit == default_memory_limit() > 0
    assert EngineConfig(memory_limit=123).memory_limit == 123
    c = Connection()
    c.sql("SET memory_limit = 0")      # 0 after construction: multi-pass off
    assert c.config.memory_limit == 0


@pytest.mark.parametrize("env_dir", [False, True], ids=["unset", "set"])
def test_compile_cache_dir(env_dir, tmp_path):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c",
         "import duckdb_cubit, jax; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(duckdb_cubit.compile_cache_dir())"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    jax_dir, ours = out.stdout.split()
    want = str(tmp_path / "cc") if env_dir else os.path.join(root,
                                                             ".jax_cache")
    assert jax_dir == ours == want
