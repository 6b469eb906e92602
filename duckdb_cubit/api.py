"""User-facing connection API.

Analog of the reference's DuckDB/Connection/ClientContext query lifecycle
(reference src/main/client_context.cpp:697 Query: parse -> plan -> optimize
-> physical plan -> execute): `Connection.sql()` drives the same stages over
the device engine, and `Connection.table_plan()` exposes the plan-builder API
for programs that want to skip SQL.
"""

from __future__ import annotations

from .exec import result as R
from .exec.executor import Executor
from .sql.binder import Binder
from .storage.table import Catalog, from_numpy


class Result:
    def __init__(self, relation, status: str | None = None,
                 static_rows: list | None = None):
        self.relation = relation
        self.status = status
        self._static_rows = static_rows

    def rows(self) -> list[tuple]:
        if self.relation is None:
            return [tuple(r) for r in (self._static_rows or [])]
        _, rows, _ = R.materialize(self.relation)
        return rows

    def strings(self) -> list[list[str]]:
        if self.relation is None:
            return [[str(v) for v in r] for r in (self._static_rows or [])]
        return R.to_strings(self.relation)

    def __repr__(self):
        rows = self.strings()
        if not rows and self.status:
            return self.status
        head = [" | ".join(r) for r in rows[:20]]
        more = f"\n... ({len(rows)} rows)" if len(rows) > 20 else ""
        return "\n".join(head) + more


class QueryTimeoutError(RuntimeError):
    """Query exceeded config.query_timeout_s (reference interrupt.cpp
    analog: the dispatch is abandoned, the session stays usable)."""


class _QueryDeadline:
    """SIGALRM-based per-query deadline (main thread only; a no-op
    elsewhere — worker threads cannot receive SIGALRM)."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.active = False

    def __enter__(self):
        import signal
        import threading

        off_main = (threading.current_thread()
                    is not threading.main_thread())
        if self.seconds <= 0 or off_main:
            return self

        def raise_timeout(signum, frame):
            raise QueryTimeoutError(
                f"query exceeded {self.seconds:.1f}s deadline "
                f"(SET query_timeout_s = 0 to disable)")

        self._old = signal.signal(signal.SIGALRM, raise_timeout)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        self.active = True
        return self

    def __exit__(self, *exc):
        import signal

        if self.active:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self._old)
        return False


class Connection:
    def __init__(self, catalog: Catalog | None = None, config=None,
                 mesh=None):
        from .config import EngineConfig

        self.catalog = catalog if catalog is not None else Catalog()
        self.config = config if config is not None else EngineConfig()
        self.mesh = mesh
        if mesh is not None:
            if self.catalog.tables:
                from .parallel.shard import shard_catalog

                self.catalog = shard_catalog(self.catalog, mesh)
            else:
                # tables arrive later via register_numpy (shard_table);
                # mark the catalog as mesh-placed now so plan caches and
                # the exchange lowering see the placement
                self.catalog.placement = f"mesh{mesh.devices.size}:{id(mesh)}"
                self.catalog.mesh = mesh
        self.executor = Executor(self.catalog, self.config)
        self.binder = Binder(self.catalog, self.executor)
        self._txn_snapshot = None
        self._txn_wal: list[str] | None = None
        # durability (storage/persist.py): when set, DDL/DML statements are
        # WAL-logged under this directory and checkpoint() snapshots to it
        self.db_path: str | None = None

    def attach(self, path: str):
        """Enable durability: subsequent DDL/DML append to `path`'s WAL."""
        import os

        os.makedirs(path, exist_ok=True)
        self.db_path = path
        return self

    def checkpoint(self, path: str | None = None):
        """Snapshot the catalog to disk and truncate the WAL (reference
        CheckpointManager analog)."""
        from .storage.persist import checkpoint as _ckpt

        target = path or self.db_path
        if target is None:
            raise ValueError("no database path: attach(path) first")
        _ckpt(self, target)
        self.db_path = target

    # -------------------------------------------------------------- data in
    def register_numpy(self, name: str, columns: dict, schema=None):
        table = from_numpy(name, columns, schema)
        if self.mesh is not None:
            from .parallel.shard import shard_table

            table = shard_table(table, self.mesh)
        self.catalog.register(table)

    def load_tpch(self, sf: float = 0.01):
        from .tpch import load

        self.catalog = load.load_catalog(sf)
        if self.mesh is not None:
            from .parallel.shard import shard_catalog

            self.catalog = shard_catalog(self.catalog, self.mesh)
        self.executor = Executor(self.catalog, self.config)
        self.binder = Binder(self.catalog, self.executor)
        return self

    # ------------------------------------------------------------- querying
    def sql(self, query: str, profile: bool = False) -> Result:
        from .sql import ast as A
        from .sql.parser import parse_statement

        stmt = parse_statement(query)
        if isinstance(stmt, A.SelectStmt):
            timeout = getattr(self.config, "query_timeout_s", 0.0)
            with _QueryDeadline(timeout):
                plan = self.binder.bind(stmt)
                rel = self.executor.execute(plan, profile=profile)
                # dispatch returns before the device finishes: wait for
                # the result inside the deadline when one is set
                if timeout > 0:
                    rel.count()
            return Result(rel)
        from .sql.statements import execute_statement

        status, rows = execute_statement(self, stmt)
        # durability: log DDL/DML to the WAL after successful execution
        # (reference write_ahead_log.cpp; replayed by
        # storage/persist.open_database, truncated by checkpoint).
        # Inside an open transaction, entries are buffered and only reach
        # the on-disk WAL at COMMIT — a ROLLBACK discards them, so aborted
        # statements can never be resurrected by replay-on-open (reference
        # transaction-local WAL buffering, write_ahead_log.cpp).
        if (getattr(self, "db_path", None)
                and not getattr(self, "_wal_replaying", False)
                and isinstance(stmt, (A.CreateTable, A.CreateIndex,
                                      A.Insert, A.Delete, A.Update,
                                      A.DropTable))):
            if self._txn_wal is not None:
                self._txn_wal.append(query)
            else:
                from .storage.persist import wal_append

                wal_append(self.db_path, query)
        return Result(None, status=status, static_rows=rows)

    # ------------------------------------------------------- transactions
    def begin(self):
        if self._txn_snapshot is not None:
            raise RuntimeError("transaction already active")
        self._txn_snapshot = self.catalog.snapshot()
        self._txn_wal = []

    def commit(self):
        if self._txn_snapshot is None:
            raise RuntimeError("no active transaction")
        # flush buffered WAL entries: the transaction becomes durable only
        # now, and atomically with respect to replay order
        if self.db_path and self._txn_wal:
            from .storage.persist import wal_append

            for q in self._txn_wal:
                wal_append(self.db_path, q)
        self._txn_snapshot = None
        self._txn_wal = None

    def rollback(self):
        if self._txn_snapshot is None:
            raise RuntimeError("no active transaction")
        self.catalog.restore(self._txn_snapshot)
        self._txn_snapshot = None
        self._txn_wal = None

    def execute_plan(self, plan, profile: bool = False) -> Result:
        return Result(self.executor.execute(plan, profile=profile))

    def prepare(self, query: str):
        """PreparedStatement analog: parse/bind/optimize/compile once;
        the returned object's execute() is a single device dispatch."""
        from .exec.executor import PreparedQuery

        plan = self.binder.bind_sql(query)
        return PreparedQuery(self.executor, plan)

    def prepare_plan(self, plan):
        from .exec.executor import PreparedQuery

        return PreparedQuery(self.executor, plan)

    def tpch_query(self, n: int) -> Result:
        from .tpch import queries

        return Result(queries.run(self.executor, n))

    def explain(self, query: str) -> str:
        plan = self.binder.bind_sql(query)
        return self.explain_plan(plan)

    def explain_plan(self, plan) -> str:
        """Operator tree + pipeline decomposition (EXPLAIN analog; the
        pipeline section mirrors the reference's MetaPipeline breakdown,
        meta_pipeline.cpp:69)."""
        from .exec.executor import build_pipelines
        from .plan import optimizer as opt

        plan = opt.optimize(plan, self.catalog)
        lines = []

        def walk(op, d):
            lines.append("  " * d + op.describe())
            for c in op.children:
                walk(c, d + 1)

        walk(plan, 0)
        pipelines = build_pipelines(plan)
        lines.append(f"-- pipelines ({len(pipelines)}):")
        for i, p in enumerate(pipelines):
            deps = [pipelines.index(d) for d in p.dependencies]
            dep_s = f" deps={deps}" if deps else ""
            lines.append(f"  [{i}]{dep_s} {p.describe()}")
        return "\n".join(lines)


def connect(sf: float | None = None, mesh=None) -> Connection:
    """Open a connection; `mesh` distributes storage + execution over a
    jax.sharding.Mesh (tables row-sharded, programs GSPMD-compiled)."""
    conn = Connection(mesh=mesh)
    if sf is not None:
        conn.load_tpch(sf)
    return conn
