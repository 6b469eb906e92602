"""Physical operators.

Analog of the reference's PhysicalOperator tree (reference
src/execution/physical_plan_generator.cpp dispatching 61 logical operator
types; operator interfaces in src/execution/operator/).  This execution
model replaces the source/operator/sink chunk protocol with whole-column
dataflow: every operator consumes and produces a `Relation` — named device
arrays plus a validity mask — and the executor decides pipeline boundaries.

Dynamic cardinalities under static shapes: operators keep their input's
capacity and narrow the mask (filter, PK-FK join) whenever possible; only
operators that must re-shape rows (expansion joins, group-by outputs,
compacting index scans) allocate a new capacity, chosen from host-visible
bounds so compiled shapes stay in a small bucket set.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..index import pk as pk_index
from ..ops import bitmap as bm
from ..ops import join as join_ops
from ..ops import groupby as groupby_ops
from ..ops import kernels
from ..ops.expressions import (ColMeta, EvalContext, Expr, Typed, and_valid,
                               as_mask)
from ..storage.table import Column, Table, pad_count
from ..types import (BOOL, CHAR1, DATE, DOUBLE, INT32, INT64, VARCHAR,
                     DataType, TypeId)


@dataclasses.dataclass
class RelColumn:
    array: jnp.ndarray
    dtype: DataType
    dictionary: np.ndarray | None = None
    domain: np.ndarray | None = None  # sorted distinct values (CHAR1/small int)
    # per-value NULL mask (None = all valid) — analog of the reference's
    # ValidityMask (validity_mask.hpp:50); produced by outer joins and
    # NULL-yielding aggregates, consumed by expressions and aggregates
    valid: jnp.ndarray | None = None


@dataclasses.dataclass
class Relation:
    """A batch of named columns + validity mask (the inter-operator format)."""
    columns: dict[str, RelColumn]
    mask: jnp.ndarray
    capacity: int

    def eval_ctx(self) -> EvalContext:
        arrays = {n: c.array for n, c in self.columns.items()}
        meta = {n: ColMeta(c.dtype, c.dictionary) for n, c in self.columns.items()}
        valids = {n: c.valid for n, c in self.columns.items()
                  if c.valid is not None}
        return EvalContext(arrays, meta, valids)

    def count(self) -> int:
        return int(jnp.sum(self.mask))

    def evaluate(self, expr: Expr) -> Typed:
        return expr.eval(self.eval_ctx())

    def with_mask(self, mask) -> "Relation":
        return Relation(self.columns, mask, self.capacity)

    def gather(self, indices: jnp.ndarray, valid: jnp.ndarray,
               capacity: int) -> "Relation":
        safe = jnp.clip(indices, 0, self.capacity - 1)
        cols = {
            n: RelColumn(jnp.take(c.array, safe, axis=0), c.dtype,
                         c.dictionary, c.domain,
                         None if c.valid is None
                         else jnp.take(c.valid, safe, axis=0))
            for n, c in self.columns.items()
        }
        return Relation(cols, valid, capacity)


class ExecContext:
    def __init__(self, catalog, config=None, profiler=None, traced=False):
        self.catalog = catalog
        self.config = config
        self.profiler = profiler
        self.traced = traced
        # verification leg 3: disable direct-address/fused fast paths so the
        # generic operator paths independently confirm results
        self.verify_mode = False
        # traced mode: per-scan input arrays injected by the executor
        self.scan_inputs: dict[int, dict] = {}
        # traced runtime assertions (name, scalar) verified host-side after run
        self.checks: list[tuple[str, Any]] = []
        # staged execution: id(op) -> stable tag so a failed capacity check
        # maps back to the operator to regrow (executor._handle_failed_checks)
        self.check_tags: dict[int, int] = {}
        self._cache: dict[int, Relation] = {}

    def add_check(self, op, kind: str, ok, cap: int = 0):
        """Attach a deferred runtime assertion.  `kind` in {"expansion",
        "unique"} is recoverable: the staged executor doubles the operator's
        capacity (or falls back from the single-match to the expansion join)
        and retries the stage — the analog of the reference regrowing /
        repartitioning a too-small hash table (join_hashtable.cpp:1370)."""
        tag = self.check_tags.get(id(op), -1)
        self.checks.append((f"{kind}#{tag}#{int(cap)}", ok))


class PhysicalOperator:
    """Base physical operator; `children` gives the pipeline structure."""

    name = "physical_op"

    def __init__(self, children: Sequence["PhysicalOperator"] = ()):
        self.children = list(children)

    def execute(self, ctx: ExecContext) -> Relation:
        key = id(self)
        if key in ctx._cache:
            return ctx._cache[key]
        if ctx.profiler is not None:
            with ctx.profiler.operator(self):
                out = self._execute(ctx)
                # sync so per-operator timings are honest (EXPLAIN ANALYZE)
                jax.block_until_ready(out.mask)
                jax.block_until_ready([c.array for c in out.columns.values()])
                if ctx.profiler.measure_cardinality:
                    out_count = out.count()
                    ctx.profiler.record_cardinality(self, out_count)
        else:
            out = self._execute(ctx)
        ctx._cache[key] = out
        return out

    def _execute(self, ctx: ExecContext) -> Relation:
        raise NotImplementedError

    # pipeline-breaker protocol (analog of reference MetaPipeline building:
    # meta_pipeline.cpp:85 — build sides finish before probes run)
    def is_pipeline_breaker(self) -> bool:
        return False

    def blocking_children(self) -> list["PhysicalOperator"]:
        return []

    def describe(self) -> str:
        return self.name

    # --- compiled execution protocol -----------------------------------
    def prepare(self, ctx: "ExecContext"):
        """Phase A (host): resolve data-dependent shape decisions."""
        for c in self.children:
            c.prepare(ctx)

    def signature(self) -> str:
        """Structural signature for the compiled-plan cache."""
        child_sigs = ",".join(c.signature() for c in self.children)
        return f"{self._self_signature()}({child_sigs})"

    def _self_signature(self) -> str:
        return self.name

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def static_base_table(op: PhysicalOperator) -> str | None:
    """Which base table's row space an operator's output stays aligned to.

    Mask-preserving operators (filters, projections, semi/anti joins and the
    probe side of single-match joins) keep the base table's capacity and row
    order, which lets joins against them use direct-address PK indexes.
    """
    if isinstance(op, TableScan):
        return None if getattr(op, "_decode_cap", None) is not None \
            else op.table_name
    if isinstance(op, (Filter, Limit)):
        return static_base_table(op.children[0])
    if isinstance(op, Project):
        return static_base_table(op.children[0])
    if isinstance(op, HashJoin):
        if op.join_type in ("semi", "anti") or (
                op.single_match and not getattr(op, "_force_expand", False)):
            return static_base_table(op.children[0])
    if isinstance(op, (MarkJoin, BroadcastScalar, Window)):
        # mask-preserving: output rows stay aligned to the probe/child rows
        return static_base_table(op.children[0])
    return None


def relation_from_table(table: Table) -> Relation:
    cols = {
        n: RelColumn(c.data, c.dtype, c.dictionary, getattr(c, "domain", None))
        for n, c in table.columns.items()
    }
    return Relation(cols, table.row_mask(), table.capacity)


class TableScan(PhysicalOperator):
    """Sequential/bitmap/index scan with pushed-down filters.

    The analog of PhysicalTableScan + RowGroup::TemplatedScan (reference
    physical_table_scan.cpp:82, row_group.cpp:448): pushed filters are
    resolved against CUBIT indexes first (segment-wise AND of bin ORs — the
    fork's index-scan hook, table_scan.cpp:296-370); residual predicates
    evaluate as vectorized expressions ANDed into the mask.  When the index
    count is below the decode threshold the scan compacts to row-ids and
    gathers only the projected columns (the IndexScanFunction fetch path,
    table_scan.cpp:251-273); otherwise it stays mask-based.
    """

    name = "table_scan"

    DEFAULT_THRESHOLD = 0.001
    DEFAULT_MAX_COUNT = 1 << 14

    def __init__(self, table_name: str, filters: Sequence[Expr] = (),
                 projection: Sequence[str] | None = None,
                 index_filters: Sequence[tuple] | None = None,
                 decode_threshold: float = DEFAULT_THRESHOLD,
                 decode_max_count: int = DEFAULT_MAX_COUNT):
        super().__init__()
        self.table_name = table_name
        self.filters = list(filters)
        self.projection = list(projection) if projection is not None else None
        # index_filters: [(column, kind, args)] resolved by the optimizer
        self.index_filters = list(index_filters or [])
        self.decode_threshold = decode_threshold
        self.decode_max_count = decode_max_count

    def needed_columns(self, table: Table) -> list[str]:
        if self.projection is None:
            return list(table.columns.keys())
        needed = set(self.projection)
        for f in self.filters:
            needed |= _expr_columns(f)
        return [n for n in table.columns if n in needed]

    def _index_words(self, table: Table):
        """Evaluate pushed index filters -> combined candidate bitvector."""
        index_words = None
        for col_name, kind, args in self.index_filters:
            idx = table.indexes[col_name]
            if kind == "eq":
                words = idx.query_eq(args[0])
            elif kind == "isin":
                words = idx.query_isin(args[0])
            elif kind == "range":
                res = idx.query_range(*args)
                assert res.exact, "non-exact index range needs residual filter"
                words = res.words
            else:
                raise ValueError(kind)
            index_words = words if index_words is None else (index_words & words)
        return index_words

    def _index_count_bound(self, table: Table) -> int | None:
        """Host-side upper bound on the candidate count: min over each index
        filter's exact bin-range cardinality (bins are disjoint, so each
        per-index count is exact; the AND of several can only be smaller)."""
        bound = None
        for col_name, kind, args in self.index_filters:
            idx = table.indexes[col_name]
            if kind == "eq":
                c = idx.count_eq(args[0])
            elif kind == "isin":
                c = idx.count_isin(args[0])
            elif kind == "range":
                c = idx.count_range(*args)
            else:
                c = None
            if c is not None:
                bound = c if bound is None else min(bound, c)
        return bound

    def prepare(self, ctx: ExecContext):
        """Phase A: evaluate index bitvectors (tiny async word ops) and take
        the decode-vs-mask decision from host-side bin cardinalities (the
        reference threshold, table_scan.cpp:348-356).  No device->host pull:
        the decision uses the index's host bin counts, and the decode path's
        exact count stays a traced device scalar.

        The thresholds come from the session config when present (the analog
        of SET index_scan_percentage / index_scan_max_count, reference
        config.hpp:246-253); constructor arguments are plan-level overrides.
        """
        table = ctx.catalog.table(self.table_name)
        threshold = self.decode_threshold
        max_count = self.decode_max_count
        if ctx.config is not None:
            if self.decode_threshold == TableScan.DEFAULT_THRESHOLD:
                threshold = ctx.config.index_scan_percentage
            if self.decode_max_count == TableScan.DEFAULT_MAX_COUNT:
                max_count = ctx.config.index_scan_max_count
        self._words = self._index_words(table)
        self._decode_cap = None
        if self._words is not None and not self.filters:
            n_rows = table.num_rows
            bound = self._index_count_bound(table)
            limit = max(max_count, int(n_rows * threshold))
            if bound is not None and bound <= limit and bound < n_rows // 2:
                cap = pad_count(bound)
                if cap < table.capacity:
                    self._decode_cap = cap

    def _execute(self, ctx: ExecContext) -> Relation:
        table = ctx.catalog.table(self.table_name)
        if not hasattr(self, "_words"):
            self.prepare(ctx)
        inputs = ctx.scan_inputs.get(id(self))
        if inputs is not None:
            cols = inputs["cols"]
            words = inputs.get("words")
            deleted = inputs.get("deleted")
        else:
            cols = {n: table.columns[n].data for n in self.needed_columns(table)}
            words = self._words
            deleted = getattr(table, "deleted", None)
        row_limit = None
        if inputs is not None:
            row_limit = inputs.get("row_limit")
        if row_limit is not None:
            # out-of-core chunked scan: this program sees one chunk of the
            # table; the live-row count within the chunk arrives as a
            # device scalar so ONE compiled program serves every chunk
            capacity = cols[next(iter(cols))].shape[0] if cols \
                else table.capacity
            base_mask = jnp.arange(capacity) < row_limit
        else:
            capacity = table.capacity
            base_mask = jnp.arange(table.capacity) < table.num_rows
        if deleted is not None:
            base_mask = base_mask & ~deleted
        col_nulls = inputs.get("colnulls", {}) if inputs is not None else {
            n: table.columns[n].nulls for n in cols
            if getattr(table.columns[n], "nulls", None) is not None}
        def _valid_of(n):
            nu = col_nulls.get(n)
            if nu is None:
                return None
            if row_limit is not None and nu.shape[0] != capacity:
                nu = nu[:capacity]
            return ~nu
        rel = Relation(
            {n: RelColumn(cols[n], table.columns[n].dtype,
                          table.columns[n].dictionary,
                          getattr(table.columns[n], "domain", None),
                          valid=_valid_of(n))
             for n in cols},
            base_mask,
            capacity)
        if getattr(self, "always_false", False):
            # statistics propagation proved the filters unsatisfiable
            # (zone-map global bounds, the analog of the reference's
            # StatisticsPropagator constant-folding, optimizer.cpp:102)
            return rel.with_mask(jnp.zeros(capacity, jnp.bool_))
        mask = rel.mask
        if words is not None:
            mask = mask & bm.expand(words, rel.capacity)
        for f in self.filters:
            mask = mask & as_mask(rel.evaluate(f))
        rel = rel.with_mask(mask)
        if self._decode_cap is not None:
            # index-scan path: decode row-ids, probe only projected columns
            cap = self._decode_cap
            rowids, count = kernels.mask_to_indices(mask, cap)
            valid = jnp.arange(cap) < count
            rel = rel.gather(rowids, valid, cap)
        return rel

    def _self_signature(self):
        idx = ";".join(f"{c}:{k}:{a}" for c, k, a in self.index_filters)
        decode = getattr(self, "_decode_cap", None)
        ff = getattr(self, "always_false", False)
        return (f"table_scan[{self.table_name};{self.projection};"
                f"{[repr(f) for f in self.filters]};{idx};decode={decode};"
                f"ff={ff}]")

    def describe(self):
        idx = f" index={[(c, k) for c, k, _ in self.index_filters]}" if self.index_filters else ""
        return f"table_scan({self.table_name}{idx}, filters={len(self.filters)})"


def _expr_columns(expr: Expr) -> set[str]:
    from ..ops import expressions as E
    out = set()

    def walk(e):
        if isinstance(e, E.Col):
            out.add(e.name)
        for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                walk(v)
    walk(expr)
    return out


class RangeSource(PhysicalOperator):
    """range(start, stop, step) table function (reference
    src/function/table/range.cpp): a generated integer column."""

    name = "range_source"

    def __init__(self, start: int, stop: int, step: int, colname: str):
        super().__init__()
        assert step != 0
        self.start, self.stop, self.step = start, stop, step
        self.colname = colname
        self.n = max(0, -(-(stop - start) // step))

    def _execute(self, ctx):
        cap = pad_count(max(1, self.n))
        arr = (jnp.arange(cap, dtype=jnp.int64) * self.step + self.start)
        mask = jnp.arange(cap) < self.n
        return Relation(
            {self.colname: RelColumn(arr, INT64, None)}, mask, cap)

    def _self_signature(self):
        return (f"range[{self.start}:{self.stop}:{self.step}:"
                f"{self.colname}]")


class SingleRow(PhysicalOperator):
    """One-row, zero-column source: SELECT <exprs> without FROM (the
    reference's PhysicalDummyScan)."""

    name = "single_row"

    def _execute(self, ctx):
        n = 8192
        mask = jnp.zeros(n, jnp.bool_).at[0].set(True)
        return Relation({}, mask, n)

    def _self_signature(self):
        return "single_row"


class Filter(PhysicalOperator):
    """Streaming filter (analog of PhysicalFilter::ExecuteInternal)."""

    name = "filter"

    def __init__(self, child: PhysicalOperator, expr: Expr):
        super().__init__([child])
        self.expr = expr

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        return rel.with_mask(rel.mask & as_mask(rel.evaluate(self.expr)))

    def _self_signature(self):
        return f"filter[{self.expr!r}]"


class Project(PhysicalOperator):
    """Projection: computed columns (analog of PhysicalProjection).

    `keep_input=True` keeps every input column and adds/overwrites the
    computed ones (used by the binder to materialize group-key expressions
    without enumerating the pass-through set).
    """

    name = "project"

    def __init__(self, child: PhysicalOperator, exprs: dict[str, Expr | str],
                 keep_input: bool = False):
        super().__init__([child])
        self.exprs = exprs
        self.keep_input = keep_input

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        cols = dict(rel.columns) if self.keep_input else {}
        for name, e in self.exprs.items():
            if isinstance(e, str):
                cols[name] = rel.columns[e]
            else:
                t = rel.evaluate(e)
                arr = t.array
                valid = t.valid
                dictionary = t.dictionary
                # constant-folded expressions (literal math, literal concat)
                # broadcast to the row space (reference CONSTANT vectors);
                # scalar validity (e.g. a bare NULL literal) broadcasts too
                if isinstance(arr, str):
                    # string literal projection: a 1-entry dictionary
                    dictionary = np.array([arr.encode()], dtype="S")
                    arr = jnp.zeros(rel.capacity, jnp.int32)
                elif jnp.ndim(arr) == 0:
                    arr = jnp.full(rel.capacity, arr)
                if valid is not None and jnp.ndim(valid) == 0:
                    valid = jnp.full(rel.capacity, valid)
                cols[name] = RelColumn(arr, t.dtype, dictionary,
                                       domain=getattr(t, "domain", None),
                                       valid=valid)
        return Relation(cols, rel.mask, rel.capacity)

    def _self_signature(self):
        return (f"project[{ {n: repr(e) for n, e in self.exprs.items()} };"
                f"keep={self.keep_input}]")


def _combine_keys(ctx, rel: Relation, names: list[str]):
    """Combine key columns into one int64 hash key.

    The 2-column case packs exactly (collision-free) and attaches a
    runtime range check for the low word.  3+ columns hash-combine, and
    EVERY probe path re-verifies the actual key columns after the match
    (collision safety), mirroring the reference's full-key
    ResolvePredicates after the salt prefilter (join_hashtable.cpp:768).
    """
    # float keys go through the injective monotone int64 encoding so
    # equality is exact (an int64 cast would conflate 2.5 and 2.4)
    key = kernels.monotone_i64(rel.columns[names[0]].array)
    if len(names) == 2:
        nxt = kernels.monotone_i64(rel.columns[names[1]].array)
        ok = jnp.all(jnp.where(rel.mask,
                               (nxt >= 0) & (nxt < jnp.int64(1) << 32),
                               True))
        ctx.checks.append((f"join_key_pack_range[{names[1]}]", ok))
        key = (key << jnp.int64(32)) + nxt
    elif len(names) > 2:
        for n in names[1:]:
            nxt = kernels.monotone_i64(rel.columns[n].array)
            key = kernels.hash64(key).astype(jnp.int64) * jnp.int64(2654435761) ^ nxt
    return key


def _exact_key_eq(probe_rel, build_rel, probe_keys, build_keys,
                  probe_rows, build_rows, base):
    """AND `base` with exact equality of every key column pair, gathered
    through explicit row-index vectors (collision re-check)."""
    safe_p = jnp.clip(probe_rows, 0, probe_rel.capacity - 1)
    safe_b = jnp.clip(build_rows, 0, build_rel.capacity - 1)
    for pk, bk in zip(probe_keys, build_keys):
        pa = jnp.take(probe_rel.columns[pk].array, safe_p, axis=0)
        ba = jnp.take(build_rel.columns[bk].array, safe_b, axis=0)
        base = base & (pa.astype(jnp.int64) == ba.astype(jnp.int64))
    return base


class HashJoin(PhysicalOperator):
    """Hash equi-join (analog of PhysicalHashJoin, join_hashtable.cpp).

    join_type: 'inner' | 'semi' | 'anti' | 'left' | 'full'
    `single_match=True` is the PK-FK fast path: the probe relation's shape is
    preserved and build columns are gathered through the matched row (no
    expansion, mask narrows on miss).  The general path expands matches into
    a fresh capacity.  FULL OUTER always expands: unmatched probe rows get
    NULL build columns (as LEFT) and unmatched build rows are appended as an
    extra capacity segment with NULL probe columns (the analog of the
    reference's right-side scan phase after probe,
    physical_hash_join.cpp full-outer GetData).
    """

    name = "hash_join"

    def __init__(self, probe: PhysicalOperator, build: PhysicalOperator,
                 probe_keys: Sequence[str], build_keys: Sequence[str],
                 join_type: str = "inner", single_match: bool = True,
                 out_capacity: int | None = None,
                 build_prefix: str = "", found_column: str | None = None):
        super().__init__([probe, build])
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.join_type = join_type
        self.single_match = single_match
        self.out_capacity = out_capacity
        self.build_prefix = build_prefix
        # left joins: expose the match flag as a named BOOL column (used by
        # decorrelated EXISTS rewrites)
        self.found_column = found_column
        if join_type == "full" and found_column:
            raise ValueError("found_column unsupported for FULL joins")

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _join_keys(self, ctx, rel: Relation, names: list[str]):
        return _combine_keys(ctx, rel, names)

    def _exact_eq(self, probe_rel, build_rel, probe_rows, build_rows, base):
        return _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                             self.build_keys, probe_rows, build_rows, base)

    def prepare(self, ctx: ExecContext):
        super().prepare(ctx)
        # direct-address PK join eligibility: single-column key against a
        # mask-aligned base-table relation that has a dense PK index
        self._pk = None
        self._reverse_pk = None
        if len(self.build_keys) == 1:
            base = static_base_table(self.children[1])
            if base is not None:
                table = ctx.catalog.table(base)
                pk = table.pk_indexes.get(self.build_keys[0])
                if pk is not None:
                    self._pk = (base, self.build_keys[0], pk.max_key)
        if (self._pk is None and self.join_type in ("semi", "anti")
                and len(self.probe_keys) == 1):
            # reverse semi-join: the PROBE side owns the PK (orders EXISTS
            # lineitem): scatter the build side's FK hits into a probe-row
            # flag array — one scatter instead of a hash build
            base = static_base_table(self.children[0])
            if base is not None:
                table = ctx.catalog.table(base)
                pk = table.pk_indexes.get(self.probe_keys[0])
                if pk is not None:
                    self._reverse_pk = (base, self.probe_keys[0], pk.max_key)

    def _pk_probe(self, ctx, probe_rel, build_rel):
        base, col, max_key = self._pk
        inputs = ctx.scan_inputs.get(id(self))
        lut = inputs["pk_lut"] if inputs is not None else \
            ctx.catalog.table(base).pk_indexes[col].lut
        return pk_index.probe(lut, max_key,
                              probe_rel.columns[self.probe_keys[0]].array,
                              probe_rel.mask, build_rel.mask)

    def _execute(self, ctx):
        probe_rel = self.children[0].execute(ctx)
        build_rel = self.children[1].execute(ctx)
        if not hasattr(self, "_pk"):
            self.prepare(ctx)
        if not ctx.verify_mode:
            from ..parallel import exchange_join as XJ

            if XJ.eligible(self, ctx, probe_rel.capacity,
                           build_rel.capacity):
                # explicit radix-exchange lowering: both sides all_to_all
                # to their hash owners, shard-local CSR join (no build
                # replication); reference HashJoinRepartitionTask analog
                self._exchange_used = True
                pkey = self._join_keys(ctx, probe_rel, self.probe_keys)
                bkey = self._join_keys(ctx, build_rel, self.build_keys)
                return XJ.execute(ctx, self, probe_rel, build_rel, pkey,
                                  bkey)
        if self._pk is not None and not ctx.verify_mode and (
                self.single_match or self.join_type in ("semi", "anti")):
            build_row, found = self._pk_probe(ctx, probe_rel, build_rel)
            if self.join_type in ("semi", "anti"):
                m = ~found if self.join_type == "anti" else found
                return probe_rel.with_mask(m & probe_rel.mask)
            return self._gather_single(probe_rel, build_rel, build_row,
                                       found)
        if self._reverse_pk is not None and not ctx.verify_mode:
            base, col, max_key = self._reverse_pk
            inputs = ctx.scan_inputs.get(id(self))
            lut = inputs["pk_lut"] if inputs is not None else \
                ctx.catalog.table(base).pk_indexes[col].lut
            k = build_rel.columns[self.build_keys[0]].array.astype(jnp.int64)
            ok = build_rel.mask & (k >= 0) & (k <= max_key)
            rows = lut[jnp.clip(k, 0, max_key)]
            ok = ok & (rows >= 0)
            tgt = jnp.where(ok, rows, probe_rel.capacity)
            hit = jnp.zeros(probe_rel.capacity + 1, jnp.bool_).at[tgt].set(
                True, mode="drop")[: probe_rel.capacity]
            m = ~hit if self.join_type == "anti" else hit
            return probe_rel.with_mask(probe_rel.mask & m)
        bkey = self._join_keys(ctx, build_rel, self.build_keys)
        pkey = self._join_keys(ctx, probe_rel, self.probe_keys)
        bs = join_ops.build(bkey, build_rel.mask)
        if self.join_type in ("semi", "anti"):
            if len(self.probe_keys) > 2:
                # hash-combined keys can collide: route through expansion +
                # exact re-check + scatter-any (ResolvePredicates analog)
                hit = self._semi_exact(ctx, probe_rel, build_rel, bs, pkey)
                m = ~hit if self.join_type == "anti" else hit
                return probe_rel.with_mask(m & probe_rel.mask)
            m = join_ops.semi_mask(bs, pkey, probe_rel.mask,
                                   anti=self.join_type == "anti")
            return probe_rel.with_mask(m)
        if self.single_match and not getattr(self, "_force_expand", False) \
                and not ctx.verify_mode and self.join_type != "full":
            entry = join_ops.probe(bs, pkey, probe_rel.mask)
            found = entry >= 0
            safe_e = jnp.maximum(entry, 0)
            build_row = jnp.where(found, bs.sorted_rows[bs.starts[safe_e]], -1)
            # single-match contract: the matched build keys must be unique,
            # otherwise inner drops matches / left dups silently (the
            # reference expands chains instead, join_hashtable.cpp:768)
            unique_ok = jnp.all(jnp.where(found, bs.counts[safe_e] <= 1, True))
            ctx.add_check(self, "unique", unique_ok)
            if len(self.probe_keys) > 2:
                probe_rows = jnp.arange(probe_rel.capacity, dtype=jnp.int32)
                found = self._exact_eq(probe_rel, build_rel, probe_rows,
                                       build_row, found)
            return self._gather_single(probe_rel, build_rel, build_row, found)
        return self._expand(ctx, probe_rel, build_rel, bs, pkey)

    def _semi_exact(self, ctx, probe_rel, build_rel, bs, pkey):
        """Exact semi-join hit mask for hash-combined (3+ column) keys."""
        cap = (getattr(self, "_cap_override", None) or self.out_capacity
               or pad_count(probe_rel.capacity))
        entry = join_ops.probe(bs, pkey, probe_rel.mask)
        out_probe, out_build, total = join_ops.expand_matches(
            bs.starts, bs.counts, bs.sorted_rows, entry, probe_rel.mask, cap)
        ctx.add_check(self, "expansion", total <= cap, cap)
        valid = (jnp.arange(cap) < total) & (out_probe >= 0)
        eq = self._exact_eq(probe_rel, build_rel, out_probe, out_build, valid)
        tgt = jnp.where(eq, jnp.maximum(out_probe, 0), probe_rel.capacity)
        return jnp.zeros(probe_rel.capacity + 1, jnp.bool_).at[tgt].set(
            True, mode="drop")[: probe_rel.capacity]

    def _gather_single(self, probe_rel, build_rel, build_row, found):
        safe = jnp.clip(build_row, 0, build_rel.capacity - 1)
        left = self.join_type == "left"
        cols = dict(probe_rel.columns)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name not in cols:
                v = None if c.valid is None else jnp.take(c.valid, safe, axis=0)
                if left:
                    # unmatched probe rows see NULL build values (outer-join
                    # semantics via per-value validity)
                    v = found if v is None else (v & found)
                cols[out_name] = RelColumn(
                    jnp.take(c.array, safe, axis=0), c.dtype, c.dictionary,
                    c.domain, v)
        if left:
            mask = probe_rel.mask
            if self.found_column:
                cols[self.found_column] = RelColumn(found, BOOL, None)
        else:
            mask = probe_rel.mask & found
        return Relation(cols, mask, probe_rel.capacity)

    def _expand(self, ctx, probe_rel, build_rel, bs, pkey):
        left = self.join_type in ("left", "full")
        entry = join_ops.probe(bs, pkey, probe_rel.mask)
        cap = getattr(self, "_cap_override", None) or self.out_capacity
        if cap is None:
            # cardinality guess from the session config (reference analog:
            # statistics-fed build-size estimates, join_hashtable.cpp:1312);
            # the deferred check below catches an undershoot at runtime and
            # the staged executor regrows + retries
            factor = (ctx.config.join_expansion_factor
                      if ctx.config is not None else 1.0)
            cap = pad_count(int(probe_rel.capacity * factor))
        out_probe, out_build, total = join_ops.expand_matches(
            bs.starts, bs.counts, bs.sorted_rows, entry, probe_rel.mask, cap,
            left=left)
        ctx.add_check(self, "expansion", total <= cap, cap)
        valid = jnp.arange(cap) < total
        matched = out_build >= 0
        if len(self.probe_keys) > 2:
            eq = self._exact_eq(probe_rel, build_rel, out_probe, out_build,
                                valid & matched)
            if left:
                matched = matched & eq
            else:
                valid = eq
        out = probe_rel.gather(out_probe, valid, cap)
        cols = dict(out.columns)
        safe_b = jnp.clip(out_build, 0, build_rel.capacity - 1)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name not in cols:
                v = None if c.valid is None else jnp.take(c.valid, safe_b,
                                                          axis=0)
                if left:
                    # unmatched probe rows see NULL build values
                    v = matched if v is None else (v & matched)
                cols[out_name] = RelColumn(
                    jnp.take(c.array, safe_b, axis=0), c.dtype, c.dictionary,
                    c.domain, v)
        if left and self.found_column:
            cols[self.found_column] = RelColumn(matched & valid, BOOL, None)
        if self.join_type == "full":
            return self._append_unmatched_build(
                probe_rel, build_rel, cols, valid, cap, out_build, matched)
        return Relation(cols, valid, cap)

    def _append_unmatched_build(self, probe_rel, build_rel, cols, valid,
                                cap, out_build, matched):
        """FULL OUTER tail: build rows no probe row matched, appended as an
        extra capacity segment with NULL probe columns."""
        bcap = build_rel.capacity
        tgt = jnp.where(matched & valid, jnp.maximum(out_build, 0), bcap)
        hit = jnp.zeros(bcap + 1, jnp.bool_).at[tgt].set(
            True, mode="drop")[:bcap]
        extra_mask = build_rel.mask & ~hit
        probe_names = set(probe_rel.columns)
        out_cols = {}
        for n, c in cols.items():
            if n in probe_names:
                pad = jnp.zeros(bcap, c.array.dtype)
                arr = jnp.concatenate([c.array, pad])
                head_v = c.valid if c.valid is not None \
                    else jnp.ones(cap, jnp.bool_)
                v = jnp.concatenate([head_v, jnp.zeros(bcap, jnp.bool_)])
            else:
                # build-origin column: strip the prefix to find the source
                src = build_rel.columns[n[len(self.build_prefix):]
                                        if n.startswith(self.build_prefix)
                                        and n[len(self.build_prefix):]
                                        in build_rel.columns else n]
                arr = jnp.concatenate([c.array, src.array])
                tail_v = src.valid if src.valid is not None \
                    else jnp.ones(bcap, jnp.bool_)
                head_v = c.valid if c.valid is not None \
                    else jnp.ones(cap, jnp.bool_)
                v = jnp.concatenate([head_v, tail_v])
            out_cols[n] = RelColumn(arr, c.dtype, c.dictionary, c.domain, v)
        out_mask = jnp.concatenate([valid, extra_mask])
        return Relation(out_cols, out_mask, cap + bcap)

    def describe(self):
        return (f"hash_join({self.join_type}, {self.probe_keys}={self.build_keys},"
                f" single={self.single_match})")

    def _self_signature(self):
        return (f"hash_join[{self.join_type};{self.probe_keys};{self.build_keys};"
                f"{self.single_match};{self.out_capacity};{self.build_prefix};"
                f"fc={self.found_column};"
                f"pk={getattr(self, '_pk', None)};"
                f"rpk={getattr(self, '_reverse_pk', None)};"
                f"ov={getattr(self, '_cap_override', None)};"
                f"fe={getattr(self, '_force_expand', False)};"
                f"exq={getattr(self, '_exq_probe', None)},"
                f"{getattr(self, '_exq_build', None)};"
                f"exu={getattr(self, '_exchange_used', False)}]")


def _cmp_arrays(a, op: str, b):
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    raise ValueError(f"unsupported range-join op {op}")


class RangeJoin(PhysicalOperator):
    """Non-equi join (analog of PhysicalPiecewiseMergeJoin /
    PhysicalIEJoin / PhysicalNestedLoopJoin / PhysicalCrossProduct,
    reference src/execution/operator/join/physical_piecewise_merge_join.cpp,
    physical_iejoin.cpp:1-1049, physical_nested_loop_join.cpp).

    Whole-column design: instead of the reference's per-thread merge loops or an
    O(N*M) nested loop, the build side is SORTED on the first condition's
    build expression and each probe row's match set becomes a contiguous
    range located by one vectorized searchsorted (log B, no data-dependent
    control flow).  The range expands through the same static-capacity
    machinery as the hash join, and every REMAINING condition is
    re-checked on the expanded pairs (the ResolvePredicates analog,
    join_hashtable.cpp:768 — here doing IEJoin's second-dimension check).
    An EMPTY condition list is the cross product.

    conditions: [(probe_expr, op, build_expr), ...], op in < <= > >= ==,
    each expr referencing only its own side's columns.  join_type:
    'inner' | 'semi' | 'anti' | 'left' ('left' requires a single driver
    condition; the binder rejects residual conditions on LEFT).
    """

    name = "range_join"

    def __init__(self, probe: PhysicalOperator, build: PhysicalOperator,
                 conditions: Sequence[tuple], join_type: str = "inner",
                 out_capacity: int | None = None, build_prefix: str = ""):
        super().__init__([probe, build])
        self.conditions = list(conditions)
        self.join_type = join_type
        self.out_capacity = out_capacity
        self.build_prefix = build_prefix
        if join_type == "left" and len(self.conditions) > 1:
            raise ValueError("LEFT range join supports one condition")

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _ranges(self, probe_rel: Relation, build_rel: Relation):
        """Per-probe (start, count) into the sorted build order."""
        big = jnp.int64(2**62)
        if not self.conditions:  # cross product: every valid build row
            sort_key = jnp.where(build_rel.mask, jnp.int64(0), big)
            order = jnp.argsort(sort_key)
            nb = jnp.sum(build_rel.mask).astype(jnp.int32)
            start = jnp.zeros(probe_rel.capacity, jnp.int32)
            count = jnp.where(probe_rel.mask, nb, 0)
            return start, count, order
        pe, op, be = self.conditions[0]
        bt = build_rel.evaluate(be)
        pt = probe_rel.evaluate(pe)
        bvalid = build_rel.mask if bt.valid is None \
            else build_rel.mask & bt.valid
        # float-valued conditions compare in double space via the monotone
        # int64 encoding (int64 casts truncated DOUBLE condition values);
        # mixed int/float sides both promote to float64 first
        floating = (jnp.issubdtype(bt.array.dtype, jnp.floating)
                    or jnp.issubdtype(pt.array.dtype, jnp.floating))
        if floating:
            big = jnp.int64(jnp.iinfo(jnp.int64).max)
            bv = kernels.monotone_i64(bt.array.astype(jnp.float64))
            pv = kernels.monotone_i64(pt.array.astype(jnp.float64))
        else:
            bv = bt.array.astype(jnp.int64)
            pv = pt.array.astype(jnp.int64)
        sort_key = jnp.where(bvalid, bv, big)     # invalid rows sort last
        order = jnp.argsort(sort_key)
        sorted_vals = sort_key[order]
        nb = jnp.sum(bvalid).astype(jnp.int32)
        lo = jnp.searchsorted(sorted_vals, pv, side="left").astype(jnp.int32)
        hi = jnp.searchsorted(sorted_vals, pv, side="right").astype(jnp.int32)
        if op == "<":          # probe < build: strictly-greater suffix
            start, count = hi, nb - hi
        elif op == "<=":
            start, count = lo, nb - lo
        elif op == ">":        # probe > build: strictly-smaller prefix
            start, count = jnp.zeros_like(lo), lo
        elif op == ">=":
            start, count = jnp.zeros_like(hi), hi
        elif op == "==":
            start, count = lo, hi - lo
        else:
            raise ValueError(f"unsupported range-join op {op}")
        count = jnp.maximum(count, 0)
        if pt.valid is not None:               # NULL probe value: no match
            count = jnp.where(pt.valid, count, 0)
        return start, count, order

    def _execute(self, ctx):
        probe_rel = self.children[0].execute(ctx)
        build_rel = self.children[1].execute(ctx)
        left = self.join_type == "left"
        start, count, order = self._ranges(probe_rel, build_rel)
        cap = getattr(self, "_cap_override", None) or self.out_capacity
        if cap is None:
            factor = (ctx.config.join_expansion_factor
                      if ctx.config is not None else 1.0)
            cap = pad_count(int(probe_rel.capacity * factor))
        entry = jnp.where(count > 0,
                          jnp.arange(probe_rel.capacity, dtype=jnp.int32),
                          -1)
        out_probe, out_build, total = join_ops.expand_matches(
            start, count, order, entry, probe_rel.mask, cap, left=left)
        ctx.add_check(self, "expansion", total <= cap, cap)
        valid = jnp.arange(cap) < total
        matched = out_build >= 0
        # residual conditions re-checked on the expanded pairs
        keep = valid & matched
        if len(self.conditions) > 1:
            gp = probe_rel.gather(out_probe, keep, cap)
            safe_b = jnp.clip(out_build, 0, build_rel.capacity - 1)
            gb = Relation(
                {n: RelColumn(jnp.take(c.array, safe_b, axis=0), c.dtype,
                              c.dictionary, c.domain,
                              None if c.valid is None
                              else jnp.take(c.valid, safe_b, axis=0))
                 for n, c in build_rel.columns.items()}, keep, cap)
            for pe2, op2, be2 in self.conditions[1:]:
                pt2 = gp.evaluate(pe2)
                bt2 = gb.evaluate(be2)
                c2 = _cmp_arrays(pt2.array, op2, bt2.array)
                if pt2.valid is not None:
                    c2 = c2 & pt2.valid
                if bt2.valid is not None:
                    c2 = c2 & bt2.valid
                keep = keep & c2
        if self.join_type in ("semi", "anti"):
            tgt = jnp.where(keep, jnp.maximum(out_probe, 0),
                            probe_rel.capacity)
            hit = jnp.zeros(probe_rel.capacity + 1, jnp.bool_).at[tgt].set(
                True, mode="drop")[: probe_rel.capacity]
            m = ~hit if self.join_type == "anti" else hit
            return probe_rel.with_mask(m & probe_rel.mask)
        out_valid = (valid if left else keep)
        out = probe_rel.gather(out_probe, out_valid, cap)
        cols = dict(out.columns)
        safe_b = jnp.clip(out_build, 0, build_rel.capacity - 1)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name not in cols:
                v = None if c.valid is None else jnp.take(c.valid, safe_b,
                                                          axis=0)
                if left:    # unmatched probe rows see NULL build values
                    v = matched if v is None else (v & matched)
                cols[out_name] = RelColumn(
                    jnp.take(c.array, safe_b, axis=0), c.dtype, c.dictionary,
                    c.domain, v)
        return Relation(cols, out_valid, cap)

    def describe(self):
        conds = [f"{p!r}{op}{b!r}" for p, op, b in self.conditions] or ["x"]
        return f"range_join({self.join_type}, {', '.join(conds)})"

    def _self_signature(self):
        conds = ";".join(f"{p!r}{op}{b!r}" for p, op, b in self.conditions)
        return (f"range_join[{self.join_type};{conds};{self.out_capacity};"
                f"{self.build_prefix};ov={getattr(self, '_cap_override', None)}]")


@dataclasses.dataclass
class Aggregate:
    kind: str                 # sum | count | min | max | avg | sum_double
    expr: Expr | None         # None for count(*)
    name: str


class GroupAggregate(PhysicalOperator):
    """Grouped aggregation (analog of PhysicalHashAggregate /
    PhysicalPerfectHashAggregate / PhysicalUngroupedAggregate).

    Picks the dense mixed-radix path when all group keys are dictionary /
    CHAR1 / small-int domains; otherwise the sort-based grouping.  With no
    keys it is the ungrouped single-row aggregate.
    """

    name = "group_aggregate"

    DEFAULT_DENSE_LIMIT = 1 << 22

    def __init__(self, child: PhysicalOperator, keys: Sequence[str],
                 aggregates: Sequence[Aggregate],
                 carry: Sequence[str] = (),
                 dense_domain_limit: int = DEFAULT_DENSE_LIMIT):
        super().__init__([child])
        self.keys = list(keys)
        self.aggregates = list(aggregates)
        # columns functionally dependent on the keys, carried through the
        # group via a representative row (c_name etc. in Q3/Q10/Q18)
        self.carry = list(carry)
        self.dense_domain_limit = dense_domain_limit

    def is_pipeline_breaker(self):
        return True

    def _self_signature(self):
        aggs = ";".join(f"{a.kind}:{a.name}:{a.expr!r}" for a in self.aggregates)
        return (f"group_aggregate[{self.keys};{self.carry};{aggs};"
                f"fk={getattr(self, '_fk_dense', None)}]")

    def prepare(self, ctx: ExecContext):
        super().prepare(ctx)
        # FK-dense grouping: a single key that is a registered foreign key
        # with a direct PK index groups straight into the referenced table's
        # row space (the perfect-hash-aggregate analog, driven by schema
        # stats instead of zone maps)
        self._fk_dense = None
        if len(self.keys) == 1:
            fk = ctx.catalog.foreign_keys.get(self.keys[0]) \
                if hasattr(ctx.catalog, "foreign_keys") else None
            if fk is not None:
                pk_table, pk_col = fk
                table = ctx.catalog.table(pk_table)
                pk = table.pk_indexes.get(pk_col)
                if pk is not None:
                    self._fk_dense = (pk_table, pk_col, pk.max_key,
                                      table.capacity)

    def _execute(self, ctx):
        fused = None if ctx.verify_mode else self._fused_scan_sum(ctx)
        if fused is not None:
            return fused
        rel = self.children[0].execute(ctx)
        if not hasattr(self, "_fk_dense"):
            self.prepare(ctx)
        if ctx.verify_mode:
            self._fk_dense = None
        # unroll-vs-scatter strategy threshold (SET small_group_limit)
        self._small = (ctx.config.small_group_limit
                       if ctx.config is not None else kernels.SMALL_GROUP_LIMIT)
        evaluated: dict[str, Typed] = {}
        for agg in self.aggregates:
            if agg.expr is not None:
                evaluated[agg.name] = rel.evaluate(agg.expr)
        if not self.keys:
            return self._ungrouped(rel, evaluated)
        if self._fk_dense is not None:
            pk_table, pk_col, max_key, num_groups = self._fk_dense
            inputs = ctx.scan_inputs.get(id(self))
            lut = inputs["pk_lut"] if inputs is not None else \
                ctx.catalog.table(pk_table).pk_indexes[pk_col].lut
            key = rel.columns[self.keys[0]].array.astype(jnp.int64)
            in_range = (key >= 0) & (key <= max_key)
            gid = lut[jnp.clip(key, 0, max_key)]
            valid = rel.mask & in_range & (gid >= 0)
            gids = jnp.maximum(gid, 0).astype(jnp.int32)
            if num_groups > self._small:
                rep = jnp.zeros(num_groups, jnp.int32)  # sorted path recomputes
            else:
                rows = jnp.arange(rel.capacity, dtype=jnp.int32)
                rep = jnp.full(num_groups + 1, -1, jnp.int32).at[
                    jnp.where(valid, gids, num_groups)].max(rows)[:num_groups]
            out_cols, out_mask = self._aggregate(rel, evaluated, gids, valid,
                                                 num_groups, rep)
            return Relation(out_cols, out_mask, num_groups)
        # choose grouping strategy
        dense_sizes = []
        dense_codes = []
        # NULLable keys can't use dense codes (NULL is its own group)
        dense_ok = all(rel.columns[k].valid is None for k in self.keys)
        for k in self.keys:
            if not dense_ok:
                break
            c = rel.columns[k]
            if c.dtype.id == TypeId.VARCHAR and c.dictionary is not None:
                dense_sizes.append(len(c.dictionary))
                dense_codes.append(c.array)
            elif c.dtype.id == TypeId.CHAR1 and c.domain is not None:
                # compact byte values to [0, |domain|) via a 256-entry LUT
                lut = np.zeros(256, np.int32)
                lut[c.domain] = np.arange(len(c.domain), dtype=np.int32)
                dense_sizes.append(len(c.domain))
                dense_codes.append(jnp.asarray(lut)[c.array.astype(jnp.int32)])
            elif c.dtype.id == TypeId.CHAR1:
                dense_sizes.append(256)
                dense_codes.append(c.array)
            elif c.dtype.id in (TypeId.INT32, TypeId.INT64, TypeId.DATE,
                                TypeId.DECIMAL) and c.domain is not None:
                # small int/date domains (zone-map bounds at ingest, or
                # propagated through extract(year) etc.): perfect-hash
                # grouping instead of a full sort — the
                # PhysicalPerfectHashAggregate statistics decision
                dense_sizes.append(len(c.domain))
                lo = int(c.domain[0])
                contiguous = int(c.domain[-1]) - lo + 1 == len(c.domain)
                if contiguous:
                    dense_codes.append(
                        (c.array.astype(jnp.int64) - lo).astype(jnp.int32))
                else:
                    dense_codes.append(jnp.searchsorted(
                        jnp.asarray(c.domain),
                        c.array.astype(jnp.int64)).astype(jnp.int32))
            else:
                dense_ok = False
                break
        dense_limit = self.dense_domain_limit
        if (ctx.config is not None
                and dense_limit == GroupAggregate.DEFAULT_DENSE_LIMIT):
            dense_limit = ctx.config.dense_domain_limit
        total = int(np.prod(dense_sizes)) if dense_ok else None
        if dense_ok and total <= dense_limit and not self.carry:
            codes, num_groups = groupby_ops.mixed_radix_codes(
                dense_codes, dense_sizes)
            gids, valid = codes, rel.mask
            rep = None
        else:
            # NULL keys form one group: a leading null-flag key per
            # nullable column, with the value normalized under NULL so
            # garbage payloads don't split the group (SQL GROUP BY
            # NULL-equality, reference grouped_aggregate_data.cpp)
            key_arrays = []
            for k in self.keys:
                c = rel.columns[k]
                enc = kernels.monotone_i64(c.array)
                if c.valid is not None:
                    key_arrays.append((~c.valid).astype(jnp.int64))
                    enc = jnp.where(c.valid, enc, jnp.int64(0))
                key_arrays.append(enc)
            gk = groupby_ops.group_by_sort(tuple(key_arrays), rel.mask,
                                           rel.capacity)
            gids, valid, num_groups, rep = (
                gk.group_ids, gk.valid, rel.capacity, gk.rep_rows)
        out_cols, out_mask = self._aggregate(rel, evaluated, gids, valid,
                                             num_groups, rep)
        return Relation(out_cols, out_mask, num_groups)

    def _fused_pattern(self, ctx):
        """Host-side check for the fused bitmap-scan + SUM pattern.

        Matches `SUM(col)` / `SUM(a*b)` over a pure index scan (every
        predicate answered by CUBIT bitvectors).  Returns the host facts
        the fused paths need, or None.  Value bounds come from zone maps
        (the analog of the reference's statistics-driven perfect-hash
        decisions)."""
        if self.keys or len(self.aggregates) != 1:
            return None
        agg = self.aggregates[0]
        if agg.kind != "sum" or agg.expr is None:
            return None
        from ..ops.expressions import Arith
        from ..ops.expressions import Col as ECol

        e = agg.expr
        if isinstance(e, Arith) and e.op == "*" and \
                isinstance(e.left, ECol) and isinstance(e.right, ECol):
            col_names = [e.left.name, e.right.name]
        elif isinstance(e, ECol):
            col_names = [e.name]
        else:
            return None
        child = self.children[0]
        if not isinstance(child, TableScan):
            return None
        if not hasattr(child, "_words"):
            child.prepare(ctx)
        if child._words is None or child.filters or \
                child._decode_cap is not None or \
                getattr(child, "always_false", False):
            return None
        table = ctx.catalog.table(child.table_name)
        if getattr(table, "deleted", None) is not None:
            return None
        if table.capacity % 8192 != 0:
            return None
        scale = 0
        maxes = []
        nonneg = True
        for cn in col_names:
            c = table.columns.get(cn)
            if c is None or c.dtype.id not in (TypeId.DECIMAL, TypeId.INT32,
                                               TypeId.INT64):
                return None
            if c.zone_map is None:
                return None
            if c.dtype.id == TypeId.DECIMAL:
                scale += c.dtype.scale
            lo = int(c.zone_map.mins.min())
            hi = int(c.zone_map.maxs.max())
            nonneg &= lo >= 0
            maxes.append(max(abs(lo), abs(hi), 1))
        prod_max = 1
        for m in maxes:
            prod_max *= m
        return {"agg": agg, "child": child, "table": table,
                "cols": col_names, "scale": scale,
                "nonneg": nonneg, "prod_max": prod_max}

    def _fused_scan_sum(self, ctx):
        """Fused bitmap-scan + ungrouped SUM — the Q6 hot path.

        Sums straight from the scan's CUBIT words (0.125 B/row): XLA fuses
        the bit unpack into the reduction, so no row mask is written.
        Products that fit int32 take that path; wider products go through
        the exact hi/lo split.  Disabled under chunked (out-of-core)
        execution — the fused arrays are planned at full-table shapes.
        """
        if getattr(ctx, "no_fused", False):
            return None
        info = self._fused_pattern(ctx)
        if info is None:
            return None
        agg, child, table = info["agg"], info["child"], info["table"]
        col_names, scale = info["cols"], info["scale"]
        inputs = ctx.scan_inputs.get(id(child))
        if inputs is not None:
            arrays = [inputs["cols"][cn] for cn in col_names]
            words = inputs["words"]
        else:
            arrays = [table.columns[cn].data for cn in col_names]
            words = child._words
        if info["nonneg"] and info["prod_max"] < 2**31:
            val = arrays[0].astype(jnp.int32)
            for a in arrays[1:]:
                val = val * a.astype(jnp.int32)
            total = bm.words_sum(words, val)
        else:
            val = arrays[0].astype(jnp.int64)
            for a in arrays[1:]:
                val = val * a.astype(jnp.int64)
            hi, lo = kernels.masked_sum_exact(
                val, bm.expand(words, table.capacity))
            total = (hi << jnp.int64(32)) + lo
        cnt = bm.popcount(words)
        dt = DataType(TypeId.DECIMAL, scale) if scale else INT64
        out = {agg.name: RelColumn(total[None], dt, None)}
        # sum over an empty input is NULL -> zero result rows (matches the
        # generic _ungrouped null_on_empty handling)
        return Relation(out, (cnt > 0)[None], 1)

    def _aggregate(self, rel, evaluated, gids, valid, num_groups, rep):
        if num_groups > self._small:
            # large group domains: reduce in group-sorted order instead of
            # a scatter-add with colliding indices (sort + cumsum +
            # boundary gathers; see kernels.py "sorted segment ops")
            return self._aggregate_sorted(rel, evaluated, gids, valid,
                                          num_groups, rep)
        counts = kernels.group_count(gids, valid, num_groups,
                                     small_limit=self._small)
        occupied = counts > 0
        out_cols: dict[str, RelColumn] = {}
        # group key columns
        if rep is None:
            out_cols.update(self._dense_key_columns(rel, num_groups))
        else:
            safe_rep = jnp.clip(rep, 0, rel.capacity - 1)
            for k in list(self.keys) + list(self.carry):
                c = rel.columns[k]
                out_cols[k] = RelColumn(
                    jnp.take(c.array, safe_rep, axis=0), c.dtype,
                    c.dictionary,
                    valid=None if c.valid is None
                    else jnp.take(c.valid, safe_rep, axis=0))
        for agg in self.aggregates:
            out_cols[agg.name] = self._one_agg(agg, evaluated, gids, valid,
                                               num_groups, counts)
        return out_cols, occupied

    def _aggregate_sorted(self, rel, evaluated, gids, valid, num_groups, rep):
        gid_sorted, srows = kernels.sort_by_group(gids, valid)
        start, end = kernels.segment_bounds(gid_sorted, num_groups)
        counts = (end - start).astype(jnp.int64)
        occupied = counts > 0
        out_cols: dict[str, RelColumn] = {}
        n = gids.shape[0]
        safe_start = jnp.minimum(start, n - 1)
        if rep is None and self.keys:
            # dense-code grouping: keys reconstructed from code arithmetic
            out_cols.update(self._dense_key_columns(rel, num_groups))
        else:
            rep_rows = jnp.where(occupied, srows[safe_start], 0)
            safe_rep = jnp.clip(rep_rows, 0, rel.capacity - 1)
            for k in list(self.keys) + list(self.carry):
                c = rel.columns[k]
                out_cols[k] = RelColumn(
                    jnp.take(c.array, safe_rep, axis=0), c.dtype,
                    c.dictionary,
                    valid=None if c.valid is None
                    else jnp.take(c.valid, safe_rep, axis=0))
        for agg in self.aggregates:
            out_cols[agg.name] = self._one_agg_sorted(
                agg, evaluated, gids, valid, num_groups, counts,
                srows, start, end)
        return out_cols, occupied

    def _one_agg_sorted(self, agg, evaluated, gids, valid, num_groups, counts,
                        srows, start, end):
        if agg.kind == "count" and agg.expr is None:
            return RelColumn(counts, INT64, None)
        t = evaluated[agg.name]
        avalid = valid if t.valid is None else (valid & t.valid)
        v_sorted = jnp.take(t.array, srows, axis=0)
        avalid_sorted = jnp.take(avalid, srows, axis=0)
        if t.valid is not None or agg.kind == "count":
            nonnull = kernels.segment_count(avalid_sorted, start, end)
            out_valid = None if t.valid is None else (nonnull > 0)
        else:
            nonnull, out_valid = counts, None
        if agg.kind == "count":
            return RelColumn(nonnull, INT64, None)
        if agg.kind in ("sum", "avg") and t.dtype.id in (
                TypeId.DECIMAL, TypeId.INT32, TypeId.INT64):
            hi, lo = kernels.segment_sum_exact(
                v_sorted.astype(jnp.int64), avalid_sorted, start, end)
            combined = (hi << jnp.int64(32)) + lo
            if agg.kind == "sum":
                return RelColumn(combined, DataType(TypeId.DECIMAL, t.dtype.scale)
                                 if t.dtype.id == TypeId.DECIMAL else INT64,
                                 None, valid=out_valid)
            scale = 10.0 ** t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 1.0
            avg = (hi.astype(jnp.float64) * (2.0**32) + lo.astype(jnp.float64)) \
                / jnp.maximum(nonnull, 1).astype(jnp.float64) / scale
            return RelColumn(avg, DOUBLE, None, valid=out_valid)
        if agg.kind in ("sum", "avg", "sum_double"):
            v = jnp.where(avalid_sorted, v_sorted.astype(jnp.float64)
                          if t.dtype.id != TypeId.DOUBLE else v_sorted, 0.0)
            if t.dtype.id == TypeId.DECIMAL:
                v = v / (10.0 ** t.dtype.scale)
            csum = jnp.cumsum(v)
            s = kernels._segment_sum_from_cumsum(csum, start, end)
            if agg.kind == "avg":
                s = s / jnp.maximum(nonnull, 1).astype(jnp.float64)
            return RelColumn(s, DOUBLE, None, valid=out_valid)
        if agg.kind in ("min", "max"):
            # float values go through the monotone int64 encoding so the
            # int64 min/max machinery is exact; empty-group sentinels use
            # the int64 extremes (encoded doubles span nearly all of int64)
            floating = jnp.issubdtype(t.array.dtype, jnp.floating)
            enc = kernels.monotone_i64(t.array)
            want_max = agg.kind == "max"
            sentinel = jnp.int64(jnp.iinfo(jnp.int64).min if want_max
                                 else jnp.iinfo(jnp.int64).max)
            r = kernels.segment_minmax(gids, enc, avalid, num_groups,
                                       sentinel, want_max=want_max)
            r = kernels.monotone_i64_inverse(r, floating)
            return RelColumn(r, t.dtype, t.dictionary, valid=out_valid)
        raise ValueError(agg.kind)

    def _dense_key_columns(self, rel, num_groups):
        """Reconstruct key values from dense mixed-radix codes (must mirror
        the size/code scheme of the dense decision in _execute)."""
        out_cols: dict[str, RelColumn] = {}
        sizes = []
        for k in self.keys:
            c = rel.columns[k]
            if c.dtype.id == TypeId.VARCHAR:
                sizes.append(len(c.dictionary))
            elif c.domain is not None:
                sizes.append(len(c.domain))
            else:
                sizes.append(256)
        gcodes = jnp.arange(num_groups, dtype=jnp.int32)
        rem = gcodes
        for k, size in reversed(list(zip(self.keys, sizes))):
            c = rel.columns[k]
            kv = rem % size
            rem = rem // size
            if c.dtype.id == TypeId.VARCHAR:
                kv = kv.astype(np.int32)
            elif c.domain is not None:
                kv = jnp.asarray(c.domain)[kv].astype(c.array.dtype)
            else:
                kv = kv.astype(jnp.uint8)
            out_cols[k] = RelColumn(kv, c.dtype, c.dictionary, c.domain)
        return dict(reversed(list(out_cols.items())))

    def _one_agg(self, agg, evaluated, gids, valid, num_groups, counts):
        if agg.kind == "count" and agg.expr is None:
            return RelColumn(counts, INT64, None)
        t = evaluated[agg.name]
        # NULL semantics: aggregates skip NULL inputs (count(expr) counts
        # only non-NULL; sum/min/max/avg over an all-NULL group are NULL) —
        # the reference's ValidityMask-aware aggregate states
        avalid = valid if t.valid is None else (valid & t.valid)
        if t.valid is not None or agg.kind == "count":
            nonnull = kernels.group_count(gids, avalid, num_groups,
                                          small_limit=self._small)
            out_valid = None if t.valid is None else (nonnull > 0)
        else:
            nonnull, out_valid = counts, None
        if agg.kind == "count":
            return RelColumn(nonnull, INT64, None)
        if agg.kind in ("sum", "avg") and t.dtype.id in (
                TypeId.DECIMAL, TypeId.INT32, TypeId.INT64):
            hi, lo = kernels.group_sum_exact(
                gids, t.array.astype(jnp.int64), avalid, num_groups,
                small_limit=self._small)
            combined = (hi << jnp.int64(32)) + lo
            if agg.kind == "sum":
                return RelColumn(combined, DataType(TypeId.DECIMAL, t.dtype.scale)
                                 if t.dtype.id == TypeId.DECIMAL else INT64,
                                 None, valid=out_valid)
            scale = 10.0 ** t.dtype.scale if t.dtype.id == TypeId.DECIMAL else 1.0
            avg = (hi.astype(jnp.float64) * (2.0**32) + lo.astype(jnp.float64)) \
                / jnp.maximum(nonnull, 1).astype(jnp.float64) / scale
            return RelColumn(avg, DOUBLE, None, valid=out_valid)
        if agg.kind in ("sum", "avg", "sum_double"):
            v = jnp.where(avalid, t.array.astype(jnp.float64)
                          if t.dtype.id != TypeId.DOUBLE else t.array, 0.0)
            if t.dtype.id == TypeId.DECIMAL:
                v = v / (10.0 ** t.dtype.scale)
            s = jnp.zeros(num_groups, jnp.float64).at[
                jnp.where(avalid, gids, 0)].add(v)
            if agg.kind == "avg":
                s = s / jnp.maximum(nonnull, 1).astype(jnp.float64)
            return RelColumn(s, DOUBLE, None, valid=out_valid)
        if agg.kind in ("min", "max"):
            floating = jnp.issubdtype(t.array.dtype, jnp.floating)
            enc = kernels.monotone_i64(t.array)
            if agg.kind == "min":
                r = kernels.group_min(gids, enc, avalid, num_groups,
                                      jnp.int64(jnp.iinfo(jnp.int64).max),
                                      small_limit=self._small)
            else:
                r = kernels.group_max(gids, enc, avalid, num_groups,
                                      jnp.int64(jnp.iinfo(jnp.int64).min),
                                      small_limit=self._small)
            r = kernels.monotone_i64_inverse(r, floating)
            return RelColumn(r, t.dtype, t.dictionary, valid=out_valid)
        raise ValueError(agg.kind)

    def _ungrouped(self, rel, evaluated):
        out_cols = {}
        for agg in self.aggregates:
            if agg.kind == "count" and agg.expr is None:
                out_cols[agg.name] = RelColumn(
                    jnp.sum(rel.mask.astype(jnp.int64))[None], INT64, None)
                continue
            t = evaluated[agg.name]
            amask = rel.mask if t.valid is None else (rel.mask & t.valid)
            out_valid = None if t.valid is None else jnp.any(amask)[None]
            if agg.kind == "count":
                out_cols[agg.name] = RelColumn(
                    jnp.sum(amask.astype(jnp.int64))[None], INT64, None)
            elif agg.kind == "sum" and t.dtype.id in (TypeId.DECIMAL,
                                                      TypeId.INT32,
                                                      TypeId.INT64):
                hi, lo = kernels.masked_sum_exact(
                    t.array.astype(jnp.int64), amask)
                combined = (hi << jnp.int64(32)) + lo
                out_cols[agg.name] = RelColumn(
                    combined[None], DataType(TypeId.DECIMAL, t.dtype.scale)
                    if t.dtype.id == TypeId.DECIMAL else INT64, None,
                    valid=out_valid)
            elif agg.kind in ("sum", "sum_double", "avg"):
                v = jnp.where(amask, t.array.astype(jnp.float64), 0.0)
                if t.dtype.id == TypeId.DECIMAL:
                    v = v / (10.0 ** t.dtype.scale)
                s = jnp.sum(v)
                if agg.kind == "avg":
                    s = s / jnp.maximum(jnp.sum(amask), 1)
                out_cols[agg.name] = RelColumn(s[None], DOUBLE, None,
                                               valid=out_valid)
            elif agg.kind in ("min", "max"):
                floating = jnp.issubdtype(t.array.dtype, jnp.floating)
                enc = kernels.monotone_i64(t.array)
                if agg.kind == "min":
                    v = jnp.where(amask, enc,
                                  jnp.int64(jnp.iinfo(jnp.int64).max))
                    r = jnp.min(v)
                else:
                    v = jnp.where(amask, enc,
                                  jnp.int64(jnp.iinfo(jnp.int64).min))
                    r = jnp.max(v)
                r = kernels.monotone_i64_inverse(r, floating)
                out_cols[agg.name] = RelColumn(r[None], t.dtype,
                                               t.dictionary, valid=out_valid)
            else:
                raise ValueError(agg.kind)
        # sum/avg/min/max over an empty input are NULL; the golden answers
        # render that as zero result rows (count() still yields a row)
        null_on_empty = all(a.kind != "count" for a in self.aggregates)
        out_mask = (jnp.any(rel.mask)[None] if null_on_empty
                    else jnp.ones(1, jnp.bool_))
        return Relation(out_cols, out_mask, 1)


def _compact_groups(rel: Relation) -> Relation:
    """Drop empty group slots so downstream capacities track group counts."""
    count = rel.count()
    cap = pad_count(count)
    if cap >= rel.capacity:
        return rel
    idx, _ = kernels.mask_to_indices(rel.mask, cap)
    valid = jnp.arange(cap) < count
    return rel.gather(idx, valid, cap)


class OrderBy(PhysicalOperator):
    """Sort + optional limit (analog of PhysicalOrder / PhysicalTopN).

    Device multi-key sort via lax.sort; DESC encodes by key negation (codes
    and ints) or sign-flipped bits (doubles).
    """

    name = "order_by"

    def __init__(self, child: PhysicalOperator, keys: Sequence[tuple[str, bool]],
                 limit: int | None = None):
        super().__init__([child])
        self.keys = list(keys)  # (column, descending)
        self.limit = limit

    def is_pipeline_breaker(self):
        return True

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        n = rel.capacity
        operands = []
        for name, desc in self.keys:
            c = rel.columns[name]
            # total-order encode: floats through the sign-flip bijection
            # (kernels.monotone_i64), ints as-is; DESC via bitwise NOT
            # (~a = -a-1 is a monotone-decreasing bijection on int64, no
            # -INT64_MIN overflow).  NULLS/masked rows are ordered by a
            # separate class operand (0=value, 1=NULL, 2=masked) instead of
            # in-band sentinels, so legitimate keys near the int64 extremes
            # can never collide with them.
            if c.dtype.id == TypeId.DOUBLE:
                a = kernels.monotone_i64(c.array)
            else:
                a = c.array.astype(jnp.int64)
            key = jnp.where(desc, ~a, a)
            cls = jnp.where(rel.mask, jnp.int8(0), jnp.int8(2))
            if c.valid is not None:
                # default NULLS LAST (before masked rows); SET
                # default_null_order='nulls_first' flips it (reference
                # config default_null_order)
                first = (ctx.config is not None and getattr(
                    ctx.config, "default_null_order", "nulls_last")
                    == "nulls_first")
                nullcls = jnp.int8(-1 if first else 1)
                cls = jnp.where(rel.mask & ~c.valid, nullcls, cls)
            operands.append(cls)
            operands.append(key)
        rows = jnp.arange(n, dtype=jnp.int32)
        out = jax.lax.sort(tuple(operands) + (rows,), num_keys=len(operands))
        perm = out[-1]
        total = jnp.sum(rel.mask.astype(jnp.int64))
        cap = rel.capacity if self.limit is None else min(
            pad_count(self.limit), rel.capacity)
        limit = total if self.limit is None else jnp.minimum(
            total, self.limit)
        valid = jnp.arange(cap) < limit
        return rel.gather(perm[:cap], valid, cap)

    def _self_signature(self):
        return f"order_by[{self.keys};{self.limit}]"


class Limit(PhysicalOperator):
    name = "limit"

    def __init__(self, child: PhysicalOperator, limit: int):
        super().__init__([child])
        self.limit = limit

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        keep = rel.mask & (jnp.cumsum(rel.mask.astype(jnp.int64)) <= self.limit)
        return rel.with_mask(keep)

    def _self_signature(self):
        return f"limit[{self.limit}]"


class BroadcastScalar(PhysicalOperator):
    """Attach a 1-row subplan's columns to every row of the child.

    The device-side uncorrelated-scalar-subquery operator: where the
    reference's plans nest a scalar subquery result into expressions
    (src/planner subquery flattening into a cross product with a one-row
    aggregate), this broadcasts the value in the SAME compiled program — no
    host round trip between the sub-aggregate and the consuming filter.
    names: {output column name: subplan column name}.
    """

    name = "broadcast_scalar"

    def __init__(self, child: PhysicalOperator, sub: PhysicalOperator,
                 names: dict[str, str]):
        super().__init__([child, sub])
        self.names = dict(names)

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _execute(self, ctx):
        rel = self.children[0].execute(ctx)
        sub = self.children[1].execute(ctx)
        cols = dict(rel.columns)
        # the subplan's single row may itself be NULL / absent (empty input)
        present = sub.mask[0] if sub.capacity == 1 else sub.mask[:1][0]
        for out_name, sub_name in self.names.items():
            c = sub.columns[sub_name]
            arr = jnp.broadcast_to(c.array[0], (rel.capacity,))
            valid = jnp.broadcast_to(
                present if c.valid is None else (present & c.valid[0]),
                (rel.capacity,))
            cols[out_name] = RelColumn(arr, c.dtype, c.dictionary, c.domain,
                                       valid)
        return Relation(cols, rel.mask, rel.capacity)

    def _self_signature(self):
        return f"broadcast_scalar[{sorted(self.names.items())}]"

    def describe(self):
        return f"broadcast_scalar({list(self.names)})"


@dataclasses.dataclass
class WindowFunc:
    kind: str                 # row_number|rank|dense_rank|lead|lag|
    #                           first_value|last_value|sum|avg|min|max|
    #                           count|total
    expr: Expr | None         # value expression (None: row_number/count(*))
    name: str                 # output column
    offset: int = 1           # lead/lag distance
    default: Any = None       # lead/lag default (None -> NULL)
    # frame: legacy string (rows_upto | range_upto | partition) or a
    # sliding tuple (mode, lo, hi), mode in {"rows","range"}, lo/hi int
    # offsets with None = UNBOUNDED (ops/window.py frame_bounds).
    # None -> range_upto with ORDER BY, else whole partition (reference
    # default frame).
    frame: object | None = None


class Window(PhysicalOperator):
    """Window functions over partitions (analog of PhysicalWindow,
    reference physical_window.cpp; kernels in ops/window.py replace the
    segment trees with sorted segmented prefix scans)."""

    name = "window"

    def __init__(self, child: PhysicalOperator,
                 partition_by: Sequence[str],
                 order_by: Sequence[tuple[str, bool]],
                 functions: Sequence[WindowFunc]):
        super().__init__([child])
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.functions = list(functions)

    def is_pipeline_breaker(self):
        return True

    def _key_arrays(self, rel):
        # float keys go through the monotone int64 encoding (ADVICE r3:
        # int64 casts silently truncated DOUBLE partition/order keys);
        # NULLable keys get a leading null-flag key — NULLs form one
        # partition / sort NULLS LAST (reference default)
        parts = []
        for k in self.partition_by:
            c = rel.columns[k]
            enc = kernels.monotone_i64(c.array)
            if c.valid is not None:
                parts.append((~c.valid).astype(jnp.int64))
                enc = jnp.where(c.valid, enc, jnp.int64(0))
            parts.append(enc)
        orders = []
        for k, desc in self.order_by:
            c = rel.columns[k]
            a = c.array
            if jnp.issubdtype(a.dtype, jnp.floating):
                enc = kernels.monotone_i64(a)
            else:
                enc = a.astype(jnp.int64)
            if desc:
                # bitwise NOT: monotone-decreasing bijection (no -INT64_MIN
                # overflow, unlike arithmetic negation)
                enc = ~enc
            if c.valid is not None:
                orders.append((~c.valid).astype(jnp.int64))
                enc = jnp.where(c.valid, enc, jnp.int64(0))
            orders.append(enc)
        return tuple(parts), tuple(orders)

    def _execute(self, ctx):
        from ..ops import window as W

        rel = self.children[0].execute(ctx)
        parts, orders = self._key_arrays(rel)
        wctx = W.analyze(parts, orders, rel.mask)
        # RANGE sliding frames need the single order key in sorted order
        order_enc = None
        if len(orders) == 1:
            order_enc = jnp.take(orders[0], wctx.perm)
        cols = dict(rel.columns)
        for f in self.functions:
            frame = f.frame or ("range_upto" if self.order_by
                                else "partition")
            if isinstance(frame, tuple):
                mode, flo, fhi = frame
                # normalize degenerate tuples to the legacy fast paths
                if flo is None and fhi is None:
                    frame = "partition"
                elif flo is None and fhi == 0:
                    frame = "rows_upto" if mode == "rows" else "range_upto"
                elif mode == "range":
                    if order_enc is None:
                        raise ValueError(
                            "RANGE offset frame requires exactly one "
                            "ORDER BY key")
                    oc = rel.columns[self.order_by[0][0]]
                    if oc.dtype.id not in (TypeId.INT32, TypeId.INT64,
                                           TypeId.DATE, TypeId.DECIMAL):
                        raise ValueError(
                            "RANGE offset frame requires an integer-"
                            "ordered key")
                    # DESC needs no offset flip: the ~ encoding is affine
                    # with slope -1, so "m PRECEDING in value space" is
                    # m encoded units below the current key either way
            if f.kind == "row_number":
                cols[f.name] = RelColumn(W.row_number(wctx), INT64, None)
            elif f.kind == "rank":
                cols[f.name] = RelColumn(W.rank(wctx), INT64, None)
            elif f.kind == "dense_rank":
                cols[f.name] = RelColumn(W.dense_rank(wctx), INT64, None)
            elif f.kind in ("lead", "lag"):
                t = rel.evaluate(f.expr)
                off = f.offset if f.kind == "lead" else -f.offset
                out, ok = W.shift(wctx, t.array, t.valid, off, f.default)
                cols[f.name] = RelColumn(out, t.dtype, t.dictionary,
                                         valid=ok)
            elif f.kind in ("first_value", "last_value"):
                t = rel.evaluate(f.expr)
                ab = W.frame_bounds(wctx, frame, order_enc)
                if ab is not None:
                    out, ok = W.first_last_sliding(
                        wctx, t.array, t.valid, ab,
                        last=f.kind == "last_value")
                    cols[f.name] = RelColumn(out, t.dtype, t.dictionary,
                                             valid=ok)
                elif f.kind == "first_value":
                    out = W.first_value(wctx, t.array)
                    cols[f.name] = RelColumn(out, t.dtype, t.dictionary)
                else:
                    out = W.last_value(wctx, t.array, frame=frame)
                    cols[f.name] = RelColumn(out, t.dtype, t.dictionary)
            elif f.kind == "count" and f.expr is None:
                out, _ = W.agg(wctx, "count", None, None, frame,
                               order_enc=order_enc)
                cols[f.name] = RelColumn(out, INT64, None)
            elif f.kind in ("sum", "total", "avg", "min", "max", "count"):
                t = rel.evaluate(f.expr)
                kind = "sum" if f.kind == "total" else f.kind
                if f.kind == "total":
                    frame = "partition"
                arr = t.array
                if kind in ("sum", "avg") and not jnp.issubdtype(
                        arr.dtype, jnp.floating):
                    arr = arr.astype(jnp.int64)
                elif kind in ("sum", "avg"):
                    kind = "sum_double" if kind == "sum" else "avg"
                out, ok = W.agg(wctx, kind, arr, t.valid, frame,
                                order_enc=order_enc)
                if kind == "avg":
                    dt, scale = DOUBLE, 10.0 ** t.dtype.scale \
                        if t.dtype.id == TypeId.DECIMAL else 1.0
                    if scale != 1.0:
                        out = out / scale
                elif f.kind == "count":
                    dt = INT64
                elif t.dtype.id == TypeId.DECIMAL:
                    dt = t.dtype
                elif kind in ("min", "max"):
                    dt = t.dtype
                else:
                    dt = DOUBLE if jnp.issubdtype(out.dtype, jnp.floating) \
                        else INT64
                cols[f.name] = RelColumn(out, dt, t.dictionary
                                         if kind in ("min", "max") else None,
                                         valid=ok)
            else:
                raise ValueError(f.kind)
        return Relation(cols, rel.mask, rel.capacity)

    def _self_signature(self):
        fs = ";".join(f"{f.kind}:{f.name}:{f.expr!r}:{f.offset}:"
                      f"{f.default}:{f.frame}" for f in self.functions)
        return f"window[{self.partition_by};{self.order_by};{fs}]"

    def describe(self):
        return (f"window(partition={self.partition_by}, order={self.order_by},"
                f" funcs={[f.kind for f in self.functions]})")


class AsofJoin(PhysicalOperator):
    """ASOF join (analog of PhysicalAsOfJoin, reference
    src/execution/operator/join/physical_asof_join.cpp): each probe row
    matches AT MOST ONE build row — the one with the greatest build time
    <= the probe time (op '>=', the canonical form; '>' strict, and '<='/
    '<' by negating both sides) among rows with equal equi-keys.

    Design: no per-partition interpolation loops — the build side is
    sorted ONCE by a composite (equi-key, time) int64 encoding and every
    probe row finds its candidate with one vectorized searchsorted; a
    gather re-checks key equality (the exact-match discipline of the hash
    join's ResolvePredicates).  Probe shape is preserved (single-match):
    'inner' narrows the mask on miss, 'left' NULL-extends build columns.

    conditions: equi key column-name pairs + (probe_time_expr, op,
    build_time_expr) with int-typed times.
    """

    name = "asof_join"

    def __init__(self, probe, build, probe_keys, build_keys,
                 probe_time: Expr, op: str, build_time: Expr,
                 join_type: str = "inner", build_prefix: str = ""):
        super().__init__([probe, build])
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.probe_time = probe_time
        self.op = op
        self.build_time = build_time
        if join_type not in ("inner", "left"):
            raise ValueError("ASOF join supports inner/left")
        self.join_type = join_type
        self.build_prefix = build_prefix

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _execute(self, ctx):
        probe_rel = self.children[0].execute(ctx)
        build_rel = self.children[1].execute(ctx)
        pt = probe_rel.evaluate(self.probe_time)
        bt = build_rel.evaluate(self.build_time)
        ptv = kernels.monotone_i64(pt.array)
        btv = kernels.monotone_i64(bt.array)
        op = self.op
        if op in ("<=", "<"):          # probe_t <= build_t: negate times
            ptv, btv = -ptv, -btv
            op = ">=" if op == "<=" else ">"
        if op == ">":                  # strict: t_b <= t_p - 1 (int times)
            ptv = ptv - 1
        # composite (key, time) encoding: keys hashed-free via exact pack
        # when single int key; multi-key uses the shared combiner (exact
        # re-check below guards collisions)
        pkey = _combine_keys(ctx, probe_rel, self.probe_keys) \
            if self.probe_keys else jnp.zeros(probe_rel.capacity, jnp.int64)
        bkey = _combine_keys(ctx, build_rel, self.build_keys) \
            if self.build_keys else jnp.zeros(build_rel.capacity, jnp.int64)
        bvalid = build_rel.mask
        if bt.valid is not None:
            bvalid = bvalid & bt.valid
        bcap = build_rel.capacity
        rows = jnp.arange(bcap, dtype=jnp.int32)
        lead = (~bvalid).astype(jnp.int64)
        _, sk, st, srows = jax.lax.sort((lead, bkey, btv, rows), num_keys=3)
        nb = jnp.sum(bvalid).astype(jnp.int32)
        big = jnp.int64(jnp.iinfo(jnp.int64).max)
        pos_idx = jnp.arange(bcap, dtype=jnp.int32)
        sk_valid = jnp.where(pos_idx < nb, sk, big)   # valid prefix only
        st_valid = jnp.where(pos_idx < nb, st, big)
        # rank-encode keys and times so the composite (key, time) fits one
        # int64 regardless of raw value ranges: rank(x) = #values <= x is
        # monotone, and x <= y <=> rank(x) <= rank(y) when x, y are both
        # drawn from the ranked set (times: probe ranks use side='right'
        # so st <= ptv <=> rank(st) <= rank(ptv) exactly)
        ts = jnp.sort(st_valid)
        krb = jnp.searchsorted(sk_valid, sk, side="left").astype(jnp.int64)
        rtb = jnp.searchsorted(ts, st, side="right").astype(jnp.int64)
        krp = jnp.searchsorted(sk_valid, pkey, side="left").astype(jnp.int64)
        rtp = jnp.searchsorted(ts, ptv, side="right").astype(jnp.int64)
        S = jnp.int64(1) << 32
        enc_b = jnp.where(pos_idx < nb, krb * S + rtb, big)
        enc_p = krp * S + rtp
        pos = jnp.searchsorted(enc_b, enc_p, side="right").astype(
            jnp.int32) - 1
        safe = jnp.clip(pos, 0, bcap - 1)
        # the candidate must carry the probe's key (otherwise the search
        # fell into the previous key's run: no time <= ptv for this key)
        found = (pos >= 0) & (sk_valid[safe] == pkey) & probe_rel.mask
        build_row = jnp.where(found, srows[safe], -1)
        if pt.valid is not None:
            found = found & pt.valid
        # exact key re-check through the matched rows (collision guard)
        if self.probe_keys:
            probe_rows = jnp.arange(probe_rel.capacity, dtype=jnp.int32)
            found = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                                  self.build_keys, probe_rows,
                                  jnp.maximum(build_row, 0), found)
        left = self.join_type == "left"
        safe_b = jnp.clip(build_row, 0, build_rel.capacity - 1)
        cols = dict(probe_rel.columns)
        for n, c in build_rel.columns.items():
            out_name = self.build_prefix + n
            if out_name not in cols:
                v = None if c.valid is None else jnp.take(c.valid, safe_b)
                if left:
                    v = found if v is None else (v & found)
                cols[out_name] = RelColumn(
                    jnp.take(c.array, safe_b, axis=0), c.dtype,
                    c.dictionary, c.domain, v)
        mask = probe_rel.mask if left else (probe_rel.mask & found)
        return Relation(cols, mask, probe_rel.capacity)

    def _self_signature(self):
        return (f"asof_join[{self.join_type};{self.probe_keys};"
                f"{self.build_keys};{self.probe_time!r}{self.op}"
                f"{self.build_time!r};{self.build_prefix}]")

    def describe(self):
        return (f"asof_join({self.join_type}, {self.probe_keys}="
                f"{self.build_keys}, {self.op})")


class Materialized(PhysicalOperator):
    """Placeholder for an executor-injected relation (ctx._cache).

    Used by the out-of-core merge pass: concatenated per-chunk partials are
    injected as this operator's result (the same mechanism that feeds stage
    boundaries), so merge plans are ordinary operator trees.
    """

    name = "materialized"

    def _execute(self, ctx):
        raise RuntimeError("materialized input was not injected")


class MarkJoin(PhysicalOperator):
    """Subquery mark join: EXISTS/IN with residual correlated predicates.

    The analog of the reference's mark/delim join family for flattened
    subqueries (reference src/execution/operator/join/physical_delim_join.cpp
    and the MARK join type in join_hashtable.cpp): the probe relation keeps
    its shape and each probe row gets a boolean "mark" = whether any build
    row matches the equi keys AND satisfies the residual predicate.  The
    residual may reference probe columns (by name) and build columns (under
    `build_prefix`) — this covers q21-style EXISTS with non-equality
    correlated conditions.  Output = probe masked by mark (negated=True for
    NOT EXISTS).
    """

    name = "mark_join"

    def __init__(self, probe: PhysicalOperator, build: PhysicalOperator,
                 probe_keys: Sequence[str], build_keys: Sequence[str],
                 residual: Expr | None = None, negated: bool = False,
                 build_prefix: str = "__mark_",
                 out_capacity: int | None = None,
                 mark_column: str | None = None):
        super().__init__([probe, build])
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.residual = residual
        self.negated = negated
        self.build_prefix = build_prefix
        self.out_capacity = out_capacity
        # when set, the mark is exposed as a BOOL column instead of being
        # applied to the mask (for marks consumed under OR / CASE)
        self.mark_column = mark_column

    def is_pipeline_breaker(self):
        return True

    def blocking_children(self):
        return [self.children[1]]

    def _execute(self, ctx):
        probe_rel = self.children[0].execute(ctx)
        build_rel = self.children[1].execute(ctx)
        bkey = _combine_keys(ctx, build_rel, self.build_keys)
        pkey = _combine_keys(ctx, probe_rel, self.probe_keys)
        bs = join_ops.build(bkey, build_rel.mask)
        entry = join_ops.probe(bs, pkey, probe_rel.mask)
        cap = getattr(self, "_cap_override", None) or self.out_capacity
        if cap is None:
            factor = (ctx.config.join_expansion_factor
                      if ctx.config is not None else 1.0)
            cap = pad_count(int(probe_rel.capacity * factor))
        out_probe, out_build, total = join_ops.expand_matches(
            bs.starts, bs.counts, bs.sorted_rows, entry, probe_rel.mask, cap)
        ctx.add_check(self, "expansion", total <= cap, cap)
        ok = (jnp.arange(cap) < total) & (out_probe >= 0)
        if len(self.probe_keys) > 2:
            ok = _exact_key_eq(probe_rel, build_rel, self.probe_keys,
                               self.build_keys, out_probe, out_build, ok)
        if self.residual is not None:
            needed = _expr_columns(self.residual)
            safe_p = jnp.clip(out_probe, 0, probe_rel.capacity - 1)
            safe_b = jnp.clip(out_build, 0, build_rel.capacity - 1)
            cols: dict[str, RelColumn] = {}
            for n, c in probe_rel.columns.items():
                if n in needed:
                    cols[n] = RelColumn(
                        jnp.take(c.array, safe_p, axis=0), c.dtype,
                        c.dictionary, c.domain,
                        None if c.valid is None
                        else jnp.take(c.valid, safe_p, axis=0))
            for n, c in build_rel.columns.items():
                out_name = self.build_prefix + n
                if out_name in needed:
                    cols[out_name] = RelColumn(
                        jnp.take(c.array, safe_b, axis=0), c.dtype,
                        c.dictionary, c.domain,
                        None if c.valid is None
                        else jnp.take(c.valid, safe_b, axis=0))
            combined = Relation(cols, ok, cap)
            ok = ok & as_mask(combined.evaluate(self.residual))
        # scatter-any back into probe-row space (one boolean per probe row)
        tgt = jnp.where(ok, jnp.maximum(out_probe, 0), probe_rel.capacity)
        mark = jnp.zeros(probe_rel.capacity + 1, jnp.bool_).at[tgt].set(
            True, mode="drop")[: probe_rel.capacity]
        if self.negated:
            mark = ~mark
        if self.mark_column is not None:
            cols = dict(probe_rel.columns)
            cols[self.mark_column] = RelColumn(mark, BOOL, None)
            return Relation(cols, probe_rel.mask, probe_rel.capacity)
        return probe_rel.with_mask(probe_rel.mask & mark)

    def _self_signature(self):
        return (f"mark_join[{self.probe_keys};{self.build_keys};"
                f"{self.residual!r};neg={self.negated};{self.out_capacity};"
                f"{self.build_prefix};mc={self.mark_column};"
                f"ov={getattr(self, '_cap_override', None)}]")

    def describe(self):
        kind = "not_exists" if self.negated else "exists"
        return (f"mark_join({kind}, {self.probe_keys}={self.build_keys},"
                f" residual={self.residual is not None})")
