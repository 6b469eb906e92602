"""Data modification: append / delete / update with index maintenance.

Analog of the reference's DataTable append/delete/update paths
(reference src/storage/data_table.cpp, local_storage.cpp) and of CUBIT's
update-conscious index deltas: every mutation buffers per-index deltas
(CubitIndex.insert/delete/update) and publishes them with one merge per
index; deletes are a validity epoch (rows never move, so PK luts and
bitmap row positions stay stable — the column-store analog of MVCC
version masks, reference row_version_manager.cpp).

All array updates are functional: readers holding the previous epoch's
arrays keep a consistent snapshot.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .table import Column, Table, pad_count
from ..types import TypeId


class DmlError(RuntimeError):
    pass


def _ensure_deleted_mask(table: Table):
    if not hasattr(table, "deleted") or table.deleted is None:
        table.deleted = jnp.zeros(table.capacity, jnp.bool_)


def _active_mask(table: Table):
    base = jnp.arange(table.capacity) < table.num_rows
    if getattr(table, "deleted", None) is not None:
        base = base & ~table.deleted
    return base


# patch Table.row_mask to honor deletions (kept here so the storage core
# stays minimal; importing dml activates DML semantics)
Table.row_mask = _active_mask  # type: ignore[assignment]


def append_rows(table: Table, rows: dict[str, np.ndarray],
                nulls: dict[str, np.ndarray] | None = None) -> int:
    """Append host rows; returns the first new row id.

    Grows capacity when needed (copy + pad), extends every CUBIT index via
    insert deltas, and extends dictionaries for VARCHAR values (new strings
    are appended to the dictionary; code order stays sorted only for the
    prefix, so ordered string predicates must re-encode — round-1 limitation
    flagged with an exception if violated).  `nulls[col]` marks NULL slots
    of the appended rows (stored as a per-column validity epoch, the
    segment-level ValidityMask analog).
    """
    n_new = len(next(iter(rows.values())))
    first = table.num_rows
    new_count = first + n_new
    grow = new_count > table.capacity
    new_capacity = pad_count(new_count) if grow else table.capacity
    remapped_dict_cols = []
    for name, col in table.columns.items():
        vals = rows[name]
        if col.dictionary is not None:
            # sorted-dictionary invariant: the whole engine (ordered string
            # predicates, LIKE truth tables, CUBIT dict bins) relies on codes
            # being order-preserving.  New strings therefore re-encode: build
            # the merged sorted dictionary and remap existing codes with one
            # device gather (functional, snapshot-safe).
            vals_b = np.array([v if isinstance(v, bytes) else str(v).encode()
                               for v in np.asarray(vals)], dtype="S")
            old_dict = col.dictionary
            width = max(old_dict.dtype.itemsize, vals_b.dtype.itemsize, 1)
            merged = np.unique(np.concatenate(
                [old_dict.astype(f"S{width}"), vals_b.astype(f"S{width}")]))
            if len(merged) != len(old_dict):
                old_to_new = np.searchsorted(
                    merged, old_dict.astype(f"S{width}")).astype(np.int32)
                if len(old_to_new):
                    col.data = jnp.asarray(old_to_new)[col.data]
                    if col.host is not None:
                        col.host = old_to_new[col.host]
                col.dictionary = merged
                remapped_dict_cols.append(name)
            codes = np.searchsorted(
                merged, vals_b.astype(f"S{width}")).astype(np.int32)
            dt = np.dtype(col.data.dtype)
            if dt.kind == "i" and dt.itemsize < 4 and \
                    len(merged) >= np.iinfo(dt).max:
                col.data = col.data.astype(jnp.int32)
                if col.host is not None:
                    col.host = col.host.astype(np.int32)
            host_new = codes.astype(col.data.dtype)
            dev_new = jnp.asarray(host_new)
        else:
            vals_np = np.asarray(vals)
            _widen_for(col, vals_np)
            host_new = vals_np.astype(col.data.dtype)
            dev_new = jnp.asarray(host_new)
        if col.host is not None:
            col.host = np.concatenate([col.host, host_new])
        data = col.data
        if grow:
            pad = jnp.repeat(data[-1:], new_capacity - table.capacity)
            data = jnp.concatenate([data, pad])
        data = data.at[first:new_count].set(dev_new)
        col.data = data
        # NULL epochs: extend/refresh the per-column null mask
        new_nulls = None if nulls is None else nulls.get(name)
        if new_nulls is not None and new_nulls.any() or \
                getattr(col, "nulls", None) is not None:
            old_h = (col.nulls_host if col.nulls_host is not None
                     else np.zeros(first, bool))
            nh = np.zeros(new_count, bool)
            nh[:first] = old_h[:first]
            if new_nulls is not None:
                nh[first:new_count] = new_nulls
            col.nulls_host = nh
            dev = np.zeros(new_capacity, bool)
            dev[:new_count] = nh
            col.nulls = jnp.asarray(dev)
        # index deltas (skipped for remapped dictionary columns — their
        # bitmap bins live in the old code space and are rebuilt below)
        idx = table.indexes.get(name)
        if idx is not None and name not in remapped_dict_cols:
            for i in range(n_new):
                idx.insert(first + i, host_new[i])
    if getattr(table, "deleted", None) is not None and grow:
        table.deleted = jnp.concatenate([
            table.deleted,
            jnp.zeros(new_capacity - table.capacity, jnp.bool_)])
    if grow:
        # capacity change invalidates bitmap word counts: rebuild indexes
        for name, idx in list(table.indexes.items()):
            from ..index.cubit import CubitIndex
            col = table.columns[name]
            host = (col.host[:new_count] if col.host is not None
                    else np.asarray(col.data[:new_count]))
            table.indexes[name] = CubitIndex.build(
                name, host if idx.bin_edges is not None else host.astype(np.int32),
                new_capacity, new_count, idx.n_bins, bin_edges=idx.bin_edges)
        table.capacity = new_capacity
        table.num_rows = new_count
    else:
        table.num_rows = new_count
        for idx in table.indexes.values():
            if idx.pending_updates:
                idx.merge()
    # dictionary remaps invalidate code-space bitmap bins: rebuild
    for name in remapped_dict_cols:
        if name in table.indexes:
            from ..index.cubit import CubitIndex
            col = table.columns[name]
            table.indexes[name] = CubitIndex.build(
                name, col.host.astype(np.int32), table.capacity,
                table.num_rows, len(col.dictionary))
    for cname in list(table.pk_indexes):
        if not _rebuild_pk_index(table, cname):
            raise DmlError(f"append broke PK uniqueness on {cname}")
    _refresh_stats(table)
    table.version += 1
    return first


def _widen_for(col, values: np.ndarray):
    """Narrowed integer storage that can't hold `values` widens back to
    int64 (bitpack-codec invariant, storage/table._narrow_int)."""
    dt = np.dtype(col.data.dtype)
    if dt.kind == "i" and dt.itemsize < 8 and values.size:
        info = np.iinfo(dt)
        v64 = values.astype(np.int64)
        if int(v64.max()) >= info.max or int(v64.min()) <= info.min:
            col.data = col.data.astype(jnp.int64)
            if col.host is not None:
                col.host = col.host.astype(np.int64)


def _rebuild_pk_index(table: Table, cname: str) -> bool:
    """Rebuild the direct-address PK lut of `cname` from the host mirror
    (host build is cheap); False when the keys no longer allow one.  A lut
    left stale after a key changes would resolve joins to the wrong rows."""
    from ..index.pk import DirectPKIndex

    col = table.columns[cname]
    keys = (col.host[:table.num_rows] if col.host is not None
            else np.asarray(col.data[:table.num_rows]))
    pk = DirectPKIndex.build(cname, keys, table.num_rows)
    if pk is None:
        return False
    table.pk_indexes[cname] = pk
    return True


def _refresh_stats(table: Table, columns=None):
    """Recompute zone maps and small-int domains from the host mirrors
    after a mutation — stale statistics would make the optimizer's
    always-false pruning and the dense-aggregate domain decision WRONG
    (the reference merges new segment stats on append,
    src/storage/table/column_data.cpp stats merge)."""
    from .table import _build_zone_map, _int_domain

    names = columns if columns is not None else list(table.columns)
    for name in names:
        col = table.columns[name]
        if col.zone_map is None and col.domain is None and \
                col.dtype.id == TypeId.DOUBLE:
            continue
        host = (col.host[:table.num_rows] if col.host is not None
                else np.asarray(col.data[:table.num_rows]))
        if getattr(col, "nulls_host", None) is not None:
            host = host[~col.nulls_host[:table.num_rows]]
        if table.num_rows == 0 or len(host) == 0:
            col.zone_map = None
            col.domain = None
            continue
        if col.dtype.id in (TypeId.INT32, TypeId.INT64, TypeId.DECIMAL,
                            TypeId.DATE, TypeId.VARCHAR, TypeId.CHAR1):
            col.zone_map = _build_zone_map(host, len(host))
        if col.dtype.id == TypeId.CHAR1:
            col.domain = np.unique(host)
        elif col.domain is not None or col.zone_map is not None:
            col.domain = _int_domain(col.zone_map, col.dtype)


def delete_rows(table: Table, row_ids: np.ndarray):
    """Mark rows deleted (validity-epoch delete; storage never compacts in
    place — the scan mask hides them and CUBIT bitmaps drop their bits)."""
    _ensure_deleted_mask(table)
    row_ids = np.asarray(row_ids, dtype=np.int64)
    table.deleted = table.deleted.at[jnp.asarray(row_ids)].set(True)
    for name, idx in table.indexes.items():
        col = table.columns[name]
        host_vals = (col.host[row_ids] if col.host is not None
                     else np.asarray(col.data[jnp.asarray(row_ids)]))
        for r, v in zip(row_ids, host_vals):
            idx.delete(int(r), v)
        idx.merge()
    table.version += 1


def update_column(table: Table, column: str, row_ids: np.ndarray,
                  new_values: np.ndarray):
    """Point updates of one column (CUBIT's update-conscious path)."""
    col = table.columns[column]
    if col.dictionary is not None:
        raise DmlError("VARCHAR update requires re-encoding (not in round 1)")
    row_ids = np.asarray(row_ids, dtype=np.int64)
    _widen_for(col, np.asarray(new_values))
    old = (col.host[row_ids] if col.host is not None
           else np.asarray(col.data[jnp.asarray(row_ids)]))
    new_host = np.asarray(new_values, dtype=old.dtype)
    col.data = col.data.at[jnp.asarray(row_ids)].set(jnp.asarray(new_host))
    if col.host is not None:
        # copy-on-write so catalog snapshots (transactions) stay consistent
        col.host = col.host.copy()
        col.host[row_ids] = new_host
    idx = table.indexes.get(column)
    if idx is not None:
        for r, ov, nv in zip(row_ids, old, np.asarray(new_values)):
            idx.update(int(r), ov, nv)
        idx.merge()
    if column in table.pk_indexes and not _rebuild_pk_index(table, column):
        # keys no longer fit a lut: joins take the generic path
        del table.pk_indexes[column]
    _refresh_stats(table, [column])
    table.version += 1
