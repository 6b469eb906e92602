"""Durability: checkpoint + write-ahead log.

The analog of the reference's single-file checkpoint + WAL replay
(reference src/storage/checkpoint_manager.cpp:566 serializing column data,
src/storage/wal_replay.cpp:721 re-applying the tail on open,
src/storage/write_ahead_log.cpp).  Re-architecture: the durable unit
is the HOST mirror of each column (device arrays are a cache of the
checkpoint, exactly like the reference's buffer pool over its block file):

 - `checkpoint(conn, path)` writes every table's unpadded columns,
   dictionaries, index/PK/FK metadata into `<path>/checkpoint.npz` +
   `<path>/manifest.json`, then truncates the WAL (reference
   CheckpointManager semantics);
 - DDL/DML statements append their SQL text to `<path>/wal.sql` BEFORE
   results are acknowledged (logical logging — statement text is the
   engine's redo record, like the reference logging catalog+data ops);
 - `open_database(path)` loads the checkpoint, rebuilds device arrays and
   indexes, then replays the WAL tail through the ordinary SQL path.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..types import DataType, TypeId
from .table import Catalog, from_numpy

_MAGIC = "duckdb_cubit-v1"


def _col_host(col, num_rows: int) -> np.ndarray:
    if col.host is not None:
        return np.asarray(col.host[:num_rows])
    return np.asarray(col.data[:num_rows])


def checkpoint(conn, path: str) -> None:
    """Serialize the connection's catalog; truncates the WAL."""
    os.makedirs(path, exist_ok=True)
    cat = conn.catalog
    blobs: dict[str, np.ndarray] = {}
    manifest: dict = {"magic": _MAGIC, "tables": {},
                      "foreign_keys": cat.foreign_keys}
    for tname, t in cat.tables.items():
        cols = {}
        deleted = getattr(t, "deleted", None)
        live = None
        num_rows = t.num_rows
        if deleted is not None:
            # checkpoint compaction: deleted rows are dropped from the
            # durable image (the reference's checkpoint also writes only
            # live versions); row ids shift, which is fine — relations
            # are unordered and PK luts are rebuilt on open
            live = ~np.asarray(deleted[:t.num_rows])
            num_rows = int(live.sum())
        for cname, c in t.columns.items():
            key = f"{tname}.{cname}"
            arr = _col_host(c, t.num_rows)
            blobs[key] = arr[live] if live is not None else arr
            if c.dictionary is not None:
                blobs[key + ".dict"] = np.asarray(c.dictionary)
            has_nulls = getattr(c, "nulls_host", None) is not None
            if has_nulls:
                nh = np.asarray(c.nulls_host[:t.num_rows])
                blobs[key + ".nulls"] = nh[live] if live is not None else nh
            cols[cname] = {"type": c.dtype.id.value,
                           "scale": c.dtype.scale,
                           "dict": c.dictionary is not None,
                           "nulls": has_nulls}
        manifest["tables"][tname] = {
            "num_rows": num_rows,
            "columns": cols,
            "indexes": {c: {"n_bins": ix.n_bins,
                            "edges": None if ix.bin_edges is None
                            else np.asarray(ix.bin_edges).tolist()}
                        for c, ix in t.indexes.items()},
            "pk_indexes": list(t.pk_indexes.keys()),
            "unique_keys": [sorted(us) for us in
                            getattr(t, "unique_keys", [])],
            "deleted": deleted is not None,
        }
    tmp = os.path.join(path, "checkpoint.tmp.npz")
    np.savez_compressed(tmp, **blobs)
    os.replace(tmp, os.path.join(path, "checkpoint.npz"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # checkpoint complete -> WAL tail is redundant (reference truncation)
    wal = os.path.join(path, "wal.sql")
    if os.path.exists(wal):
        os.remove(wal)


def wal_append(path: str, sql: str) -> None:
    """Append one durable statement to the log (fsync'd: the statement is
    on disk before the caller acknowledges it, reference WAL contract)."""
    with open(os.path.join(path, "wal.sql"), "a") as f:
        f.write(sql.strip().replace("\n", " ") + ";\n")
        f.flush()
        os.fsync(f.fileno())


def open_database(path: str):
    """-> Connection over the checkpoint with the WAL tail replayed."""
    from ..api import Connection
    from ..index.cubit import CubitIndex
    from ..index.pk import DirectPKIndex

    cat = Catalog()
    manifest_path = os.path.join(path, "manifest.json")
    conn = None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        assert manifest.get("magic") == _MAGIC, "unrecognized database dir"
        blobs = np.load(os.path.join(path, "checkpoint.npz"),
                        allow_pickle=False)
        for tname, tm in manifest["tables"].items():
            data, schema = {}, {}
            for cname, cm in tm["columns"].items():
                arr = blobs[f"{tname}.{cname}"]
                dt = DataType(TypeId(cm["type"]), cm["scale"])
                if cm["dict"]:
                    # decode through the dictionary so from_numpy re-encodes
                    d = blobs[f"{tname}.{cname}.dict"]
                    data[cname] = d[arr]
                else:
                    data[cname] = arr
                    schema[cname] = dt
            t = from_numpy(tname, data, schema or None)
            for cname, cm in tm["columns"].items():
                if cm.get("nulls"):
                    nh = blobs[f"{tname}.{cname}.nulls"].astype(bool)
                    col = t.columns[cname]
                    col.nulls_host = nh
                    dev = np.zeros(t.capacity, bool)
                    dev[: len(nh)] = nh
                    import jax.numpy as _jnp
                    col.nulls = _jnp.asarray(dev)
            t.unique_keys = [frozenset(us) for us in tm["unique_keys"]]
            for cname in tm["pk_indexes"]:
                pk = DirectPKIndex.build(cname,
                                         np.asarray(t.columns[cname].host),
                                         t.num_rows)
                if pk is not None:
                    t.pk_indexes[cname] = pk
            for cname, im in tm["indexes"].items():
                edges = None if im["edges"] is None else np.asarray(
                    im["edges"])
                t.indexes[cname] = CubitIndex.build(
                    cname, np.asarray(t.columns[cname].host), t.capacity,
                    t.num_rows, im["n_bins"], edges)
            cat.register(t)
        for fk, (pt, pc) in manifest["foreign_keys"].items():
            cat.register_foreign_key(fk, pt, pc)
    conn = Connection(cat)
    wal = os.path.join(path, "wal.sql")
    if os.path.exists(wal):
        with open(wal) as f:
            tail = f.read()
        conn._wal_replaying = True
        try:
            for stmt in tail.split(";\n"):
                if stmt.strip():
                    conn.sql(stmt)
        finally:
            conn._wal_replaying = False
    conn.db_path = path
    return conn
