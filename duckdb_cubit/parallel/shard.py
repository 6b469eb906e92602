"""Sharded catalog placement: the engine's distributed storage layout.

The analog of the reference's intra-process parallel scan state handing row
groups to threads (reference src/storage/data_table.cpp:247 MaxThreads,
src/parallel/pipeline.cpp:167 LaunchScanTasks) re-architected for a device
mesh: base-table columns and CUBIT bitmap words are row-partitioned across
the 1-D "d" axis (each device owns a contiguous row block — the morsel
analog), small lookup structures (PK luts) are replicated, and the query
programs compile under GSPMD: XLA's sharding propagation inserts the
collectives (psum for reductions, all-gathers/all-to-alls for joins and
sorts) exactly where the dataflow crosses row blocks — the scaling-book
recipe: pick a mesh, annotate shardings, let XLA insert collectives.

Everything is placement-only: arrays keep their values, so golden-answer
bit-exactness is preserved (integer split-sums are order-independent by
design).  Capacities are ROW_PAD (8192) multiples, so row counts and bitmap
word counts divide any power-of-two mesh.
"""

from __future__ import annotations

import copy

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..storage.table import Catalog, Table
from .mesh import DATA_AXIS


def _row_spec(mesh: Mesh, length: int) -> NamedSharding:
    n = mesh.devices.size
    if length % n == 0 and length >= n:
        return NamedSharding(mesh, P(DATA_AXIS))
    return NamedSharding(mesh, P())


def shard_table(table: Table, mesh: Mesh) -> Table:
    """Copy of `table` with device arrays placed on the mesh (row-sharded
    where divisible, replicated otherwise)."""
    t = copy.copy(table)
    t.columns = {}
    for name, c in table.columns.items():
        c2 = copy.copy(c)
        c2.data = jax.device_put(c.data, _row_spec(mesh, c.data.shape[0]))
        t.columns[name] = c2
    deleted = getattr(table, "deleted", None)
    if deleted is not None:
        t.deleted = jax.device_put(deleted, _row_spec(mesh,
                                                      deleted.shape[0]))
    t.indexes = {}
    for name, idx in table.indexes.items():
        ix = idx.clone() if hasattr(idx, "clone") else copy.copy(idx)
        word_spec = NamedSharding(
            mesh, P(None, DATA_AXIS)
            if ix.n_words % mesh.devices.size == 0 else P())
        if ix.words is not None:
            ix.words = jax.device_put(ix.words, word_spec)
        if getattr(ix, "cum_words", None) is not None:
            ix.cum_words = jax.device_put(ix.cum_words, word_spec)
        ix._query_cache = {}   # cached query words live on old devices
        t.indexes[name] = ix
    t.pk_indexes = {}
    repl = NamedSharding(mesh, P())
    for name, pk in table.pk_indexes.items():
        pk2 = copy.copy(pk)
        pk2.lut = jax.device_put(pk.lut, repl)
        t.pk_indexes[name] = pk2
    return t


def shard_catalog(catalog: Catalog, mesh: Mesh) -> Catalog:
    """New catalog with every table placed on the mesh.

    The source catalog (e.g. the in-process TPC-H load cache) is left
    untouched; the executor's plan caches key on `Catalog.placement` so
    sharded and unsharded connections never share prepared device arrays.
    """
    out = Catalog()
    for name, t in catalog.tables.items():
        out.register(shard_table(t, mesh))
    out.foreign_keys = dict(catalog.foreign_keys)
    out.placement = f"mesh{mesh.devices.size}:{id(mesh)}"
    out.mesh = mesh   # consumed by the explicit-exchange join lowering
    return out
