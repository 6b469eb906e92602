"""duckdb_cubit — a vectorized query-execution engine in JAX.

A from-scratch analytical SQL engine with the capabilities of the reference
DuckDB-CUBIT fork (CUBIT-style bitmap index scans, vectorized filters,
partitioned hash join, radix-partitioned hash aggregate, sort, morsel/pipeline
scheduling), re-architected for an accelerator: plans are built in Python,
every hot operator executes as XLA-compiled dataflow (jax/jnp) over
fixed-shape columnar arrays with validity masks, and multi-device scaling
uses jax.sharding meshes with collective-based exchanges instead of threads.

Layer map (mirrors SURVEY.md §1 for the reference):
  sql/ + plan/   - frontend: logical plans, optimizer, physical planning
  exec/          - pipeline builder, event-DAG executor, profiler
  ops/           - vectorized kernels (filter/expr, join, group-by, sort, bitmap)
  index/         - CUBIT segmented bitmap index, direct-address PK luts
  storage/       - columnar tables, dictionary encoding, zone maps, catalog
  parallel/      - device mesh, partitioned tables, distributed exchange
  tpch/          - TPC-H dbgen, the 22 queries, numpy oracle
"""

import os

import jax

# Exact 64-bit integer arithmetic is the engine's decimal representation;
# enable before any array is created.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: a repeated cold-process query skips its
# first compile.  JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting
# and is left alone; otherwise the cache lives at one fixed path in the
# checkout (a directory that moves between runs never hits).  Shape
# bucketing (storage.table pad_count) keeps the number of entries small.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir() -> str:
    """The persistent compilation cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

__version__ = "0.2.0"
