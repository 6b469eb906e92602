"""Engine configuration: typed instance + session settings.

Analog of the reference's layered config (reference src/main/config.cpp
DBConfig incl. index_scan_percentage / index_scan_max_count at
include/duckdb/main/config.hpp:246-253, and ClientConfig session knobs like
force_external / verify_parallelism; all surfaced via the generated settings
registry src/main/settings/settings.cpp).  Settings are plain typed fields
with a string-keyed set/get so a SQL-level SET command can drive them.
"""

from __future__ import annotations

import dataclasses

# share of the device's allocator limit that one query's working set may
# take before a stage runs multi-pass: the rest holds the resident tables,
# indexes and the stage's outputs
MEMORY_LIMIT_SHARE = 0.5
# devices whose allocator reports no limit (the CPU backend)
HOST_MEMORY_LIMIT = 12 << 30


def default_memory_limit(device=None) -> int:
    """Out-of-core budget in bytes: MEMORY_LIMIT_SHARE of the device
    allocator's `bytes_limit`, or HOST_MEMORY_LIMIT where there is none."""
    import jax

    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return HOST_MEMORY_LIMIT
    return int(limit * MEMORY_LIMIT_SHARE)


@dataclasses.dataclass
class EngineConfig:
    # index-scan thresholds (reference config.hpp:246-253 semantics)
    index_scan_percentage: float = 0.001
    index_scan_max_count: int = 1 << 14
    # grouped-aggregation strategy knobs
    small_group_limit: int = 32
    dense_domain_limit: int = 1 << 22
    # join expansion default capacity multiplier (x probe rows)
    join_expansion_factor: float = 2.0
    # distributed execution
    exchange_quota_slack: float = 2.0   # per-destination quota = slack * mean
    mesh_axis: str = "d"
    # explicit radix-exchange join lowering on mesh catalogs: route both
    # sides through a shard_map all_to_all and join shard-locally instead
    # of letting GSPMD choose collectives (reference analog:
    # HashJoinRepartitionTask, physical_hash_join.cpp:373); applied to
    # equi joins whose build side has >= exchange_min_build_rows rows
    explicit_exchange: bool = True
    exchange_min_build_rows: int = 1 << 22
    # staged execution: compile one program per pipeline, compact relations
    # at stage boundaries (default); False = single whole-plan XLA program
    staged_execution: bool = True
    # verification / debugging (analog of PRAGMA enable_verification)
    enable_verification: bool = False   # run eager + compiled, compare
    # which verification legs run: "all" (compiled + eager + unoptimized +
    # python) or "light" (skips the compiled leg — used by the sqllogic
    # harness where per-query jit compiles would dominate corpus runtime)
    verification_legs: str = "all"
    # leg 4: the independent row-by-row python executor (exec/pyverify.py,
    # the external-verifier analog) runs when the plan is supported and
    # every base table has <= this many rows (0 disables)
    pyverify_max_rows: int = 100_000
    profile: bool = False
    # memory budget per device for out-of-core decisions (bytes); stages
    # whose estimated working set exceeds it run multi-pass (chunked scan +
    # partial-aggregate merge).  Left at 0, it is derived from the device
    # when the config is made (`default_memory_limit`); SET memory_limit = 0
    # afterwards turns multi-pass execution off
    memory_limit: int = 0
    # force multi-pass execution regardless of size (reference
    # client_config.hpp:79 force_external; used by out-of-core tests)
    force_external: bool = False
    # NULL placement in ORDER BY (reference SET default_null_order):
    # "nulls_last" (engine default) or "nulls_first"
    default_null_order: str = "nulls_last"
    # per-query wall-clock deadline in seconds (0 = off): a query that
    # exceeds it is abandoned with QueryTimeoutError — the engine-level
    # analog of the reference's interrupt protocol
    # (src/parallel/interrupt.cpp, SET statement_timeout in other engines)
    query_timeout_s: float = 0.0

    def __post_init__(self):
        if not self.memory_limit:
            self.memory_limit = default_memory_limit()

    def set(self, name: str, value):
        if not hasattr(self, name):
            raise KeyError(f"unknown setting {name}")
        current = getattr(self, name)
        setattr(self, name, type(current)(value))

    def get(self, name: str):
        if not hasattr(self, name):
            raise KeyError(f"unknown setting {name}")
        return getattr(self, name)

    def settings(self) -> dict:
        return dataclasses.asdict(self)

    def plan_key(self) -> tuple:
        """Fields that change compiled-plan decisions; part of every plan
        cache key so a SET takes effect on the next execution (the analog of
        the reference re-planning prepared statements on setting changes)."""
        return (self.default_null_order,
                self.index_scan_percentage, self.index_scan_max_count,
                self.small_group_limit, self.dense_domain_limit,
                self.join_expansion_factor, self.memory_limit,
                self.force_external,
                self.explicit_exchange, self.exchange_min_build_rows)
