#!/usr/bin/env python
"""Scaling report: engine throughput on 1 device vs an 8-device mesh.

BASELINE.json asks for rows/s scaling at 1 device / 1 host / N hosts.  On a
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8) this
script measures STRONG SCALING STRUCTURE of the same code path a GPU mesh
runs (GSPMD + the explicit shard_map radix exchange) and records
per-configuration rows/s, scaling efficiency, and the exchange's modeled
wire bytes (host-static: n^2 * quota * row_bytes).  CPU-mesh numbers
measure collective/communication structure, not device speed.

Prints the report as JSON.
"""
import json
import os
import statistics
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def timed(fn, *args, k=5):
    fn(*args)  # warm/compile
    ts = []
    for _ in range(k):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def q6_scaling(n_rows=1 << 21):
    """Distributed fused bitmap scan+sum (engine distributed kernel)."""
    import jax.numpy as jnp

    from duckdb_cubit.parallel import distributed, mesh as M

    rng = np.random.default_rng(0)
    wa = rng.integers(0, 2**32, n_rows // 32, dtype=np.uint32)
    wb = rng.integers(0, 2**32, n_rows // 32, dtype=np.uint32)
    wc = rng.integers(0, 2**32, n_rows // 32, dtype=np.uint32)
    ep = rng.integers(0, 10**6, n_rows).astype(np.int64)
    di = rng.integers(0, 11, n_rows).astype(np.int64)
    out = {}
    for nd in (1, 8):
        mesh = M.make_mesh(nd)
        step = distributed.make_q6_step(mesh)
        args = [M.shard_rows(jnp.asarray(a), mesh)
                for a in (wa, wb, wc, ep, di)]
        args.append(M.shard_rows(jnp.ones(n_rows, bool), mesh))
        t = timed(lambda *a: step(*a), *args)
        out[nd] = n_rows / t
    return {"rows": n_rows, "rows_per_s_1dev": out[1],
            "rows_per_s_8dev": out[8],
            "scaling_efficiency_8dev": out[8] / out[1] / 8}


def exchange_join_scaling(n_rows=1 << 20):
    """Engine explicit radix-exchange join, 1 vs 8 devices."""
    from duckdb_cubit.api import Connection
    from duckdb_cubit.config import EngineConfig
    from duckdb_cubit.parallel import mesh as M
    from duckdb_cubit.plan import optimizer as opt
    from duckdb_cubit.plan import physical as P

    rng = np.random.default_rng(1)
    tables = {
        "probe": {"k": rng.integers(0, n_rows // 4, n_rows),
                  "pv": rng.integers(0, 100, n_rows)},
        "build": {"k": rng.integers(0, n_rows // 4, n_rows // 2),
                  "bv": rng.integers(0, 100, n_rows // 2)},
    }
    sql = ("SELECT sum(pv * bv) AS s, count(*) AS c FROM probe, build "
           "WHERE probe.k = build.k")
    out = {}
    bytes_per_n = {}
    for nd in (1, 2, 4, 8):
        cfg = EngineConfig()
        cfg.explicit_exchange = nd > 1
        cfg.exchange_min_build_rows = 1
        conn = Connection(config=cfg,
                          mesh=M.make_mesh(nd) if nd > 1 else None)
        for name, cols in tables.items():
            conn.register_numpy(name, cols)
        plan = opt.optimize(conn.binder.bind_sql(sql), conn.catalog)

        def run():
            rel = conn.executor.execute(plan, optimize=False)
            return rel.columns["s"].array

        t = timed(run)
        out[nd] = n_rows / t
        if nd > 1:
            bytes_per_n[nd] = sum(getattr(op, "_exchange_bytes", 0) or 0
                                  for op in plan.walk())
    # VERDICT r4 item 9 acceptance: modeled exchange bytes/row must be
    # ~independent of device count (quota padding used to inflate it
    # quadratically at small quotas)
    bytes_per_row = {nd: b / n_rows for nd, b in bytes_per_n.items()}
    return {"probe_rows": n_rows, "rows_per_s_1dev": out[1],
            "rows_per_s_8dev": out[8],
            "scaling_efficiency_8dev": out[8] / out[1] / 8,
            "exchange_bytes_modeled": bytes_per_n[8],
            "exchange_bytes_per_row_by_ndev": bytes_per_row,
            "bytes_per_row_8dev_over_2dev":
                bytes_per_row[8] / bytes_per_row[2]}


def main():
    report = {
        "note": ("measures collective/exchange structure on the "
                 "platform below; on a CPU mesh, not device speed"),
        "platform": jax.default_backend(),
        "devices": len(jax.devices()),
        "q6_distributed_scan": q6_scaling(),
        "exchange_hash_join": exchange_join_scaling(),
    }
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
