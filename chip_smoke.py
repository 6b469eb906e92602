#!/usr/bin/env python
"""Smoke test of the engine on the GPU, through the entry points a user
calls, checked against the repository's numpy oracle.

    python chip_smoke.py            # one card: phases verify, sf1, gpu_tests
    python chip_smoke.py --all22    # all 22 TPC-H queries in verify and sf1
    python chip_smoke.py --sf 10    # the main phase at another scale factor
    python chip_smoke.py --mesh4    # four cards: the mesh phase only

Phases:
  verify     SF0.01, Q1/Q3/Q6 as SQL plus Q9/Q13/Q18/Q21, under
             SET enable_verification = true: compiled, eager, unoptimized
             and the independent row-by-row executor must agree.
  sf1        connect(sf=1); Q1/Q3/Q6 as SQL text through Connection.sql
             against the numpy oracle (decimals exact, doubles within a
             relative 1e-9), then Q9/Q13/Q18/Q21 so the PK probe, outer,
             semi/anti and expansion stages compile on the card.  Cold
             (compile) and warm seconds per query.
  gpu_tests  the `gpu`-marked tests (tests/test_gpu.py): the scan-sum and
             PK-probe paths as compiled for the card, at SF1 width, against
             numpy.
  mesh4      connect(sf=1, mesh=make_mesh(4)); Q1/Q3/Q6 against the
             oracle, Q3 with the explicit radix-exchange join forced, and
             exchange_with_requota on skewed keys.

One process drives the card(s).  Exits non-zero, and prints no result,
unless JAX finds a GPU and every phase passes; the last line is one JSON
object naming the device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

MAIN_QUERIES = (9, 13, 18, 21)
ORACLE_QUERIES = (1, 3, 6)


def log(msg):
    print(msg, flush=True)


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def run_oracle_query(conn, oracle, q):
    """SQL text through Connection.sql, cold then warm, vs the oracle."""
    got, cold = timed(lambda: conn.sql(oracle.SQL[q]).strings())
    _, warm = timed(lambda: conn.sql(oracle.SQL[q]).strings())
    problems = oracle.compare(got, oracle.ORACLES[q](conn.catalog))
    log(f"  q{q:02d} sql: {len(got)} rows, cold {cold:.3f}s, warm "
        f"{warm:.4f}s, oracle {'MATCH' if not problems else problems[:3]}")
    if problems:
        raise AssertionError(f"q{q} differs from the oracle: {problems[:3]}")


def run_plan_query(conn, q, require_rows=True):
    rows, cold = timed(lambda: conn.tpch_query(q).strings())
    _, warm = timed(lambda: conn.tpch_query(q).strings())
    log(f"  q{q:02d} plan: {len(rows)} rows, cold {cold:.3f}s, warm "
        f"{warm:.4f}s")
    if require_rows and not rows:
        raise AssertionError(f"q{q} returned no rows")


def phase_verify(all22):
    from duckdb_cubit.api import connect
    from duckdb_cubit.tpch import oracle

    conn = connect(sf=0.01)
    conn.sql("SET enable_verification = true")
    for q in ORACLE_QUERIES:
        run_oracle_query(conn, oracle, q)
    # the verifier checks each answer; at SF0.01 Q17 rightly has none (its
    # SUM matches no row, and an empty SUM renders as no row)
    for q in (range(1, 23) if all22 else MAIN_QUERIES):
        run_plan_query(conn, q, require_rows=False)


def phase_main(sf, all22):
    import jax

    from duckdb_cubit.api import connect
    from duckdb_cubit.tpch import oracle

    conn, load = timed(lambda: connect(sf=sf))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  load sf{sf:g}: {load:.1f}s, lineitem "
        f"{conn.catalog.table('lineitem').num_rows} rows, bytes_in_use "
        f"{stats.get('bytes_in_use')}")
    for q in ORACLE_QUERIES:
        run_oracle_query(conn, oracle, q)
    for q in (range(1, 23) if all22 else MAIN_QUERIES):
        run_plan_query(conn, q)


def phase_gpu_tests():
    import jax

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_gpu.py")
    spec = importlib.util.spec_from_file_location("test_gpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tests = [n for n in dir(mod) if n.startswith("test_")]
    if not tests:
        raise AssertionError("no gpu tests found")
    for name in tests:
        _, sec = timed(lambda: getattr(mod, name)(jax.devices()[0]))
        log(f"  {name}: passed ({sec:.1f}s)")


def phase_mesh4(sf):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from duckdb_cubit.api import connect
    from duckdb_cubit.parallel import exchange as X
    from duckdb_cubit.parallel import mesh as M
    from duckdb_cubit.plan import optimizer as opt
    from duckdb_cubit.plan import physical as P
    from duckdb_cubit.tpch import oracle

    if len(jax.devices()) < 4:
        raise AssertionError(f"--mesh4 needs 4 GPUs, found "
                             f"{len(jax.devices())}")
    mesh = M.make_mesh(4)
    conn, load = timed(lambda: connect(sf=sf, mesh=mesh))
    col = conn.catalog.table("lineitem").columns["l_extendedprice"].data
    if len(col.sharding.device_set) != 4:
        raise AssertionError("lineitem is not sharded over 4 devices")
    log(f"  load+shard sf{sf:g} over 4 devices: {load:.1f}s")
    for q in ORACLE_QUERIES:
        run_oracle_query(conn, oracle, q)
    # Q3 with the explicit radix-exchange join forced on every equi join
    conn.config.explicit_exchange = True
    conn.config.exchange_min_build_rows = 1
    plan = opt.optimize(conn.binder.bind_sql(oracle.SQL[3]), conn.catalog)
    rel, sec = timed(lambda: conn.executor.execute(plan, optimize=False))
    from duckdb_cubit.exec.result import to_strings
    problems = oracle.compare(to_strings(rel), oracle.q3(conn.catalog))
    used = [o for o in plan.walk() if isinstance(o, P.HashJoin)
            and "exu=True" in o._self_signature()]
    log(f"  q03 explicit exchange: {len(used)} exchange joins, {sec:.3f}s, "
        f"oracle {'MATCH' if not problems else problems[:3]}")
    if problems or not used:
        raise AssertionError("q3 with explicit exchange failed")
    # skewed keys: 90% one key overflows the first quota; the host
    # re-runs with doubled quotas until the exchange fits
    rng = np.random.default_rng(1)
    n_rows = 4 * (1 << 20)
    skew = np.full(n_rows, 7, dtype=np.int64)
    skew[: n_rows // 10] = rng.integers(100, 10**6, size=n_rows // 10)
    valid = M.shard_rows(jnp.ones(n_rows, bool), mesh)
    (_, v2, _, quota, rounds), sec = timed(lambda: X.exchange_with_requota(
        mesh, M.shard_rows(jnp.asarray(skew), mesh), valid, []))
    kept = int(np.asarray(v2).sum())
    log(f"  exchange_with_requota: {rounds} rounds, quota {quota}, "
        f"{kept} of {n_rows} rows, {sec:.3f}s")
    if rounds < 1 or kept != n_rows:
        raise AssertionError("skewed exchange lost rows")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--all22", action="store_true",
                    help="run all 22 TPC-H queries in verify and sf1")
    ap.add_argument("--sf", type=float, default=1,
                    help="scale factor of the sf1 and mesh4 phases "
                    "(default 1)")
    ap.add_argument("--mesh4", action="store_true",
                    help="run the four-card mesh phase and nothing else")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import jax

    devices = jax.devices()
    log(f"jax {jax.__version__}; devices {devices}")
    if devices[0].platform != "gpu":
        log(f"error: needs a GPU, JAX found {devices[0].platform}")
        return 2
    import duckdb_cubit

    log(f"compile cache: {duckdb_cubit.compile_cache_dir()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if args.mesh4:
        phases = [("mesh4", lambda: phase_mesh4(args.sf))]
        count = 4
    else:
        phases = [("verify", lambda: phase_verify(args.all22)),
                  (f"sf{args.sf:g}", lambda: phase_main(args.sf, args.all22)),
                  ("gpu_tests", phase_gpu_tests)]
        count = 1
    failed = []
    for name, fn in phases:
        log(f"phase {name}:")
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - a failed phase fails the run
            traceback.print_exc()
            failed.append(name)
        log(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
            f"{time.perf_counter() - t:.1f}s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if failed:
        log(f"error: failed phases {failed}")
        return 1
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
