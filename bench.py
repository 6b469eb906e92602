"""Benchmark: TPC-H Q6 through the CUBIT bitmap path, and the PK probe, on
one GPU at SF1.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"sections"}.

value = end-to-end Q6 rows/s: lineitem rows over the median warm time of
`Connection.sql(Q6)` until the answer is on the host (parse, bind, plan
cache hit, one device program, result pull).

vs_baseline = the Q6 device program's rows/s as a share of the card's
memory roofline for the bytes it must read: the predicate words
(0.125 B/row), l_extendedprice (int32, 4 B/row) and l_discount (stored
int8, 1 B/row).

sections.join_probe = the engine's direct-address PK probe
(index/pk.probe) of SF1 lineitem.l_orderkey into the orders lut, against
the 10 B/row it reads (4 B key, 4 B lut entry, 1 B build liveness, 1 B
probe validity).

Device times come from a host clock around calls that end in
block_until_ready, after a warm-up call.  Q6 is checked against the numpy
oracle (tpch/oracle.py); a mismatch exits 1.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Peak memory bandwidth by jax device_kind (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
Q6_BYTES_PER_ROW = 0.125 + 4.0 + 1.0
PROBE_BYTES_PER_ROW = 10.0
REPS = 20


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _median_seconds(fn, reps=REPS):
    fn()                                   # warm-up (compile, caches)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _log(f"bench: needs a GPU, JAX found {dev.platform}")
        return 2
    peak = PEAK_BYTES_PER_S.get(dev.device_kind)
    if peak is None:
        _log(f"bench: no peak bandwidth known for {dev.device_kind!r}")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()),
              "name_power_limit": smi.stdout.strip().splitlines()[0]
              if smi.stdout.strip() else None}
    _log(f"bench: {device}")

    from duckdb_cubit.api import connect
    from duckdb_cubit.index import pk as pk_index
    from duckdb_cubit.plan import optimizer as opt
    from duckdb_cubit.tpch import oracle

    conn = connect(sf=1)
    li = conn.catalog.table("lineitem")
    n_rows = li.num_rows
    problems = oracle.check(conn, 6)
    if problems:
        print(json.dumps({"error": f"Q6 wrong: {problems[:3]}",
                          "device": device}))
        return 1
    e2e = _median_seconds(lambda: conn.sql(oracle.SQL[6]).strings())

    plan = opt.optimize(conn.binder.bind_sql(oracle.SQL[6]), conn.catalog)
    jitted, arrays, _ = conn.executor.compile_plan(plan)
    q6_dev = _median_seconds(
        lambda: jax.block_until_ready(jitted(arrays)))

    orders = conn.catalog.table("orders")
    pkidx = orders.pk_indexes["o_orderkey"]
    keys = li.columns["l_orderkey"].data
    probe = jax.jit(lambda k, lut, v, m: pk_index.probe(
        lut, pkidx.max_key, k, v, m))
    probe_args = (keys, pkidx.lut, li.row_mask(), orders.row_mask())
    probe_s = _median_seconds(
        lambda: jax.block_until_ready(probe(*probe_args)))

    q6_rows_s = n_rows / q6_dev
    probe_rows_s = li.capacity / probe_s
    print(json.dumps({
        "metric": "tpch_sf1_q6_e2e_rows_per_s",
        "value": n_rows / e2e,
        "unit": "rows/s",
        "vs_baseline": q6_rows_s * Q6_BYTES_PER_ROW / peak,
        "device": device,
        "sections": {
            "q6": {"e2e_seconds": e2e, "device_seconds": q6_dev,
                   "device_rows_per_s": q6_rows_s,
                   "bytes_per_row": Q6_BYTES_PER_ROW,
                   "roofline_share": q6_rows_s * Q6_BYTES_PER_ROW / peak,
                   "correct": True},
            "join_probe": {"device_seconds": probe_s,
                           "rows_per_s": probe_rows_s,
                           "bytes_per_row": PROBE_BYTES_PER_ROW,
                           "roofline_share":
                           probe_rows_s * PROBE_BYTES_PER_ROW / peak},
            "peak_bytes_per_s": peak,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
