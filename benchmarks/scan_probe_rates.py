#!/usr/bin/env python
"""Device rates of the Q6 fused scan-sum and the direct-address PK probe,
beside a plain copy, at TPC-H lineitem widths (SF1 and SF10 row counts).

  scan_sum        SUM(l_extendedprice * l_discount) over a CUBIT predicate
                  at Q6's ~1.9% selectivity, straight from the packed
                  words (ops/bitmap.words_sum): 0.125 + 4 + 1 B/row
  probe_sorted    index/pk.probe of lineitem-like FKs (sorted runs of 1-7)
                  into an orders-like lut with 1 key in 4 present:
                  4 B key + 4 B lut + 1 B liveness + 1 B validity per row
  probe_shuffled  the same keys in random order
  copy_1GiB       x ^ 1 over a 1 GiB uint32 array: read + write

Each scan and probe rate is device time from `--reps` calls chained in one
compiled loop (one dispatch), so host dispatch is not counted.  Needs a
GPU.

Usage: python benchmarks/scan_probe_rates.py [--rows 6001215 59986052]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from duckdb_cubit.index import pk as pk_index  # noqa: E402
from duckdb_cubit.ops import bitmap as bm  # noqa: E402
from duckdb_cubit.storage.table import pad_count  # noqa: E402


def device_seconds(fn, args, reps):
    """Per-call device seconds: `reps` calls chained in one compiled loop.
    `fn` returns non-negative values; their running sum feeds the first
    argument through an XOR with `sum >> 62`, zero in practice but not
    provably so, so XLA can neither hoist the call out of the loop nor
    shrink it."""
    def loop(*a):
        def body(i, acc):
            first = a[0] ^ (acc >> 62).astype(a[0].dtype)
            return acc + jnp.sum(fn(first, *a[1:]), dtype=jnp.int64)
        return jax.lax.fori_loop(0, reps, body, jnp.int64(0))

    jitted = jax.jit(loop)
    jitted(*args).block_until_ready()            # compile + warm up
    times = []
    for _ in range(5):
        t = time.perf_counter()
        jitted(*args).block_until_ready()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) / reps


def run(rows, reps, rng):
    cap = pad_count(rows)
    mask = np.zeros(cap, bool)
    mask[:rows] = rng.random(rows) < 0.019
    price = rng.integers(90_000, 10_500_000, cap).astype(np.int32)
    disc = rng.integers(0, 11, cap).astype(np.int8)
    words = bm.pack_mask(jnp.asarray(mask), cap // 32)
    args = (words, jnp.asarray(price), jnp.asarray(disc))

    def scan_sum(w, a, b):
        return bm.words_sum(w, a.astype(jnp.int32) * b.astype(jnp.int32))

    want = int((price[mask].astype(np.int64) * disc[mask]).sum())
    out = {"rows": rows,
           "scan_sum_correct": int(jax.jit(scan_sum)(*args)) == want}
    sec = device_seconds(scan_sum, args, reps)
    out["scan_sum"] = {"us": sec * 1e6,
                       "GBps": 5.125 * rows / sec / 1e9}
    # the copy's output must be written, so it is timed per dispatch (each
    # call takes ~1 ms, far above the dispatch cost)
    big = jnp.arange(1 << 28, dtype=jnp.uint32)
    copy = jax.jit(lambda x: x ^ 1)
    copy(big).block_until_ready()
    t = time.perf_counter()
    for _ in range(reps):
        y = copy(big)
    y.block_until_ready()
    sec = (time.perf_counter() - t) / reps
    out["copy_1GiB"] = {"us": sec * 1e6, "GBps": 2 * big.nbytes / sec / 1e9}
    n_orders = rows // 4
    okeys = np.sort(rng.choice(4 * n_orders, n_orders, replace=False)) + 1
    idx = pk_index.DirectPKIndex.build("o_orderkey", okeys, n_orders)
    fk = np.repeat(okeys, rng.integers(1, 8, n_orders))[:rows]
    fk = np.pad(fk, (0, cap - len(fk)), mode="edge").astype(np.int32)
    alive = jnp.asarray(rng.random(n_orders) < 0.5)
    valid = jnp.ones(cap, bool)

    def probe(k, lut, v, m):
        row, found = pk_index.probe(lut, idx.max_key, k, v, m)
        return row + 1 + found

    for name, keys in (("probe_sorted", fk),
                       ("probe_shuffled", rng.permutation(fk))):
        sec = device_seconds(probe, (jnp.asarray(keys), idx.lut, valid,
                                     alive), reps)
        out[name] = {"us": sec * 1e6, "Grow_s": cap / sec / 1e9,
                     "GBps": 10 * cap / sec / 1e9}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[6_001_215, 59_986_052])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device {dev.device_kind} x{len(jax.devices())}; {smi.strip()}")
    rng = np.random.default_rng(0)
    for rows in args.rows:
        print(json.dumps(run(rows, args.reps, rng)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
