#!/usr/bin/env python
"""TPC-H per-query wall-time runner (reference benchmark_runner analog).

Mirrors the reference protocol (reference benchmark/benchmark_runner.cpp:
119-145 + benchmark/tpch/sf1/tpch_sf1.benchmark.in:1-17): for each of
q01..q22, one untimed warmup run, then NRUNS timed runs, emitted as
`name,run,timing` CSV rows (seconds).  Answers are verified against the
reference golden CSVs on the warmup run; a FAIL row is emitted instead
of timings on mismatch.

Usage: python benchmarks/tpch_sf1_runner.py [--sf 1.0] [--runs 5]
       [--out tpch_sf1.csv] [--queries 1,6,9]

Timing notes: each run is an end-to-end engine execution (staged
executor, plan caches warm after the warmup) measured with a host pull
of the materialized result, the same thing a client would observe.
First-compile happens in the warmup; the persistent XLA compilation
cache (duckdb_cubit/__init__.py) carries compiles across processes.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--queries", default=None,
                    help="comma-separated subset, default all 22")
    args = ap.parse_args()

    from duckdb_cubit.api import connect
    from duckdb_cubit.tpch import answers

    qs = ([int(x) for x in args.queries.split(",")] if args.queries
          else list(range(1, 23)))

    t0 = time.perf_counter()
    conn = connect(sf=args.sf)
    print(f"# loaded sf{args.sf} in {time.perf_counter()-t0:.1f}s",
          file=sys.stderr, flush=True)

    rows_out = ["name,run,timing"]
    have_answers = answers.answers_available() and args.sf in (0.01, 0.1, 1)
    for q in qs:
        name = f"benchmark/tpch/sf{args.sf:g}/q{q:02d}.benchmark"
        try:
            tw = time.perf_counter()
            res = conn.tpch_query(q)
            rows = res.strings()
            warm = time.perf_counter() - tw
            if have_answers:
                problems = answers.compare(rows, args.sf, q)
                if problems:
                    print(f"# q{q:02d} WRONG: {problems[:2]}",
                          file=sys.stderr, flush=True)
                    rows_out.append(f"{name},FAIL,wrong-answer")
                    continue
            print(f"# q{q:02d} warmup {warm:.2f}s", file=sys.stderr,
                  flush=True)
            for r in range(1, args.runs + 1):
                t = time.perf_counter()
                res = conn.tpch_query(q)
                res.strings()           # materialize: what a client sees
                dt = time.perf_counter() - t
                rows_out.append(f"{name},{r},{dt:.6f}")
                print(f"# q{q:02d} run {r}: {dt:.3f}s", file=sys.stderr,
                      flush=True)
        except Exception as e:  # noqa: BLE001 - record and continue
            print(f"# q{q:02d} ERROR: {e}", file=sys.stderr, flush=True)
            rows_out.append(f"{name},FAIL,{type(e).__name__}")

    csv = "\n".join(rows_out) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(csv)
        print(f"# wrote {args.out}", file=sys.stderr)
    else:
        print(csv)


if __name__ == "__main__":
    main()
