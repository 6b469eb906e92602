#!/usr/bin/env python
"""Interactive SQL shell for duckdb_cubit.

Analog of the reference's CLI shell (reference tools/shell/): REPL over the
Connection API with dot-commands for catalog inspection, timing, EXPLAIN,
and TPC-H helpers.

Usage:  python tools/shell.py [--sf 0.01] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=None,
                    help="load TPC-H at this scale factor")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from duckdb_cubit.api import connect

    print("duckdb_cubit shell — \\q quit, \\d tables, \\timing, "
          "\\explain <sql>, \\tpch <n>")
    t0 = time.time()
    conn = connect(sf=args.sf)
    if args.sf is not None:
        print(f"TPC-H sf{args.sf} loaded in {time.time()-t0:.1f}s")
    timing = True
    buf = []
    while True:
        try:
            prompt = "sql> " if not buf else "...> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not buf and line.startswith("\\"):
            cmd, *rest = line.split(None, 1)
            if cmd in ("\\q", "\\quit"):
                break
            if cmd == "\\d":
                for name, t in conn.catalog.tables.items():
                    idx = ",".join(t.indexes) or "-"
                    print(f"{name:12} {t.num_rows:>12} rows  indexes: {idx}")
                continue
            if cmd == "\\timing":
                timing = not timing
                print(f"timing {'on' if timing else 'off'}")
                continue
            if cmd == "\\explain" and rest:
                print(conn.explain(rest[0]))
                continue
            if cmd == "\\tpch" and rest:
                t0 = time.time()
                res = conn.tpch_query(int(rest[0]))
                out = res.strings()
                dt = time.time() - t0
                for r in out[:40]:
                    print(" | ".join(r))
                print(f"({len(out)} rows{f', {dt:.3f}s' if timing else ''})")
                continue
            print(f"unknown command {cmd}")
            continue
        buf.append(line)
        joined = "\n".join(buf)
        if not joined.rstrip().endswith(";") and line.strip() != "":
            continue
        buf = []
        sql = joined.strip().rstrip(";")
        if not sql:
            continue
        try:
            t0 = time.time()
            res = conn.sql(sql)
            rows = res.strings()
            dt = time.time() - t0
            for r in rows[:100]:
                print(" | ".join(r))
            extra = f", {dt:.3f}s" if timing else ""
            if res.status and not rows:
                print(f"{res.status}{f' ({dt:.3f}s)' if timing else ''}")
            else:
                print(f"({len(rows)} rows{extra})")
        except Exception as e:
            print(f"error: {e}")


if __name__ == "__main__":
    main()
