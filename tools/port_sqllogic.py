#!/usr/bin/env python
"""Port reference sqllogictest files that pass under this engine.

Walks the reference's test/sql corpus (reference test/sqlite/
sqllogic_test_runner.cpp executes 2904 such files), runs each file
against a fresh Connection, and copies files that FULLY pass into
tests/sqllogic/ported/ (with a provenance header).  Files that fail
parse/bind/execute are recorded with their first error line in
tests/sqllogic/PORTED_SKIPLIST.md — an explicit dialect-coverage map
rather than silent omission.

Usage: python tools/port_sqllogic.py [--limit N] [--timeout S] [dirs...]
"""

import argparse
import os
import signal
import sys
import time

# the porter only parses and runs tiny tables: pin it to the CPU
# programmatically (conftest.py's pattern) so it never takes an accelerator
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/test/sql"
DEFAULT_DIRS = ["filter", "join", "aggregate", "order", "subquery",
                "projection", "limit", "types/integer", "types/decimal",
                "types/null", "cast", "conjunction", "distinct",
                "update", "delete", "insert", "window"]


class _Timeout(Exception):
    pass


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=200)
    ap.add_argument("--timeout", type=int, default=45)
    ap.add_argument("--max-bytes", type=int, default=24_000)
    ap.add_argument("dirs", nargs="*", default=None)
    args = ap.parse_args()

    from duckdb_cubit.api import Connection
    from duckdb_cubit.testing import sqllogic as SL

    dirs = args.dirs or DEFAULT_DIRS
    candidates = []
    for d in dirs:
        base = os.path.join(REF, d)
        for root, _, files in os.walk(base):
            for f in sorted(files):
                if f.endswith(".test"):
                    p = os.path.join(root, f)
                    try:
                        sz = os.path.getsize(p)
                    except OSError:
                        continue
                    if sz <= args.max_bytes:
                        candidates.append((sz, p))
    candidates.sort()
    print(f"# {len(candidates)} candidate files", file=sys.stderr)

    out_dir = os.path.join("tests", "sqllogic", "ported")
    os.makedirs(out_dir, exist_ok=True)
    ported, skipped = [], []

    def alarm(signum, frame):
        raise _Timeout()

    signal.signal(signal.SIGALRM, alarm)
    for sz, path in candidates:
        if len(ported) >= args.limit:
            break
        rel = os.path.relpath(path, REF)
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError:
            continue
        signal.alarm(args.timeout)
        t0 = time.perf_counter()
        print(f"try {rel}", file=sys.stderr, flush=True)
        try:
            report = SL.run_script(text, conn=Connection(), path=rel)
            signal.alarm(0)
            if report.skipped or report.executed < 3:
                skipped.append((rel, f"skipped (requires/{report.executed} "
                                f"records)"))
                continue
            name = rel.replace("/", "__")
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(f"# ported from reference test/sql/{rel}\n"
                        f"# (sqllogictest corpus; runnable under the "
                        f"duckdb_cubit dialect, {report.executed} "
                        f"records)\n\n" + text)
            ported.append(rel)
            print(f"PORT {rel} ({report.executed} records, "
                  f"{time.perf_counter()-t0:.1f}s)", file=sys.stderr)
        except _Timeout:
            skipped.append((rel, "timeout"))
        except Exception as e:  # noqa: BLE001
            signal.alarm(0)
            first = str(e).split("\n")
            msg = next((ln for ln in first if "-->" in ln), first[0])[:160]
            skipped.append((rel, msg))
    signal.alarm(0)

    with open(os.path.join("tests", "sqllogic", "PORTED_SKIPLIST.md"),
              "w") as f:
        f.write("# Reference sqllogic files not yet runnable\n\n"
                "Generated by tools/port_sqllogic.py; each entry is the "
                "first failure\nline (dialect gap, unsupported feature, or "
                "timeout).\n\n")
        for rel, msg in skipped:
            f.write(f"- `{rel}` — {msg}\n")
    print(f"# ported {len(ported)}, skipped {len(skipped)}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
