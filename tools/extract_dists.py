#!/usr/bin/env python
"""Extract the TPC-H specification distribution tables (dists.dss) into JSON.

The distribution data (word lists and weights for p_container, colors, p_types,
nations, regions, order priorities, ship instructions/modes, return flags,
market segments, and the text-generation grammar) is normative TPC-H
specification data owned by the Transaction Processing Performance Council.
The reference embeds it as a C string (reference:
extension/tpch/dbgen/include/dbgen/dists_dss.h); we restructure it into
`duckdb_cubit/tpch/dists.json` as {name: [[token, weight], ...]} so the
engine's native generator can load it without any C-header parsing.

Run once:  python tools/extract_dists.py
"""
import json
import os
import re

REF = "/root/reference/extension/tpch/dbgen/include/dbgen/dists_dss.h"
OUT = os.path.join(os.path.dirname(__file__), "..", "duckdb_cubit", "tpch", "dists.json")


def parse_c_string_literal(src: str) -> str:
    # concatenated "..." fragments; decode escapes
    parts = re.findall(r'"((?:[^"\\]|\\.)*)"', src)
    text = "".join(parts)
    return text.encode().decode("unicode_escape")


def parse_dists(text: str) -> dict:
    dists = {}
    name = None
    cur = None
    for raw in text.split("\n"):
        line = raw.split("#", 1)[0].strip("\r")
        if not line.strip():
            continue
        toks = line.split()
        if toks and toks[0].upper() == "BEGIN":
            name = toks[1].lower()
            cur = []
            continue
        if toks and toks[0].upper().startswith("END"):
            if name is not None:
                dists[name] = cur
            name, cur = None, None
            continue
        if name is None or "|" not in line:
            continue
        token, weight = line.rsplit("|", 1)
        try:
            w = int(weight.strip())
        except ValueError:
            continue
        if token.lower() == "count":
            continue  # count rows are redundant with the list length
        cur.append([token, w])
    return dists


def main():
    with open(REF) as f:
        src = f.read()
    text = parse_c_string_literal(src)
    dists = parse_dists(text)
    with open(os.path.abspath(OUT), "w") as f:
        json.dump(dists, f, indent=1)
    for k, v in dists.items():
        print(f"{k}: {len(v)} entries, total weight {sum(w for _, w in v)}")


if __name__ == "__main__":
    main()
