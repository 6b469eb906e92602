"""Independent numpy oracle for TPC-H Q1, Q3 and Q6.

Recomputes each answer from the catalog's unpadded host columns
(`Column.host`) with plain numpy: no engine kernel, plan or device array is
involved, so a fault in the engine cannot confirm itself.  Decimals are
int64 cents summed exactly; averages are doubles, which the engine reduces
in another order, so they compare within a relative 1e-9.

`SQL` holds the three queries' texts with the TPC-H specification's
validation parameters (Q1 DELTA = 90, Q3 SEGMENT = BUILDING and
DATE = 1995-03-15, Q6 DATE = 1994-01-01, DISCOUNT = 0.06, QUANTITY = 24).
"""

from __future__ import annotations

import numpy as np

from ..exec.result import DOUBLE_REL_TOL, format_decimal
from ..types import date_to_days, days_to_date

SQL = {
    1: """
        SELECT l_returnflag, l_linestatus,
               sum(l_quantity) AS sum_qty,
               sum(l_extendedprice) AS sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               avg(l_quantity) AS avg_qty,
               avg(l_extendedprice) AS avg_price,
               avg(l_discount) AS avg_disc,
               count(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= CAST('1998-09-02' AS date)
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    3: """
        SELECT l_orderkey,
               sum(l_extendedprice * (1 - l_discount)) AS revenue,
               o_orderdate, o_shippriority
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING'
          AND c_custkey = o_custkey
          AND l_orderkey = o_orderkey
          AND o_orderdate < CAST('1995-03-15' AS date)
          AND l_shipdate > CAST('1995-03-15' AS date)
        GROUP BY l_orderkey, o_orderdate, o_shippriority
        ORDER BY revenue DESC, o_orderdate
        LIMIT 10
    """,
    6: """
        SELECT sum(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= CAST('1994-01-01' AS date)
          AND l_shipdate < CAST('1995-01-01' AS date)
          AND l_discount BETWEEN 0.05 AND 0.07
          AND l_quantity < 24
    """,
}

# rows per int64 partial sum: every addend here is below 2^40, so a chunk
# sum stays below 2^63 and the Python-int total is exact
_CHUNK = 1 << 20


def _exact_sum(values: np.ndarray) -> int:
    v = values.astype(np.int64)
    return sum(int(v[i:i + _CHUNK].sum()) for i in range(0, len(v), _CHUNK))


def _host(catalog, table: str, names) -> dict:
    t = catalog.table(table)
    return {n: np.asarray(t.columns[n].host[:t.num_rows]) for n in names}


def q1(catalog) -> list[list]:
    h = _host(catalog, "lineitem", (
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate"))
    m = h["l_shipdate"] <= date_to_days("1998-09-02")
    rf, ls = h["l_returnflag"][m], h["l_linestatus"][m]
    qty = h["l_quantity"][m].astype(np.int64)
    price = h["l_extendedprice"][m].astype(np.int64)
    disc = h["l_discount"][m].astype(np.int64)
    tax = h["l_tax"][m].astype(np.int64)
    disc_price = price * (100 - disc)              # scale 4
    rows = []
    for r in np.unique(rf):
        for s in np.unique(ls):
            g = (rf == r) & (ls == s)
            n = int(g.sum())
            if not n:
                continue
            sum_qty, sum_price = _exact_sum(qty[g]), _exact_sum(price[g])
            # price*(1-disc)*(1+tax) at scale 6 reaches ~2^37 per row
            charge = _exact_sum(disc_price[g] * (100 + tax[g]))
            rows.append([
                chr(r), chr(s),
                format_decimal(sum_qty, 2), format_decimal(sum_price, 2),
                format_decimal(_exact_sum(disc_price[g]), 4),
                format_decimal(charge, 6),
                sum_qty / 100 / n, sum_price / 100 / n,
                _exact_sum(disc[g]) / 100 / n,
                str(n)])
    return rows


def q3(catalog) -> list[list]:
    cust = catalog.table("customer")
    seg = cust.columns["c_mktsegment"]
    codes = np.flatnonzero(seg.dictionary == b"BUILDING")
    c = _host(catalog, "customer", ("c_custkey", "c_mktsegment"))
    building = c["c_custkey"][np.isin(c["c_mktsegment"], codes)]
    o = _host(catalog, "orders", ("o_orderkey", "o_custkey", "o_orderdate",
                                  "o_shippriority"))
    om = (o["o_orderdate"] < date_to_days("1995-03-15")) & \
        np.isin(o["o_custkey"], building)
    okeys = o["o_orderkey"][om].astype(np.int64)
    odate = o["o_orderdate"][om].astype(np.int64)
    oprio = o["o_shippriority"][om].astype(np.int64)
    li = _host(catalog, "lineitem", ("l_orderkey", "l_extendedprice",
                                     "l_discount", "l_shipdate"))
    lm = (li["l_shipdate"] > date_to_days("1995-03-15")) & \
        np.isin(li["l_orderkey"], okeys)
    lkey = li["l_orderkey"][lm].astype(np.int64)
    rev = (li["l_extendedprice"][lm].astype(np.int64)
           * (100 - li["l_discount"][lm].astype(np.int64)))
    if not len(lkey):
        return []
    order = np.argsort(lkey, kind="stable")
    lkey, rev = lkey[order], rev[order]
    starts = np.flatnonzero(np.r_[True, lkey[1:] != lkey[:-1]])
    gkeys = lkey[starts]
    grev = np.add.reduceat(rev, starts)             # <= 7 lines per order
    pos = np.searchsorted(np.sort(okeys), gkeys)
    by_key = np.argsort(okeys)
    gdate, gprio = odate[by_key][pos], oprio[by_key][pos]
    top = np.lexsort((gdate, -grev))[:10]
    return [[str(int(gkeys[i])), format_decimal(int(grev[i]), 4),
             days_to_date(int(gdate[i])).isoformat(), str(int(gprio[i]))]
            for i in top]


def q6(catalog) -> list[list]:
    h = _host(catalog, "lineitem", ("l_shipdate", "l_discount", "l_quantity",
                                    "l_extendedprice"))
    m = ((h["l_shipdate"] >= date_to_days("1994-01-01"))
         & (h["l_shipdate"] < date_to_days("1995-01-01"))
         & (h["l_discount"] >= 5) & (h["l_discount"] <= 7)
         & (h["l_quantity"] < 2400))
    rev = (h["l_extendedprice"][m].astype(np.int64)
           * h["l_discount"][m].astype(np.int64))
    return [[format_decimal(_exact_sum(rev), 4)]]


ORACLES = {1: q1, 3: q3, 6: q6}


def compare(got: list[list[str]], want: list[list]) -> list[str]:
    """Engine rows (strings) against oracle rows -> mismatch descriptions
    (empty = equal).  A float oracle cell is a DOUBLE and compares within
    DOUBLE_REL_TOL; every other cell must match its string exactly."""
    if len(got) != len(want):
        return [f"row count: got {len(got)}, want {len(want)}"]
    problems = []
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            problems.append(f"row {i}: {len(g)} columns, want {len(w)}")
            continue
        for j, (gc, wc) in enumerate(zip(g, w)):
            if isinstance(wc, float):
                ok = abs(float(gc) - wc) <= DOUBLE_REL_TOL * max(
                    abs(wc), abs(float(gc)), 1e-300)
            else:
                ok = gc == wc
            if not ok:
                problems.append(f"row {i} col {j}: got {gc!r}, want {wc!r}")
    return problems


def check(conn, query: int) -> list[str]:
    """Run SQL[query] through `conn.sql` and compare it with the oracle."""
    got = conn.sql(SQL[query]).strings()
    return compare(got, ORACLES[query](conn.catalog))
