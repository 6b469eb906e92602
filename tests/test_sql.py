"""SQL frontend tests: parse + bind + execute against the numpy oracle."""

import pytest

from duckdb_cubit.api import connect
from duckdb_cubit.sql.parser import parse
from duckdb_cubit.tpch import oracle


@pytest.fixture(scope="module")
def conn():
    return connect(sf=0.01)


def test_parse_all_reference_queries():
    import glob

    files = sorted(glob.glob(
        "/root/reference/extension/tpch/dbgen/queries/q*.sql"))
    if not files:
        pytest.skip("reference queries not mounted")
    for f in files:
        parse(open(f).read())


def test_sql_q6_matches_golden(conn):
    assert not oracle.check(conn, 6)


def test_sql_q1_matches_golden(conn):
    assert not oracle.check(conn, 1)


def test_sql_q3_matches_oracle(conn):
    assert not oracle.check(conn, 3)


def test_sql_q6_fused_scan_sum_matches_oracle():
    from duckdb_cubit.plan import optimizer as opt
    from duckdb_cubit.plan.physical import ExecContext, GroupAggregate

    # at SF0.01 the index scan would decode row ids; with the decode
    # thresholds at zero it keeps the bitmap and sums from its words, as
    # at SF1 and above
    conn = connect(sf=0.01)
    conn.sql("SET index_scan_max_count = 0")
    conn.sql("SET index_scan_percentage = 0")
    plan = opt.optimize(conn.binder.bind_sql(oracle.SQL[6]), conn.catalog)
    conn.executor.execute(plan, optimize=False)
    agg = [o for o in plan.walk() if isinstance(o, GroupAggregate)]
    fused = agg[0]._fused_pattern(ExecContext(conn.catalog, conn.config))
    # l_extendedprice * l_discount < 2^31: the int32 words-fused sum
    assert fused is not None and fused["prod_max"] < 2**31
    assert not oracle.check(conn, 6)


@pytest.mark.parametrize("got,ok", [
    ([["1.00", 2.0000000001]], True),      # double within 1e-9
    ([["1.00", 2.00001]], False),          # double beyond it
    ([["1.01", 2.0]], False),              # a decimal one cent off
    ([["1.00", 2.0], ["1.00", 2.0]], False),  # extra row
])
def test_oracle_compare(got, ok):
    strings = [[str(c) for c in row] for row in got]
    assert (not oracle.compare(strings, [["1.00", 2.0]])) == ok


def test_sql_join_aggregate(conn):
    # revenue per nation for one month, via SQL joins
    rows = conn.sql("""
        SELECT n_name, count(*) AS cnt
        FROM lineitem, supplier, nation
        WHERE l_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND l_shipdate >= date '1994-01-01'
          AND l_shipdate < date '1994-02-01'
        GROUP BY n_name
        ORDER BY cnt DESC, n_name
        LIMIT 5
    """).strings()
    assert len(rows) == 5
    assert int(rows[0][1]) >= int(rows[1][1])


def test_sql_simple_select_limit(conn):
    rows = conn.sql(
        "SELECT n_name, n_regionkey FROM nation ORDER BY n_name LIMIT 3"
    ).strings()
    assert rows[0][0] == "ALGERIA"
    assert len(rows) == 3


def test_sql_scalar_subquery(conn):
    rows = conn.sql("""
        SELECT count(*) AS n FROM orders
        WHERE o_totalprice > (SELECT avg(o_totalprice) FROM orders)
    """).strings()
    n = int(rows[0][0])
    total = int(conn.sql("SELECT count(*) AS n FROM orders").strings()[0][0])
    assert 0 < n < total


def test_sql_date_interval_fold(conn):
    a = conn.sql("SELECT count(*) AS n FROM orders "
                 "WHERE o_orderdate < date '1998-12-01' - interval '90' day"
                 ).strings()
    b = conn.sql("SELECT count(*) AS n FROM orders "
                 "WHERE o_orderdate < date '1998-09-02'").strings()
    assert a == b


def test_explain(conn):
    text = conn.explain("SELECT count(*) AS n FROM lineitem WHERE l_quantity < 10")
    assert "table_scan" in text and "group_aggregate" in text
