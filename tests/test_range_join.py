"""Non-equi joins: RangeJoin operator + binder wiring.

The analog of the reference's nested-loop / piecewise-merge / IE joins and
cross product (reference src/execution/operator/join/
physical_nested_loop_join.cpp, physical_piecewise_merge_join.cpp,
physical_iejoin.cpp:1-1049, physical_cross_product.cpp) — here one
sort+searchsorted range operator with residual re-checks on expanded pairs.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from duckdb_cubit.api import connect
from duckdb_cubit.ops.expressions import Col
from duckdb_cubit.plan import physical as P
from duckdb_cubit.plan.physical import Relation, RelColumn
from duckdb_cubit.types import INT64


class _Fixed(P.PhysicalOperator):
    def __init__(self, rel):
        super().__init__([])
        self.rel = rel

    def _execute(self, ctx):
        return self.rel

    def _self_signature(self):
        return "fixed"


def _rel(cols, n, cap=None):
    cap = cap or n
    mask = jnp.arange(cap) < n
    out = {}
    for k, v in cols.items():
        a = np.zeros(cap, np.int64)
        a[:n] = v
        out[k] = RelColumn(jnp.asarray(a), INT64, None)
    return Relation(out, mask, cap)


@pytest.fixture(scope="module")
def conn():
    return connect(sf=0.01)


@pytest.mark.parametrize("op,fn", [
    ("<", np.less), ("<=", np.less_equal),
    (">", np.greater), (">=", np.greater_equal), ("==", np.equal)])
def test_operator_each_op_matches_oracle(op, fn):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, 40)
    b = rng.integers(0, 50, 30)
    j = P.RangeJoin(_Fixed(_rel({"x": a}, 40)), _Fixed(_rel({"y": b}, 30)),
                    [(Col("x"), op, Col("y"))], out_capacity=8192)
    r = j._execute(P.ExecContext(None))
    m = np.asarray(r.mask)
    xs = np.asarray(r.columns["x"].array)[m]
    ys = np.asarray(r.columns["y"].array)[m]
    wi, wj = np.nonzero(fn(a[:, None], b[None, :]))
    assert sorted(zip(xs.tolist(), ys.tolist())) == \
        sorted(zip(a[wi].tolist(), b[wj].tolist()))


def test_operator_residual_condition_iejoin_shape():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 50, 40)
    b = rng.integers(0, 50, 30)
    j = P.RangeJoin(_Fixed(_rel({"x": a}, 40)), _Fixed(_rel({"y": b}, 30)),
                    [(Col("x"), "<", Col("y")),
                     (Col("x") + Col("x"), ">", Col("y"))],
                    out_capacity=8192)
    r = j._execute(P.ExecContext(None))
    want = int(((a[:, None] < b[None, :]) & (2 * a[:, None] > b[None, :]))
               .sum())
    assert int(jnp.sum(r.mask)) == want


def test_operator_semi_anti_cross():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 50, 40)
    b = rng.integers(0, 50, 30)
    pr, br = _Fixed(_rel({"x": a}, 40)), _Fixed(_rel({"y": b}, 30))
    ctx = P.ExecContext(None)
    semi = P.RangeJoin(pr, br, [(Col("x"), "<", Col("y"))], join_type="semi")
    want = int((a[:, None] < b[None, :]).any(1).sum())
    assert int(jnp.sum(semi._execute(ctx).mask)) == want
    anti = P.RangeJoin(pr, br, [(Col("x"), "<", Col("y"))], join_type="anti")
    assert int(jnp.sum(anti._execute(ctx).mask)) == 40 - want
    cross = P.RangeJoin(pr, br, [], out_capacity=8192)
    assert int(jnp.sum(cross._execute(ctx).mask)) == 1200


def test_sql_pure_inequality_join(conn):
    r = conn.sql("SELECT count(*) AS c FROM nation n1, nation n2 "
                 "WHERE n1.n_nationkey < n2.n_nationkey").rows()
    assert r[0][0] == 25 * 24 // 2


def test_sql_cross_product(conn):
    r = conn.sql("SELECT count(*) AS c FROM region, nation").rows()
    assert r[0][0] == 125


def test_sql_range_join_with_residual(conn):
    r = conn.sql("SELECT count(*) AS c FROM nation n1, nation n2 "
                 "WHERE n1.n_nationkey < n2.n_nationkey "
                 "AND n1.n_regionkey > n2.n_regionkey").rows()
    t = conn.catalog.table("nation")
    k = np.asarray(t.columns["n_nationkey"].data)[:25]
    g = np.asarray(t.columns["n_regionkey"].data)[:25]
    want = int(((k[:, None] < k[None, :]) & (g[:, None] > g[None, :])).sum())
    assert r[0][0] == want


def test_sql_equi_edge_keeps_inequality_as_post_filter(conn):
    r = conn.sql("SELECT count(*) AS c FROM nation n, region r "
                 "WHERE n.n_regionkey = r.r_regionkey "
                 "AND n.n_nationkey > r.r_regionkey").rows()
    t = conn.catalog.table("nation")
    k = np.asarray(t.columns["n_nationkey"].data)[:25]
    g = np.asarray(t.columns["n_regionkey"].data)[:25]
    assert r[0][0] == int((k > g).sum())


def test_sql_range_join_larger_side(conn):
    r = conn.sql("SELECT count(*) AS c FROM supplier s, nation n "
                 "WHERE s.s_nationkey < n.n_nationkey").rows()
    sn = np.asarray(conn.catalog.table("supplier")
                    .columns["s_nationkey"].data)[:100]
    k = np.asarray(conn.catalog.table("nation")
                   .columns["n_nationkey"].data)[:25]
    assert r[0][0] == int((sn[:, None] < k[None, :]).sum())
