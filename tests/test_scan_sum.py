"""Fused bitmap-scan + exact SUM (ops/bitmap.words_sum) and the direct-
address PK probe (index/pk.probe) against plain numpy references."""

import jax.numpy as jnp
import numpy as np
import pytest

from duckdb_cubit.index import pk as pk_index
from duckdb_cubit.ops import bitmap as bm
from duckdb_cubit.storage.table import pad_count


def _numpy_words(mask: np.ndarray) -> np.ndarray:
    """Reference packing: bit (r & 31) of word (r >> 5) covers row r."""
    n_words = len(mask) // 32
    bits = mask.reshape(n_words, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


def _case(n_rows, seed, a_max, b_max):
    rng = np.random.default_rng(seed)
    cap = pad_count(n_rows)
    mask = np.zeros(cap, bool)
    mask[:n_rows] = rng.random(n_rows) < 0.3
    a = np.zeros(cap, np.int64)
    b = np.zeros(cap, np.int64)
    a[:n_rows] = rng.integers(0, a_max, n_rows)
    b[:n_rows] = rng.integers(0, b_max, n_rows)
    # padding rows carry garbage that their zero bits must cancel
    a[n_rows:] = a_max - 1
    b[n_rows:] = b_max - 1
    return mask, a, b


# row counts: one row, a ragged tail inside the last word and block, exact
# blocks, and several blocks with a ragged tail
SIZES = [1, 8191, 65536, 100003]


# payload storage widths as the narrowing codec leaves them (l_discount is
# int8 on the device); the engine widens to int32 before the product
@pytest.mark.parametrize("b_dtype", [jnp.int8, jnp.int32],
                         ids=["int8", "int32"])
@pytest.mark.parametrize("n_rows", SIZES)
def test_words_sum_matches_numpy(n_rows, b_dtype):
    mask, a, b = _case(n_rows, n_rows, 2**24, 2**7)
    words = jnp.asarray(_numpy_words(mask))
    vals = (jnp.asarray(a, jnp.int32)
            * jnp.asarray(b, b_dtype).astype(jnp.int32))
    got = int(bm.words_sum(words, vals))
    want = int((a[mask].astype(object) * b[mask].astype(object)).sum())
    assert got == want


@pytest.mark.parametrize("n_rows", [65536, 100003])
def test_words_sum_products_near_2_31_stay_exact(n_rows):
    # every product sits just under 2^31: an int32 accumulator would wrap
    # after two rows, and a float64 one would round
    mask, a, b = _case(n_rows, 7, 2**24, 2**7)
    a[:] = 2**24 - 1 - (np.arange(len(a)) % 3)
    b[:] = 127
    vals = jnp.asarray(a, jnp.int32) * jnp.asarray(b, jnp.int32)
    assert int(jnp.max(vals)) == (2**24 - 1) * 127
    got = int(bm.words_sum(jnp.asarray(_numpy_words(mask)), vals))
    want = int((a[mask].astype(object) * 127).sum())
    assert got == want and want > 2**40


def test_words_sum_equals_expanded_mask_sum():
    mask, a, _ = _case(40000, 3, 2**31 - 1, 2)
    words = jnp.asarray(_numpy_words(mask))
    vals = jnp.asarray(a, jnp.int32)
    expanded = bm.expand(words, len(mask))
    assert np.array_equal(np.asarray(expanded), mask)
    want = jnp.sum(jnp.where(expanded, vals.astype(jnp.int64), 0))
    assert int(bm.words_sum(words, vals)) == int(want)


# ---------------------------------------------------------------- PK probe

def _probe_case(kind, seed=0):
    rng = np.random.default_rng(seed)
    n_build = 5000
    if kind == "sparse":
        build_keys = np.sort(rng.choice(4 * n_build, n_build, replace=False))
    else:
        build_keys = np.arange(1, n_build + 1)
    build_alive = np.ones(n_build, bool)
    if kind == "dead_build_rows":
        build_alive = rng.random(n_build) < 0.5
    if kind == "absent":
        # half the probes miss: below, above and inside the key range
        probe = np.concatenate([
            rng.integers(-50, 0, 500), rng.integers(n_build + 1,
                                                    2 * n_build, 500),
            rng.choice(build_keys, 1000)])
    else:
        probe = np.repeat(build_keys, rng.integers(1, 8, n_build))
        if kind in ("sparse", "absent"):
            probe = probe + rng.integers(0, 2, len(probe))
    if kind == "unsorted":
        probe = rng.permutation(probe)
    return build_keys, build_alive, probe


@pytest.mark.parametrize("kind", ["dense", "absent", "sparse", "unsorted",
                                  "dead_build_rows"])
def test_pk_probe_matches_numpy(kind):
    build_keys, build_alive, probe = _probe_case(kind)
    idx = pk_index.DirectPKIndex.build("k", build_keys, len(build_keys))
    assert idx is not None
    probe_valid = np.ones(len(probe), bool)
    probe_valid[::17] = False
    row, found = pk_index.probe(idx.lut, idx.max_key, jnp.asarray(probe),
                                jnp.asarray(probe_valid),
                                jnp.asarray(build_alive))
    where = {int(k): r for r, k in enumerate(build_keys)}
    want_row = np.array([where.get(int(k), -1) for k in probe])
    want_found = (want_row >= 0) & probe_valid & \
        build_alive[np.maximum(want_row, 0)]
    assert np.array_equal(np.asarray(found), want_found)
    assert np.array_equal(np.asarray(row), np.where(want_found, want_row, -1))


@pytest.mark.parametrize("a_max", [2**20, 2**40], ids=["int32", "int64"])
def test_fused_scan_sum_through_sql_matches_numpy(a_max):
    # int32 products take words_sum; products past 2^31 take the exact
    # hi/lo split over the expanded mask
    from duckdb_cubit.api import Connection
    from duckdb_cubit.plan import optimizer as opt
    from duckdb_cubit.plan.physical import ExecContext, GroupAggregate

    rng = np.random.default_rng(5)
    n = 50000
    a = rng.integers(0, a_max, n)
    b = rng.integers(0, 100, n)
    v = rng.integers(0, 64, n)
    conn = Connection()
    conn.register_numpy("t", {"a": a, "b": b, "v": v})
    conn.sql("CREATE INDEX ON t(v)")
    conn.sql("SET index_scan_max_count = 0")
    conn.sql("SET index_scan_percentage = 0")
    q = "SELECT sum(a * b) AS s FROM t WHERE v < 20"
    plan = opt.optimize(conn.binder.bind_sql(q), conn.catalog)
    conn.executor.execute(plan, optimize=False)
    agg = [o for o in plan.walk() if isinstance(o, GroupAggregate)][0]
    info = agg._fused_pattern(ExecContext(conn.catalog, conn.config))
    assert info is not None and (info["prod_max"] < 2**31) == (a_max < 2**31)
    m = v < 20
    want = int((a[m].astype(object) * b[m].astype(object)).sum())
    assert conn.sql(q).strings() == [[str(want)]]
