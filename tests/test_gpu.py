"""The scan-sum and PK-probe paths as compiled for the GPU, at SF1 lineitem
width, against plain numpy.  They skip off the card; `chip_smoke.py` runs
them there."""

import jax
import numpy as np
import pytest

from duckdb_cubit.index import pk as pk_index
from duckdb_cubit.ops import bitmap as bm
from duckdb_cubit.storage.table import pad_count

pytestmark = pytest.mark.gpu

SF1_LINEITEM_ROWS = 6_001_215
SF1_ORDERS_ROWS = 1_500_000


def test_words_sum_on_card_matches_numpy(gpu_device):
    rng = np.random.default_rng(6)
    cap = pad_count(SF1_LINEITEM_ROWS)
    mask = np.zeros(cap, bool)
    mask[:SF1_LINEITEM_ROWS] = rng.random(SF1_LINEITEM_ROWS) < 0.02
    price = rng.integers(90_000, 10_500_000, cap).astype(np.int32)
    disc = rng.integers(0, 11, cap).astype(np.int8)
    words = np.packbits(mask.reshape(-1, 32)[:, ::-1], axis=1,
                        bitorder="big").view(">u4").ravel().astype(np.uint32)
    put = lambda x: jax.device_put(x, gpu_device)  # noqa: E731
    fused = jax.jit(lambda w, a, b: bm.words_sum(
        w, a.astype(np.int32) * b.astype(np.int32)))
    got = int(fused(put(words), put(price), put(disc)))
    want = int((price[mask].astype(np.int64) * disc[mask]).sum())
    assert got == want


def test_pk_probe_on_card_matches_numpy(gpu_device):
    rng = np.random.default_rng(3)
    # orders keys are sparse (8 of every 32 key values), lineitem's FKs
    # arrive sorted in runs of 1-7
    build_keys = np.sort(rng.choice(4 * SF1_ORDERS_ROWS, SF1_ORDERS_ROWS,
                                    replace=False)) + 1
    alive = rng.random(SF1_ORDERS_ROWS) < 0.5
    probe = np.repeat(build_keys, rng.integers(1, 8, SF1_ORDERS_ROWS))
    probe[::11] += 1                     # some misses
    idx = pk_index.DirectPKIndex.build("o_orderkey", build_keys,
                                       SF1_ORDERS_ROWS)
    put = lambda x: jax.device_put(x, gpu_device)  # noqa: E731
    fn = jax.jit(lambda lut, k, v, m: pk_index.probe(lut, idx.max_key, k, v,
                                                     m))
    row, found = fn(put(idx.lut), put(probe),
                    put(np.ones(len(probe), bool)), put(alive))
    lut = np.asarray(idx.lut)
    want_row = lut[np.clip(probe, 0, idx.max_key)]
    want_found = (probe <= idx.max_key) & (want_row >= 0) & \
        alive[np.maximum(want_row, 0)]
    assert np.array_equal(np.asarray(found), want_found)
    assert np.array_equal(np.asarray(row), np.where(want_found, want_row, -1))
