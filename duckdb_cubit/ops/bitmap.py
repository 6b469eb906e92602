"""Bitvector word kernels: the device compute core of the CUBIT index.

Bitmaps are `uint32[n_bins, n_words]` arrays; bit (r & 31) of word (r >> 5)
covers row r.  Because every row belongs to exactly one bin of a given
column's index, per-column bitmaps are pairwise disjoint, which lets OR over
a bin range lower to an integer SUM (no carries): one fused reduction
instead of a log-depth OR tree.

These kernels replace the reference's index-scan row-id production
(reference src/function/table/table_scan.cpp:251-273 IndexScanFunction and
the ART search producing vector<row_t>, art.cpp:918): predicate evaluation is
segment-wise AND/OR over words, decode is popcount + nonzero.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32


def num_words(capacity: int) -> int:
    return (capacity + WORD_BITS - 1) // WORD_BITS


@functools.partial(jax.jit, static_argnames=("n_bins", "n_words"))
def build_bitmaps(codes: jnp.ndarray, row_valid: jnp.ndarray, n_bins: int,
                  n_words: int) -> jnp.ndarray:
    """Scatter rows into per-bin bitvectors.

    Each row sets exactly one bit in one (bin, word) slot, so the bits being
    summed are distinct powers of two and scatter-ADD equals scatter-OR.
    """
    n = codes.shape[0]
    rows = jnp.arange(n, dtype=jnp.int64)
    word = rows >> 5
    bit = (jnp.uint32(1) << (rows & 31).astype(jnp.uint32))
    bit = jnp.where(row_valid, bit, jnp.uint32(0))
    safe_codes = jnp.clip(codes.astype(jnp.int64), 0, n_bins - 1)
    flat = safe_codes * n_words + word
    words = jnp.zeros(n_bins * n_words, jnp.uint32).at[flat].add(bit)
    return words.reshape(n_bins, n_words)


def or_range(bitmaps: jnp.ndarray, lo: int, hi: int) -> jnp.ndarray:
    """OR of bins [lo, hi] — disjointness makes this an integer sum."""
    if hi < lo:
        return jnp.zeros(bitmaps.shape[1], jnp.uint32)
    return jnp.sum(bitmaps[lo : hi + 1], axis=0, dtype=jnp.uint32)


@jax.jit
def popcount(words: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(jax.lax.population_count(words).astype(jnp.int64))


@functools.partial(jax.jit, static_argnames=("capacity",))
def expand(words: jnp.ndarray, capacity: int) -> jnp.ndarray:
    """Bitvector -> bool row mask of length `capacity`."""
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    bits = (words[:, None] >> shifts[None, :]) & jnp.uint32(1)
    return bits.reshape(-1)[:capacity].astype(jnp.bool_)


@functools.partial(jax.jit, static_argnames=("n_words",))
def pack_mask(mask: jnp.ndarray, n_words: int) -> jnp.ndarray:
    """bool row mask -> bitvector words (inverse of `expand`)."""
    n = mask.shape[0]
    padded = jnp.zeros(n_words * WORD_BITS, jnp.uint32).at[:n].set(
        mask.astype(jnp.uint32))
    lanes = padded.reshape(n_words, WORD_BITS)
    weights = (jnp.uint32(1) << jnp.arange(WORD_BITS, dtype=jnp.uint32))
    return jnp.sum(lanes * weights[None, :], axis=1, dtype=jnp.uint32)


def words_sum(words: jnp.ndarray, values: jnp.ndarray) -> jnp.ndarray:
    """Exact int64 sum of int32 `values` over the rows set in `words`.

    `values` has len(words) * 32 rows.  The bit unpack fuses into the
    reduction, so the predicate costs 0.125 B/row and no row mask is
    materialized.  Each addend is widened to int64, so the sum is exact
    for any row count below 2^32.
    """
    bits = (words[:, None] >> jnp.arange(WORD_BITS, dtype=jnp.uint32)
            ) & jnp.uint32(1)
    v = values.reshape(words.shape[0], WORD_BITS)
    return jnp.sum(jnp.where(bits != 0, v, 0), dtype=jnp.int64)
