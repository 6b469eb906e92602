"""Window function kernels.

Analog of the reference's PhysicalWindow / WindowSegmentTree (reference
src/execution/operator/aggregate/physical_window.cpp:822,
window_segment_tree.cpp).  Design: ONE multi-key sort by
(partition keys, order keys) shared by every function over the same window,
then every frame primitive is a segmented prefix operation — segmented
scans via `lax.associative_scan` with reset flags, rank/peer arithmetic via
positional cummax/cummin — finally scattered back to input row order.  No
segment trees: prefix scans over sorted runs give running frames in O(n);
the reference's default RANGE frame (current row + peers) is the rows
prefix gathered at the row's LAST PEER position.

Sliding frames (ROWS/RANGE BETWEEN m PRECEDING AND n FOLLOWING — the
reference's WindowSegmentTree, window_segment_tree.cpp) are
re-architected for whole-column passes: sum/count/avg are prefix-sum DIFFERENCES at the frame
bounds, min/max use a log-doubling sparse table (two overlapping
power-of-two windows cover any [a, b] exactly because min/max are
idempotent), and RANGE bounds come from a vectorized in-segment binary
search over the sorted order key.  A frame is either a legacy string
("rows_upto" | "range_upto" | "partition") or a tuple
(mode, lo, hi) with mode in {"rows", "range"}, lo/hi int offsets
(None = UNBOUNDED): ("rows", -2, 3) = ROWS BETWEEN 2 PRECEDING AND
3 FOLLOWING.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .kernels import monotone_i64


def _sort_by(partition_keys, order_keys, valid):
    """Sort rows by (validity, partition keys, order keys).

    A leading validity key pushes masked rows to the end WITHOUT a key-value
    sentinel — sentinels collide with monotone-encoded float keys (a double
    2.0 bitcasts to exactly 2**62).  Float keys are mapped through
    kernels.monotone_i64 so ordering is exact (ADVICE r3: int64 casts
    truncated DOUBLE order keys)."""
    n = valid.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    lead = (~valid).astype(jnp.int64)
    keys = tuple(monotone_i64(k) for k in (*partition_keys, *order_keys))
    out = jax.lax.sort((lead,) + keys + (rows,), num_keys=1 + len(keys))
    np_ = len(partition_keys)
    return out[1:1 + np_], out[1 + np_:-1], out[-1]


def _change_flags(sorted_keys, n):
    """True at positions whose key tuple differs from the previous row."""
    change = jnp.zeros(n, jnp.bool_).at[0].set(True)
    for k in sorted_keys:
        change = change | jnp.concatenate(
            [jnp.ones(1, jnp.bool_), k[1:] != k[:-1]])
    return change


@dataclasses.dataclass
class WindowCtx:
    """Shared per-(partition, order) sort analysis.

    perm      : input row index at each sorted position
    starts    : partition-start flags (sorted order)
    change    : peer-group-start flags (partition OR order key changed)
    seg_start : position of this row's partition start
    seg_end   : position of this row's partition end (inclusive)
    last_peer : position of the last row of this row's peer group
    seg_id    : dense partition id per sorted position
    """
    n: int
    perm: jnp.ndarray
    starts: jnp.ndarray
    change: jnp.ndarray
    seg_start: jnp.ndarray
    seg_end: jnp.ndarray
    last_peer: jnp.ndarray
    seg_id: jnp.ndarray
    valid_sorted: jnp.ndarray

    def scatter_back(self, values_sorted):
        return jnp.zeros(self.n, values_sorted.dtype).at[self.perm].set(
            values_sorted)

    def take(self, column_array):
        return jnp.take(column_array, self.perm, axis=0)


def analyze(partition_keys, order_keys, valid) -> WindowCtx:
    """Sort + boundary analysis shared by all functions of one window."""
    n = valid.shape[0]
    spart, sorder, perm = _sort_by(partition_keys, order_keys, valid)
    valid_sorted = jnp.take(valid, perm)
    # the invalid tail forms its own partition even when its partition-key
    # values continue the last valid partition (masked rows must never
    # extend a live partition's seg_end/last_peer)
    vchange = jnp.concatenate(
        [jnp.zeros(1, jnp.bool_), valid_sorted[1:] != valid_sorted[:-1]])
    if partition_keys:
        starts = _change_flags(spart, n) | vchange
    else:
        starts = jnp.zeros(n, jnp.bool_).at[0].set(True) | vchange
    # no ORDER BY: all partition rows are peers (ADVICE r3 — all-ones made
    # rank() behave like row_number())
    change = (starts | _change_flags(sorder, n)) if sorder else starts
    pos = jnp.arange(n, dtype=jnp.int64)
    seg_start = jax.lax.cummax(jnp.where(starts, pos, 0), axis=0)
    # last position of a run: the next flag position minus one, found by a
    # reversed cummin over "this is the final row of its run" markers
    def last_of_run(flags):
        boundary = jnp.concatenate([flags[1:], jnp.ones(1, jnp.bool_)])
        rev = jnp.flip(jnp.where(boundary, pos, n))
        return jnp.flip(jax.lax.cummin(rev, axis=0))
    seg_end = last_of_run(starts)
    last_peer = last_of_run(change)
    seg_id = jnp.cumsum(starts.astype(jnp.int64)) - 1
    return WindowCtx(n, perm, starts, change, seg_start, seg_end,
                     last_peer, seg_id, valid_sorted)


def _seg_running_sum(ctx: WindowCtx, values):
    """Segmented inclusive running sum via global cumsum minus the value
    just before the segment start (cumsum is one fused scan primitive;
    lax.associative_scan unrolls log2(n) pad/slice levels that take minutes
    to compile at SF1 shapes — same finding as ops/join.py expand_matches)."""
    c = jnp.cumsum(values)
    base_idx = jnp.maximum(ctx.seg_start - 1, 0)
    base = jnp.where(ctx.seg_start > 0, jnp.take(c, base_idx), 0)
    return c - base


def _seg_running_idem(ctx: WindowCtx, values, op, ident):
    """Segmented inclusive scan for IDEMPOTENT ops (min/max): Hillis-Steele
    doubling with a segment-boundary guard — log2(n) fused elementwise
    passes, no associative_scan."""
    n = values.shape[0]
    pos = jnp.arange(n, dtype=jnp.int64)
    v = values
    shift = 1
    while shift < n:
        prev = jnp.concatenate(
            [jnp.full(shift, ident, v.dtype), v[:-shift]])
        ok = (pos - shift) >= ctx.seg_start
        v = op(v, jnp.where(ok, prev, ident))
        shift <<= 1
    return v


# ------------------------------------------------------- sliding frames
def _seg_lower_bound(sorted_keys, lo_idx, hi_idx, targets):
    """Vectorized lower_bound: first position p in [lo_idx, hi_idx) with
    sorted_keys[p] >= targets (per element); returns hi_idx when none."""
    n = sorted_keys.shape[0]
    lo = lo_idx.astype(jnp.int64)
    hi = hi_idx.astype(jnp.int64)
    steps = max(1, int(np.ceil(np.log2(max(2, n)))) + 1)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = jnp.take(sorted_keys, jnp.clip(mid, 0, n - 1))
        go_right = active & (v < targets)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


def frame_bounds(ctx: WindowCtx, frame, order_enc=None):
    """-> (a, b) inclusive sorted-position bounds per row, or None for
    legacy string frames.  order_enc: the monotone-encoded single order
    key in SORTED order (required for ("range", lo, hi) frames)."""
    if not isinstance(frame, tuple):
        return None
    mode, flo, fhi = frame
    pos = jnp.arange(ctx.n, dtype=jnp.int64)
    if mode == "rows":
        a = ctx.seg_start if flo is None else jnp.maximum(
            pos + int(flo), ctx.seg_start)
        b = ctx.seg_end if fhi is None else jnp.minimum(
            pos + int(fhi), ctx.seg_end)
        return a, b
    if mode == "range":
        assert order_enc is not None, "RANGE frame needs one ORDER BY key"
        k = order_enc
        if flo is None:
            a = ctx.seg_start
        else:
            a = _seg_lower_bound(k, ctx.seg_start, ctx.seg_end + 1,
                                 k + int(flo))
        if fhi is None:
            b = ctx.seg_end
        else:
            # last position with key <= k + hi  ==  lower_bound(k+hi+1) - 1
            b = _seg_lower_bound(k, ctx.seg_start, ctx.seg_end + 1,
                                 k + int(fhi) + 1) - 1
        return a, b
    raise ValueError(mode)


def _prefix_at(running, idx):
    """running inclusive prefix value at position idx, 0 before start."""
    return jnp.where(idx >= 0, jnp.take(running, jnp.maximum(idx, 0)),
                     jnp.zeros((), running.dtype))


def _sliding_sum(ctx: WindowCtx, values, a, b):
    c = jnp.cumsum(values)
    return jnp.where(b >= a, _prefix_at(c, b) - _prefix_at(c, a - 1),
                     jnp.zeros((), c.dtype))


def _sliding_idem(values, a, b, op, ident):
    """min/max over [a, b] via a log-doubling sparse table: two
    overlapping power-of-two windows (idempotent ops) — the analog of
    the reference's WindowSegmentTree queries."""
    n = values.shape[0]
    levels = [values]
    span = 1
    while span < n:
        prev = levels[-1]
        shifted = jnp.concatenate(
            [prev[span:], jnp.full(min(span, n), ident, prev.dtype)])
        levels.append(op(prev, shifted))
        span <<= 1
    table = jnp.stack(levels)                 # (K, n)
    length = jnp.maximum(b - a + 1, 1)
    k = 63 - jax.lax.clz(length.astype(jnp.int64))
    pw = jnp.left_shift(jnp.int64(1), k)
    flat = table.reshape(-1)
    left = jnp.take(flat, k * n + jnp.clip(a, 0, n - 1))
    right = jnp.take(flat, k * n + jnp.clip(b - pw + 1, 0, n - 1))
    out = op(left, right)
    return jnp.where(b >= a, out, jnp.full((), ident, values.dtype))


# --------------------------------------------------------------- rankings
def _ctx_of(ctx_or_parts, order_keys, valid) -> WindowCtx:
    if isinstance(ctx_or_parts, WindowCtx):
        return ctx_or_parts
    return analyze(tuple(ctx_or_parts), tuple(order_keys), valid)


def row_number(ctx_or_parts, order_keys=None, valid=None):
    ctx = _ctx_of(ctx_or_parts, order_keys, valid)
    pos = jnp.arange(ctx.n, dtype=jnp.int64)
    return ctx.scatter_back(pos - ctx.seg_start + 1)


def rank(ctx_or_parts, order_keys=None, valid=None):
    ctx = _ctx_of(ctx_or_parts, order_keys, valid)
    pos = jnp.arange(ctx.n, dtype=jnp.int64)
    first_peer = jax.lax.cummax(jnp.where(ctx.change, pos, 0), axis=0)
    return ctx.scatter_back(first_peer - ctx.seg_start + 1)


def dense_rank(ctx_or_parts, order_keys=None, valid=None):
    ctx = _ctx_of(ctx_or_parts, order_keys, valid)
    c = jnp.cumsum(ctx.change.astype(jnp.int64))
    base = jnp.take(c, ctx.seg_start)
    return ctx.scatter_back(c - base + 1)


# ----------------------------------------------------------- value movers
def shift(ctx: WindowCtx, values, valid, offset: int, default=None):
    """LEAD (offset>0) / LAG (offset<0): value `offset` rows away within
    the partition, NULL (or `default`) outside.  Returns (array, valid)."""
    pos = jnp.arange(ctx.n, dtype=jnp.int64)
    v_sorted = ctx.take(values)
    val_sorted = ctx.valid_sorted if valid is None else \
        (ctx.valid_sorted & ctx.take(valid))
    idx = jnp.clip(pos + offset, 0, ctx.n - 1)
    in_part = (pos + offset >= ctx.seg_start) & (pos + offset <= ctx.seg_end)
    out = jnp.take(v_sorted, idx, axis=0)
    ok = in_part & jnp.take(val_sorted, idx)
    if default is not None:
        out = jnp.where(ok, out, jnp.asarray(default, out.dtype))
        ok = ok | ~in_part  # default fills outside-partition slots
        return ctx.scatter_back(out), ctx.scatter_back(ok)
    out = jnp.where(ok, out, jnp.zeros((), out.dtype))
    return ctx.scatter_back(out), ctx.scatter_back(ok)


def first_value(ctx: WindowCtx, values):
    v_sorted = ctx.take(values)
    return ctx.scatter_back(jnp.take(v_sorted, ctx.seg_start, axis=0))


def last_value(ctx: WindowCtx, values, whole_partition: bool = False,
               frame: str | None = None):
    """last_value over the frame: 'range_upto' (default RANGE frame — the
    row's last PEER), 'partition' (partition's final value), or 'rows_upto'
    (an explicit ROWS ... CURRENT ROW frame — the current row itself, NOT
    the last peer; ADVICE r3)."""
    if frame is None:
        frame = "partition" if whole_partition else "range_upto"
    v_sorted = ctx.take(values)
    if frame == "rows_upto":
        at = jnp.arange(ctx.n, dtype=jnp.int64)
    elif frame == "partition":
        at = ctx.seg_end
    else:
        at = ctx.last_peer
    return ctx.scatter_back(jnp.take(v_sorted, at, axis=0))


# ------------------------------------------------------ running aggregates
def _frame_gather(ctx: WindowCtx, running, frame: str):
    """Map a rows-inclusive running scan to the requested frame."""
    if frame == "rows_upto":
        return running
    if frame == "range_upto":            # default frame: include peers
        return jnp.take(running, ctx.last_peer, axis=0)
    if frame == "partition":
        return jnp.take(running, ctx.seg_end, axis=0)
    raise ValueError(frame)


def agg(ctx: WindowCtx, kind: str, values, valid, frame="range_upto",
        order_enc=None):
    """SUM/COUNT/AVG/MIN/MAX over the frame.  Exact int64 accumulation for
    sums (decimal-safe); avg returns (sum, count) for the caller to divide.
    Returns (array, out_valid) in input row order.  `frame` is a legacy
    string or a sliding (mode, lo, hi) tuple (see frame_bounds)."""
    ab = frame_bounds(ctx, frame, order_enc)
    if ab is not None:
        return _agg_sliding(ctx, kind, values, valid, ab)
    if values is None:                    # count(*)
        cnt = _seg_running_sum(ctx, ctx.valid_sorted.astype(jnp.int64))
        return ctx.scatter_back(_frame_gather(ctx, cnt, frame)), None
    v_sorted = ctx.take(values)
    ok = ctx.valid_sorted if valid is None else \
        (ctx.valid_sorted & ctx.take(valid))
    nonnull = _seg_running_sum(ctx, ok.astype(jnp.int64))
    nn = _frame_gather(ctx, nonnull, frame)
    if kind == "count":
        return ctx.scatter_back(nn), None
    if kind in ("sum", "avg", "sum_double"):
        zero = jnp.zeros((), v_sorted.dtype)
        s = _seg_running_sum(ctx, jnp.where(ok, v_sorted, zero))
        total = _frame_gather(ctx, s, frame)
        if kind == "avg":
            out = total.astype(jnp.float64) / jnp.maximum(nn, 1)
            return ctx.scatter_back(out), ctx.scatter_back(nn > 0)
        return ctx.scatter_back(total), ctx.scatter_back(nn > 0)
    if kind in ("min", "max"):
        if jnp.issubdtype(v_sorted.dtype, jnp.floating):
            ident = jnp.asarray(jnp.inf if kind == "min" else -jnp.inf,
                                v_sorted.dtype)
        else:
            info = jnp.iinfo(v_sorted.dtype)
            ident = jnp.asarray(info.max if kind == "min" else info.min,
                                v_sorted.dtype)
        op = jnp.minimum if kind == "min" else jnp.maximum
        m = _seg_running_idem(ctx, jnp.where(ok, v_sorted, ident), op, ident)
        out = _frame_gather(ctx, m, frame)
        return ctx.scatter_back(out), ctx.scatter_back(nn > 0)
    raise ValueError(kind)


def _agg_sliding(ctx: WindowCtx, kind: str, values, valid, ab):
    a, b = ab
    if values is None:                    # count(*): frame row count
        cnt = _sliding_sum(ctx, ctx.valid_sorted.astype(jnp.int64), a, b)
        return ctx.scatter_back(cnt), None
    v_sorted = ctx.take(values)
    ok = ctx.valid_sorted if valid is None else \
        (ctx.valid_sorted & ctx.take(valid))
    nn = _sliding_sum(ctx, ok.astype(jnp.int64), a, b)
    if kind == "count":
        return ctx.scatter_back(nn), None
    if kind in ("sum", "avg", "sum_double"):
        zero = jnp.zeros((), v_sorted.dtype)
        s = _sliding_sum(ctx, jnp.where(ok, v_sorted, zero), a, b)
        if kind == "avg":
            out = s.astype(jnp.float64) / jnp.maximum(nn, 1)
            return ctx.scatter_back(out), ctx.scatter_back(nn > 0)
        return ctx.scatter_back(s), ctx.scatter_back(nn > 0)
    if kind in ("min", "max"):
        if jnp.issubdtype(v_sorted.dtype, jnp.floating):
            ident = jnp.asarray(jnp.inf if kind == "min" else -jnp.inf,
                                v_sorted.dtype)
        else:
            info = jnp.iinfo(v_sorted.dtype)
            ident = jnp.asarray(info.max if kind == "min" else info.min,
                                v_sorted.dtype)
        op = jnp.minimum if kind == "min" else jnp.maximum
        m = _sliding_idem(jnp.where(ok, v_sorted, ident), a, b, op, ident)
        return ctx.scatter_back(m), ctx.scatter_back(nn > 0)
    raise ValueError(kind)


def first_last_sliding(ctx: WindowCtx, values, valid, ab, last: bool):
    """first_value/last_value over a sliding frame: the value at the
    frame's first/last position (reference semantics: includes NULLs)."""
    a, b = ab
    v_sorted = ctx.take(values)
    at = jnp.clip(b if last else a, 0, ctx.n - 1)
    out = jnp.take(v_sorted, at, axis=0)
    okv = ctx.valid_sorted if valid is None else \
        (ctx.valid_sorted & ctx.take(valid))
    ok = jnp.take(okv, at) & (b >= a)
    return ctx.scatter_back(out), ctx.scatter_back(ok)


# ----------------------------------------------------- legacy entry points
# (kept for existing callers/tests; one-shot analyze + kernel)
def _legacy(partition_keys, order_keys, valid):
    return analyze(tuple(partition_keys), tuple(order_keys), valid)


def running_sum(partition_keys, order_keys, values, valid):
    """SUM(v) OVER (PARTITION BY ... ORDER BY ... ROWS UNBOUNDED PRECEDING)."""
    ctx = _legacy(partition_keys, order_keys, valid)
    out, _ = agg(ctx, "sum", values.astype(jnp.int64), None,
                 frame="rows_upto")
    return out


def partition_total(partition_keys, values, valid):
    """SUM(v) OVER (PARTITION BY ...) — whole-partition frame."""
    ctx = _legacy(partition_keys, (), valid)
    out, _ = agg(ctx, "sum", values.astype(jnp.int64), None,
                 frame="partition")
    return out
