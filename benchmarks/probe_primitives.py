#!/usr/bin/env python
"""Microbenchmark: primitive costs behind join probes on the device.

Measures device throughput of each candidate primitive for a join probe:
random/monotone gather, scatter, sort, cumsum/cummax, searchsorted.  Each
op runs ITERS times inside ONE jitted fori_loop with a data dependency
between iterations, so per-dispatch host cost is amortized away.
"""

import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

N = 1 << 22          # probe rows (~4.2M)
T = 1 << 20          # build/LUT rows (~1.0M)
ITERS = 20


def _log(m):
    print(m, file=sys.stderr, flush=True)


def timed(name, make_fn, bytes_per_iter):
    """make_fn() -> (jitted_fn, args). jitted_fn loops ITERS times
    internally; each dispatch gets its own seed argument."""
    fn, args = make_fn()
    fn(jnp.int32(999), *args).block_until_ready()   # compile + warm up
    reps = 3
    ts = []
    for rep in range(reps):
        t0 = time.perf_counter()
        fn(jnp.int32(rep), *args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    t = min(ts) / ITERS
    gbs = bytes_per_iter / t / 1e9
    _log(f"{name:34s} {t*1e3:9.3f} ms/iter  {N/t/1e6:10.1f} Mrow/s  "
         f"{gbs:8.1f} GB/s(model)")
    return {"name": name, "ms_per_iter": t * 1e3, "mrows_per_s": N / t / 1e6,
            "model_gb_per_s": gbs}


def loop(body):
    """ITERS-iteration fori_loop; consumes every output element through a
    random-weighted sum so XLA cannot narrow the op to a slice (a bare
    r[:1] reduction lets the compiler rewrite a 4M-row gather into a
    1-row gather and the timing measures nothing)."""
    def fn(seed, *args):
        w = args[0]

        def step(i, acc):
            r = body(i + seed, *args[1:])
            wi = jax.lax.dynamic_slice(w, (0,), (r.shape[0],))
            return acc + jnp.sum(r.astype(jnp.int32) * wi,
                                 dtype=jnp.int32)

        return jax.lax.fori_loop(0, ITERS, step, jnp.int32(0))
    return jax.jit(fn)


def main():
    rng = np.random.default_rng(0)
    rand_keys = jnp.asarray(rng.integers(0, T, N), jnp.int32)
    sorted_keys = jnp.sort(rand_keys)
    lut = jnp.asarray(rng.integers(0, 1 << 30, T), jnp.int32)
    vals64 = jnp.asarray(rng.integers(0, 1 << 60, N), jnp.int64)
    scatter_idx = jnp.asarray(rng.permutation(N)[:T], jnp.int32)
    build_sorted = jnp.sort(jnp.asarray(rng.integers(0, 1 << 30, T),
                                        jnp.int32))
    results = []
    w = jnp.asarray(rng.integers(-(1 << 20), 1 << 20, N), jnp.int32)

    def bench(name, body, args, bytes_per_iter):
        results.append(timed(name, lambda: (loop(body), (w,) + args),
                             bytes_per_iter))

    # 1. random gather: out[i] = lut[k[i]]
    bench("gather_random_4B", lambda i, k, l: l[(k + i) % T],
          (rand_keys, lut), N * 8)
    # 2. monotone gather
    bench("gather_monotone_4B",
          lambda i, k, l: l[jnp.minimum(k + i, T - 1)],
          (sorted_keys, lut), N * 8)
    # 3. gather from small (64K) table
    small = lut[: 1 << 16]
    bench("gather_random_64K_table",
          lambda i, k, s: s[(k + i) & 0xFFFF], (rand_keys, small), N * 8)
    # 3b. gather from tiny (2K) table
    tiny = lut[: 1 << 11]
    bench("gather_random_2K_table",
          lambda i, k, s: s[(k + i) & 0x7FF], (rand_keys, tiny), N * 8)
    # 4. scatter T values into N slots
    zeros = jnp.zeros(N, jnp.int32)
    bench("scatter_set_T_into_N",
          lambda i, z, idx, l: z.at[(idx + i) % N].set(l, mode="drop"),
          (zeros, scatter_idx, lut), T * 8 + N * 4)
    # 5. sort int64
    bench("sort_i64", lambda i, v: jax.lax.sort(v + i), (vals64,), N * 16 * 22)
    # 6. sort int32 key + int32 payload
    k32 = rand_keys
    bench("sort_k32_v32",
          lambda i, k, v: jax.lax.sort((k + i, v), num_keys=1)[0],
          (k32, jnp.arange(N, dtype=jnp.int32)), N * 8 * 22)
    # 7. cumsum int32
    bench("cumsum_i32", lambda i, k: jnp.cumsum(k + i), (rand_keys,), N * 8)
    # 8. cummax int32
    bench("cummax_i32",
          lambda i, k: jax.lax.cummax(k + i), (rand_keys,), N * 8)
    # 9. searchsorted N probes into sorted T
    bench("searchsorted_N_in_T",
          lambda i, k, b: jnp.searchsorted(b, k + i).astype(jnp.int32),
          (rand_keys, build_sorted), N * 8)
    # 10. elementwise stream (sanity roofline probe)
    bench("stream_add_i32", lambda i, k: k + i, (rand_keys,), N * 8)
    # 11. argsort-free rank: sort packed (key<<22 | idx)
    packed = (vals64 << 22) | jnp.arange(N, dtype=jnp.int64)
    bench("sort_packed_i64",
          lambda i, p: jax.lax.sort(p + i), (packed,), N * 16 * 22)

    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
