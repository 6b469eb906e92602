import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time, sys, jax, jax.numpy as jnp
import duckdb_cubit
import numpy as np

N = 1<<23
key = jax.random.PRNGKey(0)
k64 = jax.random.randint(key, (N,), 0, 6_000_000).astype(jnp.int64)
rows = jnp.arange(N, dtype=jnp.int32)
mask = jax.random.bernoulli(key, 0.5, (N,))
sk = jnp.sort(k64)
jax.block_until_ready((k64, rows, mask, sk))
print('data ready', flush=True)

def bench(name, fn, *args, trials=3):
    f = jax.jit(fn)
    t0=time.perf_counter()
    r = f(*args); jax.block_until_ready(r)
    print(f'{name:40s} compile+1st {time.perf_counter()-t0:8.2f} s', flush=True)
    t0=time.perf_counter()
    for _ in range(trials):
        r = f(*args)
    jax.block_until_ready(r)
    print(f'{name:40s} {(time.perf_counter()-t0)/trials*1e3:8.2f} ms', flush=True)

bench('lax.cummax 8M i32', lambda r: jax.lax.cummax(r, axis=0), rows)
bench('scatter set drop 8M', lambda r: jnp.zeros(N, jnp.int32).at[r].set(r, mode="drop"), rows)
bench('scatter add 8M->2M', lambda k: jnp.zeros(1<<21, jnp.int64).at[(k % (1<<21)).astype(jnp.int32)].add(jnp.int64(1)), k64)
bench('searchsorted 8M into 8M', lambda a,b: jnp.searchsorted(a,b), sk, k64)
bench('lax.sort (i64,i32) 8M', lambda k,r: jax.lax.sort((k,r), num_keys=1), k64, rows)
bench('lax.sort stable (i32,i32) 8M', lambda m,r: jax.lax.sort((m.astype(jnp.int32),r), num_keys=1, is_stable=True), mask, rows)
bench('lax.sort 4key (i64x3,i32) 8M', lambda k,r: jax.lax.sort((k,k,k,r), num_keys=3), k64, rows)
