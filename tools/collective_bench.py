#!/usr/bin/env python
"""Transport microbenchmark — the ``Pilaf/ib-test.cc`` analog.

The reference measures RDMA READ / 1-way verb / 2-way verb latency and
throughput over message sizes 2^0..2^17 (``ib-test.cc:43-44``). Here the
transports are (a) device-memory random gathers (the RDMA READ analog: how
fast the engine can fetch buckets) and (b) collectives over a mesh
(all_gather = gather_vectors transport, psum = the reduce path; NVLink
between the cards of one host). This tool sweeps the same size range and
reports per-op latency and bandwidth.

Run on one card (gather + copy), on four cards for the collectives, or on
a virtual CPU mesh for the collective path shape check:
    python tools/collective_bench.py --mesh 4x2x1 --cpu
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def timeit(fn, iters=20):
    fn()  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    import jax
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh", default=None, help="TxSxQ for collective sweep")
    p.add_argument("--cpu", action="store_true",
                   help="force CPU (virtual devices)")
    p.add_argument("--max_pow", type=int, default=17)
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    print(f"devices: {jax.devices()}")

    # (a) HBM gather sweep — the one-sided-read analog
    n = 1 << 24
    table = jnp.arange(n, dtype=jnp.uint32)
    for pw in range(0, args.max_pow + 1, 3):
        m = 1 << pw
        idx = jnp.asarray(
            np.random.default_rng(0).integers(0, n, m), jnp.int32)
        f = jax.jit(lambda t=table, i=idx: t[i])
        dt = timeit(f)
        print(f"gather  {m:>8d} x4B: {dt*1e6:10.1f} us  "
              f"{m*4/dt/1e9:8.2f} GB/s")

    # (b) collective sweep over a mesh
    if args.mesh:
        from jax.sharding import PartitionSpec as P
        from verticut_tpu.parallel import make_mesh
        t, s, q = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(t, s, q)
        for pw in range(0, args.max_pow + 1, 3):
            m = 1 << pw
            x = jnp.zeros((t * s, m), jnp.uint32)

            def ag(x=x):
                def f(xl):
                    return jax.lax.all_gather(xl, ("table", "shard"), axis=0)
                return jax.jit(jax.shard_map(
                    f, mesh=mesh, in_specs=P(("table", "shard")),
                    out_specs=P(None), check_vma=False))(x)
            dt = timeit(ag, iters=10)
            print(f"all_gather {m:>8d} x4B x{t*s}dev: {dt*1e6:10.1f} us")


if __name__ == "__main__":
    main()
