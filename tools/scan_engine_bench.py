#!/usr/bin/env python
"""Block-min scan engines on one NVIDIA GPU: the fused Pallas-Triton pass-1
kernel (ops/pallas/blockmin.py) against the plain XLA formulation
(``hamming._blockmin_xla``), alone and end to end.

For each corpus size (clustered 128-bit codes generated on the device from
a seed, the inline range index built on the device, m=4) the engines run in
the order kernel, XLA, kernel, so drift within the call shows. Each round
measures, at Q uniform queries unless named otherwise:

* ``pass1``: per-block minima over the whole corpus, chunked as
  ``scan_blockmin`` chunks it, at block 512 and block 128;
* ``scan``: ``hamming.scan_blockmin`` alone (pass 1, fold, rescore) at
  k=10 / block 512 and k=100 / block 128;
* ``mih``: ``mih_search`` end to end on uniform and clustered batches
  (corpus rows with 3 flipped bits) at k=10 and k=100.

``--xla-slab-gib`` adds XLA rounds of ``pass1`` and ``scan`` at other caps
on the pass-1 distance slab, which change only the chunk count of pass 1
and of the fold.

Every measurement is one warm-up call (compilation included, reported as
``first_s``) and ``--reps`` timed calls ending in a host copy. Results must
be equal across engines, or the run fails. Prints one line per measurement
and, last, one JSON object with all of them, also written to ``--out``.

Usage: python tools/scan_engine_bench.py [--sizes 1000000,100000000]
           [--queries 8192] [--reps 3] [--xla-slab-gib 8]
           [--out chiprun_out/scan_engine_bench.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from verticut_tpu import codes  # noqa: E402
from verticut_tpu.ops import hamming  # noqa: E402
from verticut_tpu.ops.pallas import blockmin as kern  # noqa: E402

BITS = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def set_engine(kernel: bool, slab: int) -> None:
    """Point scan_blockmin's pass 1 at one engine and slab cap, and drop
    every in-memory compiled program so the next call traces anew."""
    hamming.use_scan_kernel = lambda platform: kernel
    hamming.XLA_SLAB = slab
    jax.clear_caches()


@functools.partial(jax.jit, static_argnames=("block", "kernel"))
def pass1_checksum(queries, db, block: int, kernel: bool):
    """Pass 1 of scan_blockmin over every whole block of ``db``, with its
    chunking, reduced to one checksum (the sum of all block minima) in
    place of the fold."""
    q, w = queries.shape
    nfull = db.shape[0] // block
    if kernel:
        q_pm = kern.unpack_queries(queries)
        max_rows = hamming.CHUNK_MAX
    else:
        q_pm = codes.unpack_bits_pm1(queries)
        max_rows = min(hamming.CHUNK_MAX, hamming.XLA_SLAB // q)
    ch = hamming._pick_chunk(nfull, block, q, max_rows)
    cb = ch // block
    last = nfull * block - ch

    def body(c, acc):
        start = jnp.minimum(c * ch, last)
        rows = jax.lax.dynamic_slice(db, (start, 0), (ch, w))
        if kernel:
            bm = kern.blockmin_pass1(q_pm, rows, block=block)[:q]
        else:
            bm = hamming._blockmin_xla(q_pm, rows, block)
        # blocks shared with the previous chunk count once
        fresh = (jax.lax.broadcasted_iota(jnp.int32, (1, cb), 1)
                 + start // block) >= c * cb
        return acc + jnp.sum(jnp.where(fresh, bm, 0))   # wraps alike

    return jax.lax.fori_loop(0, -(-nfull // cb), body, jnp.int32(0))


def timed(fn, reps: int) -> dict:
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return {"first_s": first, "times_s": times, "out": out}


def measure(size: int, n_q: int, reps: int, rounds, card: str, record):
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.index import build_index
    from verticut_tpu.search import mih_search

    corpus = codes.clustered_codes_device(0, size, BITS,
                                          n_clusters=max(1, size // 200),
                                          flip_p=0.02)
    t0 = time.perf_counter()
    index = build_index(corpus, MIHConfig(bits=BITS, n_tables=4),
                        directory="range",
                        keep_entry_ids=size < 20_000_000)
    jax.block_until_ready([t.entry_rows for t in index.tables])
    log(f"n={size}: built in {time.perf_counter() - t0:.2f} s on {card}")
    qu = jnp.asarray(codes.random_codes(1, n_q, BITS))
    qc = codes.perturbed_queries_device(jax.random.PRNGKey(1), corpus, n_q)
    first_out = {}

    def run(engine, name, fn):
        r = timed(fn, reps)
        out = r.pop("out")
        if name in first_out:
            same = all(np.array_equal(a, b)
                       for a, b in zip(first_out[name], out))
            if not same:
                raise RuntimeError(f"n={size} {name}: results differ "
                                   "between engines")
        else:
            first_out[name] = out
        ts = sorted(r["times_s"])
        log(f"n={size} {engine} {name}: first {r['first_s']:.3f} s; "
            f"timed min {ts[0]:.5f} median {ts[len(ts) // 2]:.5f} max "
            f"{ts[-1]:.5f} s")
        record({"n": size, "q": n_q, "engine": engine,
                "measure": name, **r})

    for kernel, slab, full in rounds:
        set_engine(kernel, slab)
        engine = ("kernel" if kernel
                  else f"xla(slab {slab * 4 / 2**30:g} GiB)")
        for block in (512, 128):
            run(engine, f"pass1 block={block}",
                lambda block=block: (np.asarray(pass1_checksum(
                    qu, corpus, block, kernel)),))
        for k, block in ((10, 512), (100, 128)):
            run(engine, f"scan k={k} block={block}",
                lambda k=k, block=block: tuple(map(np.asarray, (
                    hamming.scan_blockmin(qu, corpus, k, block=block)))))
        if not full:
            continue
        for k in (10, 100):
            scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
            for qname, q in (("uniform", qu), ("clustered", qc)):
                run(engine, f"mih {qname} k={k}",
                    lambda q=q, scfg=scfg: tuple(map(np.asarray, (
                        mih_search(index, q, scfg)[:2]))))
    del index, corpus


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="1000000,100000000")
    p.add_argument("--queries", type=int, default=8192)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--xla-slab-gib", default="",
                   help="extra slab caps (GiB, comma-separated) for XLA "
                        "pass1/scan rounds")
    p.add_argument("--out", default="chiprun_out/scan_engine_bench.json")
    args = p.parse_args(argv)

    from verticut_tpu.utils.cache import enable_compilation_cache
    from verticut_tpu.utils.device import require_gpu
    device = require_gpu()
    enable_compilation_cache()
    card = device["card"]
    log(f"card: {card}")
    slab = hamming.XLA_SLAB
    rounds = [(True, slab, True), (False, slab, True), (True, slab, True)]
    rounds += [(False, int(float(g) * 2**30) // 4, False)
               for g in args.xla_slab_gib.split(",") if g]
    results = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def record(entry):
        results.append(entry)
        with open(args.out, "w") as f:
            json.dump({"device": device, "results": results}, f, indent=1)

    for size in (int(s) for s in args.sizes.split(",")):
        measure(size, args.queries, args.reps, rounds, card, record)
    print(json.dumps({"device": device, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
