"""Headline benchmark: batched exact MIH K-NN throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
North star (BASELINE.md): >1,000,000 batched queries/sec/chip at exact
recall; vs_baseline = QPS / 1e6.

Workload: LSH-like clustered 128-bit codes (the reference's canonical shape:
128 bits, 4 tables — src/image_search_constants.h:10-13), queries are
perturbed DB codes, k=10 exact, plus k=100 and uniform-query cells.
Steady-state timing after compile warmup. Refuses to run without a GPU and
records the device (platform, kind, count, card name and power limit).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax
    from verticut_tpu.utils.cache import enable_compilation_cache
    from verticut_tpu.utils.device import require_gpu
    device = require_gpu()
    enable_compilation_cache()
    import jax.numpy as jnp
    from verticut_tpu import codes
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.index.build_native import build_index_native
    from verticut_tpu.search import mih_search

    n = int(os.environ.get("VERTICUT_BENCH_N", 1_000_000))
    q_batch = int(os.environ.get("VERTICUT_BENCH_Q", 8192))
    k = int(os.environ.get("VERTICUT_BENCH_K", 10))
    cfg = MIHConfig(bits=128, n_tables=4)
    scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)

    rng = np.random.default_rng(0)
    device_build_min = int(os.environ.get("VERTICUT_DEVICE_BUILD_MIN",
                                          20_000_000))
    if n >= device_build_min:
        # scale path: the corpus is generated AND built on device, so
        # set-up does not wait on a host generator and a 1.6 GB upload
        from verticut_tpu.index import build_index
        log(f"bench: generating {n} clustered codes on device")
        t0 = time.time()
        packed_dev = codes.clustered_codes_device(
            0, n, cfg.bits, n_clusters=n // 200, flip_p=0.02)
        gen_s = time.time() - t0
        t0 = time.time()
        # inline (id,code) rows (~20.5 B/entry/table) when they take at
        # most a quarter of the device memory JAX may use, leaving the
        # rest to the search's temporaries; compact ids-only blocks
        # beyond that (DESIGN.md §3). Inline removes the per-candidate
        # 16 B code gathers of the compact layout.
        limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
        if not limit:
            raise RuntimeError("the device reports no memory limit "
                               "(memory_stats()['bytes_limit'])")
        inline = n * 21 * cfg.n_tables <= limit // 4
        index = build_index(packed_dev, cfg, store_codes=inline,
                            directory="range",
                            keep_entry_ids=n < 20_000_000)
        jax.block_until_ready(index.tables[-1].directory.se)
        build_s = time.time() - t0
        log(f"bench: device gen {gen_s:.1f}s build {build_s:.1f}s")
        # queries: perturb random db rows by 3 bit flips, on device
        queries = codes.perturbed_queries_device(
            jax.random.PRNGKey(0), packed_dev, q_batch)
    else:
        log(f"bench: generating {n} clustered codes")
        packed = codes.clustered_codes(0, n, cfg.bits, n_clusters=n // 200,
                                       flip_p=0.02)
        t0 = time.time()
        index = build_index_native(packed, cfg)  # C++ radix + range dirs
        jax.block_until_ready(index.tables[-1].entry_ids)
        build_s = time.time() - t0
        log(f"bench: build {build_s:.1f}s")

        # queries: perturb random db rows by 3 bit flips
        sel = rng.integers(0, n, q_batch)
        qraw = codes.unpack_to_bytes(packed[sel])
        flips = rng.integers(0, cfg.bits, (q_batch, 3))
        for i in range(q_batch):
            for b in flips[i]:
                qraw[i, b // 8] ^= 1 << (b % 8)
        queries = jnp.asarray(codes.pack_bytes(qraw))

    from verticut_tpu.search import mih_search_dispatch, mih_search_finalize

    # warmup (compile all radius levels this workload touches)
    t0 = time.time()
    res = mih_search(index, queries, scfg)
    warmup_s = time.time() - t0
    log(f"bench: warmup+compile {warmup_s:.1f}s "
        f"radii={np.bincount(res.radius).tolist()}")
    assert (res.dists[:, 0] <= 3).all(), "planted neighbor missed"

    # latency: single batch, dispatch -> sync
    times = []
    for _ in range(3):
        t0 = time.time()
        res = mih_search(index, queries, scfg)
        times.append(time.time() - t0)
        log(f"bench: latency run {times[-1]:.3f}s")
    lat = min(times)

    # throughput: depth-4 pipeline of batches (device work + result
    # transfer of batch i overlap the host sync of batches i-3..i-1 —
    # the serving configuration; dispatch fires the async D2H copy, so
    # finalize mostly finds host-resident bytes. Falls back to the
    # sequential path if the fused driver declined.)
    n_batches = 12
    depth = 4
    t0 = time.time()
    pending = mih_search_dispatch(index, queries, scfg)
    if pending is None:
        dt = lat
    else:
        window = [pending]
        for _ in range(depth - 1):
            window.append(mih_search_dispatch(index, queries, scfg))
        for _ in range(n_batches - depth):
            res = mih_search_finalize(window.pop(0))
            assert res is not None
            window.append(mih_search_dispatch(index, queries, scfg))
        while window:
            res = mih_search_finalize(window.pop(0))
            assert res is not None
        dt = (time.time() - t0) / n_batches
    log(f"bench: pipelined {dt:.3f}s/batch")
    qps = q_batch / dt

    # harder workloads, measured with the same depth-4 pipelined protocol
    # as the headline (single-batch latency reported alongside)
    def pipelined_qps(qs, sc, n_b=8, depth=4):
        assert n_b >= depth, "QPS window must cover at least `depth` batches"
        mih_search(index, qs, sc)            # warm/compile
        t0 = time.time()
        res = mih_search(index, qs, sc)
        lat1 = time.time() - t0
        pending = mih_search_dispatch(index, qs, sc)
        if pending is None:
            return round(q_batch / lat1, 1), lat1, res
        t0 = time.time()
        window = [pending]
        for _ in range(depth - 1):
            window.append(mih_search_dispatch(index, qs, sc))
        for _ in range(n_b - depth):
            res = mih_search_finalize(window.pop(0))
            assert res is not None
            window.append(mih_search_dispatch(index, qs, sc))
        while window:
            res = mih_search_finalize(window.pop(0))
            assert res is not None
        return round(q_batch * n_b / (time.time() - t0), 1), lat1, res

    extra_cells = {}
    oracle_nq = int(os.environ.get("VERTICUT_BENCH_ORACLE", "0"))
    if oracle_nq:
        # exactness bit: compare the engine's distance multiset against an
        # independent brute-force scan of the full corpus for the first
        # oracle_nq queries
        from verticut_tpu.search.linear import linear_search
        oq = queries[:oracle_nq]
        res_o = mih_search(index, oq, scfg)
        t0 = time.time()
        # independent formulation on purpose: the popcount engine shares
        # no selection machinery with the scan tier the engine itself
        # uses (scan_blockmin + select_desc), so a shared miscompile
        # cannot fake a pass
        od, _ = linear_search(oq, index.codes, k, method="popcount")
        jax.block_until_ready(od)
        oracle_s = time.time() - t0
        ok = bool(np.array_equal(np.sort(np.asarray(res_o.dists), axis=-1),
                                 np.sort(np.asarray(od), axis=-1)))
        extra_cells["oracle_queries"] = oracle_nq
        extra_cells["oracle_scan_s"] = round(oracle_s, 2)
        extra_cells["oracle_multiset_equal"] = ok
        log(f"bench: oracle multiset equal={ok} scan {oracle_s:.1f}s")
    if os.environ.get("VERTICUT_BENCH_CELLS", "1") != "0":
        # a failing cell fails the run: no partial artifact
        scfg100 = SearchConfig(knn=100, candidate_cap=8192,
                               max_enum_radius=5)
        qps100, lat100, _ = pipelined_qps(queries, scfg100)
        extra_cells["k100_qps"] = qps100
        extra_cells["k100_batch_latency_s"] = round(lat100, 4)
        uq = jnp.asarray(codes.random_codes(99, q_batch, cfg.bits))
        qps_u, lat_u, ru = pipelined_qps(uq, scfg)
        extra_cells["uniform_q_qps"] = qps_u
        extra_cells["uniform_batch_latency_s"] = round(lat_u, 4)
        extra_cells["uniform_mean_radius"] = float(np.mean(ru.radius))

    print(json.dumps({
        "metric": "mih_exact_qps_per_chip",
        "value": round(qps, 1),
        "unit": "queries/s",
        "vs_baseline": round(qps / 1e6, 4),
        "extra": {
            "n_codes": n, "q_batch": q_batch, "k": k,
            "batch_latency_s": round(lat, 4),
            "pipelined_batch_s": round(dt, 4),
            "build_s": round(build_s, 2),
            "warmup_s": round(warmup_s, 2),
            "mean_radius": float(np.mean(res.radius)),
            "mean_probes": float(np.mean(res.n_probes)),
            "mean_cands": float(np.mean(res.n_cands)),
            "device": device,
            **extra_cells,
        },
    }))


if __name__ == "__main__":
    main()
