#!/usr/bin/env python
"""RPC load generator — the ``image-search-test`` binary analog
(``src/image_search_test.cc:112-170``): sequential and concurrent
(thread-per-query) throughput against a running image server, with
per-request latency percentiles (p50/p90/p99) emitted as one JSON line.

``--selfbuild N`` makes the run self-contained: build an N-code clustered
index, start the in-process server, run the sequential and threaded loads,
and print the artifact.

Without ``--selfbuild`` this process is a pure client and never initialises
a JAX backend. Keep it that way beside a GPU server: a JAX process reserves
most of the card's memory when it first uses it, so a second one on the
same card fails for want of memory.
"""

import argparse
import json
import sys
import threading
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def run_load(cli, qids, knn, threads):
    """Run one load; returns (wall_s, sorted per-request latencies)."""
    lats = []
    lock = threading.Lock()

    def one(qid):
        t0 = time.perf_counter()
        r = cli.search_image_by_id(qid, knn)
        dt = time.perf_counter() - t0
        assert r, f"empty result for {qid}"
        with lock:
            lats.append(dt)

    t0 = time.time()
    if threads <= 1:
        for qid in qids:
            one(qid)
    else:
        errs = []

        def worker(chunk):
            try:
                for qid in chunk:
                    one(qid)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        per = (len(qids) + threads - 1) // threads
        ts = [threading.Thread(target=worker,
                               args=(qids[i * per:(i + 1) * per],))
              for i in range(threads)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        if errs:
            raise errs[0]
    return time.time() - t0, sorted(lats)


def pcts(lats):
    if not lats:
        return {}
    return {p: round(lats[min(len(lats) - 1, int(len(lats) * p / 100))] * 1e3,
                     2)
            for p in (50, 90, 99)}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=9191)
    p.add_argument("-n", "--num", type=int, default=100)
    p.add_argument("-k", "--knn", type=int, default=10)
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="0 = sequential; else concurrent thread count")
    p.add_argument("--query_id_file", default=None,
                   help="file of query ids, one per line")
    p.add_argument("--selfbuild", type=int, default=0, metavar="N",
                   help="build an N-code index + in-process server, then "
                        "run sequential AND threaded loads (one artifact)")
    args = p.parse_args()

    server = None
    if args.selfbuild:
        import numpy as np
        from verticut_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()
        import jax
        from verticut_tpu import codes
        from verticut_tpu.config import MIHConfig
        from verticut_tpu.index.build_native import build_index_native
        from verticut_tpu.service import ImageSearchServer
        cfg = MIHConfig()
        print(f"selfbuild: {args.selfbuild} codes", file=sys.stderr,
              flush=True)
        packed = codes.clustered_codes(0, args.selfbuild, cfg.bits,
                                       n_clusters=args.selfbuild // 200,
                                       flip_p=0.02)
        index = build_index_native(packed, cfg)
        jax.block_until_ready(index.tables[-1].entry_ids)
        server = ImageSearchServer(index, port=0,
                                   default_knn=args.knn).start()
        print("selfbuild: prewarming shape buckets", file=sys.stderr,
              flush=True)
        # compile the batch buckets this load can reach (≤ 2x peak
        # concurrency) before taking any: a cold bucket mid-run stalls
        # the worker for a full compile with every request queued behind it
        server.prewarm(max_rows=128)
        args.port = server.port

    from verticut_tpu.service import ImageSearchClient

    cli = ImageSearchClient(host=args.host, port=args.port)
    assert cli.ping() == "pong"
    if args.query_id_file:
        with open(args.query_id_file) as f:
            qids = [int(line) for line in f if line.strip()][:args.num]
    else:
        qids = list(range(args.num))

    if args.selfbuild:
        # one artifact: warmup (compile), then sequential + threaded rows.
        # The warmup must cover the THREADED arrival shapes too — the
        # micro-batching leader pads each device batch to the concurrent
        # arrival count's shape bucket, and a cold compile of a new batch
        # shape (~20-60 s through the remote compiler) otherwise lands in
        # the first threaded row's p99 (observed: 21.5 s p99 at
        # threads16 on an otherwise-warm server).
        run_load(cli, qids[:8], args.knn, 0)          # sequential shapes
        for th in (16, 64):
            run_load(cli, qids[:2 * th], args.knn, th)
        rows = {}
        for name, th in (("sequential", 0), ("threads16", 16),
                         ("threads64", 64)):
            dt, lats = run_load(cli, qids, args.knn, th)
            rows[name] = {"qps": round(len(qids) / dt, 1),
                          "latency_ms": pcts(lats)}
            print(f"{name}: {rows[name]}", file=sys.stderr, flush=True)
        print(json.dumps({
            "metric": "serving_rpc", "n_codes": args.selfbuild,
            "knn": args.knn, "n_queries": len(qids),
            "device": str(jax.devices()[0].device_kind), **rows}))
        server.stop()
        return

    dt, lats = run_load(cli, qids, args.knn, args.threads)
    mode = "seq" if args.threads <= 1 else f"{args.threads} threads"
    print(f"{len(qids)} queries in {dt:.3f}s -> {len(qids)/dt:.1f} qps "
          f"({mode}) p50/p90/p99 ms: {pcts(lats)}")


if __name__ == "__main__":
    main()
