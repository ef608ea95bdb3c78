#!/usr/bin/env python
"""Smoke run of the MIH search path on one NVIDIA GPU, at deployment size.

The deployment is the reference's own shape: 100M clustered 128-bit codes,
m=4 tables, k=10 and the launcher default k=100. Codes are generated on
the device from a seed. Phases, each of which fails the run:

1. device check: refuse to run without a GPU; print the card's name and
   power limit;
2. build the 100M inline range index on the device;
3. exact search: one 8192-query clustered batch at k=10 and k=100 and one
   uniform batch at k=10, each compared on 64 queries with the independent
   popcount scan (distance multisets, exact equality);
4. the block-min scan kernel against its plain XLA reference over the
   whole 100M corpus at Q=8192, block 128 and 512 (exact equality);
5. the native (C++) build of a 1M corpus against ``build_index``: equal
   search results;
6. the served path: ``ImageSearchServer`` on the 100M index over loopback,
   answering ``ImageSearchClient`` requests, equal to ``mih_search``: a few
   single-query requests, then one full 8192-query ``search_batch`` at
   k=100, timed at the client.

``--four-cards`` runs only the sharded engines on a 4-card table mesh
(``build_sharded_index`` + ``sharded_mih_search``, ``build_sharded_compact``
+ ``sharded_compact_search``) over the same 100M corpus, compared with the
popcount scan and with single-card ``mih_search``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_CODES = 100_000_000     # image_search_constants.h:14
N_QUERIES = 8192
N_ORACLE = 64
BITS = 128
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def build_corpus(n: int, seed: int = SEED):
    """Clustered codes generated on the device (bench.py's distribution)."""
    from verticut_tpu import codes
    return codes.clustered_codes_device(seed, n, BITS,
                                        n_clusters=max(1, n // 200),
                                        flip_p=0.02)


def phase_build(corpus, card: str):
    import jax
    from verticut_tpu.config import MIHConfig
    from verticut_tpu.index import build_index
    t0 = time.time()
    index = build_index(corpus, MIHConfig(bits=BITS, n_tables=4),
                        directory="range",
                        keep_entry_ids=corpus.shape[0] < 20_000_000)
    jax.block_until_ready([t.entry_rows for t in index.tables])
    log(f"phase build: {corpus.shape[0]} codes, inline range index in "
        f"{time.time() - t0:.1f} s (compile included) on {card}")
    return index


def check_oracle(res_dists, queries, corpus, k: int, n_oracle: int,
                 what: str) -> None:
    """Distance multisets of the first ``n_oracle`` queries against the
    independent popcount scan."""
    from verticut_tpu.search.linear import linear_search
    od, _ = linear_search(queries[:n_oracle], corpus, k, method="popcount")
    got = np.sort(np.asarray(res_dists)[:n_oracle], axis=-1)
    require(np.array_equal(got, np.sort(np.asarray(od), axis=-1)),
            f"{what}: distance multisets equal the popcount oracle")
    log(f"  {what}: oracle multisets equal on {n_oracle} queries")


def search_queries(corpus, n_q: int, seed: int = SEED + 1):
    """(clustered, uniform) query batches: corpus rows with 3 flipped bits,
    and uniform random codes."""
    import jax
    import jax.numpy as jnp
    from verticut_tpu import codes
    qc = codes.perturbed_queries_device(jax.random.PRNGKey(seed), corpus,
                                        n_q)
    qu = jnp.asarray(codes.random_codes(seed, n_q, BITS))
    return qc, qu


def phase_exact(index, corpus, n_q: int = N_QUERIES,
                n_oracle: int = N_ORACLE):
    from verticut_tpu.config import SearchConfig
    from verticut_tpu.search import mih_search
    qc, qu = search_queries(corpus, n_q)
    n = corpus.shape[0]
    for name, q, k in (("clustered k=10", qc, 10),
                       ("clustered k=100", qc, 100),
                       ("uniform k=10", qu, 10)):
        scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
        t0 = time.time()
        res = mih_search(index, q, scfg)
        t_first = time.time() - t0
        t0 = time.time()
        res = mih_search(index, q, scfg)
        t_warm = time.time() - t0
        d, i = np.asarray(res.dists), np.asarray(res.ids)
        require(d.shape == (n_q, k) and i.shape == (n_q, k),
                f"{name}: result shape")
        require(((i >= 0) & (i < n)).all() and ((d >= 0) & (d <= BITS)).all(),
                f"{name}: every slot holds a valid (id, dist)")
        if name.startswith("clustered"):
            require((d[:, 0] <= 3).all(), f"{name}: planted neighbours found")
        log(f"phase exact {name}: first call {t_first:.2f} s, warm "
            f"{t_warm:.3f} s, mean radius {np.mean(res.radius):.2f}")
        check_oracle(d, q, corpus, k, n_oracle, name)
    return qc


def phase_kernel(corpus, n_q: int = N_QUERIES, rows: int = 1 << 20) -> None:
    """Pass 1 of the block-min scan: the kernel against the XLA formulation
    over the whole corpus, ``rows`` codes per comparison step (the last
    step is pulled back to end at the corpus end)."""
    import functools

    import jax
    import jax.numpy as jnp
    from verticut_tpu import codes
    from verticut_tpu.ops import hamming
    from verticut_tpu.ops.pallas import blockmin as kern

    q = jnp.asarray(codes.random_codes(SEED + 7, n_q, BITS))
    n = corpus.shape[0]
    rows = min(rows, n)
    sub = min(rows, max(512, (1 << 29) // n_q))   # XLA slab <= 2 GB

    @functools.partial(jax.jit, static_argnames=("block",))
    def mismatches(corpus, q, block):
        q_i8 = kern.unpack_queries(q)
        q_pm = codes.unpack_bits_pm1(q)

        def step(c, bad):
            part = jax.lax.dynamic_slice(
                corpus, (jnp.minimum(c * rows, n - rows), 0),
                (rows, q.shape[1]))
            got = kern.blockmin_pass1(q_i8, part, block=block)[:q.shape[0]]

            def ref(s, out):
                m = hamming._blockmin_xla(
                    q_pm, jax.lax.dynamic_slice(part, (s * sub, 0),
                                                (sub, q.shape[1])), block)
                return jax.lax.dynamic_update_slice(out, m,
                                                    (0, s * (sub // block)))

            want = jax.lax.fori_loop(0, rows // sub, ref, jnp.zeros_like(got))
            return bad + jnp.sum(got != want)

        return jax.lax.fori_loop(0, -(-n // rows), step, jnp.int32(0))

    for block in (128, 512):
        t0 = time.time()
        bad = int(mismatches(corpus, q, block))
        require(bad == 0, f"kernel block={block}: per-block minima equal "
                f"the XLA reference ({bad} differ)")
        log(f"phase kernel block={block}: {n_q} queries x {n} codes, "
            f"per-block minima equal the XLA reference "
            f"({time.time() - t0:.1f} s)")


def phase_native(n: int = 1_000_000, n_q: int = N_QUERIES) -> None:
    import jax.numpy as jnp
    from verticut_tpu import codes
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.index import build_index
    from verticut_tpu.index.build_native import build_index_native
    from verticut_tpu.search import mih_search
    cfg = MIHConfig(bits=BITS, n_tables=4)
    packed = codes.clustered_codes(SEED, n, BITS, n_clusters=max(1, n // 200),
                                   flip_p=0.02)
    t0 = time.time()
    native_idx = build_index_native(packed, cfg)
    t_native = time.time() - t0
    device_idx = build_index(jnp.asarray(packed), cfg, directory="range")
    qc, _ = search_queries(jnp.asarray(packed), n_q)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    a = mih_search(native_idx, qc, scfg)
    b = mih_search(device_idx, qc, scfg)
    require(np.array_equal(a.dists, b.dists) and np.array_equal(a.ids, b.ids),
            "native build: results equal build_index")
    log(f"phase native: {n} codes built in {t_native:.1f} s; {n_q} k=10 "
        f"results equal build_index")


def phase_served(index, queries, n_req: int = 8, k_full: int = 100) -> None:
    """Server and client in this process (one process per card)."""
    from verticut_tpu import codes
    from verticut_tpu.config import SearchConfig
    from verticut_tpu.search import mih_search
    from verticut_tpu.service import ImageSearchClient, ImageSearchServer, wire
    k = 10
    ids = np.arange(n_req, dtype=np.int64) * (index.n // n_req)
    by_id = np.asarray(index.codes[ids])
    by_code = np.asarray(queries[:n_req])
    want_id = mih_search(index, by_id, SearchConfig(knn=k))
    want_code = mih_search(index, by_code, SearchConfig(knn=k))

    def rows(res, r):
        return [[int(i), int(d)] for i, d in zip(res.ids[r], res.dists[r])
                if i >= 0]

    srv = ImageSearchServer(index, port=0, default_knn=k).start()
    client = ImageSearchClient(port=srv.port)
    try:
        require(client.ping() == "pong", "served: ping")
        t0 = time.time()
        for r, i in enumerate(ids):
            require(client.search_image_by_id(int(i), k) == rows(want_id, r),
                    f"served: search_image_by_id({i})")
        raw = codes.unpack_to_bytes(by_code)
        for r in range(n_req):
            require(client.search_by_code(raw[r].tobytes(), k)
                    == rows(want_code, r), f"served: search_by_code row {r}")
        batch = client.search_batch(raw.tobytes(), k)
        require(batch == [rows(want_code, r) for r in range(n_req)],
                "served: search_batch")
        log(f"phase served: {2 * n_req + 1} requests on {index.n} codes equal "
            f"mih_search ({time.time() - t0:.1f} s)")
        # one full-width batch at the launcher's k: the answer is ~5.7 MB
        # of msgpack, decoded by the client as it arrives
        want_full = mih_search(index, queries, SearchConfig(knn=k_full))
        raw_full = codes.unpack_to_bytes(np.asarray(queries)).tobytes()
        client.search_batch(raw_full, k_full)           # compiles the bucket
        t0 = time.time()
        full = client.search_batch(raw_full, k_full)
        t_full = time.time() - t0
        require(full == [rows(want_full, r) for r in range(len(full))]
                and len(full) == queries.shape[0],
                f"served: search_batch of {queries.shape[0]} at k={k_full}")
        blob = wire.packb([1, 0, None, full])
        t0 = time.time()
        wire.packb([1, 0, None, full])
        t_pack = time.time() - t0
        t0 = time.time()
        wire.unpackb(blob)
        t_unpack = time.time() - t0
        log(f"phase served: search_batch of {len(full)} queries at "
            f"k={k_full} equals mih_search; {t_full:.3f} s client wall, "
            f"of which the {len(blob)}-byte answer takes {t_pack:.3f} s to "
            f"encode and {t_unpack:.3f} s to decode on the host")
        log_c_codec([1, 0, None, full], blob)
    finally:
        client.close()
        srv.stop()


def log_c_codec(obj, blob: bytes) -> None:
    """Where the ``msgpack`` package happens to be installed, time its C
    codec on the same answer, for comparison with service/wire.py. The
    served path never imports it."""
    try:
        import msgpack
    except ImportError:
        log("  msgpack package not installed: C codec not timed")
        return
    t0 = time.time()
    packed = msgpack.packb(obj)
    t_pack = time.time() - t0
    t0 = time.time()
    msgpack.unpackb(packed)
    t_unpack = time.time() - t0
    require(packed == blob, "wire.py writes the bytes msgpack writes")
    log(f"  msgpack {msgpack.version} C codec on the same answer: "
        f"{t_pack:.3f} s to encode, {t_unpack:.3f} s to decode; same bytes")


def memory_gib(device, stat: str = "bytes_in_use") -> str:
    """One device memory statistic in GiB ("n/a" where the backend
    reports none, as the CPU does)."""
    value = (device.memory_stats() or {}).get(stat)
    return "n/a" if value is None else f"{value / 2**30:.2f} GiB"


def device_memory_line(devices) -> str:
    return ", ".join(f"card {d.id}: {memory_gib(d)}" for d in devices)


def check_same_answers(res, want, queries, corpus, what: str) -> None:
    """``res`` against single-card ``want``: equal distances, distinct ids
    per row, and each id's true distance equal to the one reported. Ids
    themselves may differ only among codes tied at the k-th distance."""
    import jax.numpy as jnp
    from verticut_tpu import codes
    d, i = np.asarray(res.dists), np.asarray(res.ids)
    require(np.array_equal(d, np.asarray(want.dists)),
            f"{what}: distances equal single-card mih_search")
    s = np.sort(i, axis=-1)
    require(((i >= 0) & (i < corpus.shape[0])).all()
            and not (s[:, 1:] == s[:, :-1]).any(),
            f"{what}: valid, distinct ids")
    true_d = np.asarray(codes.hamming_distance(
        corpus[jnp.asarray(i)], jnp.asarray(queries)[:, None, :]))
    require(np.array_equal(true_d, d), f"{what}: ids carry their distances")
    same = int((i == np.asarray(want.ids)).all(axis=-1).sum())
    log(f"phase four-cards {what}: equal to single-card mih_search "
        f"({same} of {len(i)} rows with identical ids; the rest differ "
        "only among ties at the k-th distance)")


def phase_four_cards(n: int = N_CODES, n_q: int = N_QUERIES,
                     n_oracle: int = N_ORACLE) -> None:
    """The table-sharded engines on a 4-card mesh, against the popcount
    scan and single-card ``mih_search`` over the same corpus."""
    import gc

    import jax
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.parallel import make_mesh
    from verticut_tpu.search import mih_search
    from verticut_tpu.search.sharded import (build_sharded_index,
                                             sharded_mih_search)
    from verticut_tpu.search.sharded_compact import (build_sharded_compact,
                                                     sharded_compact_search)
    devices = jax.devices()[:4]
    require(len(devices) == 4, "four devices")
    cfg = MIHConfig(bits=BITS, n_tables=4)
    scfg = SearchConfig(knn=10, candidate_cap=8192, max_enum_radius=5)
    corpus = build_corpus(n)
    qc, _ = search_queries(corpus, n_q)
    single = phase_build(corpus, "card 0")
    want = mih_search(single, qc, scfg)
    check_oracle(want.dists, qc, corpus, 10, n_oracle, "single card")
    del single
    gc.collect()

    mesh = make_mesh(n_tables=4, devices=devices)
    t0 = time.time()
    sharded = build_sharded_index(corpus, cfg, mesh)
    jax.block_until_ready(sharded.entry_rows)
    peak0 = memory_gib(devices[0], "peak_bytes_in_use")
    gc.collect()
    log(f"phase four-cards sharded build: {time.time() - t0:.1f} s; card 0 "
        f"peak {peak0}; in use {device_memory_line(devices)}")
    owners = sorted(s.device.id for s in sharded.entry_rows.addressable_shards)
    require(owners == sorted(d.id for d in devices)
            and all(s.data.shape[0] == 1
                    for s in sharded.entry_rows.addressable_shards),
            "each card holds exactly one table")
    res = sharded_mih_search(sharded, qc, scfg)
    check_oracle(res.dists, qc, corpus, 10, n_oracle, "sharded_mih_search")
    check_same_answers(res, want, qc, corpus, "sharded_mih_search")
    del sharded
    gc.collect()

    t0 = time.time()
    compact = build_sharded_compact(corpus, cfg, mesh)
    jax.block_until_ready(compact.codes)
    log(f"phase four-cards compact build: {time.time() - t0:.1f} s; in use "
        f"{device_memory_line(devices)}")
    res = sharded_compact_search(compact, qc, scfg)
    check_oracle(res.dists, qc, corpus, 10, n_oracle,
                 "sharded_compact_search")
    check_same_answers(res, want, qc, corpus, "sharded_compact_search")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card sharded phases")
    args = p.parse_args(argv)

    from verticut_tpu.utils.cache import enable_compilation_cache
    from verticut_tpu.utils.device import require_gpu
    device = require_gpu()
    enable_compilation_cache()
    card = device.pop("card")
    log(f"card: {card}")
    t0 = time.time()
    if args.four_cards:
        phase_four_cards()
    else:
        corpus = build_corpus(N_CODES)
        index = phase_build(corpus, card)
        qc = phase_exact(index, corpus)
        phase_kernel(corpus)
        phase_native()
        phase_served(index, qc)
    log(f"all phases passed in {time.time() - t0:.1f} s; card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
