"""On-chip oracle drive — the recording gate for selection/merge changes.

An accelerator backend can miscompile selection code at (width, batch,
program) combinations that CPU tests and isolated micro-probes cannot
reproduce (CLAUDE.md "Invariants"). Run this on the card after ANY change
to a selection or merge path (ops/topk.py, ops/hamming.py, the fused
pipeline staging).

Coverage: clustered + uniform 1M corpora, k ∈ {10, 100, 500, 1000},
the production fused engine vs an INDEPENDENT brute-force oracle
(``linear_search(method="popcount")`` — XOR + popcount + chunk merges,
sharing no code with the blockmin/select_desc machinery the engine's scan
tier uses, so a shared miscompile cannot fake a pass).
Pass criterion per cell: the k-NN distance multisets are equal for every
query, and every returned id's recomputed Hamming distance equals the
distance the engine claimed for it.

Role parity: the reference's equivalent gate is ``accuracy_test``
(``src/accuracy_test.cc:72-135``) run against ``linear_search``
(``src/linear_search.cc:39-64``); this adds the id-distance cross-check
because the failure mode being guarded (wrong ids with plausible
distances) is compiler-induced, not algorithmic.

Usage::

    python tools/oracle_drive.py               # full grid
    VERTICUT_ORACLE_N=100000 python tools/oracle_drive.py   # quick

Prints one JSON object; exit code 0 iff every cell passed.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def perturbed_queries(rng, packed, n, bits, q_batch, n_flips=3):
    import jax
    import jax.numpy as jnp
    sel = jnp.asarray(rng.integers(0, n, q_batch))
    pos = jnp.asarray(rng.integers(0, bits, (q_batch, n_flips)))
    rows = packed[sel]
    n_words = bits // 32
    word = jax.lax.broadcasted_iota(jnp.int32, (1, 1, n_words), 2)
    terms = jnp.where(
        pos[:, :, None] // 32 == word,
        jnp.uint32(1) << (pos[:, :, None] % 32).astype(jnp.uint32),
        jnp.uint32(0))
    out = rows
    for j in range(n_flips):
        out = out ^ terms[:, j]
    return out


def main():
    from verticut_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from verticut_tpu import codes
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.index import build_index
    from verticut_tpu.search import mih_search
    from verticut_tpu.search.linear import linear_search

    n = int(os.environ.get("VERTICUT_ORACLE_N", 1_000_000))
    q_batch = int(os.environ.get("VERTICUT_ORACLE_Q", 1024))
    ks = tuple(int(x) for x in os.environ.get(
        "VERTICUT_ORACLE_K", "10,100,500,1000").split(","))
    cfg = MIHConfig(bits=128, n_tables=4)
    rng = np.random.default_rng(7)

    corpora = {}
    corpora["clustered"] = jnp.asarray(
        codes.clustered_codes(1, n, cfg.bits, n_clusters=max(2, n // 200),
                              flip_p=0.02))
    corpora["uniform"] = jnp.asarray(codes.random_codes(2, n, cfg.bits))

    cells = []
    all_ok = True
    for name, packed in corpora.items():
        index = build_index(packed, cfg, directory="range")
        # half perturbed-db queries (enumeration-resolved), half random
        # (scan-tier-resolved) — both selection paths must be exercised
        qp = perturbed_queries(rng, packed, n, cfg.bits, q_batch // 2)
        qr = jnp.asarray(codes.random_codes(3, q_batch - q_batch // 2,
                                            cfg.bits))
        queries = jnp.concatenate([qp, qr], axis=0)
        q_host = np.asarray(queries)
        db_host = np.asarray(packed)

        for k in ks:
            scfg = SearchConfig(knn=k, candidate_cap=8192, max_enum_radius=5)
            t0 = time.time()
            res = mih_search(index, queries, scfg)
            eng_s = time.time() - t0
            t0 = time.time()
            od, _ = linear_search(queries, packed, k, method="popcount")
            od = np.asarray(od)
            orc_s = time.time() - t0
            multiset = bool(np.array_equal(
                np.sort(np.asarray(res.dists), axis=-1), np.sort(od, -1)))
            # id-distance cross-check on host (numpy popcount, fully
            # independent of the device): every claimed (id, dist) pair
            # must be true — guards "right distance, wrong id" miscompiles
            ids = np.asarray(res.ids)
            dd = np.asarray(res.dists)
            valid = ids >= 0
            rows = db_host[np.clip(ids, 0, n - 1)]
            hd = np.bitwise_xor(rows, q_host[:, None, :])
            hd = np.unpackbits(hd.view(np.uint8), axis=-1).sum(-1)
            ids_ok = bool(np.all((hd == dd) | ~valid))
            ok = multiset and ids_ok
            all_ok &= ok
            cells.append({
                "corpus": name, "k": k, "n": n, "q": q_batch,
                "multiset_equal": multiset, "id_dist_equal": ids_ok,
                "engine_s": round(eng_s, 3), "oracle_s": round(orc_s, 3),
                "mean_radius": round(float(np.mean(res.radius)), 3),
            })
            log(f"oracle: {name} k={k} multiset={multiset} ids={ids_ok} "
                f"engine {eng_s:.2f}s oracle {orc_s:.2f}s")

    out = {
        "metric": "oracle_drive",
        "ok": all_ok,
        "device": str(jax.devices()[0].device_kind),
        "cells": cells,
    }
    print(json.dumps(out))
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
