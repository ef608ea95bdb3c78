#!/usr/bin/env python
"""BIGANN/TexMex end-to-end: feature vectors -> binary codes -> MIH index
-> K-NN search -> recall@k against exact ground truth.

Closes the loop the reference leaves external (it consumes a pre-computed
``lsh.code`` file, ``src/build_hash_tables.cc:42``, and its accuracy
protocol is ``src/accuracy_test.cc:72-135``): reads the standard
``.bvecs``/``.fvecs`` base + query files and ``.ivecs`` ground truth
(utils/io.py), trains an ITQ encoder (models/lsh.py) on a base sample,
encodes base + queries on the device, builds the index, searches, and reports
recall@k of the exact ground-truth neighbors within the Hamming top-R
shortlist (the standard binary-hashing evaluation).

No dataset handy? ``--synth N`` generates a SIFT-like clustered uint8
corpus, computes exact L2 ground truth on device, and runs the identical
pipeline — the format contract and recall math are exercised end to end.

    python tools/bigann.py --synth 100000 --queries 1000 --k 10 --bits 128
    python tools/bigann.py --base sift_base.bvecs --query sift_query.bvecs \
        --gt sift_groundtruth.ivecs --k 100
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def l2_ground_truth(queries_f, base_f, k, chunk=65536):
    """Exact L2 top-k ids on device: ||a-b||^2 = ||a||^2 - 2ab + ||b||^2."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    q = jnp.asarray(queries_f, jnp.float32)

    @jax.jit
    def chunk_d2(q, base_c):
        # arrays as arguments, not closure constants (CLAUDE.md: captured
        # arrays become HLO constants -> oversized remote-compile payloads)
        qn = jnp.sum(q * q, axis=1, keepdims=True)
        b = base_c.astype(jnp.float32)
        bn = jnp.sum(b * b, axis=1)
        return qn - 2.0 * (q @ b.T) + bn[None, :]

    best_d = np.full((q.shape[0], k), np.inf, np.float32)
    best_i = np.full((q.shape[0], k), -1, np.int64)
    for lo in range(0, base_f.shape[0], chunk):
        d2 = np.asarray(chunk_d2(q, jnp.asarray(base_f[lo:lo + chunk])))
        ids = np.arange(lo, lo + d2.shape[1])
        cat_d = np.concatenate([best_d, d2], axis=1)
        cat_i = np.concatenate(
            [best_i, np.broadcast_to(ids, d2.shape)], axis=1)
        sel = np.argsort(cat_d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(cat_d, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    return best_i


def synth_features(n, nq, dim, seed):
    """SIFT-like clustered uint8 features + queries near base points."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_clusters = max(8, n // 500)
    centers = rng.integers(0, 160, (n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, n)
    base = centers[assign] + rng.normal(0, 12.0, (n, dim))
    base = np.clip(base, 0, 255).astype(np.uint8)
    sel = rng.integers(0, n, nq)
    qf = base[sel].astype(np.float32) + rng.normal(0, 6.0, (nq, dim))
    return base, np.clip(qf, 0, 255).astype(np.uint8)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base", help=".bvecs/.fvecs base vectors")
    p.add_argument("--query", help=".bvecs/.fvecs query vectors")
    p.add_argument("--gt", help=".ivecs exact ground truth (else computed)")
    p.add_argument("--synth", type=int, default=0,
                   help="generate a synthetic corpus of this size instead")
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--max-base", type=int, default=0)
    p.add_argument("--bits", type=int, default=128)
    p.add_argument("--tables", type=int, default=4)
    p.add_argument("--k", type=int, default=10,
                   help="ground-truth neighbors to recover")
    p.add_argument("--json", help="write a JSON artifact of the results")
    p.add_argument("--shortlists",
                   help="comma list of shortlist sizes to sweep (the "
                        "standard recall@k@R curve); overrides --shortlist")
    p.add_argument("--shortlist", type=int, default=0,
                   help="Hamming top-R shortlist (default: 10*k)")
    p.add_argument("--train-sample", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dim", type=int, default=128)
    args = p.parse_args()

    from verticut_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import numpy as np
    import jax.numpy as jnp
    from verticut_tpu.config import MIHConfig, SearchConfig
    from verticut_tpu.index.build_native import build_index_native
    from verticut_tpu.models.lsh import ITQEncoder, encode_corpus
    from verticut_tpu.search import mih_search
    from verticut_tpu.utils import io as vio

    if args.synth:
        log(f"bigann: synthesizing {args.synth} x {args.dim} uint8 features")
        base_f, query_f = synth_features(args.synth, args.queries, args.dim,
                                         args.seed)
        gt = None
    else:
        if not (args.base and args.query):
            p.error("--base/--query or --synth required")
        base_f = vio.read_vecs(args.base, max_rows=args.max_base)
        query_f = vio.read_vecs(args.query, max_rows=args.queries)
        gt = vio.read_vecs(args.gt)[:len(query_f)] if args.gt else None
    nq = len(query_f)
    log(f"bigann: base {base_f.shape} queries {query_f.shape}")

    if gt is None:
        log("bigann: computing exact L2 ground truth on device")
        gt = l2_ground_truth(query_f, base_f, args.k)
    gt = np.asarray(gt)[:, :args.k]

    t0 = time.time()
    rng = np.random.default_rng(args.seed)
    sample = base_f[rng.choice(len(base_f),
                               min(args.train_sample, len(base_f)),
                               replace=False)]
    enc = ITQEncoder.fit(jnp.asarray(sample, jnp.float32), bits=args.bits)
    train_s = time.time() - t0
    t0 = time.time()
    base_codes = encode_corpus(enc, base_f.astype(np.float32))
    query_codes = encode_corpus(enc, query_f.astype(np.float32))
    encode_s = time.time() - t0
    log(f"bigann: ITQ train {train_s:.1f}s encode {encode_s:.1f}s")

    cfg = MIHConfig(bits=args.bits, n_tables=args.tables)
    t0 = time.time()
    index = build_index_native(base_codes, cfg)
    build_s = time.time() - t0

    if args.shortlists:
        shortlists = [int(s) for s in args.shortlists.split(",")]
    else:
        shortlists = [args.shortlist or 10 * args.k]
    qc = jnp.asarray(query_codes)
    bf = base_f.astype(np.float32)
    qf = query_f.astype(np.float32)
    d_true = np.linalg.norm(bf[gt] - qf[:, None, :], axis=-1)
    rows = []
    for shortlist in shortlists:
        scfg = SearchConfig(knn=shortlist)
        mih_search(index, qc, scfg)  # warm/compile (steady-state numbers)
        t0 = time.time()
        res = mih_search(index, qc, scfg)
        search_s = time.time() - t0

        # recall@1@R and recall@k@R (standard binary-hashing evaluation:
        # is the true neighbor inside the Hamming top-R shortlist)
        hits = 0
        hits1 = 0
        for i in range(nq):
            found = set(res.ids[i].tolist())
            hits += len(set(gt[i].tolist()) & found)
            hits1 += 1 if int(gt[i, 0]) in found else 0
        recall = hits / float(nq * args.k)
        recall1 = hits1 / float(nq)
        # reference-style distance ratio on the features
        # (accuracy_test.cc:118-126: mean of d(found)/d(true) per rank)
        found = np.clip(res.ids[:, :args.k], 0, len(base_f) - 1)
        d_found = np.linalg.norm(bf[found] - qf[:, None, :], axis=-1)
        ratio = float(np.mean(d_found / np.maximum(d_true, 1e-6)))

        print(f"recall@1 (shortlist {shortlist}): {recall1:.4f}")
        print(f"recall@{args.k} (shortlist {shortlist}): {recall:.4f}")
        print(f"distance ratio: {ratio:.4f}")
        print(f"train {train_s:.1f}s encode {encode_s:.1f}s "
              f"build {build_s:.1f}s "
              f"search {search_s:.2f}s ({nq / max(search_s, 1e-9):.0f} qps)")
        rows.append({"shortlist": shortlist, "recall_at_1": round(recall1, 4),
                     f"recall_at_{args.k}": round(recall, 4),
                     "distance_ratio": round(ratio, 4),
                     "search_s": round(search_s, 3),
                     "qps": round(nq / max(search_s, 1e-9), 1)})

    if args.json:
        import json
        art = {"dataset": ("synthetic" if args.synth else args.base),
               "n_base": int(len(base_f)), "n_queries": int(nq),
               "dim": int(base_f.shape[1]), "bits": args.bits,
               "n_tables": args.tables, "k": args.k,
               "train_s": round(train_s, 1), "encode_s": round(encode_s, 1),
               "build_s": round(build_s, 1), "sweep": rows}
        with open(args.json, "w") as f:
            f.write(json.dumps(art) + "\n")
        log(f"bigann: wrote {args.json}")


if __name__ == "__main__":
    main()
