"""Brute-force exact K-NN scan — the ground-truth oracle.

Equivalent of ``src/linear_search.cc:39-64`` (fetch every code, XOR+popcount,
priority-queue top-k), re-cast as a chunked batched device scan. Ties at the
kth distance resolve by ascending id (deterministic; the reference's heap is
insertion-order-dependent there, so recall comparisons are done on distance
multisets — see tests/test_parity.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from verticut_tpu.ops import hamming


def linear_search(queries, db, k: int, method: str = "auto",
                  chunk: int = 65536):
    """Exact top-k: returns ``(dists int32[Q, k], ids int32[Q, k])``
    ascending by (dist, id).

    method: "auto" is the production scan, the block-min pre-selection
    scan (:func:`hamming.scan_blockmin`, whose pass 1 follows
    :func:`hamming.use_scan_kernel`). "popcount" is the independent oracle:
    XOR + popcount with per-chunk merges, sharing no selection machinery
    with the production scan. "matmul" is the ±1 GEMM with per-chunk
    merges. All are exact (distances <= bits are integers, exact in the
    GEMM's int8/bf16 operands and int32/f32 sums).
    """
    queries = jnp.asarray(queries, jnp.uint32)
    db = jnp.asarray(db, jnp.uint32)
    chunk = min(chunk, max(db.shape[0], 8))
    if method == "auto":
        # narrower blocks at large k (the rescore gathers k blocks/query),
        # and slice the query batch so the [Q, k, block, W] rescore buffer
        # stays bounded (at q=8192, k=500, block=512 it would be 33 GB)
        block = 512 if k <= 32 else 128
        per_q = max(1, k * block * db.shape[1] * 4)
        max_q = max(256, (1 << 31) // per_q)
        nq = queries.shape[0]
        parts = [hamming.scan_blockmin(queries[lo:lo + max_q], db, k,
                                       block=block)
                 for lo in range(0, nq, max_q)]
        if len(parts) == 1:
            return parts[0]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))
    if method == "popcount":
        return hamming.scan_popcount(queries, db, k, chunk=chunk)
    if method == "matmul":
        return hamming.scan_matmul(queries, db, k, chunk=chunk)
    raise ValueError(f"unknown method {method!r}")
