"""Aligned-block chunk descriptors: variable (start, count) row ranges →
fixed-budget lists of BLK-aligned block fetches.

The memory-system fact this encodes: an XLA gather pays a fixed cost per
gathered row, nearly regardless of row width up to ~512 B, so fetching
bucket entries one row at a time (16-32 B) wastes most of that cost while
fetching them as BLK-entry aligned blocks amortizes it (the per-row cost
on the GPU is not yet measured, ROADMAP Queue 1). This is the analog of the
reference reading a whole bucket per RDMA (``src/search_worker.cc:249``
fetches the full ``Image_List`` blob, not per-entry) — latency amortized
over a contiguous region.

A probe's candidate range ``[start, start+count)`` becomes
``ceil`` over the aligned blocks it straddles; per-chunk ``(lo, hi)``
windows mask rows outside the range. All chunks of all probes of a query
are flattened into one fixed ``CHB`` budget (compare-reduce over the
probe axis, zero gathers — same lowering as ``expand_buckets``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def chunk_descriptors(starts: jax.Array, counts: jax.Array, *, blk: int,
                      chb: int, n_blocks: int
                      ) -> Tuple[jax.Array, jax.Array, jax.Array,
                                 jax.Array, jax.Array]:
    """Flatten per-probe row ranges into BLK-aligned chunk descriptors.

    ``starts/counts: int32[Q, H]`` (count 0 = empty probe) →
    ``(blk_id int32[Q, CHB], lo int32[Q, CHB], hi int32[Q, CHB],
    nch int32[Q], overflow bool[Q])``.

    Chunk slot ``h`` of query ``q`` covers entry rows
    ``[blk_id*blk + lo, blk_id*blk + hi)``; slots beyond the query's chunk
    count have ``lo == hi`` (nothing valid) and a clipped ``blk_id``.
    ``overflow`` is set when a query needs more than ``chb`` chunks — the
    caller re-runs those queries with a larger budget (exactness contract,
    DESIGN.md §2).
    """
    q, h_probes = starts.shape
    ends = starts + counts
    ablk0 = starts // blk
    nch_p = jnp.where(counts > 0,
                      (ends + (blk - 1)) // blk - ablk0, 0)      # [Q, H]
    cum = jnp.cumsum(nch_p, axis=-1)
    base = cum - nch_p                                           # exclusive
    total = cum[:, -1]
    h = jnp.arange(chb, dtype=jnp.int32)[None, :]                # [1, CHB]

    in_seg = ((h[:, None, :] >= base[:, :, None])
              & (h[:, None, :] < cum[:, :, None]))               # [Q, H, CHB]

    def sel(payload):  # exactly one probe segment owns each chunk slot
        return jnp.sum(jnp.where(in_seg, payload[:, :, None], 0), axis=1)

    blk_id = h + sel(ablk0 - base)
    s_j = sel(starts)
    e_j = sel(ends)
    lo = jnp.clip(s_j - blk_id * blk, 0, blk)
    hi = jnp.clip(e_j - blk_id * blk, 0, blk)
    blk_id = jnp.clip(blk_id, 0, n_blocks - 1)
    nch = jnp.minimum(total, chb)
    return blk_id, lo, hi, nch, total > chb


def fetch_score_blocks(entry_rows: jax.Array, blk_id: jax.Array,
                       lo: jax.Array, hi: jax.Array, queries: jax.Array,
                       *, blk: int) -> Tuple[jax.Array, jax.Array]:
    """Gather descriptor blocks of word-major (id, code) entry blocks and
    score them against the queries.

    ``entry_rows: uint32[NB, blk*RW]`` — one row per block, word-major
    (lane ``w*blk + r`` = word w of entry r; word 0 = id, pad entries id
    0xFFFFFFFF; see index/mih.MIHTable.entry_rows),
    ``blk_id/lo/hi: int32[Q, CHB]``, ``queries: uint32[Q, W]`` →
    ``(dist int32[Q, CHB*blk], id int32[Q, CHB*blk])`` with invalid slots
    at (INF, -1). One gather of CHB 512 B rows per query — the whole
    candidate fetch is CHB gather rows instead of CHB*blk — and the
    word-major layout makes id extraction and per-word XOR/popcount
    static column slices.
    """
    from verticut_tpu.ops import topk

    w = queries.shape[-1]
    nq, chb = blk_id.shape
    g = entry_rows[blk_id]                                    # [Q,CHB,blk*RW]
    ids = g[..., 0:blk].astype(jnp.int32)                     # [Q, CHB, blk]
    dist = jnp.zeros_like(ids)
    for j in range(w):
        x = g[..., (1 + j) * blk:(2 + j) * blk] ^ queries[:, None, j:j + 1]
        dist = dist + jax.lax.population_count(x).astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, blk), 2)
    valid = (pos >= lo[..., None]) & (pos < hi[..., None]) & (ids >= 0)
    dist = jnp.where(valid, dist, topk.INF_DIST)
    ids = jnp.where(valid, ids, topk.INVALID_ID)
    return dist.reshape(nq, chb * blk), ids.reshape(nq, chb * blk)
