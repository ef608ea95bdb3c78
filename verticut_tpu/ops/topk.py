"""Batched bounded top-k with id-dedup — the device analog of the reference's
master-side ``std::map`` dedup + bounded ``std::priority_queue``
(``src/search_worker.cc:179-198``).

State is a fixed-shape *pool* per query: ``(dist int32[Q, P], id int32[Q, P])``
kept sorted ascending by ``(dist, id)``; empty slots hold ``id = -1`` and
``dist = INF``. Merging new candidates is two ``lax.sort`` passes:

1. sort by id → mark adjacent duplicates invalid (a candidate id always
   carries the same distance — Hamming distance is a pure function of
   (query, id) — so "first seen wins" in the reference and "any copy wins"
   here produce identical pools);
2. sort by (dist, id) → keep the first P.

Both sorts are multi-key ``lax.sort`` calls, batched over Q on the last axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INF_DIST = jnp.int32(0x7FFFFFFF)
INVALID_ID = jnp.int32(-1)
_UMAX = jnp.uint32(0xFFFFFFFF)


def empty_pool(n_queries: int, pool_size: int):
    """Fresh pool: all slots invalid."""
    return (jnp.full((n_queries, pool_size), INF_DIST, jnp.int32),
            jnp.full((n_queries, pool_size), INVALID_ID, jnp.int32))


def merge_topk_dedup(pool_dist: jax.Array, pool_id: jax.Array,
                     cand_dist: jax.Array, cand_id: jax.Array):
    """Merge candidates into the pool, dropping duplicate ids.

    ``pool_*: [Q, P]``, ``cand_*: [Q, C]`` (invalid candidates: id = -1).
    Returns the new ``(pool_dist, pool_id)``, sorted ascending by (dist, id).
    """
    p = pool_dist.shape[-1]
    idk = jnp.concatenate([pool_id, cand_id], axis=-1).astype(jnp.uint32)
    d = jnp.concatenate([pool_dist, cand_dist], axis=-1)
    d = jnp.where(idk == _UMAX, INF_DIST, d)

    # Pass 1: group by id, invalidate all but the first copy.
    idk, d = jax.lax.sort((idk, d), num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros_like(idk[..., :1], jnp.bool_),
         (idk[..., 1:] == idk[..., :-1]) & (idk[..., 1:] != _UMAX)], axis=-1)
    idk = jnp.where(dup, _UMAX, idk)
    d = jnp.where(dup, INF_DIST, d)

    # Pass 2: order by (dist, id), truncate to pool size.
    d, idk = jax.lax.sort((d, idk), num_keys=2)
    d, idk = d[..., :p], idk[..., :p]
    return d, jnp.where(idk == _UMAX, INVALID_ID, idk.astype(jnp.int32))


PACKED_ID_BITS = 24  # ids < 2^24 and dist < 2^8 pack into one uint32


def can_pack(max_id: int, max_dist: int) -> bool:
    # strict: the all-ones packed key is reserved as the invalid sentinel
    return max_id < (1 << PACKED_ID_BITS) and max_dist < (
        1 << (32 - PACKED_ID_BITS)) - 1


def merge_topk_dedup_packed(pool_dist: jax.Array, pool_id: jax.Array,
                            cand_dist: jax.Array, cand_id: jax.Array,
                            n_dup: int, block: int = 2048):
    """Fast-path merge for ids < 2^24 and dist ≤ 255.

    Packs (dist, id) into one uint32 key ``dist<<24 | id``, so duplicates of
    an id are *bitwise identical* keys (Hamming distance is a pure function
    of the id). One ``lax.top_k`` over the bit-inverted keys selects the
    smallest ``P + n_dup`` pairs; duplicates land adjacent in its sorted
    output and are compacted with a cumsum-scatter. ``n_dup`` must bound the
    duplicate copies that can ride along with the P winners — each id has at
    most one copy per table per radius plus one in the pool, so callers pass
    ``P * n_tables``. One selection instead of the two-pass multi-key sort.

    Wide candidate sets are pre-reduced blockwise (a ``lax.top_k`` can be a
    full sort of the axis, so hierarchical beats flat past ~2 blocks):
    each ``block``-wide slice keeps its top ``P + n_dup``
    keys — a superset of its members in the global top ``P + n_dup`` (dups
    of a winner included, since per-block top-m keeps any key ≥ the global
    m-th) — exactness preserved.
    """
    p = pool_dist.shape[-1]
    inv0 = jnp.uint32(0)  # inverted INF: top_k picks largest inverted keys
    shift = jnp.uint32(PACKED_ID_BITS)
    kp = jnp.where(pool_id >= 0,
                   ~((pool_dist.astype(jnp.uint32) << shift)
                     | pool_id.astype(jnp.uint32)), inv0)
    kc = jnp.where(cand_id >= 0,
                   ~((cand_dist.astype(jnp.uint32) << shift)
                     | cand_id.astype(jnp.uint32)), inv0)
    m_blk = min(p + n_dup, block)
    c = kc.shape[-1]
    if c > 2 * block and m_blk < block:
        q = kc.shape[0]
        nb = -(-c // block)
        if nb * block != c:
            kc = jnp.pad(kc, ((0, 0), (0, nb * block - c)),
                         constant_values=0)
        kc = jax.lax.top_k(kc.reshape(q, nb, block), m_blk)[0] \
            .reshape(q, nb * m_blk)
    keys = jnp.concatenate([kp, kc], axis=-1)
    width = keys.shape[-1]
    m = min(p + n_dup, width)
    top = select_desc(keys, m)            # descending inverted = asc packed
    dup = jnp.concatenate(
        [jnp.zeros_like(top[..., :1], jnp.bool_),
         (top[..., 1:] == top[..., :-1]) & (top[..., 1:] != inv0)], axis=-1)
    # compact survivors: invalidate dups, then one more top_k — a scatter
    # compaction compiles/runs pathologically at the wide pools of
    # approximate mode (k*20), while top_k over the already-selected m is
    # cheap at any width
    top = jnp.where(dup, inv0, top)
    out = select_desc(top, p)
    packed = ~out
    invalid = out == inv0
    pid = jnp.where(invalid, INVALID_ID,
                    (packed & jnp.uint32((1 << PACKED_ID_BITS) - 1))
                    .astype(jnp.int32))
    pd = jnp.where(invalid, INF_DIST,
                   (packed >> shift).astype(jnp.int32))
    return pd, pid


def merge_topk(pool_dist: jax.Array, pool_id: jax.Array,
               cand_dist: jax.Array, cand_id: jax.Array):
    """Merge without dedup (linear-scan path: ids are unique by construction)."""
    p = pool_dist.shape[-1]
    idk = jnp.concatenate([pool_id, cand_id], axis=-1).astype(jnp.uint32)
    d = jnp.concatenate([pool_dist, cand_dist], axis=-1)
    d = jnp.where(idk == _UMAX, INF_DIST, d)
    d, idk = jax.lax.sort((d, idk), num_keys=2)
    d, idk = d[..., :p], idk[..., :p]
    return d, jnp.where(idk == _UMAX, INVALID_ID, idk.astype(jnp.int32))


def chunk_topk(dists: jax.Array, ids: jax.Array, k: int,
               block: int = 2048):
    """Per-chunk bounded top-k, hierarchical.

    ``dists: int32[Q, T]``, ``ids: int32[Q or 1, T]`` → ``([Q, k], [Q, k])``.

    ``lax.top_k`` can lower to a full sort, so a single top-k over a
    wide chunk (T ~ 64k) would dominate the whole scan. Instead: blockwise
    top-k (each block's winners are a superset of its global-top-k members —
    exactness preserved), then a final top-k over the concatenated winners.
    Ties at the threshold resolve to the lowest position (ascending id for
    id-ordered chunks) at both levels — the same (dist, id) lexicographic
    selection the sort-based merge uses.
    """
    t = dists.shape[-1]
    ids_b = jnp.broadcast_to(ids, dists.shape)
    if t > 2 * block and t % block == 0 and k <= block:
        q = dists.shape[0]
        nb = t // block
        db = dists.reshape(q, nb, block)
        ib = ids_b.reshape(q, nb, block)
        neg, idx = jax.lax.top_k(-db, k)               # [Q, nb, k]
        sel = jnp.take_along_axis(ib, idx, axis=-1)
        dists = (-neg).reshape(q, nb * k)
        ids_b = sel.reshape(q, nb * k)
        t = nb * k
    kk = min(k, t)
    neg, idx = jax.lax.top_k(-dists, kk)
    sel = jnp.take_along_axis(ids_b, idx, axis=-1)
    d = -neg
    if kk < k:
        pad = k - kk
        d = jnp.pad(d, ((0, 0), (0, pad)), constant_values=int(INF_DIST))
        sel = jnp.pad(sel, ((0, 0), (0, pad)), constant_values=-1)
    d = jnp.where(sel < 0, INF_DIST, d)
    return d, sel


def merge_topk_packed(pool_dist: jax.Array, pool_id: jax.Array,
                      cand_dist: jax.Array, cand_id: jax.Array):
    """No-dedup merge via one uint32-packed ``lax.top_k``.

    Requires ``can_pack`` bounds (ids < 2^24, dist <= 254). Packing halves
    the sorted bytes and gives bitwise-equal dup keys; one selection
    instead of the two-pass multi-key sort merge.
    """
    p = pool_dist.shape[-1]
    shift = jnp.uint32(PACKED_ID_BITS)
    kp = jnp.where(pool_id >= 0,
                   ~((pool_dist.astype(jnp.uint32) << shift)
                     | pool_id.astype(jnp.uint32)), jnp.uint32(0))
    kc = jnp.where(cand_id >= 0,
                   ~((cand_dist.astype(jnp.uint32) << shift)
                     | cand_id.astype(jnp.uint32)), jnp.uint32(0))
    keys = jnp.concatenate([kp, kc], axis=-1)
    top = jax.lax.top_k(keys, p)[0]
    packed = ~top
    invalid = top == jnp.uint32(0)
    pid = jnp.where(invalid, INVALID_ID,
                    (packed & jnp.uint32((1 << PACKED_ID_BITS) - 1))
                    .astype(jnp.int32))
    pd = jnp.where(invalid, INF_DIST, (packed >> shift).astype(jnp.int32))
    return pd, pid


def chunk_topk_affine(dists: jax.Array, base, k: int, n_valid,
                      block: int = 2048):
    """Hierarchical chunk top-k for position-affine ids (id = base + pos).

    Avoids all bulk id gathers: blockwise ``top_k`` indices *are* the
    in-block positions, so candidate ids come from arithmetic on the
    returned indices (a take_along_axis with computed indices is a random
    gather per element).
    ``dists: int32[Q, T]``; positions >= n_valid are invalid.
    """
    q, t = dists.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, t), 1)
    dists = jnp.where(pos < n_valid, dists, INF_DIST)
    if t > 2 * block and t % block == 0 and k <= block:
        nb = t // block
        db = dists.reshape(q, nb, block)
        neg, idx = jax.lax.top_k(-db, k)                    # [Q, nb, k]
        block_base = (jnp.arange(nb, dtype=jnp.int32) * block)[None, :, None]
        ids1 = (block_base + idx).reshape(q, nb * k)        # in-chunk pos
        d1 = (-neg).reshape(q, nb * k)
    else:
        d1 = dists
        ids1 = jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, (1, t), 1), (q, t))
    w1 = d1.shape[-1]
    kk = min(k, w1)
    p_bits = max(1, (w1 - 1).bit_length())
    if w1 > _TOPK_WIDE and p_bits <= 21:
        # wide final strip (k*nb past the blockwise reduce): lax.top_k's
        # compile time explodes with the sorted width, so pack
        # (dist, slot) and select via the shrink ladder; dist field >= 11
        # bits holds any Hamming distance (codes <= 512 bits), INF ->
        # invalid
        slot = jax.lax.broadcasted_iota(jnp.uint32, (1, w1), 1)
        keys = jnp.where(d1 < INF_DIST,
                         ~((d1.astype(jnp.uint32) << jnp.uint32(p_bits))
                           | slot), jnp.uint32(0))
        top = select_desc(keys, kk)
        packed = ~top
        bad = top == jnp.uint32(0)
        idx2 = jnp.clip((packed & jnp.uint32((1 << p_bits) - 1))
                        .astype(jnp.int32), 0, w1 - 1)
        d = jnp.where(bad, INF_DIST,
                      (packed >> jnp.uint32(p_bits)).astype(jnp.int32))
    else:
        neg, idx2 = jax.lax.top_k(-d1, kk)
        d = -neg
    sel = jnp.take_along_axis(ids1, idx2, axis=-1)          # only [Q, k]
    if kk < k:
        d = jnp.pad(d, ((0, 0), (0, k - kk)), constant_values=int(INF_DIST))
        sel = jnp.pad(sel, ((0, 0), (0, k - kk)), constant_values=-1)
    invalid = d >= INF_DIST
    gids = jnp.where(invalid, INVALID_ID, base + sel)
    return jnp.where(invalid, INF_DIST, d), gids


# --------------------------------------------------------------------------
# Wide selection. A lax.top_k over a wide operand whose INDICES output is
# consumed (the variadic (key, iota) lowering) can compile pathologically
# slowly, with a cost that grows with the sorted width. The blockwise
# shrink ladder below uses narrow native top_k sorts only.
#
# A handwritten compare/select tournament (bitonic block sort + pairwise
# sorted-merge from reshape + strided-slice shuffles) was tried first and
# is GONE FOR CAUSE: its lowering MISCOMPILED at unpredictable (width,
# batch, program) combinations that isolated micro-probes and the CPU
# could not reproduce; only on-card oracle drives caught it. Do not
# reintroduce handwritten sorting networks: use lax.top_k / lax.sort
# compositions.
#
# Both widths below hold exactness at any value; they await tuning on the
# GPU (ROADMAP Queue 1).
# --------------------------------------------------------------------------

#: lax.top_k axis width beyond which the ladder takes over
_TOPK_WIDE = 1536

#: widest axis where ONE native single-operand (value-only) lax.top_k is
#: used instead of the blockwise ladder
_TOPK_NATIVE_W = 4096


def select_desc(keys: jax.Array, m: int) -> jax.Array:
    """Largest ``m`` keys of the last axis, sorted descending — built ONLY
    from narrow native ``lax.top_k`` sorts (safe in any program context).

    Three regimes (see ``_TOPK_NATIVE_W``):

    * width ≤ 4096: ONE native value-only ``lax.top_k``.
    * wider, m ≤ 1536: blockwise shrink ladder — per-block ``top_k`` keeps
      every member of the global top-``m`` (if a global winner fell outside
      its block's top-m, the m better in-block keys would all outrank it —
      contradiction), so repeated block-reduction then one final narrow
      sort is exact, and no wide variadic top_k is compiled.
    * m > 1536 (approximate k*20 pools): single-operand ``lax.sort`` +
      ``flip`` — compiles flat in width where wide top_k explodes.

    Pads with 0 (the invalid sentinel) when the axis is shorter than ``m``.
    """
    w = keys.shape[-1]
    kk = min(m, w)
    if kk > _TOPK_WIDE:
        out = jnp.flip(jax.lax.sort(keys, dimension=-1), -1)[..., :kk]
    elif w <= _TOPK_NATIVE_W:
        out = jax.lax.top_k(keys, kk)[0]
    else:
        b = max(_pow2ceil(2 * kk), 512)
        x = keys
        while x.shape[-1] > max(2 * b, _TOPK_NATIVE_W):
            wx = x.shape[-1]
            nb = -(-wx // b)
            pad = nb * b - wx
            if pad:
                x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
            lead = x.shape[:-1]
            x = jax.lax.top_k(x.reshape(*lead, nb, b), kk)[0]
            x = x.reshape(*lead, nb * kk)
        out = jax.lax.top_k(x, kk)[0]
    if kk < m:
        out = jnp.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, m - kk)])
    return out


# Historic alias: callers written while the tournament still existed
# distinguished a "loop-safe" selection; there is only one selection now.
ladder_select_desc = select_desc


# --------------------------------------------------------------------------
# Strip merges: per-table pre-merge + narrow dedup merge.
#
# Within ONE table at ONE radius step every candidate id is unique: probes
# are distinct buckets / distinct prefix ranges, hence disjoint row ranges
# (the enumeration never visits a row twice). So a per-table top-P
# selection provably retains every member of the global top-P distinct
# set — if a winner's copy in table t fell outside t's top-P, the P
# better entries of t are P distinct ids all ordered before it, a
# contradiction. The flat dedup merge then runs at width (m+1)·P instead
# of m·cap (5x narrower at k=100, where lax.top_k's full-sort cost is the
# batch bottleneck — ROADMAP r2 #2 "per-table pre-merge").
# --------------------------------------------------------------------------


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def table_topk_packed(cand_dist: jax.Array, cand_id: jax.Array, p: int,
                      block: int = 512) -> jax.Array:
    """Per-table top-``p`` as inverted packed ``dist<<24 | id`` keys.

    Requires ``can_pack`` bounds. ``[Q, C] -> uint32[Q, p]`` (descending
    inverted = ascending (dist, id); empty slots = 0)."""
    shift = jnp.uint32(PACKED_ID_BITS)
    kc = jnp.where(cand_id >= 0,
                   ~((cand_dist.astype(jnp.uint32) << shift)
                     | cand_id.astype(jnp.uint32)), jnp.uint32(0))
    c = kc.shape[-1]
    # pre-reduce only past the native-top_k width
    if c > max(2 * block, _TOPK_NATIVE_W) and p < block:
        q = kc.shape[0]
        nb = -(-c // block)
        if nb * block != c:
            kc = jnp.pad(kc, ((0, 0), (0, nb * block - c)),
                         constant_values=0)
        kc = jax.lax.top_k(kc.reshape(q, nb, block), p)[0] \
            .reshape(q, nb * p)
    return select_desc(kc, min(p, kc.shape[-1]))


def merge_strips_packed(pool_dist: jax.Array, pool_id: jax.Array,
                        strips: jax.Array, n_copies: int):
    """Dedup merge of the pool with pre-merged per-table strips.

    ``strips: uint32[Q, S]`` inverted packed keys (from
    :func:`table_topk_packed`, concatenated over tables/shards);
    ``n_copies`` bounds the copies one id can have across pool + strips
    (= n_tables + 1 single-device; tables·shards + 1 sharded). Duplicates
    are bitwise-equal keys — sort, invalidate adjacent, re-select."""
    p = pool_dist.shape[-1]
    shift = jnp.uint32(PACKED_ID_BITS)
    kp = jnp.where(pool_id >= 0,
                   ~((pool_dist.astype(jnp.uint32) << shift)
                     | pool_id.astype(jnp.uint32)), jnp.uint32(0))
    keys = jnp.concatenate([kp, strips], axis=-1)
    width = keys.shape[-1]
    m = min(p * n_copies, width)
    top = select_desc(keys, m)
    dup = jnp.concatenate(
        [jnp.zeros_like(top[..., :1], jnp.bool_),
         (top[..., 1:] == top[..., :-1]) & (top[..., 1:] != jnp.uint32(0))],
        axis=-1)
    top = jnp.where(dup, jnp.uint32(0), top)
    out = select_desc(top, p)
    packed = ~out
    invalid = out == jnp.uint32(0)
    pid = jnp.where(invalid, INVALID_ID,
                    (packed & jnp.uint32((1 << PACKED_ID_BITS) - 1))
                    .astype(jnp.int32))
    pd = jnp.where(invalid, INF_DIST, (packed >> shift).astype(jnp.int32))
    return pd, pid


#: widest chunk axis admitted into the chunk-min variadic ``lax.top_k``
#: (indices consumed). The r2 compile bomb was the variadic lowering at
#: WIDE sorted axes (>13 min at [8192, 3132]); chunk counts here are
#: 44-652, three orders narrower, and chip-verified by the oracle drive.
_CHUNKMIN_MAX_CHB = 1024


def table_topk_chunkmin_packed(cand_dist: jax.Array, cand_id: jax.Array,
                               p: int, blk: int) -> jax.Array:
    """Per-table top-``p`` inverted packed keys via CHUNK-MIN pre-selection.

    ``cand_* [Q, C]`` arrive from the block fetch as ``C = chb*blk`` slots
    in chunk-major order. Within ONE table at one radius step every id
    appears at most once (disjoint probe ranges), so the table's top-``p``
    elements by packed (dist, id) key occupy at most ``p`` chunks. Exact
    selection therefore reduces first (the scan_blockmin insight applied to
    enumeration candidates): per-chunk key maxima (inverted keys: max =
    best) -> top-``p`` CHUNKS (narrow ``lax.top_k``, indices consumed at
    chunk width 44-652, far below the wide-variadic compile cliff) ->
    gather those chunks -> one narrow ``select_desc``. Proof: if a top-p
    element's chunk were unselected, the p selected chunks each hold an
    element strictly ordering before it — p distinct elements (one id is
    in one chunk within a table), contradiction.

    Motivation: the per-table ``lax.top_k [8192, 1100] -> 10`` strip
    selections are wide; the chunk-min path sorts 44-wide + 250-wide
    instead of 1100-wide. Falls back to :func:`table_topk_packed` unless
    the gathered strip is well under the candidate width
    (``4*p*blk <= C``): the saving exists only when ``p*blk`` stays a
    small fraction of C. The crossover awaits measurement on the GPU
    (ROADMAP Queue 1). Requires ``can_pack`` bounds.
    """
    q, c = cand_dist.shape
    chb = c // blk
    if (4 * p * blk > c or c % blk or chb > _CHUNKMIN_MAX_CHB
            or p > _TOPK_WIDE):
        return table_topk_packed(cand_dist, cand_id, p)
    shift = jnp.uint32(PACKED_ID_BITS)
    kc = jnp.where(cand_id >= 0,
                   ~((cand_dist.astype(jnp.uint32) << shift)
                     | cand_id.astype(jnp.uint32)), jnp.uint32(0))
    kc3 = kc.reshape(q, chb, blk)
    cmax = jnp.max(kc3, axis=-1)                       # [Q, chb]
    _, ci = jax.lax.top_k(cmax, p)                     # narrow variadic
    g = jnp.take_along_axis(kc3, ci[..., None], axis=1).reshape(q, p * blk)
    return select_desc(g, p)


def table_topk_chunkmin_pos(cand_dist: jax.Array, cand_id: jax.Array,
                            p: int, blk: int):
    """Chunk-min pre-selection for UNBOUNDED ids (the >2^24 corpus path):
    same chunk argument as :func:`table_topk_chunkmin_packed` with
    (dist, slot) packed keys — slot order ties match
    :func:`table_topk_pos` (slots ascend within and across chunks).
    """
    q, c = cand_dist.shape
    chb = c // blk
    if (4 * p * blk > c or c % blk or chb > _CHUNKMIN_MAX_CHB
            or p > _TOPK_WIDE):
        return table_topk_pos(cand_dist, cand_id, p)
    assert c < (1 << PACKED_ID_BITS), f"candidate width {c} >= 2^24"
    pos = jax.lax.broadcasted_iota(jnp.uint32, (1, c), 1)
    shift = jnp.uint32(PACKED_ID_BITS)
    kc = jnp.where(cand_id >= 0,
                   ~((cand_dist.astype(jnp.uint32) << shift) | pos),
                   jnp.uint32(0))
    kc3 = kc.reshape(q, chb, blk)
    cmax = jnp.max(kc3, axis=-1)
    _, ci = jax.lax.top_k(cmax, p)
    g = jnp.take_along_axis(kc3, ci[..., None], axis=1).reshape(q, p * blk)
    kk = min(p, g.shape[-1])
    top = select_desc(g, kk)
    packed = ~top
    invalid = top == jnp.uint32(0)
    sel = jnp.clip((packed & jnp.uint32((1 << PACKED_ID_BITS) - 1))
                   .astype(jnp.int32), 0, c - 1)
    sid = jnp.take_along_axis(cand_id, sel, axis=-1)
    sd = (packed >> shift).astype(jnp.int32)
    return (jnp.where(invalid, INF_DIST, sd),
            jnp.where(invalid, INVALID_ID, sid))


def table_topk_pos(cand_dist: jax.Array, cand_id: jax.Array, p: int,
                   block: int = 512):
    """Per-table top-``p`` for UNBOUNDED ids: select by packed
    ``(dist8, pos24)`` keys (pos = slot in the candidate axis, always
    < 2^24), then recover the winners' ids with one narrow gather.

    ``[Q, C] -> (dist int32[Q, p], id int32[Q, p])``. This is what removes
    the 2^24-id ceiling of the packed path (VERDICT r2 missing #3): above
    16.7M codes the old fallback was a two-pass multi-key ``lax.sort`` at
    full candidate width per merge."""
    q, c = cand_dist.shape
    assert c < (1 << PACKED_ID_BITS), f"candidate width {c} >= 2^24"
    pos = jax.lax.broadcasted_iota(jnp.uint32, (1, c), 1)
    shift = jnp.uint32(PACKED_ID_BITS)
    kc = jnp.where(cand_id >= 0,
                   ~((cand_dist.astype(jnp.uint32) << shift) | pos),
                   jnp.uint32(0))
    if c > max(2 * block, _TOPK_NATIVE_W) and p < block:
        nb = -(-c // block)
        if nb * block != c:
            kc = jnp.pad(kc, ((0, 0), (0, nb * block - c)),
                         constant_values=0)
        kc = jax.lax.top_k(kc.reshape(q, nb, block), p)[0] \
            .reshape(q, nb * p)
    kk = min(p, kc.shape[-1])
    top = select_desc(kc, kk)
    packed = ~top
    invalid = top == jnp.uint32(0)
    sel = jnp.clip((packed & jnp.uint32((1 << PACKED_ID_BITS) - 1))
                   .astype(jnp.int32), 0, c - 1)
    sid = jnp.take_along_axis(cand_id, sel, axis=-1)
    sd = (packed >> shift).astype(jnp.int32)
    return (jnp.where(invalid, INF_DIST, sd),
            jnp.where(invalid, INVALID_ID, sid))


def merge_strips_dedup_pos(pool_dist: jax.Array, pool_id: jax.Array,
                           strip_dist: jax.Array, strip_id: jax.Array):
    """Dedup merge of explicit (dist, id) strips — unbounded ids.

    Dedup: sort the concatenated strip by id (native key-value
    ``lax.sort`` — the handwritten network it replaced miscompiled at
    some widths; see the wide-selection module comment);
    duplicates land adjacent and carry identical dists (distance is a
    function of the id), so all-but-first are invalidated by one shifted
    compare. Final selection: pack ``(dist8, slot)`` — slot in the
    id-sorted strip, so equal-dist ties resolve to the smaller id — one
    narrow ``top_k``, one [Q, P] gather."""
    p = pool_dist.shape[-1]
    d = jnp.concatenate([pool_dist, strip_dist], axis=-1)
    i = jnp.concatenate([pool_id, strip_id], axis=-1)
    w = d.shape[-1]
    # id -1 -> 0xFFFFFFFF sorts last
    ui = i.astype(jnp.uint32)
    ui, ud = jax.lax.sort((ui, d.astype(jnp.uint32)), num_keys=2)
    dup = jnp.concatenate(
        [jnp.zeros_like(ui[..., :1], jnp.bool_),
         (ui[..., 1:] == ui[..., :-1]) & (ui[..., 1:] != _UMAX)], axis=-1)
    valid = (ui != _UMAX) & ~dup
    slot_bits = max(1, (w - 1).bit_length())
    slot = jax.lax.broadcasted_iota(jnp.uint32, (1, w), 1)
    keys = jnp.where(valid,
                     ~((ud << jnp.uint32(slot_bits)) | slot), jnp.uint32(0))
    kk = min(p, w)
    top = select_desc(keys, kk)
    packed = ~top
    invalid = top == jnp.uint32(0)
    sel = jnp.clip((packed & jnp.uint32((1 << slot_bits) - 1))
                   .astype(jnp.int32), 0, w - 1)
    out_i = jnp.take_along_axis(ui, sel, axis=-1).astype(jnp.int32)
    out_d = (packed >> jnp.uint32(slot_bits)).astype(jnp.int32)
    out_d = jnp.where(invalid, INF_DIST, out_d)
    out_i = jnp.where(invalid, INVALID_ID, out_i)
    if kk < p:
        out_d = jnp.pad(out_d, ((0, 0), (0, p - kk)),
                        constant_values=int(INF_DIST))
        out_i = jnp.pad(out_i, ((0, 0), (0, p - kk)), constant_values=-1)
    return out_d, out_i


def kth_stats(pool_dist: jax.Array, pool_id: jax.Array, k: int):
    """(pool has >= k valid entries, distance of the kth entry) per query."""
    full = pool_id[..., k - 1] >= 0
    return full, pool_dist[..., k - 1]
