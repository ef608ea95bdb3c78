"""Single-device batched MIH search — exact and approximate K-NN.

Re-architecture of ``SearchWorker`` (``src/search_worker.cc:93-264``) for a
batched accelerator:

* The recursive per-bucket enumeration + RDMA fetch becomes, per radius:
  ``probes = query_sub ^ flip_masks[r]`` → vectorized directory lookup →
  fixed-capacity candidate-slot expansion → one batched gather of
  (id, code) entries → XOR+popcount distances → dedup top-k merge.
* The master-rank ``std::map`` dedup + bounded priority queue
  (``:179-198``) becomes the sort-based pool merge in ``ops/topk.py``.
* The per-radius lockstep with a broadcast stop bit (``:170-207``) becomes a
  host-side radius loop over a jitted step with per-query ``done`` masks
  (queries in a batch finish at different radii; done queries probe nothing).

Exactness contract: the reference's stop rule — after processing radius r,
stop when k found and kth-dist <= (r+1)*m (``:204``, hardcoded m=4 there) —
plus explicit candidate-buffer overflow detection with automatic cap-doubling
re-runs (the reference hides the same capacity issue in a 40 MB buffer,
``src/pilaf_proxy.h:10``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from verticut_tpu import codes as codes_lib
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import directory as dir_lib
from verticut_tpu.index.mih import MIHIndex, MIHTable
from verticut_tpu.ops import chunks as chunks_lib
from verticut_tpu.ops import enumeration, topk
from verticut_tpu.search import linear as linear_lib

# Default fetch-block size for range-engine cost models when the caller
# doesn't pass the index's real block (inline tight rows: 25 entries x
# 20 B = 500 B/row; compact idrows: 32 ids x 4 B = 128 B/row — both at
# most 512 B per gathered row). 32 upper-bounds both layouts.
RANGE_BLK = 32

# Largest corpus whose overflow retries ride the scan ladder instead of a
# separate 2x-cap re-enumeration ladder (run_pipeline overflow_to_scan):
# a small-tier blockmin scan at <=32M reads <=0.5 GB of codes; at 100M the
# scan's 1.6 GB pass would dominate a capped re-enumeration.
OVERFLOW_SCAN_MAX_N = 32_000_000

# Smallest batch that turns on the scan-dominance stage skip: it diverts
# scan-dominated queries from deep enumeration to the scan stage, which
# changes the read-amplification STATS (radius/n_probes — results stay
# exact), and its win is a big-batch throughput effect; small batches keep
# bit-identical stats parity with the adaptive loop driver
# (tests/test_fused.py pins that).
SCAN_DOMINANCE_MIN_NQ = 1024


class SearchState(NamedTuple):
    pool_dist: jax.Array   # int32[Q, P]
    pool_id: jax.Array     # int32[Q, P]
    done: jax.Array        # bool[Q]
    radius: jax.Array      # int32[Q] — radius at which each query finished
    overflow: jax.Array    # bool[Q] — candidate cap exceeded at some radius
    n_probes: jax.Array    # int32[Q] — enumerated buckets (n_local_reads)
    n_nonempty: jax.Array  # int32[Q] — non-empty buckets   (n_sub_reads)
    n_cands: jax.Array     # int32[Q] — candidates scored


class SearchResult(NamedTuple):
    dists: jax.Array   # int32[Q, k] ascending
    ids: jax.Array     # int32[Q, k] (-1 = fewer than k results exist)
    radius: np.ndarray
    n_probes: np.ndarray
    n_nonempty: np.ndarray
    n_cands: np.ndarray


def init_state(n_queries: int, pool_size: int) -> SearchState:
    pd, pi = topk.empty_pool(n_queries, pool_size)
    z = jnp.zeros((n_queries,), jnp.int32)
    f = jnp.zeros((n_queries,), jnp.bool_)
    return SearchState(pool_dist=pd, pool_id=pi, done=f, radius=z,
                       overflow=f, n_probes=z, n_nonempty=z, n_cands=z)


# --------------------------------------------------------------------------
# Candidate-slot expansion: variable bucket sizes → fixed-capacity buffer
# --------------------------------------------------------------------------

def expand_buckets(starts: jax.Array, counts: jax.Array, cap: int):
    """Flatten per-probe (start, count) ranges into ``cap`` candidate slots.

    ``starts/counts: int32[Q, C]`` → ``(entry int32[Q, cap],
    valid bool[Q, cap], total int32[Q])``. Slot p of query q belongs to the
    probe j whose cumulative-count interval contains p; overflow beyond
    ``cap`` is truncated (caller re-runs with a doubled cap).

    Two lowerings:
    * compare-reduce (default when Q*C*cap is moderate): a masked sum over
      the probe axis — elementwise only, zero gathers. Probe segments are
      disjoint in the slot space, so exactly one term survives per slot.
    * batched bisection over the cumulative counts for very large C·cap —
      ceil(log2 C) rounds of take_along_axis. (A vmapped
      ``jnp.searchsorted`` can lower to a per-row loop, and a gather costs
      far more than an elementwise op, hence the compare-reduce default.)
    """
    q, c = counts.shape
    cum = jnp.cumsum(counts, axis=-1)               # inclusive [Q, C]
    total = cum[:, -1]
    p = jnp.arange(cap, dtype=jnp.int32)[None, :]   # [1, cap]

    if q * c * cap <= (1 << 31):
        excl = cum - counts                          # [Q, C]
        payload = starts - excl                      # entry = p + payload[j]
        in_seg = ((p[:, None, :] >= excl[:, :, None])
                  & (p[:, None, :] < cum[:, :, None]))      # [Q, C, cap]
        entry = p + jnp.sum(
            jnp.where(in_seg, payload[:, :, None], 0), axis=1)
        valid = p < jnp.minimum(total, cap)[:, None]
        return entry, valid, total

    # binary search: smallest j with cum[j] > p  (side="right")
    lo = jnp.zeros((q, cap), jnp.int32)
    hi = jnp.full((q, cap), c, jnp.int32)
    # lo converges within [0, c]: c+1 outcomes need ceil(log2(c+1)) rounds
    for _ in range(max(1, c.bit_length())):
        mid = (lo + hi) >> 1
        cm = jnp.take_along_axis(cum, mid, axis=-1)
        go_right = cm <= p
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    j = jnp.minimum(lo, c - 1)
    excl = jnp.take_along_axis(cum, j, axis=-1) - \
        jnp.take_along_axis(counts, j, axis=-1)
    entry = jnp.take_along_axis(starts, j, axis=-1) + (p - excl)
    valid = p < jnp.minimum(total, cap)[:, None]
    return entry, valid, total


# --------------------------------------------------------------------------
# One radius step (jitted per (radius, shapes); tables unrolled)
# --------------------------------------------------------------------------

def _table_candidates_range(table: MIHTable, all_codes: Optional[jax.Array],
                            queries: jax.Array,
                            q_sub: jax.Array, pmasks: jax.Array,
                            done: jax.Array, cap: int, s_bits: int):
    """Candidates for one range-directory table at one radius.

    ``pmasks`` are flip masks over the directory's ``pbits`` prefix bits
    (NOT the full substring): one probe per flipped *prefix* fetches the
    whole contiguous sorted-row range sharing that prefix, covering every
    low-bit flip mask at once plus extra neighbors that are scored with
    their true distance (a superset — exactness preserved; see
    index/directory.RangeDirectory). Returns
    (cand_dist [Q, S], cand_id [Q, S], n_scored, overflow, n_probe,
    n_nonempty) where S = cap rounded to the fetch-block budget.
    """
    from verticut_tpu.index.mih import ID_ROW_BLOCK, entry_block_size
    d = table.directory
    compact = table.entry_rows is None
    blk = ID_ROW_BLOCK if compact else entry_block_size(queries.shape[-1])
    chb = max(4, cap // blk)
    shift = s_bits - d.pbits
    pref = (q_sub >> jnp.uint32(shift))[:, None] ^ pmasks[None, :]  # [Q, H]
    starts, counts = d.range_lookup(pref)
    active = ~done
    counts = jnp.where(active[:, None], counts, 0)
    n_probe = jnp.where(active, pref.shape[1], 0).astype(jnp.int32)
    n_nonempty = jnp.sum((counts > 0).astype(jnp.int32), axis=-1)

    if compact:
        # ids-only blocks + per-candidate code gather from the shared
        # id-ordered array (DESIGN.md §3 compact mode: 4 B/entry/table).
        # The gathered-codes intermediate is processed in chunk-axis
        # slices so deep-radius/retry shapes never materialize multi-GB
        # [Q, CHB, blk, W] buffers.
        n_blocks = table.entry_idrows.shape[0]
        blk_id, lo, hi, _nch, overflow = chunks_lib.chunk_descriptors(
            starts, counts, blk=blk, chb=chb, n_blocks=n_blocks)
        nq = blk_id.shape[0]
        n = all_codes.shape[0]
        w = queries.shape[-1]
        pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, blk), 2)
        sl = max(8, (1 << 23) // max(nq * blk * w, 1))
        d_parts, i_parts = [], []
        for c0 in range(0, chb, sl):
            c1 = min(c0 + sl, chb)
            cid = table.entry_idrows[blk_id[:, c0:c1]].astype(jnp.int32)
            ccodes = all_codes[jnp.clip(cid, 0, n - 1)]
            dd = jnp.sum(jax.lax.population_count(
                ccodes ^ queries[:, None, None, :]).astype(jnp.int32),
                axis=-1)
            ok = ((pos >= lo[:, c0:c1, None]) & (pos < hi[:, c0:c1, None])
                  & (cid >= 0))
            d_parts.append(jnp.where(ok, dd, topk.INF_DIST)
                           .reshape(nq, (c1 - c0) * blk))
            i_parts.append(jnp.where(ok, cid, topk.INVALID_ID)
                           .reshape(nq, (c1 - c0) * blk))
        dist = jnp.concatenate(d_parts, axis=-1)
        cand_id = jnp.concatenate(i_parts, axis=-1)
    else:
        n_blocks = table.entry_rows.shape[0]
        blk_id, lo, hi, _nch, overflow = chunks_lib.chunk_descriptors(
            starts, counts, blk=blk, chb=chb, n_blocks=n_blocks)
        dist, cand_id = chunks_lib.fetch_score_blocks(
            table.entry_rows, blk_id, lo, hi, queries, blk=blk)
    n_scored = jnp.sum(hi - lo, axis=-1)
    return dist, cand_id, n_scored, overflow, n_probe, n_nonempty


def _table_candidates(table: MIHTable, all_codes: Optional[jax.Array],
                      queries: jax.Array, q_sub: jax.Array,
                      masks: jax.Array, done: jax.Array, cap: int,
                      use_bitmap: bool):
    """Candidates for one table at one radius.

    Returns (cand_dist [Q, cap], cand_id [Q, cap], total, n_probe, n_nonempty).
    """
    probes = q_sub[:, None] ^ masks[None, :]            # [Q, C]
    active = ~done
    if use_bitmap and table.bitmap is not None:
        occupied = table.bitmap.get(probes)             # [Q, C]
        starts, counts = table.directory.lookup(probes)
        counts = jnp.where(occupied, counts, 0)
    else:
        starts, counts = table.directory.lookup(probes)
    counts = jnp.where(active[:, None], counts, 0)
    n_probe = jnp.where(active, probes.shape[1], 0).astype(jnp.int32)
    n_nonempty = jnp.sum((counts > 0).astype(jnp.int32), axis=-1)

    entry, valid, total = expand_buckets(starts, counts, cap)
    n = table.entry_ids.shape[0]
    entry_c = jnp.clip(entry, 0, n - 1)
    cand_id = table.entry_ids[entry_c]                  # [Q, cap]
    if table.entry_codes is not None:
        cand_codes = table.entry_codes[entry_c]         # [Q, cap, W]
    else:
        cand_codes = all_codes[jnp.clip(cand_id, 0, all_codes.shape[0] - 1)]
    dist = codes_lib.hamming_distance(cand_codes, queries[:, None, :])
    cand_id = jnp.where(valid, cand_id, topk.INVALID_ID)
    dist = jnp.where(valid, dist, topk.INF_DIST)
    return dist, cand_id, total, n_probe, n_nonempty


@functools.partial(
    jax.jit,
    static_argnames=("radius", "n_tables", "knn", "pool_size", "cap",
                     "approximate", "use_bitmap", "s_bits"))
def radius_step(tables: Tuple[MIHTable, ...], all_codes: Optional[jax.Array],
                queries: jax.Array, q_subs: jax.Array, masks: jax.Array,
                state: SearchState, *, radius: int, n_tables: int, knn: int,
                pool_size: int, cap: int, approximate: bool, use_bitmap: bool,
                s_bits: int) -> SearchState:
    """Process one Hamming-ball radius for the whole query batch."""
    del pool_size  # implied by state shapes
    cands_d, cands_i = [], []
    total_c = jnp.zeros_like(state.n_cands)
    n_probes = state.n_probes
    n_nonempty = state.n_nonempty
    overflow = state.overflow
    is_range = isinstance(tables[0].directory, dir_lib.RangeDirectory)
    for t in range(n_tables):
        if is_range:
            d, i, tot, ovf, npb, nne = _table_candidates_range(
                tables[t], all_codes, queries, q_subs[:, t], masks,
                state.done, cap, s_bits)
            overflow = overflow | ovf
        else:
            d, i, tot, npb, nne = _table_candidates(
                tables[t], all_codes, queries, q_subs[:, t], masks,
                state.done, cap, use_bitmap)
            overflow = overflow | (tot > cap)
        cands_d.append(d)
        cands_i.append(i)
        total_c = total_c + jnp.minimum(tot, cap)
        n_probes = n_probes + npb
        n_nonempty = n_nonempty + nne

    # Per-table pre-merge to pool_size-wide strips (ids are unique within
    # a table at one radius step — disjoint probe ranges), then one narrow
    # dedup merge; see ops/topk.py strip-merge rationale. The candidate
    # axis is chunk-major (blk-slot fetch blocks), so the strip selection
    # reduces per-chunk first (topk.table_topk_chunkmin_*) rather than
    # running one wide selection per table.
    from verticut_tpu.index.mih import ID_ROW_BLOCK, entry_block_size
    blk = (ID_ROW_BLOCK if tables[0].entry_rows is None
           and tables[0].entry_idrows is not None
           else entry_block_size(queries.shape[-1]))
    max_id = max(t.n_entries(queries.shape[-1]) for t in tables)
    bits = queries.shape[-1] * 32
    p = state.pool_dist.shape[-1]
    if topk.can_pack(max_id - 1, bits):
        strips = jnp.concatenate(
            [topk.table_topk_chunkmin_packed(d, i, p, blk)
             for d, i in zip(cands_d, cands_i)], axis=-1)
        pd, pi = topk.merge_strips_packed(
            state.pool_dist, state.pool_id, strips, n_copies=n_tables + 1)
    else:
        sd, si = zip(*[topk.table_topk_chunkmin_pos(d, i, p, blk)
                       for d, i in zip(cands_d, cands_i)])
        pd, pi = topk.merge_strips_dedup_pos(
            state.pool_dist, state.pool_id,
            jnp.concatenate(sd, axis=-1), jnp.concatenate(si, axis=-1))

    if approximate:
        # Stop when the k*factor pool fills (search_worker.cc:136-137).
        newly_done = pi[:, -1] >= 0
    else:
        # Exact MIH completeness rule (search_worker.cc:201-205).
        full, kth = topk.kth_stats(pd, pi, knn)
        newly_done = full & (kth <= (radius + 1) * n_tables)
    newly_done = newly_done | (radius >= s_bits)
    done = state.done | newly_done
    rad = jnp.where(state.done, state.radius, radius)
    return SearchState(pool_dist=pd, pool_id=pi, done=done, radius=rad,
                       overflow=overflow, n_probes=n_probes,
                       n_nonempty=n_nonempty, n_cands=state.n_cands + total_c)


# --------------------------------------------------------------------------
# Host driver: adaptive radius loop + overflow / max-radius fallbacks
# --------------------------------------------------------------------------

def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _check_bitmap_engine(index: MIHIndex, scfg: SearchConfig) -> None:
    """``use_bitmap`` is a legacy-bucket-engine feature: the range engine
    reads whole prefix ranges, so bucket occupancy is answered by the
    (start, end) pair it fetches anyway (DESIGN.md §5). A silently ignored
    config knob is a lie — reject it loudly."""
    if scfg.use_bitmap and isinstance(index.tables[0].directory,
                                      dir_lib.RangeDirectory):
        raise ValueError(
            "use_bitmap=True has no effect on the range-directory engine "
            "(range fetches subsume the occupancy test; DESIGN.md §5) — "
            "build with directory='dense'/'hash' + with_bitmap=True to use "
            "the bitmap filter, or drop use_bitmap")


def effective_scfg(scfg: SearchConfig) -> SearchConfig:
    """Approx-mode crossover: above ``approx_exact_crossover`` pool slots
    the k*factor merges cost more than exact search, so approximate
    requests run the exact engine (a strictly better answer, never
    slower — SearchConfig.approx_exact_crossover). Shared by every
    driver so single-device, sharded, and serving agree."""
    if scfg.approximate and scfg.pool_size > scfg.approx_exact_crossover:
        import dataclasses
        return dataclasses.replace(scfg, approximate=False)
    return scfg


def _check_query_shape(index: MIHIndex, queries) -> None:
    """Queries must be uint32[Q, n_words] for this index's code width —
    a mismatched word count would silently probe garbage substrings
    (the reference validates the code size at load,
    ``src/build_hash_tables.cc:42``)."""
    if queries.ndim != 2 or queries.shape[-1] != index.cfg.n_words:
        raise ValueError(
            f"queries shape {tuple(queries.shape)} does not match index "
            f"code width ({index.cfg.n_words} uint32 words = "
            f"{index.cfg.bits} bits); expected [Q, {index.cfg.n_words}]")


def _index_mask_bits(index: MIHIndex) -> int:
    """Bits the flip-mask enumeration runs over: the range directory's
    prefix width (probes are per-prefix), else the full substring width."""
    d = index.tables[0].directory
    if isinstance(d, dir_lib.RangeDirectory):
        return d.pbits
    return index.cfg.s_bits


def _index_fetch_blk(index: MIHIndex) -> int:
    """Fetch-block granularity of the index's range tables (slots are
    consumed in whole blocks, so budgets must count in the right unit)."""
    from verticut_tpu.index.mih import ID_ROW_BLOCK, entry_block_size
    t0 = index.tables[0]
    if t0.entry_rows is None and t0.entry_idrows is not None:
        return ID_ROW_BLOCK
    return entry_block_size(index.cfg.n_words)


def _cap_for_radius(scfg: SearchConfig, cfg: MIHConfig, n: int, radii,
                    pool_size: int, mask_bits: Optional[int] = None,
                    is_range: bool = False, blk: int = RANGE_BLK) -> int:
    """Per-radius candidate capacity: sized from the uniform-occupancy
    expectation plus headroom; overflow detection + re-run covers skewed
    (clustered) data. Shrinking the cap is the single biggest lever on the
    gather/merge cost, so it must track the radius, not the worst case."""
    if isinstance(radii, int):
        radii = (radii,)
    mask_bits = mask_bits or cfg.s_bits
    n_m = sum(enumeration.n_masks(mask_bits, r) for r in radii)
    # uniform-occupancy expectation: C probes x n/2^mask_bits per value
    expected = n_m * (n / float(1 << mask_bits))
    if is_range:
        # slots consumed = fetch blocks: >=1 block per nonempty probe, the
        # range rows themselves, plus headroom for one clustered hot range
        slots = n_m * blk + 2 * int(expected) + 12 * blk
        cap = -(-slots // (4 * blk)) * (4 * blk)
    else:
        cap = _pow2ceil(int(4 * expected) + 4 * pool_size + 128)
    return int(min(scfg.candidate_cap, max(256, cap)))

@functools.partial(jax.jit, static_argnames=("new_batch",))
def _compact(queries, q_subs, state: SearchState, sel, n_act,
             new_batch: int):
    """One fused gather of all per-query arrays down to the active rows."""
    sel = sel[:new_batch]
    q = queries[sel]
    qs = q_subs[sel]
    st = SearchState(*(leaf[sel] for leaf in state))
    pad_mask = jnp.arange(new_batch) >= n_act
    return q, qs, st._replace(done=st.done | pad_mask)


def _scatter_rows(full: SearchState, orig: jax.Array,
                  cur: SearchState) -> SearchState:
    return SearchState(*(f.at[orig].set(c) for f, c in zip(full, cur)))


@functools.partial(
    jax.jit,
    static_argnames=("schedule", "caps", "batch_caps", "n_tables", "knn",
                     "pool_size", "approximate", "use_bitmap", "s_bits",
                     "retry_caps", "retry_budget", "scan_budget",
                     "scan_dominance", "overflow_to_scan"))
def fused_pipeline(tables, all_codes, queries, q_subs,
                   masks_tuple, state0: SearchState, *, schedule, caps,
                   batch_caps, n_tables, knn, pool_size, approximate,
                   use_bitmap, s_bits, retry_caps=None, retry_budget=0,
                   scan_budget=0, scan_dominance=0, overflow_to_scan=False):
    """The whole radius schedule as ONE device program.

    The loop driver costs one host round-trip per radius (the done-check)
    plus two per compaction. Here the compaction happens on
    device (stable sort by done-flag; active rows first) and stage batch
    sizes are fixed up front (``batch_caps``); actives beyond a stage
    budget simply stop enumerating and are resolved by the scan stage /
    host fallback — still exact. One dispatch, one sync.

    ``retry_caps``: optional per-stage caps for a device-side overflow
    retry pass — queries whose candidate buffers clipped (``overflow`` set,
    the exactness contract's re-run trigger) are compacted into a
    ``retry_budget`` sub-batch and re-searched from radius 0 at the larger
    caps, entirely on device. Without it the host driver pays a separate
    dispatch + sync round trip per retry. Stages lax.cond-skip when
    nothing overflowed.

    ``scan_budget``: optional device-side brute-force stage — queries still
    unfinished after the schedule (deep-radius stragglers) are compacted
    and resolved with the exact block-min scan inside the same program,
    replacing both the deep enumeration radii (C(p, r) probe cost) and the
    host linear-fallback round trip.
    """
    def step_fn(i, r, cap, cq, cqs, cs):
        return radius_step(
            tables, all_codes, cq, cqs, masks_tuple[i], cs,
            radius=r, n_tables=n_tables, knn=knn, pool_size=pool_size,
            cap=cap, approximate=approximate, use_bitmap=use_bitmap,
            s_bits=s_bits)

    scan_fn = None
    if all_codes is not None:
        from verticut_tpu.ops import hamming
        # Smaller blocks at large k: the rescore gathers k blocks per
        # query, so the gather bill is k*block rows — at k=100,
        # block=512 is 51k rows/query while 128 is 12.8k.
        blk = 512 if knn <= 32 else 128

        def scan_fn(sq):
            # block-min pre-selection scan: per-block minima from the ±1
            # GEMM, selection over blocks only
            return hamming.scan_blockmin(sq, all_codes, knn, block=blk)

    return run_pipeline(step_fn, scan_fn, queries, q_subs, state0,
                        schedule=schedule, caps=caps, batch_caps=batch_caps,
                        knn=knn, pool_size=pool_size, retry_caps=retry_caps,
                        retry_budget=retry_budget, scan_budget=scan_budget,
                        scan_dominance=scan_dominance,
                        overflow_to_scan=overflow_to_scan)


def _stage_shift(knn: int, n: int = 0) -> int:
    """First-stage batch-budget shift: deep-stage budgets are ``nq >> (shift
    + 2*(stage-1))``. The straggler fraction grows with k (at k=100 on
    clustered data a large share of queries need radius 2), so wide-k
    searches get a gentler shrink; actives beyond a stage budget are exact
    but resolve via the scan tiers, and overflowing the small tiers costs
    a full-batch scan.

    Stage-2 cost scales with the budget (probe gathers, candidate fetch,
    selection widths are all [budget, ...]), so k=10 shrinks harder; the
    tightest shift spills the last few actives to the scan tier, which is
    cheap only where a tier-sized scan is (small corpora) — at 100M a
    spilled row drags a full-corpus scan into the batch — so the
    aggressive shift is gated on ``n``; callers that cannot know the
    corpus size get the spill-free budget. Every value is exact; the
    shifts await re-tuning on the GPU (ROADMAP Queue 1)."""
    if knn > 32:
        return 2
    return 5 if 0 < n <= 4_000_000 else 4


def run_pipeline(step_fn, scan_fn, queries, q_subs, state0: SearchState, *,
                 schedule, caps, batch_caps, knn, pool_size,
                 retry_caps=None, retry_budget=0, scan_budget=0,
                 scan_dominance=0, overflow_to_scan=False):
    """Generic staged pipeline: schedule stages with device compaction, a
    device-side overflow retry pass, and a device-side brute-force scan
    stage. ``step_fn(i, radius, cap, queries, q_subs, state) -> state`` is
    one radius step (single-device or shard_map-local with collectives);
    ``scan_fn(queries) -> (dists [B, knn], ids [B, knn])`` is the exact
    scan. Shared by the single-device and sharded fused drivers.

    ``scan_dominance``: if > 0 (requires a scan stage reaching the full
    batch), skip every post-first enumeration stage when the active count
    after the first stage is >= this threshold — a scan-dominated workload
    (uniform queries against clustered data never satisfy the MIH stop
    rule at small radii) resolves the whole batch in the scan stage anyway,
    so deeper enumeration is pure waste.
    ``overflow_to_scan``: route overflowed-but-finished queries to the
    scan stage instead of a separate enumeration-retry ladder (one ladder,
    not two); exactness is preserved because the scan is
    exact and supersedes any clipped pool. The caller enables this only
    where a small-tier scan is cheaper than a capped re-enumeration (small
    corpora; at 100M a 2x-cap retry beats scanning 1.6 GB).
    """
    nq = queries.shape[0]

    def staged(queries_b, q_subs_b, state_b, stage_caps, stage_batch_caps,
               dominance=0):
        """Run the schedule with device compaction over one query batch.
        Returns (full-batch state, compaction-budget-overflow flag)."""
        nb0 = queries_b.shape[0]
        full = state_b
        orig = jnp.arange(nb0, dtype=jnp.int32)
        cur_q, cur_qs, cur_state = queries_b, q_subs_b, state_b
        dom = jnp.zeros((), jnp.bool_)

        for i, (r, _group) in enumerate(schedule):
            # runtime stage skip: late radii have huge mask sets but
            # usually no active queries left; lax.cond executes only the
            # taken branch. (Under shard_map the predicate is uniform
            # within each (table, shard) collective group — every member
            # holds the same query slice — so branches cannot diverge
            # across a collective.)
            def _run(args, i=i, r=r):
                cq, cqs, cs, fl, og = args
                cs = step_fn(i, r, stage_caps[i], cq, cqs, cs)
                return cs, _scatter_rows(fl, og, cs)

            def _skip(args):
                _cq, _cqs, cs, fl, _og = args
                return cs, fl

            skip = jnp.all(cur_state.done)
            if i > 0 and dominance:
                skip = skip | dom
            cur_state, full = jax.lax.cond(
                skip, _skip, _run,
                (cur_q, cur_qs, cur_state, full, orig))
            if i == 0 and dominance:
                # decided once, on the full batch, before any compaction
                dom = (jnp.sum((~cur_state.done).astype(jnp.int32))
                       >= dominance)
            if i + 1 < len(schedule):
                nb = stage_batch_caps[i + 1]
                if nb < cur_q.shape[0]:
                    # Truncating the active set to the stage budget is
                    # exactness-neutral: dropped actives keep their state
                    # in `full` with done=False and are resolved by the
                    # scan stage / host linear fallback. (Workloads where
                    # enumeration mostly fails — uniform-random queries —
                    # overflow every stage budget by design and must flow
                    # to the scan, not to a failure flag.)
                    done_key = cur_state.done.astype(jnp.int32)
                    _, perm = jax.lax.sort(
                        (done_key,
                         jnp.arange(cur_q.shape[0], dtype=jnp.int32)),
                        num_keys=2)
                    sel = perm[:nb]
                    cur_q = cur_q[sel]
                    cur_qs = cur_qs[sel]
                    cur_state = SearchState(*(leaf[sel]
                                              for leaf in cur_state))
                    orig = orig[sel]
        return full

    full = staged(queries, q_subs, state0, caps, batch_caps,
                  dominance=scan_dominance if scan_budget else 0)
    # every budget clip degrades to a slower-but-exact path (scan stage,
    # host retry/scan), so the pipeline itself cannot fail; the flag is
    # kept in the packed result format as a reserved column
    compact_ovf = jnp.zeros((), jnp.bool_)

    if retry_caps and not overflow_to_scan:
        # Compact the overflowed-but-finished rows (unfinished ones hit the
        # exact linear fallback regardless) and re-run the schedule on them
        # — with its own shrinking stage batches: a handful of retried
        # queries needing radius 2+ must not drag the whole retry budget
        # through the deep stages. TIERED like the scan stage: a small
        # tier catches the typical overflow count, the big tier runs only
        # if the small one was outgrown. The flag count and compaction
        # sort are hoisted so the gates are MUTUALLY EXCLUSIVE on the
        # pre-ladder flags (a tier that ran either cleared a row's flag or
        # left one that 2x caps cannot fix — re-running it at the same
        # caps is pointless), and each tier's whole body — query gather,
        # staged re-run, state blend — sits under one lax.cond: a skipped
        # tier costs nothing.
        flag = full.overflow & full.done
        n_f = jnp.sum(flag.astype(jnp.int32))
        idx = jnp.arange(nq, dtype=jnp.int32)
        _, perm = jax.lax.sort(((~flag).astype(jnp.int32), idx),
                               num_keys=2)
        small = min(retry_budget, max(64, nq // 16))
        budgets = [small] + ([retry_budget] if retry_budget > small else [])
        for bi, budget in enumerate(budgets):
            # Flagged rows beyond the last budget keep overflow=True and
            # are re-run by the host retry path — a round trip, but rare².
            sel = perm[:budget]
            retry_bc = tuple(
                budget if i == 0
                else max(64, budget >> (_stage_shift(knn) + 2 * (i - 1)))
                for i in range(len(schedule)))
            run = n_f > (0 if bi == 0 else budgets[bi - 1])
            if bi + 1 < len(budgets):
                run = run & (n_f <= budget)

            def _do(f, sel=sel, budget=budget, retry_bc=retry_bc):
                flag_sel = flag[sel]
                rstate = init_state(budget, pool_size)._replace(
                    done=~flag_sel)
                rfull = staged(queries[sel], q_subs[sel], rstate,
                               retry_caps, retry_bc)

                def _blend(fl, c):
                    m = flag_sel.reshape((-1,) + (1,) * (c.ndim - 1))
                    return fl.at[sel].set(jnp.where(m, c, fl[sel]))

                # pools/flags come from the re-run; read-amplification
                # stats keep the first run's counts (matching the host
                # retry path)
                return f._replace(
                    pool_dist=_blend(f.pool_dist, rfull.pool_dist),
                    pool_id=_blend(f.pool_id, rfull.pool_id),
                    done=_blend(f.done, rfull.done),
                    radius=_blend(f.radius, rfull.radius),
                    overflow=_blend(f.overflow, rfull.overflow))

            full = jax.lax.cond(run, _do, lambda f: f, full)

    if scan_budget and scan_fn is not None:
        # Tiered scan: a small tier catches the common handful of
        # stragglers; larger tiers lax.cond-skip entirely unless the
        # smaller one was outgrown (scan-dominated workloads — uniform
        # queries, large k — where the whole batch lands here instead of
        # in the host fallback). A full-size scan for a handful of
        # stragglers would cost a whole corpus pass, hence the tiers; the
        # x8 ladder keeps a few hundred stragglers (k=100 clustered) off
        # the full-batch scan.
        # The flag count and compaction sort are hoisted (exactly the
        # first tier whose budget covers the straggler count runs, so the
        # gates are mutually exclusive on the pre-ladder flags) and each
        # tier's whole body — query gather, scan, blend — sits under one
        # lax.cond.
        flag = ~full.done
        if overflow_to_scan:
            # one ladder, not two: overflowed-but-finished rows join the
            # stragglers; the scan blend marks them done and clears the
            # overflow flag (the scan result is exact by construction)
            flag = flag | full.overflow
        n_sc = jnp.sum(flag.astype(jnp.int32))
        idx = jnp.arange(nq, dtype=jnp.int32)
        _, perm = jax.lax.sort(((~flag).astype(jnp.int32), idx),
                               num_keys=2)
        budgets = [min(scan_budget, nq)]
        while budgets[-1] < nq:
            budgets.append(min(nq, budgets[-1] * 8))
        for bi, budget in enumerate(budgets):
            run = n_sc > (0 if bi == 0 else budgets[bi - 1])
            if budget < nq:
                run = run & (n_sc <= budget)
            sel = perm[:budget]

            def _scan(f, sel=sel):
                flag_sel = flag[sel]
                d, i = scan_fn(queries[sel])
                if pool_size > knn:
                    d = jnp.pad(d, ((0, 0), (0, pool_size - knn)),
                                constant_values=int(topk.INF_DIST))
                    i = jnp.pad(i, ((0, 0), (0, pool_size - knn)),
                                constant_values=-1)

                def _blend(fl, c):
                    m = flag_sel.reshape((-1,) + (1,) * (c.ndim - 1))
                    return fl.at[sel].set(jnp.where(m, c, fl[sel]))

                return f._replace(
                    pool_dist=_blend(f.pool_dist, d),
                    pool_id=_blend(f.pool_id, i),
                    done=_blend(f.done, jnp.ones_like(flag_sel)),
                    overflow=_blend(f.overflow, jnp.zeros_like(flag_sel)))

            full = jax.lax.cond(run, _scan, lambda f: f, full)
    return full, compact_ovf


def _result_id_bits(tables, bits: int) -> int:
    """Bits of id payload when one uint32 word can hold a (dist, id) result
    pair — 0 when it cannot (wide ids fall back to the 2P layout). Sized so
    every true distance 0..bits plus an all-ones sentinel fits above."""
    max_id = max(t.n_entries(bits // 32) for t in tables)
    id_bits = max(1, int(max_id - 1).bit_length())
    dist_bits = 32 - id_bits
    return id_bits if (1 << dist_bits) - 1 > bits else 0


@functools.partial(
    jax.jit,
    static_argnames=("schedule", "caps", "batch_caps", "n_tables", "knn",
                     "pool_size", "approximate", "use_bitmap", "s_bits",
                     "retry_caps", "retry_budget", "scan_budget",
                     "scan_dominance", "overflow_to_scan"))
def fused_pipeline_packed(tables, all_codes, queries, masks_tuple, *,
                          n_tables, pool_size,
                          **kw) -> jax.Array:
    """fused_pipeline as ONE dispatch end-to-end, result flattened into ONE
    array: uint32 ``[Q, k + 3]`` = [(dist << id_bits | id) top-k |
    flags_word | n_nonempty | n_cands] when ids fit under the distance
    field (all-ones word = empty slot), else int32 ``[Q, 2k + 3]`` =
    [top-k dists | top-k ids | the same 3 stat words].

    flags_word = done(bit0) | overflow(bit1) | covf(bit2) | radius(bits
    3..9) | saturating-16-bit n_probes (bits 16..31). Only the first k of
    the P pool slots ship: the finalize path and every fallback consume
    ``pd[:, :k]`` alone, so the approx-mode k*20 pool never leaves the
    device.

    Substring extraction and state init happen inside the jit, and the
    result is a single array: every eager op dispatch, array creation and
    device_get leaf costs a host round trip, so one program and one
    transfer per batch.
    """
    q_subs = codes_lib.all_substrings(queries, n_tables)
    state0 = init_state(queries.shape[0], pool_size)
    full, covf = fused_pipeline(tables, all_codes, queries,
                                q_subs, masks_tuple, state0,
                                n_tables=n_tables,
                                pool_size=pool_size, **kw)
    nq = queries.shape[0]
    k = kw["knn"]
    flags = (full.done.astype(jnp.uint32)
             | (full.overflow.astype(jnp.uint32) << 1)
             | (jnp.broadcast_to(covf.astype(jnp.uint32), (nq,)) << 2)
             | (jnp.minimum(full.radius, 127).astype(jnp.uint32) << 3)
             | (jnp.minimum(full.n_probes, 0xFFFF).astype(jnp.uint32) << 16))
    cols = jnp.stack([flags, full.n_nonempty.astype(jnp.uint32),
                      full.n_cands.astype(jnp.uint32)], axis=1)
    pd_k, pi_k = full.pool_dist[:, :k], full.pool_id[:, :k]
    id_bits = _result_id_bits(tables, queries.shape[-1] * 32)
    if id_bits:
        pool_u = jnp.where(
            pi_k < 0, jnp.uint32(0xFFFFFFFF),
            (pd_k.astype(jnp.uint32) << id_bits) | pi_k.astype(jnp.uint32))
        return jnp.concatenate([pool_u, cols], axis=1)
    return jnp.concatenate([pd_k, pi_k, cols.astype(jnp.int32)], axis=1)


_MASK_CACHE = {}


def _device_masks(mask_bits: int, group) -> jax.Array:
    """Per-(bits, group) device-resident flip-mask arrays — uploaded once,
    not on every call."""
    key = (mask_bits, tuple(group))
    if key not in _MASK_CACHE:
        _MASK_CACHE[key] = jnp.asarray(np.concatenate(
            [enumeration.flip_masks(mask_bits, g) for g in group]))
    return _MASK_CACHE[key]


def _retire(final: dict, orig_ids: np.ndarray, state: SearchState,
            rows: np.ndarray) -> None:
    """Copy finished rows of the (possibly compacted) device state to host."""
    if len(rows) == 0:
        return
    host = jax.device_get(tuple(state))
    (pd, pi, done, radius, overflow, n_probes, n_nonempty, n_cands) = host
    for oi, ri in zip(orig_ids, rows):
        final[int(oi)] = (pd[ri], pi[ri], radius[ri], overflow[ri],
                          not done[ri], n_probes[ri], n_nonempty[ri],
                          n_cands[ri])


def _radius_schedule(scfg: SearchConfig, cfg: MIHConfig, n: int,
                     mask_bits: Optional[int] = None,
                     is_range: bool = False):
    """Shared schedule: coalesced (exact) or per-radius groups, cut at the
    enumeration-vs-scan crossover."""
    mask_bits = mask_bits or cfg.s_bits
    max_r = min(scfg.max_enum_radius, mask_bits)
    if scfg.coalesce_radii and not scfg.approximate and max_r >= 1:
        schedule = [(1, (0, 1))] + [(r, (r,)) for r in range(2, max_r + 1)]
    else:
        schedule = [(r, (r,)) for r in range(max_r + 1)]
    out = []
    for r, group in schedule:
        n_group = sum(enumeration.n_masks(mask_bits, g) for g in group)
        if is_range:
            # cost unit is fetched rows: ~(expected range + one block) per
            # probe, vs scanning all n codes once
            est_rows = n_group * (n / float(1 << mask_bits) + RANGE_BLK)
            too_dear = est_rows * cfg.n_tables > scfg.fallback_ratio * max(n, 1)
        else:
            too_dear = (n_group * cfg.n_tables
                        > scfg.fallback_ratio * max(n, 1))
        if r > 1 and too_dear:
            break
        out.append((r, group))
    return tuple(out)


class FusedHandle(NamedTuple):
    """In-flight fused search: the device result + finalize context."""

    packed: jax.Array      # int32[Q, 2P+7] (see fused_pipeline_packed)
    queries: jax.Array
    index: "MIHIndex"
    scfg: SearchConfig
    cap: Optional[int]


def mih_search_dispatch(index: MIHIndex, queries,
                        scfg: SearchConfig = SearchConfig(),
                        _cap: Optional[int] = None
                        ) -> Optional[FusedHandle]:
    """Launch the fused single-dispatch search WITHOUT waiting for it.

    Returns None when the fused driver cannot run this workload (empty
    schedule / ``scfg.fused`` off). Pair with :func:`mih_search_finalize`;
    keeping 2+ handles in flight overlaps the device work of one batch
    with the host sync of another. This is the batched analog of the
    reference's in-flight request window
    (``src/image_search_server.cc`` serving loop).
    """
    if not scfg.fused:
        return None
    scfg = effective_scfg(scfg)
    _check_bitmap_engine(index, scfg)
    cfg = index.cfg
    queries = jnp.asarray(queries, jnp.uint32)
    _check_query_shape(index, queries)
    nq = queries.shape[0]
    tables = tuple(index.tables)
    k, pool_size = scfg.knn, scfg.pool_size
    mask_bits = _index_mask_bits(index)
    is_range = isinstance(index.tables[0].directory, dir_lib.RangeDirectory)
    schedule = tuple(
        (r, g)
        for r, g in _radius_schedule(scfg, cfg, index.n, mask_bits, is_range)
        if sum(enumeration.n_masks(mask_bits, x) for x in g)
        <= scfg.fused_max_masks)
    if not schedule:
        return None
    # small first tier; run_pipeline adds the cond-skipped full-batch
    # tier for scan-dominated workloads (uniform queries, large k)
    scan_budget = (min(nq, max(64, nq // 64)) if index.codes is not None
                   else 0)
    caps = tuple(_cap or _cap_for_radius(scfg, cfg, index.n, g, pool_size,
                                         mask_bits, is_range,
                                         _index_fetch_blk(index))
                 for _, g in schedule)
    batch_caps = tuple(
        nq if i == 0 else max(64, nq >> (_stage_shift(k, index.n)
                                         + 2 * (i - 1)))
        for i in range(len(schedule)))
    masks_tuple = tuple(_device_masks(mask_bits, group)
                        for _, group in schedule)

    # x2, not x4: covers the typical clustered hot range at half the cost;
    # the rare double-overflow falls to the host retry (which quadruples)
    retry_caps = tuple(min(c * 2, max(scfg.candidate_cap, c)) for c in caps)
    # Optional merged ladder (SearchConfig.overflow_to_scan). EXACT
    # mode only (like the dominance gate below): the scan returns exact
    # results, which preserves exact-mode semantics trivially but would
    # silently upgrade approx-mode answers away from the reference's
    # k*20-pool spec (tests/test_approx_prod.py pins that spec).
    overflow_to_scan = (scfg.overflow_to_scan and scan_budget > 0
                        and not scfg.approximate
                        and index.n <= OVERFLOW_SCAN_MAX_N)
    packed = fused_pipeline_packed(
        tables, index.codes, queries, masks_tuple,
        schedule=schedule, caps=caps, batch_caps=batch_caps,
        n_tables=cfg.n_tables, knn=k, pool_size=pool_size,
        approximate=scfg.approximate, use_bitmap=scfg.use_bitmap,
        s_bits=cfg.s_bits,
        retry_caps=(None if overflow_to_scan
                    else retry_caps if retry_caps != caps else None),
        retry_budget=0 if overflow_to_scan else min(nq, max(64, nq // 4)),
        scan_budget=scan_budget,
        scan_dominance=(nq // 2
                        if scan_budget and not scfg.approximate
                        and nq >= SCAN_DOMINANCE_MIN_NQ else 0),
        overflow_to_scan=overflow_to_scan)
    # Start the device->host copy of the result the moment the program
    # finishes: finalize()'s device_get then finds the bytes already on
    # the host instead of waiting behind the NEXT batch's compute.
    packed.copy_to_host_async()
    return FusedHandle(packed=packed, queries=queries, index=index,
                       scfg=scfg, cap=_cap)


def mih_search_finalize(h: FusedHandle) -> Optional[SearchResult]:
    """Wait for a dispatched fused search and apply host-side fallbacks.

    Returns None if a fused stage budget overflowed (caller must re-run
    via the adaptive loop — ``mih_search`` does this automatically)."""
    scfg, k = h.scfg, h.scfg.knn
    host = jax.device_get(h.packed)  # the single sync, one transfer
    id_bits = _result_id_bits(tuple(h.index.tables), h.index.cfg.bits)
    if id_bits:  # word-packed (dist, id) layout: [Q, k + 3] uint32
        pool = host[:, :k]
        empty = pool == np.uint32(0xFFFFFFFF)
        pd = np.where(empty, topk.INF_DIST,
                      pool >> id_bits).astype(np.int32)
        pi = np.where(empty, topk.INVALID_ID,
                      pool & ((1 << id_bits) - 1)).astype(np.int32)
        stats = host[:, k:]
    else:  # [Q, 2k + 3] int32
        pd = host[:, :k].astype(np.int32)
        pi = host[:, k:2 * k].astype(np.int32)
        stats = host[:, 2 * k:]
    flags = stats[:, 0].astype(np.uint32)
    if ((flags >> 2) & 1).any():  # covf (per query-shard under shard_map)
        return None
    done, overflow = (flags & 1) != 0, ((flags >> 1) & 1) != 0
    radius = ((flags >> 3) & 0x7F).astype(np.int32)
    n_probes = (flags >> 16).astype(np.int32)
    n_nonempty = stats[:, 1].astype(np.int32)
    n_cands = stats[:, 2].astype(np.int32)
    dists = pd.copy()
    ids = pi.copy()
    not_done = ~done
    return _apply_fallbacks(h.index, h.queries, scfg, h.cap, k, dists, ids,
                            radius, overflow, not_done, n_probes,
                            n_nonempty, n_cands)


def _mih_search_fused(index: MIHIndex, queries, tables,
                      scfg: SearchConfig,
                      _cap: Optional[int]) -> Optional[SearchResult]:
    """Single-dispatch fused search; returns None if a stage budget was
    exceeded (caller falls back to the adaptive loop)."""
    del tables  # handled inside dispatch
    h = mih_search_dispatch(index, queries, scfg, _cap)
    if h is None:
        return None
    return mih_search_finalize(h)


def _apply_fallbacks(index, queries, scfg, _cap, k, dists, ids, radius,
                     overflow, not_done, n_probes, n_nonempty, n_cands
                     ) -> SearchResult:
    """Overflow retry + brute-force fallback, shared by both drivers.

    ``queries`` may be a device array; the host copy is materialized only
    when a retry/fallback actually fires (the device->host pull is a
    round trip that the common all-finished path must not pay).
    """
    redo = overflow & ~not_done
    base_cap = _cap or scfg.candidate_cap
    queries0 = None
    if redo.any():
        if base_cap < index.n:
            queries0 = np.asarray(queries)
            idxs = np.nonzero(redo)[0]
            new_cap = min(base_cap * 4, max(index.n, 8))
            # memory guard: retry batches at quadrupled caps allocate
            # nq * cap * m candidate slots — slice the batch so the slot
            # tensor stays bounded (~0.5 GB of int32 pairs)
            max_rows = max(64, (1 << 25) // max(new_cap, 1))
            for lo in range(0, len(idxs), max_rows):
                part = idxs[lo:lo + max_rows]
                sub = mih_search(index, queries0[part], scfg, _cap=new_cap)
                dists[part] = sub.dists
                ids[part] = sub.ids
                radius[part] = sub.radius
        else:
            # Terminal cap (>= n) STILL overflowed: range-engine budgets are
            # consumed in whole fetch blocks (+1 block per straddling
            # probe), so cap >= n does not prove completeness. Never drop a
            # set overflow flag — route these queries to the provably exact
            # linear scan instead (exactness contract, DESIGN.md §2).
            not_done = not_done | redo

    if not_done.any():
        if index.codes is None:
            raise ValueError(
                "queries unfinished at max_enum_radius and index has no "
                "code array for linear fallback; raise max_enum_radius")
        if queries0 is None:
            queries0 = np.asarray(queries)
        idxs = np.nonzero(not_done)[0]
        ld, li = linear_lib.linear_search(queries0[idxs], index.codes, k)
        dists[idxs] = np.asarray(ld)
        ids[idxs] = np.asarray(li)

    return SearchResult(dists=dists, ids=ids, radius=radius,
                        n_probes=n_probes, n_nonempty=n_nonempty,
                        n_cands=n_cands)


def mih_search(index: MIHIndex, queries, scfg: SearchConfig = SearchConfig(),
               _cap: Optional[int] = None, _fused: bool = True
               ) -> SearchResult:
    """Batched K-NN over the MIH index.

    The host loop advances the radius in lockstep for the whole batch
    (the reference's per-radius MPI barrier, one device sync per radius);
    queries that satisfied their stop rule are masked out. Queries that
    overflow the candidate cap are re-run with a doubled cap; queries not
    finished at ``max_enum_radius`` fall back to the exact linear scan
    (enumeration cost passes brute-force cost long before r=32 anyway —
    see ops/enumeration.enumeration_cost).
    """
    cfg = index.cfg
    scfg = effective_scfg(scfg)
    _check_bitmap_engine(index, scfg)
    queries = jnp.asarray(queries, jnp.uint32)
    _check_query_shape(index, queries)
    nq = queries.shape[0]
    k, pool_size = scfg.knn, scfg.pool_size
    tables = tuple(index.tables)

    if scfg.fused and _fused:
        out = _mih_search_fused(index, queries, tables, scfg, _cap)
        if out is not None:
            return out
        # stage budget exceeded: fall through to the adaptive loop

    queries0 = np.asarray(queries)    # original order, for retry/fallback
    q_subs = index.table_subs(queries)
    state = init_state(nq, pool_size)

    # Batch compaction: probe cost is paid per batch row whether or not a
    # query is done (data-independent shapes), and C(s, r) grows fast while
    # the active set shrinks fast — so between radii we gather the still-
    # active rows into a pow2-bucketed smaller batch (the per-radius device
    # sync already exists: it is the reference's lockstep barrier).
    orig_idx = np.arange(nq)          # active row -> original query row
    final = {}                        # original row -> host result rows

    # radius schedule: exact mode coalesces {0, 1} into one step (results
    # identical — see SearchConfig.coalesce_radii); the schedule is already
    # cut at the enumeration-vs-scan crossover
    mask_bits = _index_mask_bits(index)
    is_range = isinstance(index.tables[0].directory, dir_lib.RangeDirectory)
    for r, group in _radius_schedule(scfg, cfg, index.n, mask_bits, is_range):
        cap = _cap or _cap_for_radius(scfg, cfg, index.n, group, pool_size,
                                      mask_bits, is_range,
                                      _index_fetch_blk(index))
        masks = _device_masks(mask_bits, group)
        step_kw = dict(
            radius=r, n_tables=cfg.n_tables, knn=k, pool_size=pool_size,
            cap=cap, approximate=scfg.approximate,
            use_bitmap=scfg.use_bitmap, s_bits=cfg.s_bits)
        nq_cur = queries.shape[0]
        # memory guard: the probe tensor is [Q, C] x m tables; late radii
        # (C(32,5)=201k) at full batch would allocate several GB — process
        # the batch in slices instead
        if nq_cur * masks.shape[0] > (1 << 26) and nq_cur > 64:
            sl = max(64, _pow2ceil((1 << 26) // max(masks.shape[0], 1)) // 2)
            parts = []
            for lo in range(0, nq_cur, sl):
                hi = min(lo + sl, nq_cur)
                sub = SearchState(*(leaf[lo:hi] for leaf in state))
                parts.append(radius_step(
                    tables, index.codes, queries[lo:hi], q_subs[lo:hi],
                    masks, sub, **step_kw))
            state = SearchState(*(jnp.concatenate(leaves)
                                  for leaves in zip(*parts)))
        else:
            state = radius_step(tables, index.codes, queries, q_subs, masks,
                                state, **step_kw)
        done_h = np.asarray(state.done)
        if done_h.all():
            break
        n_active = int((~done_h).sum())
        batch = queries.shape[0]
        new_batch = max(_pow2ceil(n_active), 64)
        if new_batch <= batch // 2:
            # retire finished rows to host, keep only active ones
            done_rows = np.nonzero(done_h)[0]
            _retire(final, orig_idx[done_rows], state, done_rows)
            act = np.nonzero(~done_h)[0]
            n_pad = new_batch - len(act)
            sel = np.concatenate([act, np.zeros(n_pad, np.int64)])
            queries, q_subs, state = _compact(
                queries, q_subs, state, jnp.asarray(sel, jnp.int32),
                jnp.int32(len(act)), new_batch=new_batch)
            orig_idx = np.concatenate(
                [orig_idx[act], np.full(n_pad, -1)])

    # retire everything still in the compacted batch
    live = orig_idx >= 0
    _retire(final, orig_idx[live], state, np.nonzero(live)[0])

    dists = np.empty((nq, pool_size), np.int32)
    ids = np.empty_like(dists)
    radius = np.empty(nq, np.int32)
    overflow = np.empty(nq, bool)
    not_done = np.empty(nq, bool)
    n_probes = np.empty(nq, np.int32)
    n_nonempty = np.empty(nq, np.int32)
    n_cands = np.empty(nq, np.int32)
    for oi, row in final.items():
        (dists[oi], ids[oi], radius[oi], overflow[oi], not_done[oi],
         n_probes[oi], n_nonempty[oi], n_cands[oi]) = row
    dists = dists[:, :k]
    ids = ids[:, :k]

    return _apply_fallbacks(index, queries0, scfg, _cap, k, dists, ids,
                            radius, overflow, not_done, n_probes,
                            n_nonempty, n_cands)
