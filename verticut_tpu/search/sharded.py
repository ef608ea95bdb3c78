"""Multi-chip MIH search over a (table, shard, query) mesh.

The distributed path of the reference — one MPI rank per substring table
probing its own hash table, per-radius ``MPI_Gatherv`` of candidates to the
master, dedup + bounded heap there, stop flag broadcast back
(``src/search_worker.cc:159-218``, ``src/mpi_coordinator.cc:34-69``) —
rebuilt as SPMD ``shard_map`` over the range-directory engine:

* table ``t``'s substring-sorted entry-row blocks live on mesh slice
  ``table=t``, range-partitioned over ``shard`` (contiguous slices, so a
  probed prefix range intersects each shard in one clamp — the bucket that
  straddles a boundary is returned piecewise and merged downstream, the
  Pilaf multi-server key split made contiguous).
* the per-table range directory (``se`` pairs in GLOBAL row coordinates)
  is replicated over ``shard``: each device clamps probed ranges to its
  own row slice.
* Queries are sharded over ``query`` and replicated over table/shard.
* Per radius: every device probes + block-fetches locally →
  ``all_gather`` of fixed-capacity candidates over (table, shard) →
  *replicated* dedup top-k merge. No master rank: every device holds the
  same pool, the stop predicate is computed redundantly, the ``bcast``
  disappears.

Two drivers share the per-device step:

* :func:`sharded_mih_search` — the default. With ``scfg.fused`` the WHOLE
  schedule (+ device-side overflow retry + straggler scan) runs as ONE
  shard_map dispatch via search.single.run_pipeline — the multi-chip
  analog of the fused single-device pipeline (one host sync per batch
  instead of one per radius; the reference hides that latency inside MPI).
* the per-radius host loop (``fused=False``) — simple, used by tests as a
  second opinion.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from verticut_tpu import codes as codes_lib
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import directory as dir_lib
from verticut_tpu.index.mih import entry_block_size, entry_row_align
from verticut_tpu.ops import chunks as chunks_lib
from verticut_tpu.ops import enumeration, topk
from verticut_tpu.parallel import collectives
from verticut_tpu.search.single import (SearchResult, SearchState,
                                        _cap_for_radius, _device_masks,
                                        _radius_schedule, _stage_shift,
                                        init_state, run_pipeline)


@dataclasses.dataclass
class ShardedMIHIndex:
    """Global-view arrays laid out over the mesh.

    ``entry_rows [m, NB, blk*rw]`` (blocked word-major (id, code) rows, see
    index/mih.MIHTable.entry_rows) is sharded P(table, shard);
    ``se [m, 2^pbits, 2]`` (range directory, global row coordinates) is
    sharded P(table) and replicated over shard/query; ``codes [Ntot, W]``
    (brute-force fallback + scan stage) is row-sharded over both model
    axes.
    """

    cfg: MIHConfig
    mesh: Mesh
    n: int
    n_rows: int                 # padded per-table row count (Ntot)
    entry_rows: jax.Array       # uint32[m, NB, blk*rw]
    se: jax.Array               # int32[m, 2^pbits, 2]
    codes: jax.Array            # uint32[Ntot, W]

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    @property
    def pbits(self) -> int:
        return (self.se.shape[1]).bit_length() - 1


def build_sharded_index(codes_arr, cfg: MIHConfig, mesh: Mesh,
                        pbits: Optional[int] = None) -> ShardedMIHIndex:
    """Build on host/any-device, then lay out over the mesh.

    The sort-per-table build is identical to the single-device path
    (index/mih.py); distribution is pure layout: contiguous row ranges of
    each sorted table go to the ``shard`` axis.
    """
    if mesh.shape["table"] not in (1, cfg.n_tables):
        raise ValueError(
            f"mesh table axis {mesh.shape['table']} != n_tables "
            f"{cfg.n_tables} (or 1)")
    codes_arr = jnp.asarray(codes_arr, jnp.uint32)
    n = codes_arr.shape[0]
    blk = entry_block_size(cfg.n_words)
    n_shards = mesh.shape["shard"]
    # every shard slice must hold whole blocks
    unit = n_shards * entry_row_align(cfg.n_words)
    n_tot = -(-max(n, 1) // unit) * unit
    n_pad = n_tot - n
    pbits = pbits or dir_lib.pick_range_pbits(n, cfg.s_bits, blk)
    # Padded entries carry substring key 0xFFFFFFFF (they land in the last
    # prefix's range) and id -1, which every consumer treats as invalid.
    ids = jnp.concatenate([jnp.arange(n, dtype=jnp.int32),
                           jnp.full((n_pad,), -1, jnp.int32)])
    rows_t, se_t = [], []
    shift = cfg.s_bits - pbits
    grid = jnp.arange((1 << pbits) + 1, dtype=jnp.int32).astype(jnp.uint32)
    for t in range(cfg.n_tables):
        subs = codes_lib.substring(codes_arr, t, cfg.s_bits)
        subs = jnp.concatenate(
            [subs, jnp.full((n_pad,), 0xFFFFFFFF, jnp.uint32)])
        sk, si_pos = jax.lax.sort(
            (subs, jnp.arange(n_tot, dtype=jnp.int32)), num_keys=2)
        si = ids[si_pos]
        sc = jnp.where((si >= 0)[:, None],
                       codes_arr[jnp.clip(si, 0, n - 1)], 0)
        # column-wise word-major assembly (same trap avoidance as
        # index/mih.make_entry_rows: no 2-D transpose of [N, small])
        nb = n_tot // blk
        cols = [si.astype(jnp.uint32).reshape(nb, blk)]
        cols += [sc[:, j].reshape(nb, blk) for j in range(cfg.n_words)]
        rows_t.append(jnp.concatenate(cols, axis=-1))
        pref = (sk >> jnp.uint32(shift)).astype(jnp.uint32)
        offs = jnp.searchsorted(pref, grid, side="left").astype(jnp.int32)
        se_t.append(jnp.stack([offs[:-1], offs[1:]], axis=-1))

    entry_rows = jnp.stack(rows_t)              # [m, NB, blk*rw]
    se = jnp.stack(se_t)                        # [m, 2^p, 2]
    codes_padded = jnp.concatenate(
        [codes_arr, jnp.zeros((n_pad, cfg.n_words), jnp.uint32)])

    tspec = "table" if mesh.shape["table"] == cfg.n_tables else None
    return ShardedMIHIndex(
        cfg=cfg, mesh=mesh, n=n, n_rows=n_tot,
        entry_rows=jax.device_put(
            entry_rows, NamedSharding(mesh, P(tspec, "shard", None))),
        se=jax.device_put(se, NamedSharding(mesh, P(tspec, None, None))),
        codes=jax.device_put(
            codes_padded, NamedSharding(mesh, P(("table", "shard"), None))))


# --------------------------------------------------------------------------
# Per-device radius step (range engine, shard-local clamp)
# --------------------------------------------------------------------------

def _device_radius_step(entry_rows, se, queries, q_subs, masks,
                        state: SearchState, *, radius, n_tables,
                        n_mesh_tables, n_shards, knn, cap, approximate,
                        s_bits, pbits, n_rows, n_total):
    """One radius step on one device. Local blocks: entry_rows
    [Tl, NBl, blk*rw], se [Tl, 2^p, 2] (global row coords), queries [Ql, W],
    q_subs [Ql, m], state leaves [Ql, ...]."""
    gather_axes = ("table", "shard")
    t0 = jax.lax.axis_index("table")
    s0 = jax.lax.axis_index("shard")
    tl = entry_rows.shape[0]
    nbl = entry_rows.shape[1]
    blk = entry_block_size(queries.shape[-1])
    n_loc = n_rows // n_shards
    row0 = (s0 * n_loc).astype(jnp.int32)
    chb = max(4, cap // blk)
    shift = s_bits - pbits
    active = ~state.done

    all_d, all_i = [], []
    n_probe = jnp.zeros_like(state.n_probes)
    n_nonempty = jnp.zeros_like(state.n_nonempty)
    total_c = jnp.zeros_like(state.n_cands)
    overflow_l = jnp.zeros_like(state.done)
    for tt in range(tl):
        tglob = t0 * tl + tt if n_mesh_tables > 1 else tt
        my_sub = jnp.take(q_subs, tglob, axis=1)
        pref = (my_sub >> jnp.uint32(shift))[:, None] ^ masks[None, :]
        p = se[tt][pref.astype(jnp.int32)]
        # clamp the global range to this shard's contiguous row slice —
        # the piecewise bucket return (Pilaf/dht.h:618-620 key split)
        ls = jnp.clip(p[..., 0] - row0, 0, n_loc)
        le = jnp.clip(p[..., 1] - row0, 0, n_loc)
        counts = jnp.where(active[:, None], le - ls, 0)
        # stats are per-(query, table): count them on shard 0 only
        on_s0 = (s0 == 0)
        n_probe = n_probe + jnp.where(
            active & on_s0, pref.shape[1], 0).astype(jnp.int32)
        n_nonempty = n_nonempty + jnp.where(
            on_s0, jnp.sum((counts > 0).astype(jnp.int32), -1), 0)

        blk_id, lo, hi, _nch, ovf = chunks_lib.chunk_descriptors(
            ls, counts, blk=blk, chb=chb, n_blocks=nbl)
        d, i = chunks_lib.fetch_score_blocks(
            entry_rows[tt], blk_id, lo, hi, queries, blk=blk)
        all_d.append(d)
        all_i.append(i)
        total_c = total_c + jnp.sum(hi - lo, axis=-1)
        overflow_l = overflow_l | ovf

    # Per-local-table pre-merge BEFORE the collective: ids are unique
    # within one (table, shard) slice at one radius (disjoint clamped
    # ranges), so local top-P strips retain every global winner, and the
    # MPI_Gatherv-analog all_gather ships pool_size keys per device
    # instead of m·cap candidate slots (ops/topk.py strip-merge rationale).
    p = state.pool_dist.shape[-1]
    if topk.can_pack(n_total - 1, queries.shape[-1] * 32):
        strips_l = jnp.concatenate(
            [topk.table_topk_chunkmin_packed(d, i, p, blk)
             for d, i in zip(all_d, all_i)], axis=-1)
        strips = collectives.gather_strips(strips_l, gather_axes)
        pd, pi = topk.merge_strips_packed(
            state.pool_dist, state.pool_id, strips, n_copies=n_tables + 1)
    else:
        sd, si = zip(*[topk.table_topk_chunkmin_pos(d, i, p, blk)
                       for d, i in zip(all_d, all_i)])
        gd, gi = collectives.gather_candidates(
            jnp.concatenate(sd, axis=-1), jnp.concatenate(si, axis=-1),
            gather_axes)
        pd, pi = topk.merge_strips_dedup_pos(
            state.pool_dist, state.pool_id, gd, gi)

    if approximate:
        newly_done = pi[:, -1] >= 0
    else:
        full, kth = topk.kth_stats(pd, pi, knn)
        newly_done = full & (kth <= (radius + 1) * n_tables)
    newly_done = newly_done | (radius >= s_bits)
    done = state.done | newly_done
    rad = jnp.where(state.done, state.radius, radius)

    overflow = state.overflow | collectives.reduce_any(overflow_l, gather_axes)
    n_probes = state.n_probes + collectives.reduce_sum(n_probe, gather_axes)
    n_nonempty_t = state.n_nonempty + collectives.reduce_sum(
        n_nonempty, gather_axes)
    n_cands = state.n_cands + collectives.reduce_sum(total_c, gather_axes)
    return SearchState(pool_dist=pd, pool_id=pi, done=done, radius=rad,
                       overflow=overflow, n_probes=n_probes,
                       n_nonempty=n_nonempty_t, n_cands=n_cands)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "radius", "n_tables", "knn", "cap",
                     "approximate", "s_bits", "pbits", "n_rows", "n_total"))
def sharded_radius_step(mesh: Mesh, entry_rows, se, queries, q_subs, masks,
                        state: SearchState, *, radius: int, n_tables: int,
                        knn: int, cap: int, approximate: bool, s_bits: int,
                        pbits: int, n_rows: int, n_total: int
                        ) -> SearchState:
    n_mesh_tables = mesh.shape["table"]
    fn = functools.partial(
        _device_radius_step, radius=radius, n_tables=n_tables,
        n_mesh_tables=n_mesh_tables, n_shards=mesh.shape["shard"], knn=knn,
        cap=cap, approximate=approximate, s_bits=s_bits, pbits=pbits,
        n_rows=n_rows, n_total=n_total)
    tspec = "table" if n_mesh_tables > 1 else None
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(tspec, "shard", None), P(tspec, None, None),
                  P("query", None), P("query", None), P(), P("query")),
        out_specs=SearchState(
            pool_dist=P("query"), pool_id=P("query"), done=P("query"),
            radius=P("query"), overflow=P("query"), n_probes=P("query"),
            n_nonempty=P("query"), n_cands=P("query")),
        check_vma=False,
    )(entry_rows, se, queries, q_subs, masks, state)


# --------------------------------------------------------------------------
# Sharded brute-force scan (fallback + oracle at scale)
# --------------------------------------------------------------------------

def _device_linear(codes_loc, queries, k, n_loc, n_total):
    from verticut_tpu.ops import hamming
    dev = jax.lax.axis_index(("table", "shard"))
    base = (dev * n_loc).astype(jnp.int32)
    d, i = hamming.scan_popcount(queries, codes_loc, k,
                                 chunk=min(65536, max(8, n_loc)))
    ig = i + base
    ok = (i >= 0) & (ig < n_total)  # mask device padding rows
    i = jnp.where(ok, ig, -1)
    d = jnp.where(ok, d, topk.INF_DIST)
    gd, gi = collectives.gather_candidates(d, i, ("table", "shard"))
    pd, pi = topk.empty_pool(queries.shape[0], k)
    return topk.merge_topk(pd, pi, gd, gi)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "n_total"))
def sharded_linear_search(mesh: Mesh, codes_arr, queries, k: int,
                          n_total: Optional[int] = None):
    """Exact top-k over row-sharded codes; pools merged by all-gather."""
    n_loc = codes_arr.shape[0] // (mesh.shape["table"] * mesh.shape["shard"])
    fn = functools.partial(_device_linear, k=k, n_loc=n_loc,
                           n_total=n_total or codes_arr.shape[0])
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(("table", "shard"), None), P("query", None)),
        out_specs=(P("query"), P("query")),
        check_vma=False,
    )(codes_arr, queries)


# --------------------------------------------------------------------------
# Fused one-dispatch driver: the whole schedule under one shard_map
# --------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("mesh", "schedule", "caps", "batch_caps", "n_tables",
                     "knn", "pool_size", "approximate", "s_bits", "pbits",
                     "n_rows", "n_total", "retry_caps", "retry_budget",
                     "scan_budget", "scan_dominance", "overflow_to_scan"))
def sharded_fused_packed(mesh: Mesh, entry_rows, se, codes_arr, queries,
                         masks_tuple, *, schedule, caps, batch_caps,
                         n_tables, knn, pool_size, approximate, s_bits,
                         pbits, n_rows, n_total, retry_caps=None,
                         retry_budget=0, scan_budget=0, scan_dominance=0,
                         overflow_to_scan=False) -> jax.Array:
    """Multi-chip fused pipeline: schedule + retry + scan stages in ONE
    shard_map dispatch; per-device query compaction; result packed as the
    single int32 array of fused_pipeline_packed. The reference's lockstep
    loop pays its per-radius barrier inside MPI (search_worker.cc:170-207);
    a host-driven loop over shard_map steps pays a host sync per radius —
    this driver pays one per batch."""
    n_mesh_tables = mesh.shape["table"]
    n_shards = mesh.shape["shard"]
    n_loc_codes = codes_arr.shape[0] // (n_mesh_tables * n_shards)

    def device_program(entry_rows, se, codes_loc, queries):
        q_subs = codes_lib.all_substrings(queries, n_tables)
        state0 = init_state(queries.shape[0], pool_size)

        def step_fn(i, r, cap, cq, cqs, cs):
            return _device_radius_step(
                entry_rows, se, cq, cqs, masks_tuple[i], cs, radius=r,
                n_tables=n_tables, n_mesh_tables=n_mesh_tables,
                n_shards=n_shards, knn=knn, cap=cap,
                approximate=approximate, s_bits=s_bits, pbits=pbits,
                n_rows=n_rows, n_total=n_total)

        def scan_fn(sq):
            return _device_linear(codes_loc, sq, knn, n_loc_codes, n_total)

        full, covf = run_pipeline(
            step_fn, scan_fn, queries, q_subs, state0, schedule=schedule,
            caps=caps, batch_caps=batch_caps, knn=knn, pool_size=pool_size,
            retry_caps=retry_caps, retry_budget=retry_budget,
            scan_budget=scan_budget, scan_dominance=scan_dominance,
            overflow_to_scan=overflow_to_scan)
        nq = queries.shape[0]
        cols = jnp.stack([full.done.astype(jnp.int32), full.radius,
                          full.overflow.astype(jnp.int32), full.n_probes,
                          full.n_nonempty, full.n_cands,
                          jnp.broadcast_to(covf.astype(jnp.int32), (nq,))],
                         axis=1)
        return jnp.concatenate([full.pool_dist, full.pool_id, cols], axis=1)

    tspec = "table" if n_mesh_tables > 1 else None
    return jax.shard_map(
        device_program, mesh=mesh,
        in_specs=(P(tspec, "shard", None), P(tspec, None, None),
                  P(("table", "shard"), None), P("query", None)),
        out_specs=P("query", None),
        check_vma=False,
    )(entry_rows, se, codes_arr, queries)


# --------------------------------------------------------------------------
# Host drivers
# --------------------------------------------------------------------------

def _sharded_schedule(index: ShardedMIHIndex, scfg: SearchConfig):
    cfg = index.cfg
    schedule = tuple(
        (r, g)
        for r, g in _radius_schedule(scfg, cfg, index.n, index.pbits, True)
        if sum(enumeration.n_masks(index.pbits, x) for x in g)
        <= scfg.fused_max_masks)
    return schedule


def _sharded_fused_search(index: ShardedMIHIndex, queries,
                          scfg: SearchConfig, _cap: Optional[int]
                          ) -> Optional[np.ndarray]:
    cfg = index.cfg
    mesh = index.mesh
    nq = queries.shape[0]
    pool_size = scfg.pool_size
    schedule = _sharded_schedule(index, scfg)
    if not schedule:
        return None
    caps = tuple(_cap or _cap_for_radius(scfg, cfg, index.n, g, pool_size,
                                         index.pbits, True,
                                         entry_block_size(cfg.n_words))
                 for _, g in schedule)
    nq_loc = nq // mesh.shape["query"]
    batch_caps = tuple(
        nq_loc if i == 0 else max(64, nq_loc >> (_stage_shift(scfg.knn, index.n)
                                                 + 2 * (i - 1)))
        for i in range(len(schedule)))
    masks_tuple = tuple(_device_masks(index.pbits, g) for _, g in schedule)
    # x2, matching the single-device driver's sizing: covers the
    # clustered hot range at half the cost; rare double-overflows take
    # the host retry (x4)
    retry_caps = tuple(min(c * 2, max(scfg.candidate_cap, c)) for c in caps)
    scan_budget = min(nq_loc, max(64, nq_loc // 64))
    # same exact-mode ladder policy as the single-device driver
    # (search/single.mih_search_dispatch): overflow rows ride the scan
    # ladder on small corpora; scan-dominated batches skip stages 2+
    from verticut_tpu.search.single import (OVERFLOW_SCAN_MAX_N,
                                            SCAN_DOMINANCE_MIN_NQ)
    o2s = (scfg.overflow_to_scan and scan_budget > 0
           and not scfg.approximate and index.n <= OVERFLOW_SCAN_MAX_N)
    packed = sharded_fused_packed(
        mesh, index.entry_rows, index.se, index.codes, queries, masks_tuple,
        schedule=schedule, caps=caps, batch_caps=batch_caps,
        n_tables=cfg.n_tables, knn=scfg.knn, pool_size=pool_size,
        approximate=scfg.approximate, s_bits=cfg.s_bits, pbits=index.pbits,
        n_rows=index.n_rows, n_total=index.n,
        retry_caps=(None if o2s
                    else retry_caps if retry_caps != caps else None),
        retry_budget=(0 if o2s else min(nq_loc, max(64, nq_loc // 4))),
        scan_budget=scan_budget,
        scan_dominance=(nq_loc // 2
                        if scan_budget and not scfg.approximate
                        and nq_loc >= SCAN_DOMINANCE_MIN_NQ else 0),
        overflow_to_scan=o2s)
    host = jax.device_get(packed)
    if (host[:, -1] != 0).any():
        return None
    return host


def sharded_mih_search(index: ShardedMIHIndex, queries,
                       scfg: SearchConfig = SearchConfig(),
                       _cap: Optional[int] = None) -> SearchResult:
    """Distributed batched K-NN. Same contract as search.single.mih_search."""
    from verticut_tpu.search.single import effective_scfg
    scfg = effective_scfg(scfg)
    cfg = index.cfg
    mesh = index.mesh
    queries = jnp.asarray(queries, jnp.uint32)
    nq = queries.shape[0]
    if nq % mesh.shape["query"] != 0:
        raise ValueError(f"query batch {nq} not divisible by query axis "
                         f"{mesh.shape['query']}")
    k, pool_size = scfg.knn, scfg.pool_size

    host = None
    if scfg.fused:
        host = _sharded_fused_search(index, queries, scfg, _cap)
    if host is not None:
        pd, pi = host[:, :pool_size], host[:, pool_size:2 * pool_size]
        cols = host[:, 2 * pool_size:]
        dists = pd[:, :k].copy()
        ids = pi[:, :k].copy()
        radius = cols[:, 1].copy()
        overflow = cols[:, 2] != 0
        not_done = cols[:, 0] == 0
        n_probes, n_nonempty, n_cands = cols[:, 3], cols[:, 4], cols[:, 5]
    else:
        # adaptive per-radius host loop (also the compact_ovf fallback)
        qsh = NamedSharding(mesh, P("query", None))
        queries_d = jax.device_put(queries, qsh)
        q_subs = jax.device_put(
            codes_lib.all_substrings(queries_d, cfg.n_tables), qsh)
        state = jax.device_put(init_state(nq, pool_size),
                               NamedSharding(mesh, P("query")))
        for r, group in _radius_schedule(scfg, cfg, index.n, index.pbits,
                                         True):
            cap = _cap or _cap_for_radius(scfg, cfg, index.n, group,
                                          pool_size, index.pbits, True,
                                          entry_block_size(cfg.n_words))
            masks = _device_masks(index.pbits, group)
            state = sharded_radius_step(
                mesh, index.entry_rows, index.se, queries_d, q_subs, masks,
                state, radius=r, n_tables=cfg.n_tables, knn=k, cap=cap,
                approximate=scfg.approximate, s_bits=cfg.s_bits,
                pbits=index.pbits, n_rows=index.n_rows, n_total=index.n)
            if bool(jnp.all(state.done)):
                break
        dists = np.array(state.pool_dist[:, :k])
        ids = np.array(state.pool_id[:, :k])
        radius = np.array(state.radius)
        overflow = np.asarray(state.overflow)
        not_done = ~np.asarray(state.done)
        n_probes = np.asarray(state.n_probes)
        n_nonempty = np.asarray(state.n_nonempty)
        n_cands = np.asarray(state.n_cands)

    redo = overflow & ~not_done
    base_cap = _cap or scfg.candidate_cap
    if redo.any():
        if base_cap < index.n:
            # pad the retry subset to the query-axis multiple
            idxs = np.nonzero(redo)[0]
            nq_ax = mesh.shape["query"]
            n_pad = (-len(idxs)) % nq_ax
            take = np.concatenate([idxs, np.repeat(idxs[:1], n_pad)])
            sub = sharded_mih_search(index, np.asarray(queries)[take], scfg,
                                     _cap=min(base_cap * 4, max(index.n, 8)))
            dists[idxs] = sub.dists[:len(idxs)]
            ids[idxs] = sub.ids[:len(idxs)]
            radius[idxs] = sub.radius[:len(idxs)]
        else:
            # terminal cap still clipped (block-granular budgets): never
            # drop an overflow flag — take the exact linear fallback
            not_done = not_done | redo

    if not_done.any():
        idxs = np.nonzero(not_done)[0]
        # keep the query-axis batch shape: scan all, take stragglers
        ld, li = sharded_linear_search(mesh, index.codes, queries, k,
                                      n_total=index.n)
        dists[idxs] = np.asarray(ld)[idxs]
        ids[idxs] = np.asarray(li)[idxs]

    return SearchResult(dists=dists, ids=ids, radius=radius,
                        n_probes=np.asarray(n_probes),
                        n_nonempty=np.asarray(n_nonempty),
                        n_cands=np.asarray(n_cands))
