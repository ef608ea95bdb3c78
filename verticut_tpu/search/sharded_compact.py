"""Compact (ids-only) sharded MIH — the 1B-scale layout and build.

The inline sharded index (search/sharded.py) stores 32 B (id, code) rows
per table — ~130 GB at 1B codes (DESIGN.md §3) — and builds centrally.
This module is the scale path:

* **Layout**: per-table blocked id rows (4 B/entry/table) + ONE id-sharded
  code array (16 B/code), ~32 B/code total + directory — 1B codes take
  ~32 GB plus directories (DESIGN.md §3 compact column).
* **Value-partitioned shards**: shard ``s`` of a table owns prefix values
  ``[s·2^p/S, (s+1)·2^p/S)`` — the Pilaf key split (``Pilaf/dht.h:618-620``)
  made *contiguous in value space*, so a probed prefix range lives wholly
  in one shard and the per-shard directory uses local row coordinates (no
  straddling clamp at all).
* **Per-device build**: no device (or host) ever materializes a full
  table. Codes are id-sharded across the mesh (device-born generation or
  sharded upload); ONE shard_map program streams the corpus in chunks via
  ``all_gather``, each (table, shard) device keeps the rows in its prefix
  range (scatter-append at a cumsum offset), then sorts its slice and
  derives its directory — the distributed analog of the reference's
  per-rank streaming build (``src/build_hash_tables.cc:25-73``), with the
  read-modify-write KV append replaced by filter + one local sort.
* **Distance-at-owner scoring**: finders fetch candidate *ids* only; ids
  all-gather over (table, shard); each device scores the ids whose code
  rows it owns (local gather + XOR/popcount), pre-merges per-table
  strips, and the strips all-gather back for the replicated dedup merge
  (ops/topk.merge_strips_dedup_pos — unbounded ids). No cross-device code
  fetch ever happens; the two collectives per radius are the
  ``MPI_Gatherv`` analog split into an id leg and a strip leg.
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
from verticut_tpu.index.mih import ID_ROW_BLOCK
from verticut_tpu.ops import chunks as chunks_lib
from verticut_tpu.ops import enumeration, topk
from verticut_tpu.parallel import collectives
from verticut_tpu.search.single import (SearchResult, SearchState,
                                        _cap_for_radius, _device_masks,
                                        _radius_schedule, _stage_shift,
                                        init_state, run_pipeline)
from verticut_tpu.search.sharded import sharded_linear_search, _device_linear


@dataclasses.dataclass
class ShardedCompactIndex:
    """Compact sharded index handle (global-view arrays on the mesh).

    ``idrows [m, NB, 32]``: blocked id-only rows, P(table, shard, None) —
    shard s's slice holds its value-range rows, substring-sorted, padded
    with id 0xFFFFFFFF to ``NB/S`` blocks.
    ``se [m, 2^p, 2]``: range directory, P(table, shard, None) — the shard
    axis splits the PREFIX dimension; offsets are LOCAL row coordinates.
    ``codes [Ntot, W]``: id-ordered codes, P((table, shard), None) — the
    ownership axis for distance-at-owner scoring and the scan fallback.
    """

    cfg: MIHConfig
    mesh: Mesh
    n: int
    pbits: int
    cap_rows: int               # per-(table, shard) row capacity (padded)
    idrows: jax.Array           # uint32[m, NB, 32]
    se: jax.Array               # int32[m, 2^pbits, 2]
    codes: jax.Array            # uint32[Ntot, W]

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["shard"]

    def memory_stats(self) -> dict:
        """Per-device and per-code memory accounting (DESIGN.md §3).

        Every model array (idrows, se, codes) is split over the full
        (table × shard) device grid — idrows/se by (table slice, value
        range), codes by id range — so per-device bytes = total / devices
        (query-axis devices replicate the model)."""
        d = self.mesh.shape["table"] * self.mesh.shape["shard"]
        idrow_b = self.idrows.size * 4
        se_b = self.se.size * 4
        code_b = self.codes.size * 4
        total = idrow_b + se_b + code_b
        return {
            "n": self.n,
            "idrows_bytes": idrow_b,
            "directory_bytes": se_b,
            "codes_bytes": code_b,
            "total_bytes": total,
            "bytes_per_code": total / max(self.n, 1),
            "bytes_per_device": total / d,
            "n_devices": d,
        }


def _mesh_tl(mesh: Mesh, cfg: MIHConfig) -> int:
    """Tables per device along the mesh table axis (1 or m when folded)."""
    if mesh.shape["table"] not in (1, cfg.n_tables):
        raise ValueError(
            f"mesh table axis {mesh.shape['table']} != n_tables "
            f"{cfg.n_tables} (or 1)")
    return cfg.n_tables // mesh.shape["table"]


def build_sharded_compact(codes_arr, cfg: MIHConfig, mesh: Mesh,
                          pbits: Optional[int] = None,
                          slack: float = 1.5) -> ShardedCompactIndex:
    """Distributed build: every (table, shard) slice is filtered, sorted,
    and indexed on its own device; the host ships (or the caller
    device-generates) only the id-sharded code array.

    ``slack`` pads each shard's row capacity over the uniform expectation;
    value-space skew beyond it raises (the exactness contract forbids
    silently dropping rows).
    """
    tl = _mesh_tl(mesh, cfg)
    n_shards = mesh.shape["shard"]
    n_dev = mesh.shape["table"] * n_shards
    if not isinstance(codes_arr, jax.Array) or codes_arr.ndim != 2:
        codes_arr = np.asarray(codes_arr, np.uint32)
    n = codes_arr.shape[0]
    # id-shard the corpus (pad rows to the device multiple; pad ids >= n
    # are filtered out inside the build)
    unit = n_dev * 128
    n_tot = -(-max(n, 1) // unit) * unit
    pbits = pbits or dir_lib.pick_range_pbits(n, cfg.s_bits, ID_ROW_BLOCK)
    pbits = max(pbits, (n_shards - 1).bit_length())
    if (1 << pbits) % n_shards:
        raise ValueError(f"2^pbits={1 << pbits} not divisible by "
                         f"{n_shards} shards")
    csh = NamedSharding(mesh, P(("table", "shard"), None))
    if isinstance(codes_arr, jax.Array) and codes_arr.shape[0] == n_tot:
        codes_d = jax.device_put(codes_arr, csh)
    else:
        host = np.zeros((n_tot, cfg.n_words), np.uint32)
        host[:n] = np.asarray(codes_arr)
        if jax.process_count() > 1:
            # multi-process: device_put cannot target non-addressable
            # devices; every process materializes only its local shards
            # from the (replicated) host corpus
            codes_d = jax.make_array_from_callback(
                host.shape, csh, lambda idx: host[idx])
        else:
            codes_d = jax.device_put(host, csh)

    # uniform expectation n_tot/S rows per (table, shard), padded by slack
    cap_rows = int(-(-int(n_tot // n_shards * slack) // ID_ROW_BLOCK)
                   * ID_ROW_BLOCK)
    idrows, se, kept = _build_compact_jit(
        mesh, codes_d, n=n, n_tot=n_tot, n_words=cfg.n_words,
        n_tables=cfg.n_tables, tl=tl, n_shards=n_shards,
        s_bits=cfg.s_bits, pbits=pbits, cap_rows=cap_rows)
    # kept is (table, shard)-sharded; under multi-process meshes its
    # shards are not all addressable — reduce to a replicated scalar on
    # device before pulling to host (multi-host seam, VERDICT r4 #7)
    kept_max = int(jax.jit(
        jnp.max, out_shardings=NamedSharding(mesh, P()))(kept))
    if kept_max > cap_rows:
        raise ValueError(
            f"value-space skew overflowed shard capacity: max kept "
            f"{kept_max} > cap {cap_rows}; rebuild with larger "
            f"slack (exactness contract: rows must never be dropped)")
    return ShardedCompactIndex(cfg=cfg, mesh=mesh, n=n, pbits=pbits,
                               cap_rows=cap_rows, idrows=idrows, se=se,
                               codes=codes_d)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n", "n_tot", "n_words", "n_tables", "tl",
                     "n_shards", "s_bits", "pbits", "cap_rows"))
def _build_compact_jit(mesh: Mesh, codes_d, *, n: int, n_tot: int,
                       n_words: int, n_tables: int, tl: int, n_shards: int,
                       s_bits: int, pbits: int, cap_rows: int):
    """One shard_map program: stream → filter → scatter-append → sort →
    local directory. Chunked all_gather bounds the transient to
    [D·chunk, W]; total collective traffic is one pass over the corpus."""
    n_dev = mesh.shape["table"] * n_shards
    n_loc = n_tot // n_dev
    chunk = min(n_loc, 1 << 20)
    n_chunks = -(-n_loc // chunk)
    shift = s_bits - pbits
    p_loc = (1 << pbits) // n_shards

    def device_build(codes_loc):
        t0 = jax.lax.axis_index("table")
        s0 = jax.lax.axis_index("shard")
        dev = jax.lax.axis_index(("table", "shard"))
        del dev
        p0 = (s0 * p_loc).astype(jnp.uint32)

        def table_stream(tglob):
            """Collect this shard's value-range rows of table tglob."""
            keys0 = jnp.full((cap_rows,), jnp.uint32(0xFFFFFFFF))
            # pad id int32-max: pads must sort AFTER real rows sharing the
            # all-ones substring key, keeping real rows contiguous [0, off)
            ids0 = jnp.full((cap_rows,), 0x7FFFFFFF, jnp.int32)

            def body(c, carry):
                keys, ids, off = carry
                # dynamic_slice clamps the start when the final chunk
                # overruns; the freshness mask drops the re-read overlap so
                # no row is indexed twice
                start = jnp.minimum(c * chunk, n_loc - chunk)
                part = jax.lax.dynamic_slice(
                    codes_loc, (start, 0), (chunk, n_words))
                g = jax.lax.all_gather(part, ("table", "shard"), axis=0)
                rows = g.reshape(n_dev * chunk, n_words)
                # global id of gathered row = src_dev*n_loc + start + i
                src = jax.lax.broadcasted_iota(
                    jnp.int32, (n_dev, chunk), 0).reshape(-1)
                lpos = start + jax.lax.broadcasted_iota(
                    jnp.int32, (n_dev, chunk), 1).reshape(-1)
                gid = src * n_loc + lpos
                sub = codes_lib.substring(rows, tglob, s_bits)
                pref = sub >> jnp.uint32(shift)
                keep = ((pref >= p0) & (pref < p0 + p_loc) & (gid < n)
                        & (lpos >= c * chunk))
                pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
                idx = jnp.where(keep, off + pos, cap_rows + 1)
                keys = keys.at[idx].set(sub, mode="drop")
                ids = ids.at[idx].set(gid, mode="drop")
                return keys, ids, off + jnp.sum(keep.astype(jnp.int32))

            keys, ids, off = jax.lax.fori_loop(
                0, n_chunks, body, (keys0, ids0, jnp.int32(0)))
            # local sort: stable (substring, id) — bucket-internal order =
            # ascending id, matching the reference's append order
            sk, si = jax.lax.sort((keys, ids), num_keys=2)
            si = jnp.where(si == jnp.int32(0x7FFFFFFF), jnp.int32(-1), si)
            # local directory over this shard's prefix slice, local coords
            grid = (p0 + jnp.arange(p_loc + 1, dtype=jnp.int32)
                    .astype(jnp.uint32)) << jnp.uint32(shift)
            # boundary for prefix p = first row with key >= p << shift;
            # the final grid entry (p0+p_loc) << shift may wrap to 0 when
            # the slice is the last one — use cap via where
            top = (p0 + p_loc) >= jnp.uint32(1 << pbits)
            offs = jnp.searchsorted(sk, grid, side="left").astype(jnp.int32)
            offs = offs.at[-1].set(jnp.where(top, off, offs[-1]))
            se_t = jnp.stack([offs[:-1], offs[1:]], axis=-1)
            rows_t = sk, si, se_t, off
            return rows_t

        out_ids, out_se, out_kept = [], [], []
        for tt in range(tl):
            tglob = (t0 * tl + tt).astype(jnp.int32) if tl < n_tables \
                else jnp.int32(tt)
            _sk, si, se_t, off = table_stream(tglob)
            out_ids.append(si.astype(jnp.uint32)
                           .reshape(cap_rows // ID_ROW_BLOCK, ID_ROW_BLOCK))
            out_se.append(se_t)
            out_kept.append(off)
        return (jnp.stack(out_ids), jnp.stack(out_se),
                jnp.stack(out_kept)[:, None])

    tspec = "table" if mesh.shape["table"] > 1 else None
    return jax.shard_map(
        device_build, mesh=mesh,
        in_specs=(P(("table", "shard"), None),),
        out_specs=(P(tspec, "shard", None), P(tspec, "shard", None),
                   P(tspec, "shard")),
        check_vma=False,
    )(codes_d)


# --------------------------------------------------------------------------
# Persistence — the scale-index checkpoint (the op-log role of
# Pilaf/store-server.cc:58-94, adapted to build-then-freeze: we persist the
# built artifact per device shard, never a monolithic pull of a 100M+
# index through one host).
# --------------------------------------------------------------------------

_SHARD_SAVE_META = "meta.json"


def _model_arrays(index: ShardedCompactIndex):
    return (("idrows", index.idrows), ("se", index.se),
            ("codes", index.codes))


def save_sharded_compact(path: str, index: ShardedCompactIndex) -> None:
    """Persist the index as per-device shard files under directory ``path``.

    Each (array, shard-offset) pair becomes one ``.npy`` (replicas across
    the query axis dedup to one file); ``meta.json`` records config, mesh
    model axes, and global shapes. Multi-host safe by construction: every
    process saves only its addressable shards, so a shared filesystem
    collects the full set exactly once per offset.
    """
    import json
    import os
    os.makedirs(path, exist_ok=True)
    shapes = {}
    for name, arr in _model_arrays(index):
        shapes[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        seen = set()
        for sh in arr.addressable_shards:
            off = tuple(int(sl.start or 0) for sl in sh.index)
            if off in seen:
                continue  # query-axis replica
            seen.add(off)
            fn = os.path.join(
                path, f"{name}_{'_'.join(map(str, off))}.npy")
            np.save(fn, np.asarray(sh.data))
    meta = {
        "format": "verticut_tpu.sharded_compact.v1",
        "bits": index.cfg.bits,
        "n_tables": index.cfg.n_tables,
        "n": index.n,
        "pbits": index.pbits,
        "cap_rows": index.cap_rows,
        "mesh_table": index.mesh.shape["table"],
        "mesh_shard": index.mesh.shape["shard"],
        "arrays": shapes,
    }
    if jax.process_index() == 0:  # one writer on a shared filesystem
        with open(os.path.join(path, _SHARD_SAVE_META), "w") as f:
            json.dump(meta, f, indent=1)


def load_sharded_compact(path: str, mesh: Mesh) -> ShardedCompactIndex:
    """Restore a saved index onto ``mesh`` (same table/shard axis sizes as
    at save time; the query axis is free — model arrays replicate over it).

    Assembly is per-device: ``jax.make_array_from_callback`` loads exactly
    the shard file each local device needs (memory-mapped, so no host copy
    of the full index ever exists).
    """
    import json
    import os
    with open(os.path.join(path, _SHARD_SAVE_META)) as f:
        meta = json.load(f)
    if (meta["mesh_table"] != mesh.shape["table"]
            or meta["mesh_shard"] != mesh.shape["shard"]):
        raise ValueError(
            f"saved for mesh (table={meta['mesh_table']}, "
            f"shard={meta['mesh_shard']}); got (table={mesh.shape['table']}"
            f", shard={mesh.shape['shard']}) — resharding a saved index "
            "requires a rebuild")
    cfg = MIHConfig(bits=int(meta["bits"]), n_tables=int(meta["n_tables"]))
    tspec = "table" if mesh.shape["table"] > 1 else None
    specs = {
        "idrows": P(tspec, "shard", None),
        "se": P(tspec, "shard", None),
        "codes": P(("table", "shard"), None),
    }
    out = {}
    for name, spec in specs.items():
        info = meta["arrays"][name]
        shape = tuple(info["shape"])

        def cb(idx, name=name):
            off = tuple(int(sl.start or 0) for sl in idx)
            fn = os.path.join(
                path, f"{name}_{'_'.join(map(str, off))}.npy")
            return np.load(fn, mmap_mode="r")

        out[name] = jax.make_array_from_callback(
            shape, NamedSharding(mesh, spec), cb)
    return ShardedCompactIndex(
        cfg=cfg, mesh=mesh, n=int(meta["n"]), pbits=int(meta["pbits"]),
        cap_rows=int(meta["cap_rows"]), idrows=out["idrows"], se=out["se"],
        codes=out["codes"])


# --------------------------------------------------------------------------
# Compact radius step: local id discovery → owner scoring → strip merge
# --------------------------------------------------------------------------

def _device_radius_step_compact(idrows, se, codes_loc, queries, q_subs,
                                masks, state: SearchState, *, radius,
                                n_tables, n_mesh_tables, n_shards, knn, cap,
                                approximate, s_bits, pbits, n_total,
                                n_loc_codes):
    """One radius step on one device (compact layout).

    Locals: idrows [tl, NBl, 32], se [tl, p_loc, 2] (LOCAL row coords),
    codes_loc [n_loc, W] (this device's id range), queries [Ql, W]."""
    t0 = jax.lax.axis_index("table")
    s0 = jax.lax.axis_index("shard")
    dev = jax.lax.axis_index(("table", "shard"))
    tl = idrows.shape[0]
    nbl = idrows.shape[1]
    blk = ID_ROW_BLOCK
    chb = max(4, cap // blk)
    shift = s_bits - pbits
    p_loc = (1 << pbits) // n_shards
    p0 = (s0 * p_loc).astype(jnp.uint32)
    c0 = (dev * n_loc_codes).astype(jnp.int32)
    active = ~state.done
    nq = queries.shape[0]

    ids_t = []
    n_probe = jnp.zeros_like(state.n_probes)
    n_nonempty = jnp.zeros_like(state.n_nonempty)
    overflow_l = jnp.zeros_like(state.done)
    for tt in range(tl):
        tglob = t0 * tl + tt if n_mesh_tables > 1 else tt
        my_sub = jnp.take(q_subs, tglob, axis=1)
        pref = (my_sub >> jnp.uint32(shift))[:, None] ^ masks[None, :]
        owned = (pref >= p0[None, None]) & (pref < (p0 + p_loc)[None, None])
        lp = jnp.clip(pref.astype(jnp.int32) - p0.astype(jnp.int32),
                      0, p_loc - 1)
        p = se[tt][lp]
        counts = jnp.where(owned & active[:, None], p[..., 1] - p[..., 0], 0)
        starts = p[..., 0]
        # each probe is owned by exactly one shard: count it there
        n_probe = n_probe + jnp.where(
            active, jnp.sum(owned.astype(jnp.int32), -1), 0)
        n_nonempty = n_nonempty + jnp.sum((counts > 0).astype(jnp.int32), -1)

        blk_id, lo, hi, _nch, ovf = chunks_lib.chunk_descriptors(
            starts, counts, blk=blk, chb=chb, n_blocks=nbl)
        cid = idrows[tt][blk_id].astype(jnp.int32)      # [Q, chb, 32]
        pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, blk), 2)
        ok = ((pos >= lo[..., None]) & (pos < hi[..., None]) & (cid >= 0))
        ids_t.append(jnp.where(ok, cid, -1).reshape(nq, chb * blk))
        overflow_l = overflow_l | ovf

    # collective 1: ship candidate IDS (4 B each) to every device
    local_ids = jnp.stack(ids_t, axis=1)                # [Q, tl, C]
    g = jax.lax.all_gather(local_ids, ("table", "shard"), axis=0)
    # [D, Q, tl, C] with D = table-major × shard → per-GLOBAL-table groups
    c_width = g.shape[-1]
    g = (g.reshape(n_mesh_tables, n_shards, nq, tl, c_width)
         .transpose(2, 0, 3, 1, 4)
         .reshape(nq, n_tables, n_shards * c_width))

    # distance-at-owner: score the ids whose code rows live here, one
    # global table at a time, chunking the width so the gathered-code
    # transient never exceeds ~32 MB (the single-device compact path's
    # slicing discipline, search/single._table_candidates_range)
    w = queries.shape[-1]
    sw = g.shape[-1]
    p_sz = state.pool_dist.shape[-1]
    sl = max(ID_ROW_BLOCK, (1 << 23) // max(nq * w, 1))
    n_cands = jnp.zeros_like(state.n_cands)
    sd, si = [], []
    for j in range(n_tables):
        gj = g[:, j]                                     # [Q, S*C]
        d_parts, i_parts = [], []
        for c_lo in range(0, sw, sl):
            c_hi = min(c_lo + sl, sw)
            part = gj[:, c_lo:c_hi]
            own = (part >= c0) & (part < c0 + n_loc_codes)
            rows = codes_loc[jnp.clip(part - c0, 0, n_loc_codes - 1)]
            dd = jnp.sum(jax.lax.population_count(
                rows ^ queries[:, None, :]).astype(jnp.int32), axis=-1)
            d_parts.append(jnp.where(own, dd, topk.INF_DIST))
            i_parts.append(jnp.where(own, part, -1))
        dist_j = jnp.concatenate(d_parts, axis=-1)
        ids_j = jnp.concatenate(i_parts, axis=-1)
        n_cands = n_cands + jnp.sum((ids_j >= 0).astype(jnp.int32), -1)
        # per-(global-table, device) strip; ids unique within each (unique
        # per table ∧ owned subset) — ops/topk.py strip-merge invariant.
        # Candidate axis is id-block-major, so the chunk-min pre-selection
        # applies (falls back internally when p_sz doesn't undercut it).
        d_s, i_s = topk.table_topk_chunkmin_pos(dist_j, ids_j, p_sz, blk)
        sd.append(d_s)
        si.append(i_s)
    strip_d = jnp.concatenate(sd, axis=-1)
    strip_i = jnp.concatenate(si, axis=-1)
    # collective 2: strips back to everyone, replicated dedup merge
    gd, gi = collectives.gather_candidates(strip_d, strip_i,
                                           ("table", "shard"))
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
    # every probe has exactly one owning shard, every table exactly one
    # processing device row, and every candidate exactly one code owner —
    # so the psums are exact counts, no de-duplication factor needed
    axes = ("table", "shard")
    return SearchState(
        pool_dist=pd, pool_id=pi, done=done, radius=rad,
        overflow=state.overflow | collectives.reduce_any(overflow_l, axes),
        n_probes=state.n_probes + collectives.reduce_sum(n_probe, axes),
        n_nonempty=state.n_nonempty + collectives.reduce_sum(
            n_nonempty, axes),
        n_cands=state.n_cands + collectives.reduce_sum(n_cands, axes))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "schedule", "caps", "batch_caps", "n_tables",
                     "knn", "pool_size", "approximate", "s_bits", "pbits",
                     "n_total", "retry_caps", "retry_budget", "scan_budget",
                     "scan_dominance", "overflow_to_scan"))
def compact_fused_packed(mesh: Mesh, idrows, se, codes_arr, queries,
                         masks_tuple, *, schedule, caps, batch_caps,
                         n_tables, knn, pool_size, approximate, s_bits,
                         pbits, n_total, retry_caps=None, retry_budget=0,
                         scan_budget=0, scan_dominance=0,
                         overflow_to_scan=False) -> jax.Array:
    """Whole compact schedule (+ retry + scan) in ONE shard_map dispatch,
    packed like fused_pipeline_packed."""
    n_mesh_tables = mesh.shape["table"]
    n_shards = mesh.shape["shard"]
    n_dev = n_mesh_tables * n_shards
    n_loc_codes = codes_arr.shape[0] // n_dev

    def device_program(idrows, se, codes_loc, queries):
        q_subs = codes_lib.all_substrings(queries, n_tables)
        state0 = init_state(queries.shape[0], pool_size)

        def step_fn(i, r, cap, cq, cqs, cs):
            return _device_radius_step_compact(
                idrows, se, codes_loc, cq, cqs, masks_tuple[i], cs,
                radius=r, n_tables=n_tables, n_mesh_tables=n_mesh_tables,
                n_shards=n_shards, knn=knn, cap=cap,
                approximate=approximate, s_bits=s_bits, pbits=pbits,
                n_total=n_total, n_loc_codes=n_loc_codes)

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
        in_specs=(P(tspec, "shard", None), P(tspec, "shard", None),
                  P(("table", "shard"), None), P("query", None)),
        out_specs=P("query", None),
        check_vma=False,
    )(idrows, se, codes_arr, queries)


def sharded_compact_search(index: ShardedCompactIndex, queries,
                           scfg: SearchConfig = SearchConfig(),
                           _cap: Optional[int] = None) -> SearchResult:
    """Distributed compact K-NN. Same contract as sharded_mih_search."""
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

    schedule = tuple(
        (r, g)
        for r, g in _radius_schedule(scfg, cfg, index.n, index.pbits, True)
        if sum(enumeration.n_masks(index.pbits, x) for x in g)
        <= scfg.fused_max_masks)
    host = None
    if schedule:
        caps = tuple(_cap or _cap_for_radius(scfg, cfg, index.n, g,
                                             pool_size, index.pbits, True,
                                             ID_ROW_BLOCK)
                     for _, g in schedule)
        nq_loc = nq // mesh.shape["query"]
        batch_caps = tuple(
            nq_loc if i == 0 else max(64, nq_loc >> (_stage_shift(scfg.knn, index.n)
                                                     + 2 * (i - 1)))
            for i in range(len(schedule)))
        masks_tuple = tuple(_device_masks(index.pbits, g)
                            for _, g in schedule)
        retry_caps = tuple(min(c * 2, max(scfg.candidate_cap, c))
                           for c in caps)
        scan_budget = min(nq_loc, max(64, nq_loc // 64))
        # same exact-mode ladder policy as the single-device driver
        from verticut_tpu.search.single import (OVERFLOW_SCAN_MAX_N,
                                                SCAN_DOMINANCE_MIN_NQ)
        o2s = (scfg.overflow_to_scan and scan_budget > 0
               and not scfg.approximate
               and index.n <= OVERFLOW_SCAN_MAX_N)
        packed = compact_fused_packed(
            mesh, index.idrows, index.se, index.codes, queries, masks_tuple,
            schedule=schedule, caps=caps, batch_caps=batch_caps,
            n_tables=cfg.n_tables, knn=k, pool_size=pool_size,
            approximate=scfg.approximate, s_bits=cfg.s_bits,
            pbits=index.pbits, n_total=index.n,
            retry_caps=(None if o2s
                        else retry_caps if retry_caps != caps else None),
            retry_budget=(0 if o2s else min(nq_loc, max(64, nq_loc // 4))),
            scan_budget=scan_budget,
            scan_dominance=(nq_loc // 2
                            if scan_budget and not scfg.approximate
                            and nq_loc >= SCAN_DOMINANCE_MIN_NQ else 0),
            overflow_to_scan=o2s)
        host = np.asarray(jax.device_get(packed))
        if (host[:, -1] != 0).any():
            host = None
    if host is None:
        # no enumerable schedule: the exact scan answers everything
        ld, li = sharded_linear_search(mesh, index.codes, queries, k,
                                       n_total=index.n)
        z = np.zeros(nq, np.int32)
        return SearchResult(dists=np.asarray(ld), ids=np.asarray(li),
                            radius=z, n_probes=z, n_nonempty=z, n_cands=z)

    pd, pi = host[:, :pool_size], host[:, pool_size:2 * pool_size]
    cols = host[:, 2 * pool_size:]
    dists = pd[:, :k].copy()
    ids = pi[:, :k].copy()
    radius = cols[:, 1].copy()
    overflow = cols[:, 2] != 0
    not_done = cols[:, 0] == 0
    n_probes, n_nonempty, n_cands = cols[:, 3], cols[:, 4], cols[:, 5]

    redo = overflow & ~not_done
    base_cap = _cap or scfg.candidate_cap
    if redo.any():
        if base_cap < index.n:
            idxs = np.nonzero(redo)[0]
            nq_ax = mesh.shape["query"]
            n_pad = (-len(idxs)) % nq_ax
            take = np.concatenate([idxs, np.repeat(idxs[:1], n_pad)])
            sub = sharded_compact_search(
                index, np.asarray(queries)[take], scfg,
                _cap=min(base_cap * 4, max(index.n, 8)))
            dists[idxs] = sub.dists[:len(idxs)]
            ids[idxs] = sub.ids[:len(idxs)]
            radius[idxs] = sub.radius[:len(idxs)]
        else:
            not_done = not_done | redo  # exactness: never drop the flag

    if not_done.any():
        idxs = np.nonzero(not_done)[0]
        ld, li = sharded_linear_search(mesh, index.codes, queries, k,
                                       n_total=index.n)
        dists[idxs] = np.asarray(ld)[idxs]
        ids[idxs] = np.asarray(li)[idxs]

    return SearchResult(dists=dists, ids=ids, radius=radius,
                        n_probes=np.asarray(n_probes),
                        n_nonempty=np.asarray(n_nonempty),
                        n_cands=np.asarray(n_cands))
