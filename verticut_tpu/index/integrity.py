"""Vectorized index integrity checking — the ``integrity-check`` binary
analog (``src/integrity_check.cc:37-70``) rebuilt for 100M+ scale.

The reference walks every code, re-looks-up its bucket, and scans the
bucket for the (id, code) pair — compiled C++ over the full corpus. The
r1-r3 tool here did the same walk in interpreted Python (hopeless past
~1M). This module replaces the per-code membership loop with whole-table
device programs built on one invariant: the entry arrays ARE the stable
``(substring, id)`` sort of the corpus (``index/mih._build_table``), and
every directory is a function of that sorted column. So:

1. recompute the ground-truth sort ``(sk, si)`` from the code array
   (same device sort the build uses — an independent execution, which is
   what an integrity check can ever verify: stored state == freshly
   derived state);
2. compare the stored id column (flat, inline-blocked, or compact-blocked
   layout) elementwise against ``si`` — this simultaneously checks
   presence, multiplicity, bucket order, and the bucket-internal
   ascending-id invariant (reference append order);
3. for inline (id, code) rows, re-gather ``codes[si]`` in bounded chunks
   and compare every code word;
4. recompute each directory's offsets/keys from ``sk`` and compare.

Together 2-4 imply the reference's per-code check (every (id, code) pair
present exactly once in the bucket its substring maps to) — and they run
as a handful of device programs instead of one host check per code.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from verticut_tpu import codes as codes_lib
from verticut_tpu.config import MIHConfig
from verticut_tpu.index import directory as dir_lib
from verticut_tpu.index.mih import (ID_ROW_BLOCK, MIHIndex, MIHTable,
                                    entry_block_size)


@functools.partial(jax.jit, donate_argnums=(0,))
def _sort_pairs(subs):
    n = subs.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.sort((subs, ids), num_keys=2)


@functools.partial(jax.jit, static_argnames=("blk",))
def _count_id_mismatch_blocked(stored_rows, si, *, blk: int):
    """stored_rows[:, :blk] (uint32 ids, pad 0xFFFFFFFF) vs ground truth
    ``si`` (int32[n]) — count mismatching positions."""
    nb = stored_rows.shape[0]
    npad = nb * blk
    n = si.shape[0]
    truth = jnp.full((npad,), jnp.uint32(0xFFFFFFFF))
    truth = truth.at[:n].set(si.astype(jnp.uint32))
    truth_b = truth.reshape(nb, blk)          # 1-D -> 2-D: safe reshape
    return jnp.sum((stored_rows[:, :blk] != truth_b).astype(jnp.int32))


@jax.jit
def _count_id_mismatch_flat(stored_ids, si):
    return jnp.sum((stored_ids.astype(jnp.int32) != si).astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("chunk_rows",))
def _count_code_mismatch_rows(entry_rows, codes_arr, si, *,
                              chunk_rows: int):
    """Inline rows: words 1..W of every entry must equal codes[si].

    Chunked ``fori_loop`` (the build's assembly discipline in reverse) so
    the gathered-code transient stays bounded at 100M."""
    nb, lanes = entry_rows.shape
    n, w = codes_arr.shape
    blk = lanes // (1 + w)
    n_valid = si.shape[0]
    npad = nb * blk
    truth = jnp.full((npad,), jnp.uint32(0xFFFFFFFF))
    truth = truth.at[:n_valid].set(si.astype(jnp.uint32))

    cr = min(chunk_rows, nb)

    def body(c, bad):
        # clamp the final chunk's start: the overlap re-checks rows
        # already verified — harmless for a checker (both slices clamp
        # to the same row offset, so they stay aligned)
        r0 = jnp.minimum(c * cr, nb - cr)
        rows = jax.lax.dynamic_slice(entry_rows, (r0, 0), (cr, lanes))
        idc = jax.lax.dynamic_slice(truth, (r0 * blk,), (cr * blk,))
        g = codes_arr[jnp.clip(idc, 0, n - 1).astype(jnp.int32)]
        valid = idc != jnp.uint32(0xFFFFFFFF)
        for j in range(w):
            stored_w = rows[:, (1 + j) * blk:(2 + j) * blk].reshape(-1)
            bad = bad + jnp.sum(
                (valid & (stored_w != g[:, j])).astype(jnp.int32))
        return bad

    return jax.lax.fori_loop(0, -(-nb // cr), body, jnp.int32(0))


def _directory_mismatches(d, sk: jax.Array, n: int) -> int:
    """Recompute the directory from the sorted key column and diff."""
    if isinstance(d, dir_lib.RangeDirectory):
        shift = d.shift
        pbits = d.pbits

        @jax.jit
        def chk(sk, se):
            prefixes = (sk >> jnp.uint32(shift)).astype(jnp.uint32)
            grid = jnp.arange((1 << pbits) + 1,
                              dtype=jnp.int32).astype(jnp.uint32)
            offs = jnp.searchsorted(prefixes, grid,
                                    side="left").astype(jnp.int32)
            want = jnp.stack([offs[:-1], offs[1:]], axis=-1)
            return jnp.sum((want != se).astype(jnp.int32))

        return int(chk(sk, d.se))
    if isinstance(d, dir_lib.DenseDirectory):
        s_bits = d.s_bits

        @jax.jit
        def chk(sk, offsets):
            grid = jnp.arange((1 << s_bits) + 1,
                              dtype=jnp.int32).astype(jnp.uint32)
            offs = jnp.searchsorted(sk, grid, side="left").astype(jnp.int32)
            return jnp.sum((offs != offsets).astype(jnp.int32))

        return int(chk(sk, d.offsets))
    if isinstance(d, dir_lib.SortedDirectory):
        return int(jnp.sum((d.keys != sk).astype(jnp.int32)))
    if isinstance(d, dir_lib.PrefixDirectory):
        bad = int(jnp.sum((d.keys != sk).astype(jnp.int32)))
        bad += int(jnp.sum((d.run_end
                            != dir_lib.compute_run_end(sk))
                           .astype(jnp.int32)))
        pbits = d.prefix_offsets.shape[0].bit_length() - 1
        prefixes = (sk >> jnp.uint32(d.shift)).astype(jnp.uint32)
        grid = jnp.arange((1 << pbits) + 1,
                          dtype=jnp.int32).astype(jnp.uint32)
        offs = jnp.searchsorted(prefixes, grid, side="left").astype(jnp.int32)
        bad += int(jnp.sum((offs != d.prefix_offsets).astype(jnp.int32)))
        return bad
    if isinstance(d, dir_lib.HashDirectory):

        @jax.jit
        def chk(sk, rows):
            n = sk.shape[0]
            idx = jnp.arange(n, dtype=jnp.int32)
            is_first = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), sk[1:] != sk[:-1]])
            run_start = jax.lax.cummax(jnp.where(is_first, idx, 0))
            run_end = dir_lib.compute_run_end(sk)
            start, count = dir_lib.HashDirectory(rows).lookup(sk)
            ok = (start == run_start) & (count == run_end - run_start)
            return jnp.sum((~ok).astype(jnp.int32))

        return int(chk(sk, d.rows))
    raise TypeError(f"unknown directory type {type(d).__name__}")


def check_table(codes_arr: jax.Array, table: MIHTable, table_id: int,
                cfg: MIHConfig, chunk_entries: int = 5_000_000) -> dict:
    """Full integrity report for one table (device-side, exact counts)."""
    subs = codes_lib.substring(codes_arr, table_id, cfg.s_bits)
    sk, si = _sort_pairs(subs)

    id_bad = None
    code_bad = 0
    if table.entry_ids is not None:
        id_bad = int(_count_id_mismatch_flat(table.entry_ids, si))
    if table.entry_idrows is not None:
        b = int(_count_id_mismatch_blocked(table.entry_idrows, si,
                                           blk=ID_ROW_BLOCK))
        id_bad = b if id_bad is None else id_bad + b
    if table.entry_rows is not None:
        blk = entry_block_size(cfg.n_words)
        b = int(_count_id_mismatch_blocked(table.entry_rows, si, blk=blk))
        id_bad = b if id_bad is None else id_bad + b
        chunk_rows = max(1, chunk_entries // blk)
        code_bad = int(_count_code_mismatch_rows(
            table.entry_rows, codes_arr, si, chunk_rows=chunk_rows))
    if table.entry_codes is not None:
        # legacy per-entry code copies: compare in bounded chunks
        n = codes_arr.shape[0]
        bad = 0
        for lo in range(0, n, chunk_entries):
            hi = min(lo + chunk_entries, n)
            want = codes_arr[jnp.clip(si[lo:hi], 0, n - 1)]
            bad += int(jnp.sum(
                (table.entry_codes[lo:hi] != want).astype(jnp.int32)))
        code_bad += bad
    if id_bad is None:
        raise ValueError("table stores no id column in any layout")

    dir_bad = _directory_mismatches(table.directory, sk, codes_arr.shape[0])
    return {"table": table_id, "id_mismatches": id_bad,
            "code_mismatches": code_bad, "directory_mismatches": dir_bad,
            "ok": id_bad == 0 and code_bad == 0 and dir_bad == 0}


def check_index(index: MIHIndex,
                codes_arr: Optional[jax.Array] = None) -> dict:
    """Integrity report for a whole index. ``codes_arr`` overrides
    ``index.codes`` (for compact indexes whose codes live elsewhere)."""
    codes_arr = codes_arr if codes_arr is not None else index.codes
    if codes_arr is None:
        raise ValueError("integrity check needs the code array")
    reports = [check_table(codes_arr, t, i, index.cfg)
               for i, t in enumerate(index.tables)]
    return {"n": index.n, "tables": reports,
            "ok": all(r["ok"] for r in reports)}
