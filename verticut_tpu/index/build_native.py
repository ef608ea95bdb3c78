"""Host-native index build: C++ radix sort feeding device arrays.

The production-scale path for corpora where a device-side ``lax.sort`` of
N rows is wasteful or doesn't fit alongside the final index (SURVEY §3.1:
the reference builds by streaming every code through the KV store; we build
CSR columns on host at memory bandwidth and upload once).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from verticut_tpu import native
from verticut_tpu.config import MIHConfig
from verticut_tpu.index import directory as dir_lib
from verticut_tpu.index.bitmap import Bitmap
from verticut_tpu.index.mih import (MIHIndex, MIHTable, _row_width,
                                    entry_block_size, entry_row_align)


def _host_range_dir(keys: np.ndarray, s_bits: int,
                    blk: int = 16) -> dir_lib.RangeDirectory:
    """Range directory from the sorted host key column: a bincount over
    prefixes + prefix-sum (no per-key search)."""
    pbits = dir_lib.pick_range_pbits(len(keys), s_bits, blk)
    shift = s_bits - pbits
    cnt = np.bincount((keys >> np.uint32(shift)).astype(np.int64),
                      minlength=1 << pbits)
    offs = np.zeros((1 << pbits) + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    se = np.stack([offs[:-1], offs[1:]], axis=-1).astype(np.int32)
    return dir_lib.RangeDirectory(se=jnp.asarray(se), s_bits=s_bits)


def _host_entry_rows(ids: np.ndarray, codes_arr: np.ndarray) -> np.ndarray:
    """Blocked word-major (id, code) rows on host (mih.MIHTable.entry_rows)."""
    n, w = len(ids), codes_arr.shape[-1]
    rw = _row_width(w)
    blk = entry_block_size(w)
    align = entry_row_align(w)
    npad = -(-max(n, 1) // align) * align
    rows = np.zeros((npad, rw), np.uint32)
    rows[n:, 0] = 0xFFFFFFFF
    rows[:n, 0] = ids.astype(np.uint32)
    rows[:n, 1:1 + w] = native.gather_rows(codes_arr, ids)
    return np.ascontiguousarray(
        rows.reshape(npad // blk, blk, rw).transpose(0, 2, 1)
    ).reshape(npad // blk, blk * rw)


def _host_entry_idrows(ids: np.ndarray) -> np.ndarray:
    """Blocked id-only rows (compact mode; mih.MIHTable.entry_idrows)."""
    from verticut_tpu.index.mih import ID_ROW_ALIGN, ID_ROW_BLOCK
    n = len(ids)
    npad = -(-max(n, 1) // ID_ROW_ALIGN) * ID_ROW_ALIGN
    out = np.full(npad, 0xFFFFFFFF, np.uint32)
    out[:n] = ids.astype(np.uint32)
    return out.reshape(npad // ID_ROW_BLOCK, ID_ROW_BLOCK)


def build_index_native(codes_arr: np.ndarray, cfg: MIHConfig = MIHConfig(),
                       dense_threshold: int = 24, store_codes: bool = True,
                       with_bitmap: bool = False, keep_codes: bool = True,
                       directory: str = "auto",
                       keep_entry_ids: bool = True) -> MIHIndex:
    codes_arr = np.ascontiguousarray(codes_arr, np.uint32)
    n = codes_arr.shape[0]
    if codes_arr.shape[-1] != cfg.n_words:
        raise ValueError(
            f"codes have {codes_arr.shape[-1]} words, config wants "
            f"{cfg.n_words}")
    if directory == "auto":
        directory = "dense" if cfg.s_bits <= dense_threshold else "range"
    if directory == "range" and not store_codes and not keep_codes:
        raise ValueError("compact range mode needs the shared code array "
                         "(keep_codes=True) to score candidates")
    tables = []
    for t in range(cfg.n_tables):
        keys, ids = native.build_csr(codes_arr, t, cfg.s_bits)
        entry_codes = entry_rows = entry_idrows = None
        if directory == "dense":
            d = dir_lib.build_dense(jnp.asarray(keys), cfg.s_bits)
        elif directory == "range":
            from verticut_tpu.index.mih import ID_ROW_BLOCK
            d = _host_range_dir(
                keys, cfg.s_bits,
                entry_block_size(cfg.n_words) if store_codes
                else ID_ROW_BLOCK)
        elif directory == "hash":  # cuckoo rows from the host key column
            d = dir_lib.HashDirectory(
                rows=jnp.asarray(native.build_hashdir(keys)))
        else:
            raise ValueError(f"unknown directory kind {directory!r}")
        if directory == "range":
            if store_codes:
                entry_rows = jnp.asarray(_host_entry_rows(ids, codes_arr))
            else:
                entry_idrows = jnp.asarray(_host_entry_idrows(ids))
        elif store_codes:
            entry_codes = jnp.asarray(native.gather_rows(codes_arr, ids))
        bmp = (Bitmap(words=jnp.asarray(native.build_bitmap(keys, cfg.s_bits)))
               if with_bitmap else None)
        tables.append(MIHTable(
            entry_ids=jnp.asarray(ids) if keep_entry_ids else None,
            entry_codes=entry_codes, directory=d, bitmap=bmp,
            entry_rows=entry_rows, entry_idrows=entry_idrows))
    codes_dev = jnp.asarray(codes_arr) if keep_codes else None
    return MIHIndex(cfg=cfg, tables=tables, n=n, codes=codes_dev)
