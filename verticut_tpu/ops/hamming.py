"""Batched Hamming-distance scan engines.

Two formulations of the brute-force scan (``src/linear_search.cc:39-64``):

* ``scan_popcount`` — XOR + ``lax.population_count`` over packed uint32
  words (4 words per 128-bit code): 16 B per DB code. The independent
  oracle.
* ``scan_matmul`` — unpack codes to ±1 vectors and run a ``[Q, B] x [B, N]``
  GEMM (``dist = (B - dot)/2``) on the tensor cores.

Both chunk the DB along N inside ``lax.scan`` (static shapes; running
bounded top-k carried through the scan).

* ``scan_blockmin`` — the production scan: per-block minima from the ±1
  GEMM (a fused Pallas-Triton kernel on the GPU), a fold over the blocks,
  and an exact rescore of the k best blocks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from verticut_tpu import codes as codes_lib
from verticut_tpu.ops import topk


def _merge(pool, cd, ci, n, bits):
    if topk.can_pack(n - 1, bits):
        return topk.merge_topk_packed(pool[0], pool[1], cd, ci)
    # >2^24-id path: the native two-key lax.sort merge (safe in any
    # program context, unlike the sorting networks it replaced; see the
    # ops/topk wide-selection comment). Only serves >16.7M-row
    # popcount/matmul scans — scan_blockmin (no _merge) is the scale
    # engine.
    return topk.merge_topk(pool[0], pool[1], cd, ci)


def _pad_db(db: jax.Array, chunk: int):
    n = db.shape[0]
    n_pad = (-n) % chunk
    if n_pad:
        out = jnp.zeros((n + n_pad, db.shape[1]), db.dtype)
        db = jax.lax.dynamic_update_slice(out, db, (0, 0))
    return db, n


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def scan_popcount(queries: jax.Array, db: jax.Array, k: int,
                  chunk: int = 65536):
    """Exact top-k via popcount scan. ``[Q, W], [N, W] -> ([Q,k], [Q,k])``."""
    db_p, n = _pad_db(db, chunk)
    n_chunks = db_p.shape[0] // chunk
    db_c = db_p.reshape(n_chunks, chunk, db.shape[-1])
    pool = topk.empty_pool(queries.shape[0], k)

    def body(pool, args):
        chunk_codes, base = args
        d = codes_lib.pairwise_hamming(queries, chunk_codes)
        cd, ci = topk.chunk_topk_affine(d, base, k, n - base)
        return _merge(pool, cd, ci, n, db.shape[-1] * 32), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (pd, pi), _ = jax.lax.scan(body, pool, (db_c, bases))
    return pd, pi


def use_scan_kernel(platform: str) -> bool:
    """Whether pass 1 of :func:`scan_blockmin` runs the fused Pallas-Triton
    kernel (ops/pallas/blockmin.py) on a JAX platform: on ``"gpu"``; the
    plain XLA formulation runs anywhere else (the CPU the tests run on).
    Read when scan_blockmin is traced."""
    return platform == "gpu"


#: cap on corpus rows per pass-1 call
CHUNK_MAX = 4 * 1024 * 1024

#: cap on Q * rows of the XLA pass 1's float32 distance slab (2 GB)
XLA_SLAB = 1 << 29

#: cap on Q * (chunk/block), the per-chunk selection operand; the
#: select_desc ladder materializes ~3 uint32 copies of it, so 2^27 keys
#: bound the fold's temporaries at ~1.6 GB
TARGET_KEYS = 1 << 27


def _pick_chunk(nfull: int, block: int, q: int, max_rows: int) -> int:
    """Rows per pass-1 call: the largest power-of-two multiple of ``block``
    that fits in the ``nfull`` whole blocks and in ``max_rows``, and keeps
    the selection operand ``q * (chunk/block)`` under TARGET_KEYS."""
    cb = 1
    while (2 * cb <= nfull and 2 * cb * block <= max_rows
           and q * 2 * cb <= TARGET_KEYS):
        cb *= 2
    return cb * block


def _blockmin_xla(q_pm: jax.Array, rows: jax.Array, block: int) -> jax.Array:
    """Plain-XLA pass 1 and the kernel's reference: ``±1[Q, B] x
    uint32[R, W] -> int32[Q, R/block]`` per-block Hamming minima (one GEMM
    into a float32 [Q, R] slab, then a block reduction)."""
    bits = q_pm.shape[1]
    dot = jax.lax.dot_general(
        q_pm, codes_lib.unpack_bits_pm1(rows),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    d = ((bits - dot) * 0.5).astype(jnp.int32)
    return jnp.min(d.reshape(q_pm.shape[0], -1, block), axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "block", "interpret"))
def scan_blockmin(queries: jax.Array, db: jax.Array, k: int,
                  block: int = 512, interpret: bool = False):
    """Exact top-k via block-min pre-selection.

    Any per-chunk ``top_k`` over the [Q, N] distance matrix is a sort of
    the full width; a reduction is not. So: reduce first, sort almost
    nothing.

    1. Pass 1 computes per-``block`` distance minima of every whole block
       with the ±1 GEMM (``dist = (B - dot)/2``) — the Pallas-Triton kernel
       where :func:`use_scan_kernel` says so (``interpret`` runs it in the
       Pallas interpreter), the XLA formulation elsewhere.
       Chunks of whole blocks fold into a ``[Q, kb]`` carry of packed
       (min, block-idx) keys, so peak memory is bounded by TARGET_KEYS at
       any corpus size. The straddling tail block's minimum is computed
       exactly over its valid rows with popcount.
    2. The fold keeps the k blocks with the smallest minima. These provably
       contain the exact (dist, id)-lexicographic top-k: if winner w
       (rank <= k) sat in an unchosen block, each of the k chosen blocks
       would hold an element with smaller blk_min — i.e. strictly smaller
       distance, or equal distance in an earlier-indexed block and hence
       smaller id — giving k elements ordered before w, contradicting
       rank(w) <= k.
    3. Gather just those k code blocks (k*block*16 B per query), rescore
       with XOR+popcount, and select over the narrow [Q, k*block] strip.

    Reads the row-major ``uint32[N, W]`` corpus in place: no padded or
    transposed copy.
    """
    q, w = queries.shape
    bits = w * 32
    n = db.shape[0]
    nfull, rem = divmod(n, block)
    nb_valid = nfull + (1 if rem else 0)
    kb = min(k, nb_valid)
    idx_bits = max(1, (nb_valid - 1).bit_length())
    if (bits + 1).bit_length() + idx_bits > 32:
        raise ValueError(f"(bits={bits}, blocks={nb_valid}) keys do not "
                         "pack into uint32")
    mask_i = jnp.uint32((1 << idx_bits) - 1)

    def keys_of(dmin, gidx):
        return ~((jnp.clip(dmin, 0, bits + 1).astype(jnp.uint32)
                  << idx_bits) | gidx)

    top = jnp.zeros((q, kb), jnp.uint32)
    if nfull:
        kernel = use_scan_kernel(jax.default_backend())
        if kernel:
            from verticut_tpu.ops.pallas import blockmin as kern
            q_pm = kern.unpack_queries(queries)
        else:
            q_pm = codes_lib.unpack_bits_pm1(queries)
        ch = _pick_chunk(nfull, block, q, CHUNK_MAX if kernel
                         else min(CHUNK_MAX, XLA_SLAB // q))
        cb = ch // block
        last = nfull * block - ch

        def body(c, carry):
            # the last chunk is pulled back to end at the last whole block;
            # blocks it shares with the previous chunk are masked to the
            # 0 sentinel so no block is selected twice
            start = jnp.minimum(c * ch, last)
            rows = jax.lax.dynamic_slice(db, (start, 0), (ch, w))
            if kernel:
                bm = kern.blockmin_pass1(q_pm, rows, block=block,
                                         interpret=interpret)[:q]
            else:
                bm = _blockmin_xla(q_pm, rows, block)
            gidx = (jax.lax.broadcasted_iota(jnp.uint32, (1, cb), 1)
                    + (start // block).astype(jnp.uint32))
            keys = jnp.where(gidx < (c * cb).astype(jnp.uint32),
                             jnp.uint32(0), keys_of(bm, gidx))
            return topk.select_desc(jnp.concatenate([carry, keys], axis=-1),
                                    kb)

        top = jax.lax.fori_loop(0, -(-nfull // cb), body, top)
    if rem:
        tail = db[nfull * block:]                          # [rem, W]
        td = jnp.min(jnp.sum(jax.lax.population_count(
            tail[None, :, :] ^ queries[:, None, :]).astype(jnp.int32),
            axis=-1), axis=-1)                             # [Q]
        top = topk.select_desc(jnp.concatenate(
            [top, keys_of(td, jnp.uint32(nfull))[:, None]], axis=-1), kb)
    # nb_valid >= kb and every valid block emits a nonzero key, so the
    # zero init sentinels cannot survive the fold
    bidx = ((~top) & mask_i).astype(jnp.int32)
    return _rescore_blocks(queries, db, bidx, k, block)


def _rescore_blocks(queries, db, bidx, k: int, block: int):
    """Gather the selected blocks, rescore exactly with popcount, select
    the (dist, id)-lexicographic top-k over the narrow strip."""
    q, w = queries.shape
    n = db.shape[0]
    kb = bidx.shape[1]
    if n < block:
        db = jnp.zeros((block, w), db.dtype).at[:n].set(db)
    bidx = jnp.sort(bidx, axis=-1)                        # ascending pos
    # a slice may not run past the corpus, so the straddling block's
    # slice starts early; rows before the block's own start are masked
    start = jnp.minimum(bidx * block, db.shape[0] - block)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(2, 3), collapsed_slice_dims=(), start_index_map=(0,))
    g = jax.lax.gather(db, start[..., None], dn, slice_sizes=(block, w),
                       mode=jax.lax.GatherScatterMode.CLIP)
    d = jnp.sum(jax.lax.population_count(
        g ^ queries[:, None, None, :]).astype(jnp.int32), axis=-1)
    pos = start[:, :, None] + jax.lax.broadcasted_iota(
        jnp.int32, (1, 1, block), 2)                      # [Q, kb, block]
    valid = (pos >= (bidx * block)[:, :, None]) & (pos < n)
    d = jnp.where(valid, d, topk.INF_DIST).reshape(q, kb * block)
    pos = pos.reshape(q, kb * block)

    # final selection on the narrow strip; the local index packs under
    # dist (valid in-strip order == ascending global position) and the
    # sentinel 0x7FFFFFFF (int32 max) sorts last, so plain int32 top_k is
    # exact
    li_bits = max(1, (kb * block - 1).bit_length())
    li = jax.lax.broadcasted_iota(jnp.int32, (1, kb * block), 1)
    sent = 0x7FFFFFFF  # dist <= 512 and li_bits <= 19: sign bit stays 0
    packed = jnp.where(d < topk.INF_DIST, (d << li_bits) | li, sent)
    kk = min(k, kb * block)
    top = (~topk.select_desc(~packed.astype(jnp.uint32), kk)).astype(jnp.int32)
    invalid = top == sent
    sel_li = top & ((1 << li_bits) - 1)
    out_d = jnp.where(invalid, topk.INF_DIST, top >> li_bits)
    out_i = jnp.where(invalid, topk.INVALID_ID,
                      jnp.take_along_axis(pos, jnp.clip(sel_li, 0), axis=-1))
    if kk < k:
        out_d = jnp.pad(out_d, ((0, 0), (0, k - kk)),
                        constant_values=int(topk.INF_DIST))
        out_i = jnp.pad(out_i, ((0, 0), (0, k - kk)), constant_values=-1)
    return out_d, out_i


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def scan_matmul(queries: jax.Array, db: jax.Array, k: int,
                chunk: int = 32768):
    """Exact top-k via the ±1 GEMM formulation.

    Unpacks each DB chunk to bf16 ±1 on the fly (device-memory reads stay
    packed; the unpack fuses into the producer side of the GEMM under XLA).
    """
    bits = db.shape[-1] * 32
    qpm = codes_lib.unpack_bits_pm1(queries)          # [Q, B]
    db_p, n = _pad_db(db, chunk)
    n_chunks = db_p.shape[0] // chunk
    db_c = db_p.reshape(n_chunks, chunk, db.shape[-1])
    pool = topk.empty_pool(queries.shape[0], k)

    def body(pool, args):
        chunk_codes, base = args
        dpm = codes_lib.unpack_bits_pm1(chunk_codes)  # [T, B]
        dot = jax.lax.dot_general(
            qpm, dpm, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        d = ((bits - dot) * 0.5).astype(jnp.int32)
        cd, ci = topk.chunk_topk_affine(d, base, k, n - base)
        return _merge(pool, cd, ci, n, bits), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (pd, pi), _ = jax.lax.scan(body, pool, (db_c, bases))
    return pd, pi
