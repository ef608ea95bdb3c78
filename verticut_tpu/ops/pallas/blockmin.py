"""Pallas-Triton kernel: fused ±1 unpack + tensor-core GEMM + block minima.

Pass 1 of the block-min scan (:func:`verticut_tpu.ops.hamming.scan_blockmin`).
The plain XLA formulation (``hamming._blockmin_xla``) hands the ±1 product
to cuBLAS, which writes a float32 ``[Q, chunk]`` slab to device memory, and
then reads the slab back to take per-block minima: 8 B of traffic per
(query, code) pair against 256 tensor-core operations, far below the card's
operations-per-byte balance. This kernel keeps each dot tile in registers,
folds it into a running per-block maximum, and stores only the
``[Q, chunk/block]`` minima.

One program owns a ``_QT``-query tile and ``_ROWS`` consecutive corpus rows
(whole blocks). It loads the query tile once and loops over its blocks and,
inside each block, over ``_TT``-row sub-tiles: load ``[TT, W]`` packed words
straight off the row-major corpus, unpack them to ±1 in registers, ``dot``
with the query tile, fold the row maxima. Grid axis 0 is the query tile, the
fastest-varying launch index, so all query tiles of one corpus run are
scheduled together and the corpus is read from device memory about once per
batch. Nothing carries between programs.

Pad and tail semantics are the caller's: the kernel scores every row it is
given, so rows past the valid count must be masked by the caller
(scan_blockmin never passes them).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from verticut_tpu import codes as codes_lib

#: corpus rows per inner GEMM sub-tile
_TT = 128
#: corpus rows per program (a power-of-two multiple of every block size)
_ROWS = 4096
#: largest query tile; small batches take the next power of two >= 16
_QT = 128


def q_tile(q: int) -> int:
    """Query-tile height for a batch of ``q`` queries (a power of two in
    [16, _QT]; 16 is the smallest dot operand the tensor cores take)."""
    return min(_QT, max(16, 1 << max(0, q - 1).bit_length()))


def rows_per_program(chunk: int) -> int:
    """Corpus rows per program for a ``chunk``-row call: ``_ROWS``, or the
    whole chunk when it is shorter (chunk is a power-of-two multiple of
    the block, so either divides it)."""
    return min(_ROWS, chunk)


def _kernel(q_ref, d_ref, o_ref, *, bits: int, block: int, tt: int):
    q = q_ref[...]                                         # [QT, B] ±1
    qt = q.shape[0]
    w = d_ref.shape[1]
    shifts = jax.lax.broadcasted_iota(jnp.uint32, (1, 1, 32), 2)

    def one_block(b, carry):
        def sub(s, mx):
            words = d_ref[pl.ds(b * block + s * tt, tt), :]        # [TT, W]
            bit = (words[:, :, None] >> shifts) & jnp.uint32(1)
            dpm = (2 * bit.astype(jnp.int8) - 1).reshape(tt, w * 32)
            dot = pl.dot(q, dpm, trans_b=True)          # int32 [QT, TT]
            return jnp.maximum(mx, jnp.max(dot, axis=1))

        mx = jax.lax.fori_loop(0, block // tt, sub,
                               jnp.full((qt,), -bits, jnp.int32))
        o_ref[:, pl.ds(b, 1)] = ((bits - mx) // 2)[:, None]
        return carry

    jax.lax.fori_loop(0, o_ref.shape[1], one_block, 0)


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def blockmin_pass1(q_pm: jax.Array, db: jax.Array, block: int,
                   interpret: bool = False) -> jax.Array:
    """``int8 ±1[Qp, B] x uint32[R, W] -> int32[Qp, R/block]`` per-block
    Hamming minima of every row of ``db``.

    ``q_pm`` comes from :func:`unpack_queries`; ``R`` is a power-of-two
    multiple of ``block``, which is a multiple of the sub-tile."""
    qp, bits = q_pm.shape
    r, w = db.shape
    qt = q_tile(qp)
    rows = rows_per_program(r)
    if (qp % qt or bits != 32 * w or block % _TT or rows % block
            or r % rows):
        raise ValueError(f"bad shapes q={qp} bits={bits} rows={r} "
                         f"block={block}")
    return pl.pallas_call(
        functools.partial(_kernel, bits=bits, block=block, tt=_TT),
        grid=(qp // qt, r // rows),
        in_specs=[pl.BlockSpec((qt, bits), lambda i, j: (i, 0)),
                  pl.BlockSpec((rows, w), lambda i, j: (j, 0))],
        out_specs=pl.BlockSpec((qt, rows // block), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((qp, r // block), jnp.int32),
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=3),
        backend="triton",
        interpret=interpret,
        name="blockmin_pass1",
    )(q_pm, db)


def unpack_queries(queries: jax.Array) -> jax.Array:
    """int8 ±1 query operand for :func:`blockmin_pass1`, padded with copies
    of row 0 to a multiple of the query tile.

    int8 with int32 accumulation is exact for ±1 operands (|dot| <= B) and
    ran ~10% faster than bf16 on an H100 (see PERF.md)."""
    q = queries.shape[0]
    pad = (-q) % q_tile(q)
    if pad:
        queries = jnp.concatenate(
            [queries, jnp.broadcast_to(queries[:1], (pad, queries.shape[1]))])
    return codes_lib.unpack_bits_pm1(queries, jnp.int8)
