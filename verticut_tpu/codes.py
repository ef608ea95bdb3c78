"""Packed binary-code arrays and bit manipulation.

A binary code of B bits is stored as ``uint32[B//32]`` words, word ``w``
holding bytes ``4w..4w+3`` of the on-disk code in little-endian order. This
makes word ``t`` of a 128-bit code exactly the reference's substring value
``binaryToInt(code + t*4, 4)`` (``Pilaf/image_tools.h:12-18``: little-endian
byte composition), so bucket indices here match the C++ index bit-for-bit.

All functions are jit-safe and shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


# --------------------------------------------------------------------------
# Packing / unpacking (host-side helpers use numpy; device fns use jnp)
# --------------------------------------------------------------------------

def pack_bytes(raw: np.ndarray) -> np.ndarray:
    """Pack ``uint8[N, nbytes]`` code bytes into ``uint32[N, nbytes//4]``.

    Byte ``4w+j`` becomes bits ``8j..8j+7`` of word ``w`` (little-endian,
    matching ``binaryToInt``'s composition order).
    """
    raw = np.asarray(raw, dtype=np.uint8)
    if raw.ndim == 1:
        raw = raw[None]
    n, nbytes = raw.shape
    if nbytes % 4:
        raise ValueError(f"code byte length {nbytes} not a multiple of 4")
    b = raw.reshape(n, nbytes // 4, 4).astype(np.uint32)
    # shift-or, not a matmul: numpy integer matmul has no BLAS kernel and
    # is ~50x slower at corpus scale
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def unpack_to_bytes(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_bytes`: ``uint32[N, W]`` → ``uint8[N, 4W]``."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.array([0, 8, 16, 24], dtype=np.uint32)
    b = (words[..., None] >> shifts) & np.uint32(0xFF)
    return b.reshape(*words.shape[:-1], words.shape[-1] * 4).astype(np.uint8)


def random_codes(seed: int, n: int, bits: int = 128) -> np.ndarray:
    """Uniform random packed codes ``uint32[n, bits//32]`` (host-side)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, bits // 32), dtype=np.uint32)


def clustered_codes(seed: int, n: int, bits: int = 128,
                    n_clusters: int = 64, flip_p: float = 0.05) -> np.ndarray:
    """Codes clustered around random centers — a more realistic (LSH-like)
    distribution than uniform for recall/latency testing.

    Chunked, byte-granular generation: each bit flips with probability
    round(flip_p*256)/256, so 100M-scale corpora generate at memory
    bandwidth instead of materializing n*bits float64 randoms.
    """
    rng = np.random.default_rng(seed)
    nbytes = bits // 8
    w = nbytes // 4
    centers = pack_bytes(
        rng.integers(0, 256, size=(n_clusters, nbytes), dtype=np.uint8))
    assign = rng.integers(0, n_clusters, size=n)
    out = centers[assign].copy()           # uint32[n, w]
    # sample flip positions: Binomial count per row, positions with
    # replacement, XOR-scattered into the packed words (duplicate positions
    # cancel; at p<=0.05 the effective rate differs from Bernoulli by
    # O(p^2), irrelevant for benchmarking)
    counts = rng.binomial(bits, flip_p, size=n)
    total = int(counts.sum())
    row = np.repeat(np.arange(n, dtype=np.int64), counts)
    pos = rng.integers(0, bits, size=total)
    flat = out.reshape(-1)
    idx = row * w + (pos >> 5)
    vals = (np.uint32(1) << (pos & 31)).astype(np.uint32)
    # grouped XOR via sort+reduceat (ufunc.at is ~100x slower)
    order = np.argsort(idx, kind="stable")
    sidx, svals = idx[order], vals[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], sidx[1:] != sidx[:-1]]))
    if len(sidx):
        flat[sidx[starts]] ^= np.bitwise_xor.reduceat(svals, starts)
    return out


def clustered_codes_device(seed: int, n: int, bits: int = 128,
                           n_clusters: int = 64,
                           flip_p: float = 0.05) -> jax.Array:
    """Device-side clustered-code generator (same distribution family as
    :func:`clustered_codes`: random centers, per-bit Bernoulli flips at
    round(flip_p*256)/256). At 100M codes the host generator and the
    upload would dominate set-up; this one runs at device speed.
    """
    import functools

    import jax.random as jr
    w = bits // 32
    thresh = max(1, round(flip_p * 256))
    chunk = min(n, 4 * 1024 * 1024)
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk

    # ONE jitted program: chunked fori_loop writing into the output carry.
    # Chunking bounds the [R, bits] random-byte transient; doing it inside
    # a single program (rather than eager per-chunk calls) writes the big
    # [n, w] array once, in place.
    @functools.partial(jax.jit, static_argnames=("rows", "total"))
    def gen_all(key, rows, total):
        k0, k1 = jr.split(key)
        centers = jr.bits(k0, (n_clusters, w), jnp.uint32)
        keys = jr.split(k1, total // rows)
        shifts = jnp.arange(32, dtype=jnp.uint32)

        def body(i, out):
            ka, kb = jr.split(keys[i])
            assign = jr.randint(ka, (rows,), 0, n_clusters, jnp.int32)
            base = centers[assign]                           # [R, w]
            # per-bit Bernoulli(thresh/256) via one random byte per bit
            rb = jr.randint(kb, (rows, bits), 0, 256, jnp.uint8)
            fb = (rb < thresh).astype(jnp.uint32).reshape(rows, w, 32)
            part = base ^ jnp.sum(fb << shifts, axis=-1, dtype=jnp.uint32)
            return jax.lax.dynamic_update_slice(
                out, part, (i * rows, 0))

        out = jnp.zeros((total, w), jnp.uint32)
        return jax.lax.fori_loop(0, total // rows, body, out)

    out = gen_all(jr.PRNGKey(seed), chunk, n_pad)
    return out if n_pad == n else out[:n]


@functools.partial(jax.jit, static_argnames=("n_queries", "n_flips"))
def perturbed_queries_device(key: jax.Array, corpus: jax.Array,
                             n_queries: int, n_flips: int = 3) -> jax.Array:
    """``n_queries`` uniformly drawn corpus rows, each with ``n_flips``
    uniformly drawn bit positions flipped (a repeated position flips
    back): queries with a planted neighbour at distance <= n_flips."""
    import jax.random as jr
    n, w = corpus.shape
    k_row, k_pos = jr.split(key)
    rows = corpus[jr.randint(k_row, (n_queries,), 0, n)]
    pos = jr.randint(k_pos, (n_queries, n_flips), 0, 32 * w)
    word = jax.lax.broadcasted_iota(jnp.int32, (1, 1, w), 2)
    terms = jnp.where(pos[:, :, None] // 32 == word,
                      jnp.uint32(1) << (pos[:, :, None] % 32).astype(
                          jnp.uint32),
                      jnp.uint32(0))                       # [Q, F, W]
    for f in range(n_flips):
        rows = rows ^ terms[:, f]
    return rows


# --------------------------------------------------------------------------
# Substring extraction (the hash-table bucket index)
# --------------------------------------------------------------------------

def substring(codes: jax.Array, table_id: int, s_bits: int) -> jax.Array:
    """Extract substring ``table_id`` (width ``s_bits``) from packed codes.

    Reference semantics: ``binaryToInt(code + table_id*substr_len, substr_len)``
    (``src/build_hash_tables.cc:45``, ``src/search_worker.cc:101``): take
    ``s_bits//8`` consecutive bytes starting at byte ``table_id*s_bits//8``,
    compose little-endian. ``s_bits`` must be a multiple of 8 and ≤ 32.

    Works on any ``uint32[..., W]`` array; returns ``uint32[...]``.
    """
    if s_bits % 8 or s_bits > 32:
        raise ValueError(f"s_bits must be a multiple of 8 and <= 32: {s_bits}")
    if s_bits == 32:
        return codes[..., table_id]
    s_bytes = s_bits // 8
    start = table_id * s_bytes
    val = jnp.zeros(codes.shape[:-1], jnp.uint32)
    for j in range(s_bytes):
        byte_idx = start + j
        word = codes[..., byte_idx // 4]
        byte = (word >> jnp.uint32((byte_idx % 4) * 8)) & jnp.uint32(0xFF)
        val = val | (byte << jnp.uint32(8 * j))
    return val


def all_substrings(codes: jax.Array, n_tables: int) -> jax.Array:
    """``uint32[..., W] -> uint32[..., n_tables]``: every table's substring."""
    s_bits = codes.shape[-1] * 32 // n_tables
    return jnp.stack(
        [substring(codes, t, s_bits) for t in range(n_tables)], axis=-1)


# --------------------------------------------------------------------------
# Hamming distance (XOR + popcount; Pilaf/image_tools.h:21-33)
# --------------------------------------------------------------------------

def hamming_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise Hamming distance between packed codes.

    Broadcasts over leading dims; reduces the trailing word dim.
    ``uint32[..., W] x uint32[..., W] -> int32[...]``.
    """
    x = jax.lax.population_count(a ^ b)
    return jnp.sum(x.astype(jnp.int32), axis=-1)


def pairwise_hamming(queries: jax.Array, db: jax.Array) -> jax.Array:
    """All-pairs Hamming distance: ``[Q, W] x [N, W] -> int32[Q, N]``.

    Materializes ``[Q, N, W]``; callers chunk N (see search/linear.py).
    """
    return hamming_distance(queries[:, None, :], db[None, :, :])


# --------------------------------------------------------------------------
# Matmul formulation: dist = (B - <±1 bits, ±1 bits>) / 2
# --------------------------------------------------------------------------

def unpack_bits_pm1(codes: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """Unpack ``uint32[..., W]`` to ``±1`` vectors ``[..., 32W]``.

    Bit k of word w (LSB-first) lands at position ``32w + k``. Feeding these
    to a matmul gives ``dot = B - 2*hamming``, turning the linear scan into a
    GEMM. ±1 is exact in bf16 and int8, and a sum of <= B such terms is
    exact in float32 or int32.
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (codes[..., None] >> shifts) & jnp.uint32(1)
    bits = bits.reshape(*codes.shape[:-1], codes.shape[-1] * 32)
    return (2 * bits.astype(jnp.int32) - 1).astype(dtype)


def hamming_via_matmul(q_pm1: jax.Array, db_pm1: jax.Array) -> jax.Array:
    """``[Q, B] x [N, B] -> int32[Q, N]`` Hamming distances via a GEMM."""
    bits = q_pm1.shape[-1]
    dot = jax.lax.dot_general(
        q_pm1, db_pm1,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    return ((bits - dot) * 0.5).astype(jnp.int32)
