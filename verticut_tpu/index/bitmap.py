"""Bucket-occupancy bitmap — 1 bit per possible substring value per table.

The equivalent of the reference's ``ImageBitmap`` + shm daemon
(``src/bitmap.{h,cc}``, ``src/bitmap_deamon.cc``, ``src/generate_bitmap.cc``):
the 2 GB POSIX-shm segment (4 tables × 2^32 bits) becomes a plain uint32
device array per table shard; the daemon/mmap machinery disappears because
device residency *is* the sharing mechanism. Bit layout matches the
reference exactly: value ``v`` → word ``v >> 5``, bit ``v & 31``
(``src/bitmap.cc:22-26``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Bitmap(NamedTuple):
    words: jax.Array  # uint32[2^s_bits / 32]

    def get(self, vals: jax.Array) -> jax.Array:
        """``uint32[...] -> bool[...]``: is bucket ``v`` non-empty?"""
        word = self.words[(vals >> jnp.uint32(5)).astype(jnp.int32)]
        return ((word >> (vals & jnp.uint32(31))) & jnp.uint32(1)) != 0

    def count(self) -> jax.Array:
        """Number of occupied buckets."""
        return jnp.sum(jax.lax.population_count(self.words).astype(jnp.int32))

    def union(self, other: "Bitmap") -> "Bitmap":
        """Bitwise OR — the ``mpi_coordinator::bitwise_or`` analog
        (``src/mpi_coordinator.cc:17-19``)."""
        return Bitmap(words=self.words | other.words)


def build_bitmap(sorted_subs: jax.Array, s_bits: int) -> Bitmap:
    """Build from the table's *sorted* substring column.

    Duplicates contribute 0 via the first-occurrence mask, so scatter-add is
    an exact scatter-OR (distinct values in one word touch distinct bits).
    """
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sorted_subs[1:] != sorted_subs[:-1]])
    contrib = jnp.where(first, jnp.uint32(1) << (sorted_subs & jnp.uint32(31)),
                        jnp.uint32(0))
    word_idx = (sorted_subs >> jnp.uint32(5)).astype(jnp.int32)
    n_words = (1 << s_bits) // 32 if s_bits >= 5 else 1
    words = jnp.zeros((n_words,), jnp.uint32).at[word_idx].add(contrib)
    return Bitmap(words=words)
