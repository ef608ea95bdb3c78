"""Bucket directories: substring value → (start, count) in the CSR entry
arrays.

This is the device-side replacement for the Pilaf DHT bucket lookup
(``Pilaf/dht.h:604-676``): instead of cuckoo-probing remote memory via RDMA
READ, a directory is a device array co-resident with the entries it
describes, and lookups are vectorized gathers/binary searches over the whole
probe batch at once.

Two implementations (same ``lookup`` contract):

* :class:`DenseDirectory` — ``offsets[2^s + 1]``; O(1) gather per probe.
  Feasible for ``s_bits`` ≤ ~26 (offsets of 256 MB at s=26).
* :class:`SortedDirectory` — the sorted substring column itself; two
  vectorized binary searches (left/right) per probe. Always feasible
  (the s=32 default: a dense 2^32-entry directory would be 16 GB/table,
  which is why the reference hashes instead — SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp


class DenseDirectory(NamedTuple):
    """CSR offsets over the full 2^s_bits value space."""

    offsets: jax.Array  # int32[2^s_bits + 1], offsets[v+1]-offsets[v] = count

    @property
    def s_bits(self) -> int:
        return (self.offsets.shape[0] - 1).bit_length() - 1

    def lookup(self, vals: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """``uint32[...] -> (start int32[...], count int32[...])``."""
        v = vals.astype(jnp.int32)  # 2^s+1 fits int32 for s<=26
        start = self.offsets[v]
        count = self.offsets[v + 1] - start
        return start, count


class SortedDirectory(NamedTuple):
    """Binary-search directory over the sorted substring column."""

    keys: jax.Array  # uint32[N], ascending (the sorted substring values)

    def lookup(self, vals: jax.Array) -> Tuple[jax.Array, jax.Array]:
        flat = vals.reshape(-1)
        lo = jnp.searchsorted(self.keys, flat, side="left")
        hi = jnp.searchsorted(self.keys, flat, side="right")
        start = lo.astype(jnp.int32).reshape(vals.shape)
        count = (hi - lo).astype(jnp.int32).reshape(vals.shape)
        return start, count


def prefix_range_search(keys: jax.Array, vals: jax.Array, lo0: jax.Array,
                        hi0: jax.Array, iters: int,
                        run_end: Optional[jax.Array] = None):
    """Batched (left, right) boundary search of ``vals`` within per-value
    candidate ranges ``[lo0, hi0)`` of the sorted ``keys`` column.

    Hand-rolled bisection (``iters`` rounds of gathers) — a vmapped
    ``jnp.searchsorted`` can lower to a per-row loop.

    With ``run_end`` (precomputed ``run_end[i] = one past the last key equal
    to keys[i]``) the right boundary costs 2 extra gathers instead of a
    second full bisection — random gathers are the entire cost of a
    probe, so this nearly halves the gathers of a lookup.
    """
    n = keys.shape[0]

    def bound(leq: bool):
        lo, hi = lo0, hi0
        for _ in range(iters):
            active = lo < hi
            mid = (lo + hi) >> 1
            km = keys[jnp.clip(mid, 0, n - 1)]
            pred = (km <= vals) if leq else (km < vals)
            lo = jnp.where(active & pred, mid + 1, lo)
            hi = jnp.where(active & ~pred, mid, hi)
        return lo

    left = bound(False)
    if run_end is None:
        return left, bound(True)
    lc = jnp.clip(left, 0, n - 1)
    hit = (left < hi0) & (keys[lc] == vals)
    right = jnp.where(hit, run_end[lc], left)
    return left, right


@jax.tree_util.register_pytree_node_class
class PrefixDirectory:
    """Two-level directory: dense offsets over the top ``pbits`` of the
    substring value narrow the binary search to a short range of the sorted
    key column. This repo's answer to the reference's s=32 problem
    (a dense 2^32 directory is infeasible; Pilaf hashes instead —
    ``Pilaf/dht.h:618-630``): 2^pbits+1 ints of device memory buy
    O(log(N/2^pbits)) probe cost.
    """

    def __init__(self, prefix_offsets: jax.Array, keys: jax.Array,
                 run_end: jax.Array, shift: int, iters: int):
        self.prefix_offsets = prefix_offsets  # int32[2^pbits + 1]
        self.keys = keys                      # uint32[N] sorted
        self.run_end = run_end                # int32[N]: end of equal-run
        self.shift = shift                    # s_bits - pbits (static)
        self.iters = iters                    # search rounds (static)

    def tree_flatten(self):
        return ((self.prefix_offsets, self.keys, self.run_end),
                (self.shift, self.iters))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], children[2], aux[0], aux[1])

    def lookup(self, vals: jax.Array) -> Tuple[jax.Array, jax.Array]:
        pref = (vals >> jnp.uint32(self.shift)).astype(jnp.int32)
        lo0 = self.prefix_offsets[pref]
        hi0 = self.prefix_offsets[pref + 1]
        left, right = prefix_range_search(self.keys, vals, lo0, hi0,
                                          self.iters, self.run_end)
        return left.astype(jnp.int32), (right - left).astype(jnp.int32)


# avalanche mixer constants — MUST match native/src/hashdir.cc (a linear
# multiply-shift hash wedges cuckoo insertion on MIH substring families;
# see the note there)
HASH_CONSTS = ((0x85EBCA6B, 0xC2B2AE35), (0x7FEB352D, 0x846CA68B))


def _mix(v: jax.Array, ca: int, cb: int) -> jax.Array:
    v = v ^ (v >> jnp.uint32(16))
    v = v * jnp.uint32(ca)
    v = v ^ (v >> jnp.uint32(13))
    v = v * jnp.uint32(cb)
    return v ^ (v >> jnp.uint32(16))


class HashDirectory(NamedTuple):
    """2-way cuckoo directory: 16-byte rows [key, start, count, 0].

    One probe = two *independent* row gathers + vectorized multiply-shift
    hashes — latency-optimal (a bisection chain is ~10 dependent
    gathers). This is the device-resident descendant of the Pilaf cuckoo DHT's
    read path (Pilaf/dht.h:626-649: compute slots from the hash, fetch row,
    compare key), with the CRC/retry machinery gone because the index is
    build-then-freeze. Host-side cuckoo build in native/src/hashdir.cc.
    """

    rows: jax.Array  # uint32[S, 4]; S power of two; empty slot: count == 0

    def lookup(self, vals: jax.Array) -> Tuple[jax.Array, jax.Array]:
        mask = jnp.uint32(self.rows.shape[0] - 1)
        i1 = (_mix(vals, *HASH_CONSTS[0]) & mask).astype(jnp.int32)
        i2 = (_mix(vals, *HASH_CONSTS[1]) & mask).astype(jnp.int32)
        r1 = self.rows[i1]                 # [..., 4]
        r2 = self.rows[i2]
        hit1 = (r1[..., 0] == vals) & (r1[..., 2] > 0)
        hit2 = (r2[..., 0] == vals) & (r2[..., 2] > 0)
        start = jnp.where(hit1, r1[..., 1], jnp.where(hit2, r2[..., 1], 0))
        count = jnp.where(hit1, r1[..., 2], jnp.where(hit2, r2[..., 2], 0))
        return start.astype(jnp.int32), count.astype(jnp.int32)


def build_hash(sorted_subs, n_slots: int = 0) -> HashDirectory:
    """Host cuckoo build (native C++), rows uploaded to device."""
    import numpy as np
    from verticut_tpu import native
    table = native.build_hashdir(np.asarray(sorted_subs), n_slots)
    return HashDirectory(rows=jnp.asarray(table))


@jax.tree_util.register_pytree_node_class
class RangeDirectory:
    """Prefix-*range* directory: dense (start, end) pairs over the top
    ``pbits`` of the substring value, describing contiguous runs of the
    substring-sorted entry rows.

    This is the device-side replacement for per-bucket probing in the hot
    loop: one 8 B gather per *prefix* returns the row range holding every
    key that shares the prefix, so a single probe covers all flip masks in
    the low ``s_bits - pbits`` bits at once, and radius-r enumeration
    shrinks from C(s_bits, r) bucket probes to C(pbits, r) range probes.
    Rows in a range whose keys are NOT in any probed bucket are fetched
    anyway and scored with their true full-code distance — a superset of
    the bucket-exact candidate set, which preserves MIH exactness (the
    stop rule only needs every key within the current radius examined;
    extra examined keys cannot hurt). The reference pays one RDMA per
    bucket (``src/search_worker.cc:230-264``); here bandwidth is cheap and
    per-gather-row latency is the budget, so we trade volume for rows.
    """

    def __init__(self, se: jax.Array, s_bits: int):
        self.se = se          # int32[2^pbits, 2]: (start, end) per prefix
        self.s_bits = s_bits  # substring width the prefixes were cut from

    def tree_flatten(self):
        return ((self.se,), (self.s_bits,))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    @property
    def pbits(self) -> int:
        return (self.se.shape[0]).bit_length() - 1

    @property
    def shift(self) -> int:
        return self.s_bits - self.pbits

    def range_lookup(self, prefixes: jax.Array
                     ) -> Tuple[jax.Array, jax.Array]:
        """``uint32[...] -> (start int32[...], count int32[...])`` — the
        contiguous sorted-row range of each probed prefix; one gather."""
        p = self.se[prefixes.astype(jnp.int32)]
        return p[..., 0], p[..., 1] - p[..., 0]

    def lookup(self, vals: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """SUPERSET lookup: the row range of the value's whole prefix.

        Contains the exact bucket of ``vals`` but usually more (every key
        sharing the top ``pbits``). Sufficient for membership/integrity
        checks; callers needing bucket-exact ranges must use a
        Dense/Sorted/Prefix/Hash directory.
        """
        return self.range_lookup(vals >> jnp.uint32(self.shift))


def pick_range_pbits(n: int, s_bits: int, blk: int = 16) -> int:
    """Prefix width targeting ~8 expected rows per range (most ranges fit
    one fetch block at any supported block width), clamped to keep ``se``
    ≤ 128 MB. The target is capped independent of wide blocks: candidate
    caps and merge widths grow with expected rows faster than the probe
    count shrinks (at 1M, pbits 16 vs 17 raised mean scored candidates
    1283 -> 1893, a count that does not depend on the device)."""
    target = max(1, min(blk, 16) // 2)
    p = max(1, (max(n, 2) - 1).bit_length() - (target - 1).bit_length())
    return max(4, min(24, s_bits, p))


def build_range(sorted_subs: jax.Array, s_bits: int,
                pbits: Optional[int] = None, blk: int = 16
                ) -> RangeDirectory:
    n = sorted_subs.shape[0]
    pbits = pbits or pick_range_pbits(n, s_bits, blk)
    shift = s_bits - pbits
    prefixes = (sorted_subs >> jnp.uint32(shift)).astype(jnp.uint32)
    grid = jnp.arange((1 << pbits) + 1, dtype=jnp.int32).astype(jnp.uint32)
    offs = jnp.searchsorted(prefixes, grid, side="left").astype(jnp.int32)
    return RangeDirectory(se=jnp.stack([offs[:-1], offs[1:]], axis=-1),
                          s_bits=s_bits)


Directory = Union[DenseDirectory, SortedDirectory, PrefixDirectory,
                  HashDirectory, RangeDirectory]


def build_dense(sorted_subs: jax.Array, s_bits: int) -> DenseDirectory:
    """Offsets via one vectorized searchsorted over all 2^s values."""
    if s_bits > 26:
        raise ValueError(
            f"dense directory infeasible at s_bits={s_bits} "
            f"(2^{s_bits}+1 offsets); use SortedDirectory")
    grid = jnp.arange((1 << s_bits) + 1, dtype=jnp.int32).astype(jnp.uint32)
    offs = jnp.searchsorted(sorted_subs, grid, side="left")
    return DenseDirectory(offsets=offs.astype(jnp.int32))


def build_sorted(sorted_subs: jax.Array) -> SortedDirectory:
    return SortedDirectory(keys=sorted_subs)


def pick_pbits(n: int, s_bits: int) -> int:
    """Prefix width: ~1 expected key per prefix slot, capped for memory
    (2^22+1 offsets = 16 MB) and by the substring width."""
    return max(1, min(22, s_bits - 1, (max(n, 2) - 1).bit_length()))


def compute_run_end(sorted_subs: jax.Array) -> jax.Array:
    """``run_end[i]`` = one past the last index whose key equals keys[i].

    O(N) via reverse cumulative max of run-terminator positions."""
    n = sorted_subs.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_last = jnp.concatenate(
        [sorted_subs[1:] != sorted_subs[:-1], jnp.ones((1,), jnp.bool_)])
    # nearest run terminator at-or-after i: reverse cumulative min
    end_val = jnp.where(is_last, idx + 1, jnp.int32(0x7FFFFFFF))
    return jnp.flip(jax.lax.cummin(jnp.flip(end_val)))


def build_prefix(sorted_subs: jax.Array, s_bits: int,
                 pbits: Optional[int] = None) -> PrefixDirectory:
    n = sorted_subs.shape[0]
    pbits = pbits or pick_pbits(n, s_bits)
    shift = s_bits - pbits
    prefixes = (sorted_subs >> jnp.uint32(shift)).astype(jnp.uint32)
    grid = jnp.arange((1 << pbits) + 1, dtype=jnp.int32).astype(jnp.uint32)
    offs = jnp.searchsorted(prefixes, grid, side="left").astype(jnp.int32)
    max_range = int(jnp.max(offs[1:] - offs[:-1])) if n else 1
    iters = max(1, int(max_range).bit_length())
    return PrefixDirectory(prefix_offsets=offs, keys=sorted_subs,
                           run_end=compute_run_end(sorted_subs),
                           shift=shift, iters=iters)
