"""Clean-room numpy model of the reference MIH algorithm.

A direct executable specification of the C++ search semantics
(``src/search_worker.cc``) used as the parity oracle for the device engine:
per-radius lockstep over m tables, candidates gathered in (table, mask,
bucket-position) order, master-side dedup-by-id, bounded max-heap with
strict-improvement eviction, and the exact/approximate stop rules.

Deliberately slow and obvious — correctness reference only.
"""

from __future__ import annotations

import heapq
from itertools import combinations

import numpy as np


def binary_to_int(b: np.ndarray) -> int:
    """Little-endian byte composition (Pilaf/image_tools.h:12-18, len=4 path)."""
    v = 0
    for i, byte in enumerate(b):
        v |= int(byte) << (8 * i)
    return v


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.unpackbits(a ^ b).sum())


class RefMIH:
    """Build + search over raw byte codes ``uint8[N, nbytes]``."""

    def __init__(self, codes: np.ndarray, n_tables: int):
        self.codes = np.asarray(codes, np.uint8)
        self.m = n_tables
        n, nbytes = self.codes.shape
        assert nbytes % n_tables == 0
        self.s_bytes = nbytes // n_tables
        self.s_bits = self.s_bytes * 8
        # build_hash_tables.cc:36-64 — sequential append per table
        self.tables = [dict() for _ in range(n_tables)]
        for img_id in range(n):
            for t in range(n_tables):
                sub = binary_to_int(
                    self.codes[img_id, t * self.s_bytes:(t + 1) * self.s_bytes])
                self.tables[t].setdefault(sub, []).append(img_id)

    def _enumerate(self, sub: int, r: int):
        """Substring values at exact Hamming distance r, in a fixed order."""
        if r == 0:
            yield sub
            return
        for c in combinations(range(self.s_bits), r):
            mask = 0
            for bit in c:
                mask |= 1 << bit
            yield sub ^ mask

    def search(self, query: np.ndarray, k: int, approximate: bool = False,
               factor: int = 20, max_radius: int = None):
        """Returns (dists, ids) ascending by dist (ties unspecified)."""
        query = np.asarray(query, np.uint8)
        pool_size = k * factor if approximate else k
        subs = [binary_to_int(query[t * self.s_bytes:(t + 1) * self.s_bytes])
                for t in range(self.m)]
        heap = []  # max-heap via negated dist
        found = set()
        radius = 0
        max_radius = self.s_bits if max_radius is None else max_radius
        while radius <= max_radius:
            gathered = []
            for t in range(self.m):
                for v in self._enumerate(subs[t], radius):
                    for img_id in self.tables[t].get(v, ()):
                        gathered.append(
                            (img_id, hamming(self.codes[img_id], query)))
            for img_id, dist in gathered:
                if img_id in found:
                    continue
                found.add(img_id)
                if len(heap) < pool_size:
                    heapq.heappush(heap, (-dist, img_id))
                elif -heap[0][0] > dist:  # strict improvement only
                    heapq.heapreplace(heap, (-dist, img_id))
            radius += 1
            if approximate:
                if len(heap) == pool_size:
                    break
            else:
                if len(heap) == k and -heap[0][0] <= radius * self.m:
                    break
        items = sorted(((-d, i) for d, i in heap))
        items = items[:k]
        dists = np.array([d for d, _ in items], np.int32)
        ids = np.array([i for _, i in items], np.int32)
        return dists, ids


def brute_force(queries: np.ndarray, codes: np.ndarray, k: int):
    """Exact top-k by (dist, id); uint8 byte codes."""
    q = np.unpackbits(queries, axis=1)[:, None, :]
    c = np.unpackbits(codes, axis=1)[None, :, :]
    d = (q != c).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(codes.shape[0]), d.shape), d),
                       axis=-1)[:, :k]
    return np.take_along_axis(d, order, axis=-1).astype(np.int32), \
        order.astype(np.int32)
