"""Configuration for the MIH engine.

The analog of the reference's three config mechanisms
(``src/image_search_constants.h:9-18`` compile-time defaults,
``src/args_config.cc:8-17`` getopt flags, ``config/*.cnf`` cluster files):
one pair of frozen dataclasses usable from Python and from CLI flags.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Reference defaults (src/image_search_constants.h:9-18).
DEFAULT_KNN = 10
N_BINARY_BITS = 128
DEFAULT_N_TABLES = 4
DEFAULT_IMAGE_TOTAL = 100_000_000
APPROXIMATE_FACTOR = 20  # src/search_worker.h:14
DEFAULT_SERVER_PORT = 9191


@dataclasses.dataclass(frozen=True)
class MIHConfig:
    """Static shape/layout parameters of a multi-index-hashing index.

    Mirrors the reference's ``binary_bits``/``n_tables`` flag pair
    (``src/args_config.cc:8-17``); ``substr_len = binary_bits/n_tables/8``
    (``src/build_hash_tables.cc:92``) generalizes to ``s_bits`` here.
    """

    bits: int = N_BINARY_BITS          # full code width in bits
    n_tables: int = DEFAULT_N_TABLES   # m: number of substrings / hash tables

    def __post_init__(self):
        if self.bits % 32 != 0:
            raise ValueError(f"bits must be a multiple of 32, got {self.bits}")
        if self.bits % (self.n_tables * 8) != 0:
            # reference asserts nbytes % size == 0 (src/search_worker.cc:75)
            raise ValueError(
                f"bits ({self.bits}) must split into {self.n_tables} "
                "byte-aligned substrings")
        if self.s_bits > 32:
            raise ValueError("substrings wider than 32 bits are unsupported "
                             "(reference uses uint32 bucket indices)")

    @property
    def n_words(self) -> int:
        """Number of uint32 words per packed code."""
        return self.bits // 32

    @property
    def n_bytes(self) -> int:
        return self.bits // 8

    @property
    def s_bits(self) -> int:
        """Substring width in bits (reference: always 32 = 128/4/8*8)."""
        return self.bits // self.n_tables

    @property
    def s_bytes(self) -> int:
        return self.s_bits // 8


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Query-time parameters.

    * ``knn`` — K (reference flag ``-k``, default 10, launcher default 100).
    * ``approximate`` — pool k*APPROXIMATE_FACTOR candidates and stop when the
      pool fills, instead of the exact MIH stop rule
      (``src/search_worker.cc:93-157``).
    * ``candidate_cap`` — fixed per-(query, table, radius) candidate buffer
      capacity. The reference hides the same bound inside a 40 MB client
      buffer (``src/pilaf_proxy.h:10``); we make it explicit, detect overflow,
      and re-run with a doubled cap to preserve exactness.
    * ``max_enum_radius`` — largest radius enumerated with flip masks; beyond
      this the engine falls back to a brute-force scan for still-unfinished
      queries (cheaper than enumerating C(32,r) masks for large r).
    """

    knn: int = DEFAULT_KNN
    approximate: bool = False
    approximate_factor: int = APPROXIMATE_FACTOR
    # Approximate mode exists purely to be CHEAPER than exact
    # (src/search_worker.cc:93-157) — but its k*factor pool makes every
    # dedup merge pool-wide, and past ~1024 slots the merges cost more
    # than exact mode's whole search. Above this pool width the drivers
    # run the EXACT engine instead: strictly better answers — an
    # approximation that costs more than exactness is parity in letter,
    # inversion in spirit. Set to a huge value to force literal k*factor
    # pools at any k.
    approx_exact_crossover: int = 1024
    # Route overflowed-but-finished rows through the scan-tier ladder
    # instead of the separate 2x-cap re-enumeration retry ladder ("one
    # ladder, not two"). Off by default: a few hundred overflow rows were
    # expected to re-enumerate cheaper than they scan; not yet measured on
    # the GPU (ROADMAP Queue 1). Exactness is unaffected either way.
    overflow_to_scan: bool = False
    candidate_cap: int = 4096
    max_enum_radius: int = 6
    use_bitmap: bool = False
    # Exact mode only: process radii 0 and 1 as one device step. Results are
    # identical (both schedules are exact; the pool after the combined step
    # is a superset of either single step's and the stop rule is checked at
    # the r=1 bound), but one full-batch launch is saved — and most queries
    # finish by radius 1 on realistic data.
    coalesce_radii: bool = True
    # Run the whole radius schedule as one device program with device-side
    # compaction (single host sync). Falls back automatically to the
    # adaptive per-radius loop if the active set outgrows a stage budget.
    fused: bool = True
    # Largest per-group mask count admitted into the fused program; later
    # radii (C(32,4)=36k masks legacy, C(17,3)=680 range-engine) blow
    # device memory for their probe intermediates and cover a vanishing
    # fraction of queries — the stragglers take the exact brute-force scan
    # instead (in-device scan stage when the fused driver runs, host
    # fallback otherwise). Any value is exact; this one awaits re-tuning
    # on the GPU (ROADMAP Queue 1).
    fused_max_masks: int = 512
    # Switch to the brute-force scan once enumerating the next radius costs
    # more probes than scanning the whole DB costs distance evaluations
    # (n_masks(s,r)*m > fallback_ratio*N). The reference has no such
    # crossover because its per-bucket cost is an RDMA round-trip, not
    # compute; here a directory probe (2 random 16 B gathers) costs
    # several times a scanned code (16 B sequential + a GEMM row), hence
    # < 1. Any value is exact; re-tune on the GPU (ROADMAP Queue 1).
    fallback_ratio: float = 0.5

    @property
    def pool_size(self) -> int:
        return self.knn * self.approximate_factor if self.approximate else self.knn


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the sharded engine.

    Axes (see SURVEY.md §7):
      * ``table``  — one slice per substring hash table (the MPI-rank analog,
        ``src/mpi_coordinator.h:13-45``).
      * ``shard``  — range-partition of each table's entries (the Pilaf
        ``hash mod server_count`` analog, ``Pilaf/dht.h:618-620``).
      * ``query``  — embarrassingly parallel query-batch sharding (the
        RPC fan-out analog, ``src/image_search_server.cc:58-83``).
    """

    n_tables: int = DEFAULT_N_TABLES
    n_shards: int = 1
    n_query: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_tables * self.n_shards * self.n_query
