"""Collective primitives — the ``mpi_coordinator`` analog.

XLA lowers them to NCCL collectives between the cards of one host (NVLink,
all to all) and to in-process copies on the CPU test mesh.

Semantic mapping (SURVEY.md §5, "Distributed communication backend"):

| reference (src/mpi_coordinator.cc)        | here                          |
|-------------------------------------------|-------------------------------|
| ``gather_vectors`` (Gather+Gatherv→MASTER)| ``gather_candidates``: fixed- |
|                                           | capacity all_gather; merge is |
|                                           | replicated, no master rank    |
| ``bcast`` of the stop flag (:26-28)       | replicated predicate (the     |
|                                           | merge is deterministic on all |
|                                           | devices) / ``reduce_any``     |
| ``bitwise_or`` = MPI_Reduce(BOR) (:17-19) | ``reduce_bitmap_or`` (psum-OR)|
| ``synchronize`` = MPI_Barrier             | implicit in SPMD dataflow     |
| ``die`` = MPI_Abort                       | host-side exception           |

All functions must be called inside ``shard_map`` with the mesh axes of
``parallel.mesh.AXES`` in scope.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp

Axis = Union[str, Tuple[str, ...]]


def gather_candidates(cand_dist: jax.Array, cand_id: jax.Array,
                      axes: Axis) -> Tuple[jax.Array, jax.Array]:
    """All-gather fixed-capacity candidate buffers over table/shard axes.

    ``[Q, C] -> [Q, n_devices*C]`` on every participant (vs. the reference's
    variable-length MPI_Gatherv to rank 0, ``mpi_coordinator.cc:34-69``:
    fixed capacity + replicated merge removes both the variable-length
    protocol and the master bottleneck).
    """
    gd = jax.lax.all_gather(cand_dist, axes, axis=0)   # [D, Q, C]
    gi = jax.lax.all_gather(cand_id, axes, axis=0)
    d = gd.shape[0] * gd.shape[2]
    return (jnp.moveaxis(gd, 0, 1).reshape(gd.shape[1], d),
            jnp.moveaxis(gi, 0, 1).reshape(gi.shape[1], d))


def gather_strips(strips: jax.Array, axes: Axis) -> jax.Array:
    """All-gather a single pre-merged strip array ``[Q, S] ->
    [Q, n_devices*S]``. Per-device pre-merge (ops/topk.table_topk_*)
    shrinks the per-radius collective payload from m·cap candidate slots
    to pool_size keys per device, and the merge behind the all_gather
    gets (m+1)·P-wide operands instead of m·cap."""
    g = jax.lax.all_gather(strips, axes, axis=0)       # [D, Q, S]
    return jnp.moveaxis(g, 0, 1).reshape(g.shape[1], g.shape[0] * g.shape[2])


def reduce_any(flag: jax.Array, axes: Axis) -> jax.Array:
    """Logical-OR reduce of a boolean across mesh axes."""
    return jax.lax.psum(flag.astype(jnp.int32), axes) > 0


def reduce_sum(x: jax.Array, axes: Axis) -> jax.Array:
    return jax.lax.psum(x, axes)


def reduce_bitmap_or(words: jax.Array, axes: Axis,
                     disjoint: bool = False) -> jax.Array:
    """Bitwise-OR reduce of bitmap words (MPI_Reduce(BOR) analog,
    ``mpi_coordinator.cc:17-19``).

    ``disjoint=True``: participants contribute non-overlapping bits (each
    shard owns its value range), so a single psum is exact and rides the
    fast all-reduce path. Otherwise all_gather + local OR (correct for
    arbitrary overlap; uint32 addition would corrupt overlapping bits).
    """
    if disjoint:
        return jax.lax.psum(words, axes)
    g = jax.lax.all_gather(words, axes, axis=0)
    return jax.lax.reduce(g, jnp.uint32(0), jax.lax.bitwise_or, (0,))
