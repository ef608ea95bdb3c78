"""Device-mesh construction for the MIH engine.

The reference's process topology — one MPI rank per substring table
(``src/run_distributed_search.py:74``: ``mpirun -n <n_tables>``), buckets
spread over Pilaf servers by ``hash mod server_count``
(``Pilaf/dht.h:618-620``), and independent queries fanned out by the RPC
front-end (``src/image_search_server.cc:58-83``) — maps onto a 3-D
``jax.sharding.Mesh``:

    ("table", "shard", "query")

* ``table`` — which substring hash table a device slice owns.
* ``shard`` — contiguous range-partition of a table's CSR rows (the
  storage-server scaling axis).

Every card of a host reaches every other over NVLink at the same rate, so
the mesh shape follows the algorithm alone.
* ``query`` — embarrassingly parallel query-batch sharding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh

AXES = ("table", "shard", "query")


def mesh_axes() -> Sequence[str]:
    return AXES


def make_mesh(n_tables: int, n_shards: int = 1, n_query: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build the (table, shard, query) mesh over the given devices."""
    need = n_tables * n_shards * n_query
    if devices is None:
        devices = jax.devices()
    if len(devices) < need:
        raise ValueError(
            f"mesh {n_tables}x{n_shards}x{n_query} needs {need} devices, "
            f"have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_tables, n_shards, n_query)
    return Mesh(arr, AXES)


def single_device_mesh() -> Mesh:
    """1x1x1 mesh — lets the sharded code path run unmodified on one chip."""
    return make_mesh(1, 1, 1)
