"""verticut_tpu — a multi-index-hashing (MIH) image-search framework in JAX.

A ground-up re-design of tu-dresden/verticut (distributed exact/approximate
K-nearest-neighbor search in Hamming space over binary codes) for an
accelerator (an NVIDIA GPU; the tests run on the CPU):

* Binary codes are packed ``uint32`` word arrays resident in device memory
  (reference: 16-byte strings in protobuf messages, ``src/image_search.proto``).
* The per-table hash tables (reference: Pilaf RDMA cuckoo DHT, ``Pilaf/dht.h``)
  become CSR-layout sorted-entry arrays + bucket directories in device memory.
* The MPI rank-per-substring parallelism (``src/mpi_coordinator.cc``) becomes a
  ``jax.sharding.Mesh`` axis ``"table"`` under ``shard_map`` with
  all-gathers replacing ``MPI_Gatherv``-to-master.
* The recursive Hamming-ball enumeration (``src/search_worker.cc:230-264``)
  becomes precomputed XOR flip-mask tables applied to batched queries.
* Candidate verification (XOR+popcount, ``Pilaf/image_tools.h:21-33``) runs
  via ``lax.population_count``; the brute-force scan runs as a ±1-bit
  matmul (a fused Pallas-Triton kernel on the GPU).

Public API (stable):
    codes, ops, index, search, parallel, kv, service, utils
"""

__version__ = "0.1.0"

from verticut_tpu import codes  # noqa: F401
from verticut_tpu.config import MIHConfig, SearchConfig  # noqa: F401
