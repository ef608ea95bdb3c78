"""Pluggable key-value store layer — the ``BaseProxy`` seam of the reference
(``src/base_proxy.h:15-29``: get/put/contain/init/close over pluggable
pilaf/memcached/redis backends).

The query path never touches a KV store (tables are CSR arrays in device
memory); this layer exists for the host-side roles the reference's stores
cover: streaming/incremental index construction, the integrity-check
round-trip, and operational tooling. Backends:

* :class:`MemoryKV`   — python dict (the CI seam; the reference's
  closest analog is memcached-on-localhost, SURVEY.md §4).
* :class:`DHTStore`   — the native C++ cuckoo-hash store (Pilaf DHT analog)
  via ctypes.
* :class:`ShardedKV`  — key-space sharding over N child stores with the
  reference's shard function ``hash(key) mod server_count``
  (``Pilaf/dht.h:618-620``, Murmur seed 3).

:class:`BucketStore` adds the typed (table_id, index) -> [(id, code)] bucket
schema of ``src/image_search.proto`` on top of any backend, with a compact
struct encoding instead of protobuf.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple


class KVStore:
    """Abstract byte KV store (BaseProxy contract)."""

    def init(self, config: Optional[str] = None) -> None:  # noqa: D401
        pass

    def close(self) -> None:
        pass

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def contains(self, key: bytes) -> bool:
        raise NotImplementedError

    def remove(self, key: bytes) -> bool:
        raise NotImplementedError


class MemoryKV(KVStore):
    def __init__(self):
        self._d: Dict[bytes, bytes] = {}

    def get(self, key):
        return self._d.get(key)

    def put(self, key, value):
        self._d[key] = value

    def contains(self, key):
        return key in self._d

    def remove(self, key):
        return self._d.pop(key, None) is not None

    def __len__(self):
        return len(self._d)


class DHTStore(KVStore):
    """Native cuckoo-hash DHT backend (verticut_tpu.native.NativeDHT)."""

    def __init__(self, n_slots: int = 1 << 16, arena_bytes: int = 1 << 24):
        from verticut_tpu import native
        self._dht = native.NativeDHT(n_slots, arena_bytes)

    def get(self, key):
        return self._dht.get(key)

    def put(self, key, value):
        self._dht.put(key, value)

    def contains(self, key):
        return self._dht.contains(key)

    def remove(self, key):
        return self._dht.remove(key)

    def stats(self):
        return self._dht.stats()

    def close(self):
        self._dht.close()

    def __len__(self):
        return len(self._dht)


class ShardedKV(KVStore):
    """hash(key) mod N sharding over child stores (Pilaf multi-server)."""

    def __init__(self, shards: Sequence[KVStore]):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = list(shards)

    def shard_for(self, key: bytes) -> int:
        from verticut_tpu import native
        # Murmur seed 3 — the reference's dedicated server-shard seed
        return native.hash_n(key, 3) % len(self.shards)

    def _s(self, key):
        return self.shards[self.shard_for(key)]

    def get(self, key):
        return self._s(key).get(key)

    def put(self, key, value):
        self._s(key).put(key, value)

    def contains(self, key):
        return self._s(key).contains(key)

    def remove(self, key):
        return self._s(key).remove(key)

    def close(self):
        for s in self.shards:
            s.close()


class OpLogKV(KVStore):
    """Write-ahead operation log around any store — the Pilaf server's
    optional append-only log (``Pilaf/store-server.cc:58-94``: 'P' and 'R'
    records, buffered writes flushed at a high-water mark). ``replay`` an
    existing log into a fresh store to recover it.

    Record format: ``P <klen u32> <vlen u32> <key> <val>`` /
    ``R <klen u32> <key>``, little-endian, binary.
    """

    FLUSH_HIGH_WATER = 256 * 1024  # store-server.cc flush threshold parity

    def __init__(self, inner: KVStore, path: str):
        self.inner = inner
        self.path = path
        self._f = open(path, "ab")
        self._buf = bytearray()

    def _append(self, rec: bytes) -> None:
        self._buf += rec
        if len(self._buf) >= self.FLUSH_HIGH_WATER:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._f.write(self._buf)
            self._f.flush()
            self._buf.clear()

    def get(self, key):
        return self.inner.get(key)

    def contains(self, key):
        return self.inner.contains(key)

    def put(self, key, value):
        self._append(b"P" + struct.pack("<II", len(key), len(value))
                     + key + value)
        self.inner.put(key, value)

    def remove(self, key):
        self._append(b"R" + struct.pack("<I", len(key)) + key)
        return self.inner.remove(key)

    def close(self):
        self.flush()
        self._f.close()
        self.inner.close()

    @staticmethod
    def replay(path: str, into: KVStore) -> int:
        """Apply a log file to a store; returns the number of records."""
        n = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            tag = data[off:off + 1]
            off += 1
            if tag == b"P":
                klen, vlen = struct.unpack_from("<II", data, off)
                off += 8
                key = data[off:off + klen]
                off += klen
                val = data[off:off + vlen]
                off += vlen
                into.put(key, val)
            elif tag == b"R":
                (klen,) = struct.unpack_from("<I", data, off)
                off += 4
                into.remove(data[off:off + klen])
                off += klen
            else:
                raise ValueError(f"corrupt op log at offset {off - 1}")
            n += 1
        return n


def make_store(backend: str = "memory", n_shards: int = 1, **kw) -> KVStore:
    """Factory mirroring the reference's --server flag
    (``src/args_config.cc:8-17``: pilaf|memcached|redis).

    ``redis``/``memcached`` are REAL network connectors (kv/remote.py) and
    need a reachable server (host/port kwargs); ``memory`` is the
    in-process dict (the CI seam); ``dht`` the native cuckoo store.
    """
    def one():
        if backend == "memory":
            return MemoryKV()
        if backend in ("dht", "pilaf", "native"):
            return DHTStore(**kw)
        if backend == "redis":
            from verticut_tpu.kv.remote import RedisKV
            return RedisKV(**kw)
        if backend == "memcached":
            from verticut_tpu.kv.remote import MemcachedKV
            return MemcachedKV(**kw)
        raise ValueError(f"unknown backend {backend!r}")
    if n_shards == 1:
        return one()
    return ShardedKV([one() for _ in range(n_shards)])


class BucketStore:
    """Typed bucket schema over a KVStore.

    Key   = HashIndex{table_id, index}  (src/image_search.proto:14-17)
    Value = Image_List{repeated ID_Code_Pair{id, code}}  (:20-27)

    Encoding: key = '!BI' struct; value = concatenated (id:uint32_le,
    code:code_bytes) records — fixed-width, so append is O(1) amortized
    instead of the reference's full protobuf re-serialize per append
    (src/build_hash_tables.cc:48-64).
    """

    def __init__(self, store: KVStore, code_bytes: int):
        self.store = store
        self.code_bytes = code_bytes
        self._rec = struct.Struct(f"<I{code_bytes}s")

    def key(self, table_id: int, index: int) -> bytes:
        return struct.pack("<BI", table_id, index)

    def append(self, table_id: int, index: int, image_id: int,
               code: bytes) -> None:
        k = self.key(table_id, index)
        rec = self._rec.pack(image_id, code)
        cur = self.store.get(k)
        self.store.put(k, rec if cur is None else cur + rec)

    def bucket(self, table_id: int, index: int) -> List[Tuple[int, bytes]]:
        raw = self.store.get(self.key(table_id, index))
        if raw is None:
            return []
        n = len(raw) // self._rec.size
        return [self._rec.unpack_from(raw, i * self._rec.size)
                for i in range(n)]

    def contains_pair(self, table_id: int, index: int, image_id: int,
                      code: bytes) -> bool:
        """The integrity_check.cc:57-61 predicate."""
        return (image_id, code) in self.bucket(table_id, index)
