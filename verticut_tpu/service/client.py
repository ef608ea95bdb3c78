"""msgpack-RPC client — the ``image_search_client`` analog
(``src/image_search_client.cc``: session-pooled msgpack-rpc with 480 s
timeout becomes a small pooled TCP client)."""

from __future__ import annotations

import itertools
import queue
import socket
import threading

from verticut_tpu.config import DEFAULT_SERVER_PORT
from verticut_tpu.service import wire

DEFAULT_TIMEOUT_S = 480.0  # src/image_search_client.cc:29
POOL_SIZE = 20             # :7-9


class ImageSearchClient:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_SERVER_PORT,
                 timeout: float = DEFAULT_TIMEOUT_S, pool: int = POOL_SIZE):
        self.addr = (host, port)
        self.timeout = timeout
        self._pool: "queue.Queue[socket.socket]" = queue.Queue()
        self._pool_size = pool
        self._created = 0
        self._lock = threading.Lock()
        self._msgid = itertools.count(1)

    def _connect(self) -> socket.socket:
        s = socket.create_connection(self.addr, timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _acquire(self) -> socket.socket:
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            with self._lock:
                grow = self._created < self._pool_size
                if grow:
                    self._created += 1
            if grow:
                try:
                    return self._connect()
                except Exception:
                    with self._lock:
                        self._created -= 1  # slot leaks would deadlock later
                    raise
            return self._pool.get(timeout=self.timeout)

    def _release(self, s: socket.socket):
        self._pool.put(s)

    def call(self, method: str, *params, _retries: int = 1):
        """One RPC round trip; transparently reconnects and retries once on
        a transport failure (the reference client's reconnect-and-restart
        loop, ``Pilaf/store-client.cc:607-679`` / epoch-bump restart)."""
        try:
            return self._call_once(method, params)
        except (ConnectionError, OSError, socket.timeout):
            if _retries <= 0:
                raise
            return self.call(method, *params, _retries=_retries - 1)

    def _call_once(self, method: str, params):
        msgid = next(self._msgid)
        payload = wire.packb([0, msgid, method, list(params)])
        s = self._acquire()
        try:
            s.sendall(payload)
            unpacker = wire.Unpacker()
            result = None
            found = False
            while not found:
                data = s.recv(1 << 16)
                if not data:
                    raise ConnectionError("server closed connection")
                unpacker.feed(data)
                for msg in unpacker:
                    if msg[0] == 1 and msg[1] == msgid:
                        if msg[2] is not None:
                            raise RuntimeError(f"rpc error: {msg[2]}")
                        result = msg[3]
                        found = True
        except Exception:
            try:
                s.close()
            finally:
                with self._lock:
                    self._created -= 1
            raise
        self._release(s)
        return result

    # typed helpers ----------------------------------------------------------

    def ping(self) -> str:
        return self.call("ping")

    def search_image_by_id(self, image_id: int, knn: int = 10,
                           approximate: bool = False):
        return self.call("search_image_by_id", image_id, knn, approximate)

    def search_by_code(self, code: bytes, knn: int = 10,
                       approximate: bool = False):
        return self.call("search_by_code", code, knn, approximate)

    def search_batch(self, codes_blob: bytes, knn: int = 10,
                     approximate: bool = False):
        return self.call("search_batch", codes_blob, knn, approximate)

    def stats(self):
        return self.call("stats")

    def close(self):
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                break


class ReplicatedSearchClient:
    """Request fan-out over serving replicas — the front-end's
    pick-a-random-worker dispatch (``src/image_search_server.cc:58-83``)
    lifted into the client, with failover to the next replica.

    Each replica is a full mesh owning the whole index; replicas scale
    request throughput over DCN (the 4th parallelism axis of SURVEY.md §2).
    """

    def __init__(self, addrs, timeout: float = DEFAULT_TIMEOUT_S,
                 pool: int = POOL_SIZE, seed: int = 0):
        import random
        if not addrs:
            raise ValueError("need at least one replica address")
        self._rng = random.Random(seed)
        self.clients = [ImageSearchClient(h, p, timeout, pool)
                        for h, p in addrs]

    def call(self, method: str, *params):
        order = list(range(len(self.clients)))
        self._rng.shuffle(order)
        last = None
        for i in order:
            try:
                return self.clients[i].call(method, *params)
            except Exception as e:  # noqa: BLE001 — failover
                last = e
        raise last

    def ping(self):
        return self.call("ping")

    def search_image_by_id(self, image_id, knn=10, approximate=False):
        return self.call("search_image_by_id", image_id, knn, approximate)

    def search_by_code(self, code, knn=10, approximate=False):
        return self.call("search_by_code", code, knn, approximate)

    def search_batch(self, blob, knn=10, approximate=False):
        return self.call("search_batch", blob, knn, approximate)

    def close(self):
        for c in self.clients:
            c.close()
