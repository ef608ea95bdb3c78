"""msgpack-RPC query front-end — the ``image_search_server`` analog.

The reference front-end (``src/image_search_server.cc``) receives a
msgpack-RPC call, picks a random worker host, and *ssh-launches* an mpirun
job per query, parsing stdout. Here the index lives in device memory next
to the server process, so dispatch is a direct library call; and because the
engine is batched, the server micro-batches concurrent requests into one
device launch (request-level parallelism axis of SURVEY.md §2 without
process churn).

Wire protocol: standard msgpack-RPC over TCP —
request ``[0, msgid, method, params]`` / response ``[1, msgid, err, result]``.
Methods:
  * ``ping()                      -> "pong"``        (dispatch parity)
  * ``search_image_by_id(id, k, approx) -> [[id, dist], ...]``
  * ``search_by_code(code_bytes, k, approx) -> [[id, dist], ...]``
  * ``search_batch(codes_bytes, k, approx) -> [[[id, dist], ...], ...]``
  * ``stats() -> {...}``
"""

from __future__ import annotations

import queue
import socket
import socketserver
import threading
from typing import Optional

import numpy as np

from verticut_tpu import codes as codes_lib
from verticut_tpu.config import SearchConfig, DEFAULT_SERVER_PORT
from verticut_tpu.service import wire
from verticut_tpu.utils.logging import get_logger
from verticut_tpu.utils.timer import Timer

log = get_logger("service")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        unpacker = wire.Unpacker()
        sock = self.request
        self.server.owner._conns.add(sock)
        try:
            while True:
                data = sock.recv(1 << 16)
                if not data:
                    return
                unpacker.feed(data)
                for msg in unpacker:
                    self._dispatch(sock, msg)
        except OSError:
            return  # connection force-closed by stop()
        finally:
            self.server.owner._conns.discard(sock)

    def _dispatch(self, sock, msg):
        srv: "ImageSearchServer" = self.server.owner
        if not isinstance(msg, (list, tuple)) or len(msg) != 4 or msg[0] != 0:
            return  # ignore notifications/garbage
        _, msgid, method, params = msg
        try:
            with Timer(f"rpc.{method}"):
                result = srv.call(method, params)
            resp = [1, msgid, None, result]
        except Exception as e:  # noqa: BLE001 — errors go on the wire
            log.warning("rpc %s failed: %s", method, e)
            resp = [1, msgid, f"{type(e).__name__}: {e}", None]
        sock.sendall(wire.packb(resp))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ImageSearchServer:
    """Serves K-NN queries over a built index (single- or multi-device)."""

    def __init__(self, index, host: str = "127.0.0.1",
                 port: int = DEFAULT_SERVER_PORT,
                 default_knn: int = 10, sharded: bool = False):
        self.index = index
        self.sharded = sharded
        self.default_knn = default_knn
        self._srv = _Server((host, port), _Handler)
        self._srv.owner = self
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self.n_requests = 0
        self.n_batches = 0
        # incremented on every (re)start — the Pilaf per-server epoch analog
        # (store-client.cc:146-147): clients detect a bounced server
        self.epoch = 0
        self._conns: set = set()
        # micro-batching: ONE worker thread owns the device and drains a
        # FIFO of (key, slot, event) work items. Leader election among
        # request threads with a condition-variable handoff lets drains
        # grow device batches without bound while late waiters sit out
        # condition timeouts on missed wakeups. A dedicated worker bounds
        # every request's wait to at most (in-flight batch + own batch)
        # and caps the batch rows.
        self._work: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._running = False
        #: admission control: max query rows per device batch. Requests
        #: beyond the cap stay queued for the next batch (FIFO), keeping
        #: per-batch latency flat under bursty concurrency — the shape
        #: the reference's load test exercises (image_search_test.cc:145-170).
        self.max_batch_rows = 2048

    # -- dispatch (the image_search_server.cc:22-48 analog) ------------------

    def call(self, method: str, params):
        if method == "ping":
            return "pong"
        if method == "stats":
            from verticut_tpu.utils.timer import timings
            return {"n_requests": self.n_requests,
                    "n_batches": self.n_batches, "n_codes": self.index.n,
                    "epoch": self.epoch, "timings": timings()}
        if method == "search_image_by_id":
            image_id, knn, approx = (list(params) + [self.default_knn, False]
                                     )[:3]
            codes_arr = self.index.codes
            if codes_arr is None:
                raise ValueError("index holds no code array")
            q = np.asarray(codes_arr[int(image_id):int(image_id) + 1])
            return self._search(q, int(knn), bool(approx))[0]
        if method == "search_by_code":
            code, knn, approx = (list(params) + [self.default_knn, False])[:3]
            q = codes_lib.pack_bytes(np.frombuffer(code, np.uint8)[None])
            return self._search(q, int(knn), bool(approx))[0]
        if method == "search_batch":
            blob, knn, approx = (list(params) + [self.default_knn, False])[:3]
            nbytes = self.index.cfg.n_bytes
            raw = np.frombuffer(blob, np.uint8).reshape(-1, nbytes)
            return self._search(codes_lib.pack_bytes(raw), int(knn),
                                bool(approx))
        raise ValueError(f"unknown method {method!r}")

    def _search(self, queries: np.ndarray, knn: int, approx: bool):
        """Micro-batching: concurrent requests with the same (knn, approx)
        coalesce into one device launch. The reference fans every query out
        as its own mpirun job (``image_search_server.cc:58-83``); a batched
        engine inverts that — request-level parallelism becomes batch rows.
        Request threads only enqueue and block on their event; all device
        work happens on the worker thread.
        """
        if not self._running:
            self._start_worker()
        evt = threading.Event()
        slot = [queries, None]          # [input rows, output rows]
        key = (int(knn), bool(approx))
        self._work.put((key, slot, evt))
        evt.wait()
        if isinstance(slot[1], BaseException):
            raise RuntimeError(
                f"batch worker failed: {slot[1]}") from slot[1]
        return slot[1]

    # -- worker thread: batch assembly + depth-2 device pipeline -----------

    def _start_worker(self):
        with self._work.mutex:  # idempotent start (any thread may race)
            if self._running:
                return
            self._running = True
        self._worker = threading.Thread(target=self._worker_loop,
                                        daemon=True, name="search-worker")
        self._worker.start()

    def _take_batch(self, first):
        """FIFO drain of same-key items up to the row cap; items of other
        keys (or beyond the cap) are requeued in arrival order."""
        key = first[0]
        batch = [first[1:]]
        rows = first[1][0].shape[0]
        requeue = []
        while rows < self.max_batch_rows:
            try:
                item = self._work.get_nowait()
            except queue.Empty:
                break
            if item is None:
                requeue.append(item)  # keep the stop sentinel observable
                break
            if item[0] != key:
                requeue.append(item)
                continue
            batch.append(item[1:])
            rows += item[1][0].shape[0]
        for item in requeue:
            self._work.put(item)
        return key, batch

    def _worker_loop(self):
        # Up to TWO device batches in flight: dispatch the next before
        # finalizing the previous so device work overlaps the host sync —
        # the serving analog of the bench's pipelined throughput mode.
        inflight = None  # (key, batch, handle, queries_or_none, sizes)
        while True:
            try:
                timeout = 0.0005 if inflight is not None else None
                try:
                    item = self._work.get(timeout=timeout)
                except queue.Empty:
                    item = False  # nothing queued: drain the in-flight batch
                if item is None:  # stop sentinel
                    if inflight is not None:
                        self._safe_finalize(inflight)
                    return
                if item is False:
                    self._safe_finalize(inflight)
                    inflight = None
                    continue
                key, batch = self._take_batch(item)
                prev, inflight = inflight, None
                try:
                    dispatched = self._dispatch_device(key, batch)
                except BaseException as e:  # noqa: BLE001 — to the waiters
                    self._deliver_error(batch, e)
                    dispatched = None
                    batch = []
                if prev is not None:
                    self._safe_finalize(prev)
                if dispatched is None:
                    if batch:  # sync engine (sharded)
                        try:
                            self._execute_sync(key, batch)
                        except BaseException as e:  # noqa: BLE001
                            self._deliver_error(batch, e)
                else:
                    inflight = (key, batch) + dispatched
            except BaseException:  # noqa: BLE001 — worker must survive
                log.exception("search worker iteration failed")

    def _safe_finalize(self, inflight):
        if inflight is None:
            return
        key, batch = inflight[0], inflight[1]
        try:
            self._finalize(key, *inflight[1:])
        except BaseException as e:  # noqa: BLE001 — to the waiters
            self._deliver_error(batch, e)

    @staticmethod
    def _deliver_error(batch, e):
        for slot, ev in batch:
            if not ev.is_set():
                slot[1] = e
                ev.set()

    def _pad_batch(self, batch):
        qs = [slot[0] for slot, _ in batch]
        sizes = [q.shape[0] for q in qs]
        queries = np.concatenate(qs)
        nq = queries.shape[0]
        self.n_requests += nq
        self.n_batches += 1
        # pad to a power of two so repeat sizes hit the compile cache
        n_pad = max(8, 1 << (nq - 1).bit_length()) - nq
        if n_pad:
            queries = np.concatenate(
                [queries, np.repeat(queries[:1], n_pad, axis=0)])
        return queries, sizes

    def _dispatch_device(self, key, batch):
        """Launch without waiting; None if only the sync path applies."""
        if self.sharded:
            return None
        from verticut_tpu.search import mih_search_dispatch
        knn, approx = key
        queries, sizes = self._pad_batch(batch)
        h = mih_search_dispatch(self.index, queries,
                                SearchConfig(knn=knn, approximate=approx))
        if h is None:  # fused driver declined: fall back to sync
            return ("sync", queries, sizes)
        return (h, None, sizes)

    def _finalize(self, key, batch, handle, queries_or_none, sizes):
        from verticut_tpu.search import mih_search, mih_search_finalize
        knn, approx = key
        scfg = SearchConfig(knn=knn, approximate=approx)
        if handle == "sync":
            res = mih_search(self.index, queries_or_none, scfg)
        else:
            res = mih_search_finalize(handle)
            if res is None:  # stage-budget edge: redo via the loop driver
                res = mih_search(self.index, handle.queries, scfg)
        self._distribute(batch, sizes, res)

    def _execute_sync(self, key, batch):
        knn, approx = key
        scfg = SearchConfig(knn=knn, approximate=approx)
        queries, sizes = self._pad_batch(batch)
        from verticut_tpu.search.sharded import sharded_mih_search
        res = sharded_mih_search(self.index, queries, scfg)
        self._distribute(batch, sizes, res)

    def _distribute(self, batch, sizes, res):
        lo = 0
        for (slot, evt), sz in zip(batch, sizes):
            rows = []
            for qi in range(lo, lo + sz):
                rows.append([[int(i), int(d)] for i, d in
                             zip(res.ids[qi], res.dists[qi]) if i >= 0])
            slot[1] = rows
            evt.set()
            lo += sz

    def prewarm(self, knn: Optional[int] = None, approx: bool = False,
                max_rows: Optional[int] = None):
        """Compile every power-of-two batch-shape bucket up to ``max_rows``.

        The worker pads each device batch to a power of two
        (``_pad_batch``) so repeat sizes hit the compile cache — but a
        bucket first seen under load stalls the single worker for a full
        compile with every queued request behind it. A production server
        compiles its shape buckets before accepting load; with the
        persistent compile cache this is seconds on any later start.
        """
        knn = self.default_knn if knn is None else knn
        max_rows = self.max_batch_rows if max_rows is None else max_rows
        codes_arr = self.index.codes
        if codes_arr is None:
            raise ValueError("index holds no code array")
        row = np.asarray(codes_arr[:1])
        b = 8
        while b <= max_rows:
            self._search(np.repeat(row, b, axis=0), knn, approx)
            log.info("prewarm: bucket %d compiled", b)
            b *= 2

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self.epoch += 1
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("image-search server on port %d", self.port)
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        if self._running:
            self._running = False
            self._work.put(None)  # stop sentinel: worker drains in-flight
            if self._worker is not None:
                self._worker.join(timeout=10)
        # proactively disconnect live clients so they reconnect and observe
        # the new epoch (the reference's resize-protocol behavior,
        # store-server.cc:97-146: disconnect all, clients retry)
        for s in list(self._conns):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5)
