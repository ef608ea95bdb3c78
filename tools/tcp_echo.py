"""Plain-TCP echo baseline — the control transport benchmark.

The reference ships ``Pilaf/tcp_echo/{multi.c,client.c}``: a threaded TCP
echo server + client used as the Ethernet/IPoIB control against the IB
verbs microbenchmarks (latency + throughput logs, ``multi.c:47,224``).
Here the analogous comparison is TCP loopback/DCN vs the in-process KV
path: this tool measures echo RTT latency and throughput over the same
message-size grid as the ib-test protocol (2^0..2^17 bytes,
``Pilaf/ib-test.cc:43``), giving the control row for
``tools/collective_bench.py`` (device-memory/collective analog) and
``tools/kv_loadtest.py`` (KV service).

Usage:
    python tools/tcp_echo.py --server [--port P]        # echo server
    python tools/tcp_echo.py --client HOST [--port P]   # size sweep
    python tools/tcp_echo.py                             # self-test (both)
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import statistics
import threading
import time


class _EchoHandler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                hdr = self._recv_exact(4)
                if hdr is None:
                    return
                n = int.from_bytes(hdr, "little")
                if n == 0:
                    return
                payload = self._recv_exact(n)
                if payload is None:
                    return
                sock.sendall(hdr + payload)
            except OSError:
                return

    def _recv_exact(self, n: int):
        buf = b""
        while len(buf) < n:
            part = self.request.recv(n - len(buf))
            if not part:
                return None
            buf += part
        return buf


class EchoServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class _S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
        self._srv = _S((host, port), _EchoHandler)
        self.port = self._srv.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def run_client(host: str, port: int, iters: int = 2000,
               max_log2: int = 17) -> list:
    """Echo RTT sweep over message sizes 2^0..2^max_log2 (ib-test grid).

    Reports per-size min/avg/stddev/max RTT and goodput, middle-fifth
    windowing excluded (latency mode measures every op; the reference's
    middle-fifth rule applies to its throughput mode, dht-test.cc:343)."""
    out = []
    sock = socket.create_connection((host, port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    f = sock.makefile("rb")
    for lg in range(0, max_log2 + 1):
        size = 1 << lg
        payload = b"\xa5" * size
        hdr = size.to_bytes(4, "little")
        n = max(50, iters >> max(0, lg - 8))   # fewer iters at big sizes
        lats = []
        for _ in range(n):
            t0 = time.perf_counter()
            sock.sendall(hdr + payload)
            rh = f.read(4)
            assert int.from_bytes(rh, "little") == size
            echoed = f.read(size)
            lats.append(time.perf_counter() - t0)
            assert len(echoed) == size
        lats_us = [x * 1e6 for x in lats]
        row = {
            "size": size, "iters": n,
            "rtt_us_min": round(min(lats_us), 1),
            "rtt_us_avg": round(statistics.mean(lats_us), 1),
            "rtt_us_stddev": round(statistics.pstdev(lats_us), 1),
            "rtt_us_max": round(max(lats_us), 1),
            "goodput_MBps": round(
                2 * size * n / sum(lats) / 1e6, 2),
        }
        out.append(row)
        print(json.dumps(row), flush=True)
    sock.sendall((0).to_bytes(4, "little"))
    sock.close()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server", action="store_true")
    ap.add_argument("--client", metavar="HOST")
    ap.add_argument("--port", type=int, default=36010)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--max-log2", type=int, default=17)
    args = ap.parse_args()
    if args.server:
        srv = EchoServer(host="0.0.0.0", port=args.port).start()
        print(f"echo server on :{srv.port}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
    elif args.client:
        run_client(args.client, args.port, args.iters, args.max_log2)
    else:  # self-test over loopback
        srv = EchoServer().start()
        try:
            run_client("127.0.0.1", srv.port, iters=min(args.iters, 500),
                       max_log2=min(args.max_log2, 12))
        finally:
            srv.stop()


if __name__ == "__main__":
    main()
