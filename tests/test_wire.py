"""The in-repo msgpack codec of the RPC front-end (service/wire.py)."""

import importlib
import sys

import numpy as np
import pytest

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.search import mih_search
from verticut_tpu.service import wire

# byte strings written out from the msgpack specification's format table
SPEC_CASES = [
    (None, "c0"), (False, "c2"), (True, "c3"),
    (0, "00"), (127, "7f"), (128, "cc80"), (256, "cd0100"),
    (65536, "ce00010000"), (2**32, "cf0000000100000000"),
    (-1, "ff"), (-32, "e0"), (-33, "d0df"), (-129, "d1ff7f"),
    (-32769, "d2ffff7fff"), (-2**31 - 1, "d3ffffffff7fffffff"),
    (1.5, "cb3ff8000000000000"),
    ("", "a0"), ("abc", "a3616263"), ("x" * 32, "d920" + "78" * 32),
    (b"", "c400"), (b"\x01\x02", "c4020102"),
    (b"\x00" * 256, "c50100" + "00" * 256),
    ([], "90"), ([1, [2]], "920191" + "02"), (list(range(16)),
                                              "dc0010" + "".join(
                                                  f"{i:02x}"
                                                  for i in range(16))),
    ({}, "80"), ({"a": 1}, "81a16101"),
    ([0, 7, "ping", []], "940007a470696e6790"),
]


@pytest.mark.parametrize("obj,hexbytes", SPEC_CASES)
def test_codec_matches_spec_bytes(obj, hexbytes):
    data = bytes.fromhex(hexbytes)
    assert wire.packb(obj) == data
    assert wire.unpackb(data) == obj


def test_codec_rejects_what_it_cannot_carry():
    with pytest.raises(TypeError):
        wire.packb({1, 2})
    with pytest.raises(OverflowError):
        wire.packb(2**64)
    with pytest.raises(ValueError):
        wire.unpackb(bytes.fromhex("c1"))            # never-used type byte
    with pytest.raises(ValueError):
        wire.unpackb(bytes.fromhex("92 01"))         # truncated array
    assert wire.packb(np.int64(-5)) == wire.packb(-5)


def test_unpacker_streams_across_arbitrary_splits():
    msgs = [[0, i, "search_batch", [b"\xff" * (40 * i), 10, False]]
            for i in range(6)] + [{"n": [1.25, None, {"x": b"q"}]}]
    data = b"".join(wire.packb(m) for m in msgs)
    for step in (1, 3, 64, len(data)):
        u = wire.Unpacker()
        got = []
        for lo in range(0, len(data), step):
            u.feed(data[lo:lo + step])
            got.extend(u)
        assert got == msgs


def test_unpacker_parses_a_large_response_once(monkeypatch):
    """A multi-MB search_batch answer arriving in 64 KiB reads decodes
    with each item parsed once: the decoder resumes inside nested arrays
    instead of starting over on every read."""
    resp = [1, 7, None, [[[100_000_000 - 37 * r - j, j] for j in range(100)]
                         for r in range(4096)]]
    data = wire.packb(resp)
    assert len(data) > 2 << 20
    n_items = 5 + 4096 * (1 + 100 * 3)
    calls = 0
    head = wire._head

    def counting_head(buf, pos):
        nonlocal calls
        calls += 1
        return head(buf, pos)

    monkeypatch.setattr(wire, "_head", counting_head)
    u = wire.Unpacker()
    got = []
    n_reads = 0
    for lo in range(0, len(data), 1 << 16):
        u.feed(data[lo:lo + (1 << 16)])
        n_reads += 1
        got.extend(u)
    assert got == [resp]
    # one call per item, plus at most one incomplete attempt per read
    assert n_items <= calls <= n_items + n_reads


def test_server_round_trip_without_msgpack(monkeypatch):
    """The served path imports no msgpack package: with the import blocked,
    a freshly imported server and client still answer, and the answers
    equal mih_search."""
    monkeypatch.setitem(sys.modules, "msgpack", None)
    for name in [m for m in sys.modules
                 if m.startswith("verticut_tpu.service")]:
        monkeypatch.delitem(sys.modules, name)
    service = importlib.import_module("verticut_tpu.service")
    packed = codes.clustered_codes(2, 2000, 128, n_clusters=20, flip_p=0.03)
    idx = build_index(packed, MIHConfig())
    srv = service.ImageSearchServer(idx, port=0).start()
    cli = service.ImageSearchClient(port=srv.port, pool=2)
    try:
        want = mih_search(idx, packed[:8], SearchConfig(knn=5))
        raw = codes.unpack_to_bytes(packed[:8])
        got = cli.search_batch(raw.tobytes(), 5)
        assert got == [[[int(i), int(d)] for i, d in zip(want.ids[r],
                                                          want.dists[r])]
                       for r in range(8)]
        assert cli.search_image_by_id(3, 5) == got[3]
    finally:
        cli.close()
        srv.stop()
