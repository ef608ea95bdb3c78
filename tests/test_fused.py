"""Fused single-dispatch driver == adaptive loop driver, bit for bit."""

import numpy as np
import pytest

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.search import mih_search


@pytest.mark.parametrize("n,n_tables,k,approx", [
    (500, 4, 10, False),
    (400, 16, 5, False),
    (600, 4, 5, True),
])
def test_fused_matches_loop(n, n_tables, k, approx):
    rng = np.random.default_rng(n + k)
    packed = codes.pack_bytes(
        rng.integers(0, 256, size=(n, 16), dtype=np.uint8))
    idx = build_index(packed, MIHConfig(bits=128, n_tables=n_tables))
    kw = dict(knn=k, approximate=approx, approximate_factor=4,
              candidate_cap=1024)
    q = packed[:32]
    r_fused = mih_search(idx, q, SearchConfig(fused=True, **kw))
    r_loop = mih_search(idx, q, SearchConfig(fused=False, **kw))
    assert np.array_equal(r_fused.dists, r_loop.dists)
    assert np.array_equal(r_fused.ids, r_loop.ids)
    assert np.array_equal(r_fused.radius, r_loop.radius)
    assert np.array_equal(r_fused.n_probes, r_loop.n_probes)


def test_fused_stage_overflow_falls_back():
    """If every query stays active past a stage budget, the fused driver
    must detect it and fall back to the loop driver (still exact)."""
    rng = np.random.default_rng(0)
    packed = codes.pack_bytes(
        rng.integers(0, 256, size=(800, 16), dtype=np.uint8))
    idx = build_index(packed, MIHConfig(bits=128, n_tables=16))
    # random data, k=20: nothing finishes early -> active set exceeds
    # nq>>3 after stage 0 -> compact_ovf -> loop fallback
    from verticut_tpu.search import linear_search
    q = packed[:128]
    res = mih_search(idx, q, SearchConfig(fused=True, knn=20,
                                          candidate_cap=2048))
    ld, _ = linear_search(q, packed, 20, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))


def test_async_dispatch_finalize_matches_sync():
    """mih_search_dispatch/finalize (the pipelining API) must return
    exactly what the sync entry point returns."""
    from verticut_tpu.search import (mih_search_dispatch,
                                     mih_search_finalize)
    rng = np.random.default_rng(42)
    packed = codes.pack_bytes(
        rng.integers(0, 256, size=(2000, 16), dtype=np.uint8))
    idx = build_index(packed, MIHConfig(bits=128, n_tables=4))
    q = packed[:64]
    scfg = SearchConfig(knn=7)
    sync = mih_search(idx, q, scfg)
    # two handles in flight, finalized out of order
    h1 = mih_search_dispatch(idx, q, scfg)
    h2 = mih_search_dispatch(idx, q[::-1].copy(), scfg)
    r2 = mih_search_finalize(h2)
    r1 = mih_search_finalize(h1)
    assert np.array_equal(r1.dists, sync.dists)
    assert np.array_equal(r1.ids, sync.ids)
    assert np.array_equal(r2.dists, sync.dists[::-1])
    assert np.array_equal(r2.ids, sync.ids[::-1])
