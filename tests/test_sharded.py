"""Sharded engine on the 8-device virtual CPU mesh.

The distributed-parity tier of SURVEY.md §4: the sharded engine must agree
with the single-device engine and the brute-force oracle on every mesh
shape (table-only, table+shard, table+query, full 3-D).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.parallel import make_mesh
from verticut_tpu.search import linear_search, mih_search
from verticut_tpu.search.sharded import (build_sharded_index,
                                         sharded_linear_search,
                                         sharded_mih_search)


def make_db(n, seed=0, bits=128):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    return codes.pack_bytes(raw)


@pytest.mark.parametrize("mesh_shape", [
    (4, 1, 1),   # one table per device (the mpirun -n 4 analog)
    (4, 2, 1),   # + range-sharded tables (the Pilaf multi-server analog)
    (4, 1, 2),   # + query parallelism
    (2, 2, 2),   # table axis folded (2 tables per slice is invalid for m=4,
])
def test_sharded_matches_oracle(mesh_shape):
    m_t, m_s, m_q = mesh_shape
    cfg = MIHConfig(bits=128, n_tables=4)
    if m_t not in (1, cfg.n_tables):
        with pytest.raises(ValueError):
            build_sharded_index(make_db(64), cfg, make_mesh(m_t, m_s, m_q))
        return
    packed = make_db(600, seed=1)
    mesh = make_mesh(m_t, m_s, m_q)
    idx = build_sharded_index(packed, cfg, mesh)
    k = 10
    q = np.asarray(packed[:16])
    scfg = SearchConfig(knn=k, candidate_cap=512)
    res = sharded_mih_search(idx, q, scfg)
    ld, li = linear_search(q, packed, k, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))


def test_sharded_matches_single_device_engine():
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = make_db(500, seed=2)
    mesh = make_mesh(4, 2, 1)
    sidx = build_sharded_index(packed, cfg, mesh)
    idx = build_index(packed, cfg)
    scfg = SearchConfig(knn=8, candidate_cap=512)
    r_sh = sharded_mih_search(sidx, np.asarray(packed[:12]), scfg)
    r_1d = mih_search(idx, packed[:12], scfg)
    assert np.array_equal(r_sh.dists, r_1d.dists)
    assert np.array_equal(r_sh.ids, r_1d.ids)


def test_sharded_full_enum_no_fallback():
    """Small s_bits: pure enumeration path across the mesh, vs oracle."""
    cfg = MIHConfig(bits=128, n_tables=16)  # s_bits=8
    packed = make_db(320, seed=3)
    mesh = make_mesh(1, 8, 1)  # tables folded, 8 range shards
    idx = build_sharded_index(packed, cfg, mesh)
    scfg = SearchConfig(knn=5, max_enum_radius=8, candidate_cap=1024,
                        fallback_ratio=1e9)
    res = sharded_mih_search(idx, np.asarray(packed[:8]), scfg)
    ld, _ = linear_search(packed[:8], packed, 5, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))


def test_sharded_linear_scan():
    packed = make_db(333, seed=4)  # deliberately not divisible by 8
    mesh = make_mesh(4, 2, 1)
    cfg = MIHConfig()
    idx = build_sharded_index(packed, cfg, mesh)
    q = jax.device_put(np.asarray(packed[:8]))
    d, i = sharded_linear_search(mesh, idx.codes, jnp.asarray(q), 7,
                                 n_total=idx.n)
    ed, ei = linear_search(packed[:8], packed, 7, method="popcount")
    assert np.array_equal(np.asarray(d), np.asarray(ed))
    assert np.array_equal(np.asarray(i), np.asarray(ei))


def test_sharded_approx_mode():
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = make_db(2000, seed=5)
    mesh = make_mesh(4, 1, 2)
    idx = build_sharded_index(packed, cfg, mesh)
    res = sharded_mih_search(
        idx, np.asarray(packed[:8]),
        SearchConfig(knn=5, approximate=True, approximate_factor=4,
                     candidate_cap=1024))
    # every returned id's distance is genuine
    d_check = np.asarray(codes.hamming_distance(
        jnp.asarray(packed)[np.clip(res.ids, 0, None)],
        jnp.asarray(packed[:8])[:, None, :]))
    valid = res.ids >= 0
    assert np.array_equal(d_check[valid], res.dists[valid])


def test_sharded_full_3d_mesh_unbalanced():
    """All three axes active at once on the 8-device mesh, with a code
    count that doesn't divide the shard axis (padding path)."""
    cfg = MIHConfig(bits=64, n_tables=2)
    packed = make_db(401, seed=9, bits=64)  # non-divisible: padding path
    mesh = make_mesh(2, 2, 2)
    idx = build_sharded_index(packed, cfg, mesh)
    res = sharded_mih_search(idx, np.asarray(packed[:8]),
                             SearchConfig(knn=6, candidate_cap=512))
    ld, _ = linear_search(packed[:8], packed, 6, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))


def test_straddling_hot_bucket_across_shards():
    """Adversary (VERDICT r1 weak#2): one bucket (a single repeated
    substring value) with count far above the per-step fetch budget,
    positioned so its sorted run straddles the shard boundary. The range
    engine must return it piecewise from both shards and stay exact via
    the overflow retry."""
    cfg = MIHConfig(bits=128, n_tables=4)
    rng = np.random.default_rng(77)
    # half the corpus shares one exact code -> in every table one run of
    # ~n/2 equal keys; with 2 shards the run must straddle the boundary
    hot = codes.random_codes(5, 1, cfg.bits)
    n_hot, n_rest = 600, 600
    rest = codes.random_codes(6, n_rest, cfg.bits)
    packed = np.concatenate([np.repeat(hot, n_hot, axis=0), rest])
    perm = rng.permutation(len(packed))
    packed = packed[perm]
    mesh = make_mesh(4, 2, 1)
    index = build_sharded_index(packed, cfg, mesh)
    queries = np.concatenate([hot, rest[:15]])  # hot query + normal ones
    scfg = SearchConfig(knn=10, candidate_cap=256)  # tight: force retries
    res = sharded_mih_search(index, queries, scfg)
    ld, _ = linear_search(queries, packed, 10, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1),
                          np.sort(np.asarray(ld), -1))


@pytest.mark.slow
def test_sharded_scale_1m_rows():
    """~1M-row corpus on the 8-device virtual mesh: realistic shard
    boundaries, capacity math and collective shapes (VERDICT r1 weak#2)."""
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.clustered_codes(13, 1_000_000, cfg.bits,
                                   n_clusters=5000, flip_p=0.02)
    mesh = make_mesh(4, 2, 1)
    index = build_sharded_index(packed, cfg, mesh)
    rng = np.random.default_rng(3)
    sel = rng.integers(0, len(packed), 64)
    qraw = codes.unpack_to_bytes(packed[sel])
    flips = rng.integers(0, cfg.bits, (64, 3))
    for i in range(64):
        for b in flips[i]:
            qraw[i, b // 8] ^= 1 << (b % 8)
    queries = codes.pack_bytes(qraw)
    res = sharded_mih_search(index, queries, SearchConfig(knn=10))
    ld, _ = linear_search(queries, packed, 10, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1),
                          np.sort(np.asarray(ld), -1))
