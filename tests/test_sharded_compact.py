"""Compact sharded engine (value-partitioned shards, distributed build,
distance-at-owner scoring) on the 8-device virtual CPU mesh.

This is the 1B-layout path (DESIGN.md §3 compact column): per-table id
rows + one id-sharded code array, built per-device — no device or host
ever materializes a full table (VERDICT r2 missing #1).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.parallel import make_mesh
from verticut_tpu.search import linear_search
from verticut_tpu.search.sharded_compact import (ShardedCompactIndex,
                                                 build_sharded_compact,
                                                 sharded_compact_search)


def make_db(n, seed=0, bits=128, clustered=False):
    if clustered:
        return codes.clustered_codes(seed, n, bits, n_clusters=16,
                                     flip_p=0.03)
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    return codes.pack_bytes(raw)


@pytest.mark.parametrize("mesh_shape,clustered", [
    ((4, 2, 1), False),   # one table per device + 2 value shards
    ((1, 8, 1), False),   # tables folded, 8 value shards
    ((4, 1, 2), False),   # query parallelism
    ((4, 2, 1), True),    # clustered (skewed) data
])
def test_compact_sharded_matches_oracle(mesh_shape, clustered):
    m_t, m_s, m_q = mesh_shape
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(m_t, m_s, m_q)
    db = make_db(1500, seed=3, clustered=clustered)
    idx = build_sharded_compact(db, cfg, mesh, slack=2.5)
    nq = 8 * m_q
    q = np.asarray(db[:nq])
    res = sharded_compact_search(
        idx, q, SearchConfig(knn=5, candidate_cap=1024))
    ld, _ = linear_search(q, db, 5, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1),
                          np.sort(np.asarray(ld), -1)), mesh_shape
    assert (res.dists[:, 0] == 0).all()      # self-match
    assert (res.n_probes > 0).all()
    assert (res.n_cands >= 1).all()


def test_compact_build_matches_central_reference():
    """The distributed build must index every (id, substring) pair exactly
    once: reassemble per-shard slices and compare against a host-side
    sort — the integrity_check.cc analog for the distributed build."""
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(4, 2, 1)
    db = make_db(700, seed=9)
    idx = build_sharded_compact(db, cfg, mesh, slack=2.5)
    n = db.shape[0]
    idrows = np.asarray(idx.idrows)          # [m, NB, 32]
    se = np.asarray(idx.se)                  # [m, 2^p, 2]
    p_loc = (1 << idx.pbits) // idx.n_shards
    rows_per_shard = idx.cap_rows
    shift = cfg.s_bits - idx.pbits
    subs = np.stack([np.asarray(codes.substring(jnp.asarray(db), t,
                                                cfg.s_bits))
                     for t in range(4)], axis=1)
    for t in range(4):
        ids_flat = idrows[t].reshape(-1).astype(np.int64)
        got = []
        for s in range(idx.n_shards):
            sl = ids_flat[s * rows_per_shard:(s + 1) * rows_per_shard]
            got.append(sl[sl != 0xFFFFFFFF])
        all_ids = np.concatenate(got)
        assert sorted(all_ids) == list(range(n)), f"table {t}"
        # per-prefix ranges point at exactly the ids with that prefix
        for s in range(idx.n_shards):
            base = s * rows_per_shard
            for lp in range(0, p_loc, max(1, p_loc // 7)):
                pref = s * p_loc + lp
                st, en = se[t, pref]
                ids_in = ids_flat[base + st:base + en]
                expect = np.nonzero(
                    (subs[:, t] >> shift) == pref)[0]
                assert sorted(ids_in) == sorted(expect), (t, s, lp)


def test_compact_memory_stats_match_design_math():
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(4, 2, 1)
    n = 4096
    idx = build_sharded_compact(make_db(n, seed=5), cfg, mesh, slack=1.5)
    st = idx.memory_stats()
    # DESIGN §3 compact column: m tables x 4 B ids (x slack x padding) +
    # 16 B codes + directory
    assert st["codes_bytes"] >= n * 16
    assert st["idrows_bytes"] >= n * 4 * 4
    assert st["idrows_bytes"] <= n * 4 * 4 * 2.2   # slack-bounded
    assert st["bytes_per_device"] * st["n_devices"] == st["total_bytes"]
    assert 30 <= st["bytes_per_code"] <= 120


def test_compact_build_raises_on_value_skew_overflow():
    """All codes sharing one prefix must overflow a tight shard capacity
    and raise — never silently drop rows (exactness contract)."""
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(4, 2, 1)
    db = np.repeat(make_db(1, seed=11), 2000, axis=0)  # one hot prefix
    with pytest.raises(ValueError, match="skew"):
        build_sharded_compact(db, cfg, mesh, slack=1.01)


@pytest.mark.parametrize("mesh_shape,reload_q", [
    ((4, 2, 1), 1),   # same mesh back
    ((4, 1, 1), 2),   # model axes equal, different query axis (8 devices)
])
def test_compact_save_load_roundtrip(tmp_path, mesh_shape, reload_q):
    """The scale index must persist and restore per shard (VERDICT r3
    missing #2 — the op-log checkpoint role, Pilaf/store-server.cc:58-94):
    search-after-load must match the brute-force oracle exactly."""
    from verticut_tpu.search.sharded_compact import (load_sharded_compact,
                                                     save_sharded_compact)
    m_t, m_s, m_q = mesh_shape
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(m_t, m_s, m_q)
    db = make_db(1800, seed=21, clustered=True)
    idx = build_sharded_compact(db, cfg, mesh, slack=2.5)
    path = str(tmp_path / "cidx")
    save_sharded_compact(path, idx)

    mesh2 = make_mesh(m_t, m_s, reload_q)
    idx2 = load_sharded_compact(path, mesh2)
    assert idx2.n == idx.n and idx2.pbits == idx.pbits
    assert idx2.cap_rows == idx.cap_rows
    np.testing.assert_array_equal(np.asarray(idx2.idrows),
                                  np.asarray(idx.idrows))
    np.testing.assert_array_equal(np.asarray(idx2.se), np.asarray(idx.se))
    nq = 8 * reload_q
    q = np.asarray(db[:nq])
    res = sharded_compact_search(idx2, q,
                                 SearchConfig(knn=5, candidate_cap=1024))
    ld, _ = linear_search(q, db, 5, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1),
                          np.sort(np.asarray(ld), -1))
    assert (res.dists[:, 0] == 0).all()


def test_compact_load_rejects_mismatched_model_mesh(tmp_path):
    from verticut_tpu.search.sharded_compact import (load_sharded_compact,
                                                     save_sharded_compact)
    cfg = MIHConfig(bits=128, n_tables=4)
    idx = build_sharded_compact(make_db(800, seed=23), cfg,
                                make_mesh(4, 2, 1), slack=2.5)
    path = str(tmp_path / "cidx")
    save_sharded_compact(path, idx)
    with pytest.raises(ValueError, match="mesh"):
        load_sharded_compact(path, make_mesh(4, 1, 2))


def test_compact_approximate_mode():
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(4, 2, 1)
    db = make_db(2000, seed=13)
    idx = build_sharded_compact(db, cfg, mesh, slack=2.5)
    q = np.asarray(db[:8])
    exact = sharded_compact_search(idx, q, SearchConfig(knn=5))
    approx = sharded_compact_search(
        idx, q, SearchConfig(knn=5, approximate=True, approximate_factor=5))
    assert (approx.dists.sum(-1) >= exact.dists.sum(-1)).all()
    assert (approx.dists[:, 0] == 0).all()


@pytest.mark.skipif(not __import__("os").environ.get("VERTICUT_SCALE_TESTS"),
                    reason="10M-row distributed build takes ~10 min on the "
                           "CPU mesh; set VERTICUT_SCALE_TESTS=1 to run "
                           "(measured green 2026-08-17: build 535 s, "
                           "43.4 B/code, 64-query oracle multiset equal)")
def test_compact_scale_10m_rows():
    """VERDICT r2 missing #1 done-criteria: virtual-mesh build+search of a
    compact sharded index at >= 10M rows, oracle-verified, with the
    DESIGN §3 memory math asserted via memory_stats()."""
    cfg = MIHConfig(bits=128, n_tables=4)
    mesh = make_mesh(4, 2, 1)
    n = 10_000_000
    db = codes.clustered_codes_device(0, n, cfg.bits, n_clusters=n // 200,
                                      flip_p=0.02)
    idx = build_sharded_compact(db, cfg, mesh)
    st = idx.memory_stats()
    assert st["bytes_per_code"] < 60          # DESIGN §3 compact column
    q = np.asarray(db[:64])
    res = sharded_compact_search(idx, jnp.asarray(q), SearchConfig(knn=10))
    ld, _ = linear_search(jnp.asarray(q), db, 10, method="popcount")
    assert np.array_equal(np.sort(np.asarray(res.dists), -1),
                          np.sort(np.asarray(ld), -1))
