"""Single-device MIH engine: integrity, exactness, approximate mode.

Test tiers mirror SURVEY.md §4: data-structure round-trips (tier 1),
index-correctness oracle = integrity_check.cc analog (tier 4a), recall
parity vs brute force = linear-search oracle (tier 4b).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.index.mih import save_index, load_index
from verticut_tpu.search import linear_search, mih_search
from tests import reference_model as ref


def make_db(n=400, bits=128, seed=0, clustered=False):
    if clustered:
        packed = codes.clustered_codes(seed, n, bits)
        return codes.unpack_to_bytes(packed), packed
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    return raw, codes.pack_bytes(raw)


# m=4 over 128 bits gives s_bits=32 (SortedDirectory);
# m=16 gives s_bits=8 (DenseDirectory). Both paths must agree.
@pytest.mark.parametrize("n_tables", [4, 16])
def test_integrity_every_code_in_own_bucket(n_tables):
    """integrity_check.cc:37-70 analog: each code's substring bucket
    contains the (id, code) pair."""
    raw, packed = make_db(n=257)
    cfg = MIHConfig(bits=128, n_tables=n_tables)
    idx = build_index(packed, cfg)
    subs = np.asarray(idx.table_subs(jnp.asarray(packed)))
    for t, tab in enumerate(idx.tables):
        # RangeDirectory.lookup returns the containing prefix range — a
        # superset of the exact bucket; membership still must hold.
        starts, counts = tab.directory.lookup(jnp.asarray(subs[:, t]))
        starts, counts = np.asarray(starts), np.asarray(counts)
        entry_ids = np.asarray(tab.entry_ids)
        if tab.entry_codes is not None:
            entry_codes = np.asarray(tab.entry_codes)
        else:  # blocked word-major rows (range engine)
            from verticut_tpu.index.mih import unblock_entry_rows
            w = np.asarray(packed).shape[-1]
            _, entry_codes = unblock_entry_rows(tab.entry_rows, w)
            entry_codes = entry_codes[:len(entry_ids)]
        for i in range(len(raw)):
            bucket_ids = entry_ids[starts[i]:starts[i] + counts[i]]
            assert i in bucket_ids, (t, i)
            row = starts[i] + list(bucket_ids).index(i)
            assert np.array_equal(entry_codes[row], np.asarray(packed)[i])


@pytest.mark.parametrize("n_tables,clustered", [(4, False), (4, True),
                                                (16, False)])
def test_exact_mih_matches_brute_force(n_tables, clustered):
    raw, packed = make_db(n=500, clustered=clustered, seed=3)
    cfg = MIHConfig(bits=128, n_tables=n_tables)
    idx = build_index(packed, cfg)
    k = 10
    q = packed[:16]
    # default fallback_ratio: s_bits=32 cuts over to the linear scan after
    # radius 2 (C(32,3)*4 > 4*500); s_bits=8 enumerates fully. Both exact.
    scfg = SearchConfig(fused=False, knn=k, max_enum_radius=cfg.s_bits, candidate_cap=512)
    res = mih_search(idx, q, scfg)
    ld, li = linear_search(q, packed, k, method="popcount")
    ld = np.asarray(ld)
    # distance multisets must match exactly (ties at the kth boundary can
    # legally differ in id)
    assert np.array_equal(np.sort(res.dists, -1), np.sort(ld, -1))
    # every returned (id, dist) must be genuine
    d_check = np.asarray(codes.hamming_distance(
        jnp.asarray(packed)[res.ids], jnp.asarray(q)[:, None, :]))
    assert np.array_equal(d_check, res.dists)


def test_exact_stop_radius_reasonable():
    raw, packed = make_db(n=2000, seed=7)
    idx = build_index(packed, MIHConfig())
    res = mih_search(idx, packed[:8], SearchConfig(fused=False, knn=5, max_enum_radius=32,
                                                   candidate_cap=2048))
    # self-match plus random 128-bit dists ~64 means several radii
    assert (res.radius >= 1).all()
    assert (res.dists[:, 0] == 0).all()  # each query finds itself


def test_overflow_retry_preserves_exactness():
    raw, packed = make_db(n=600, seed=9)
    cfg = MIHConfig(bits=128, n_tables=16)  # s_bits=8 → dense, big buckets
    idx = build_index(packed, cfg)
    k = 5
    # tiny cap forces overflow + retry
    res = mih_search(idx, packed[:8],
                     SearchConfig(fused=False, knn=k, candidate_cap=16, max_enum_radius=3))
    ld, _ = linear_search(packed[:8], packed, k, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))


def test_approximate_mode_fills_pool_and_is_sane():
    raw, packed = make_db(n=3000, seed=11)
    idx = build_index(packed, MIHConfig())
    k = 10
    exact = mih_search(idx, packed[:6], SearchConfig(fused=False, knn=k, max_enum_radius=32,
                                                     candidate_cap=4096))
    approx = mih_search(
        idx, packed[:6],
        SearchConfig(fused=False, knn=k, approximate=True, approximate_factor=5,
                     max_enum_radius=32, candidate_cap=4096))
    # approximate results are real distances and no better than exact
    d_check = np.asarray(codes.hamming_distance(
        jnp.asarray(packed)[approx.ids], jnp.asarray(packed[:6])[:, None, :]))
    assert np.array_equal(d_check, approx.dists)
    assert (approx.dists.sum(-1) >= exact.dists.sum(-1)).all()


def test_bitmap_filter_does_not_change_results():
    raw, packed = make_db(n=300, seed=13)
    cfg = MIHConfig(bits=128, n_tables=16)
    idx = build_index(packed, cfg, with_bitmap=True)
    scfg = SearchConfig(fused=False, knn=5, max_enum_radius=3, candidate_cap=1024)
    r1 = mih_search(idx, packed[:8], scfg)
    r2 = mih_search(idx, packed[:8],
                    SearchConfig(fused=False, knn=5, max_enum_radius=3, candidate_cap=1024,
                                 use_bitmap=True))
    assert np.array_equal(r1.dists, r2.dists)
    assert np.array_equal(r1.ids, r2.ids)


def test_compact_index_no_inline_codes():
    raw, packed = make_db(n=300, seed=15)
    idx = build_index(packed, MIHConfig(bits=128, n_tables=16),
                      store_codes=False)
    res = mih_search(idx, packed[:5],
                     SearchConfig(fused=False, knn=5, max_enum_radius=3, candidate_cap=1024,
                                  fallback_ratio=1e9))
    ld, _ = linear_search(packed[:5], packed, 5, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))


def test_save_load_roundtrip(tmp_path):
    raw, packed = make_db(n=120, seed=17)
    idx = build_index(packed, MIHConfig(), with_bitmap=False)
    p = str(tmp_path / "index.npz")
    save_index(p, idx)
    idx2 = load_index(p)
    scfg = SearchConfig(fused=False, knn=5, max_enum_radius=32, candidate_cap=512)
    r1 = mih_search(idx, packed[:4], scfg)
    r2 = mih_search(idx2, packed[:4], scfg)
    assert np.array_equal(r1.dists, r2.dists)
    assert np.array_equal(r1.ids, r2.ids)


def test_stats_counters_populated():
    raw, packed = make_db(n=500, seed=19)
    idx = build_index(packed, MIHConfig(bits=128, n_tables=16))
    res = mih_search(idx, packed[:4],
                     SearchConfig(fused=False, knn=3, max_enum_radius=3, candidate_cap=2048,
                                  fallback_ratio=1e9))
    assert (res.n_probes > 0).all()
    assert (res.n_nonempty >= 1).all()   # own bucket at least
    assert (res.n_cands >= 1).all()
    assert (res.n_probes >= res.n_nonempty).all()


def _hot_prefix_adversary(seed=23, n_hot=1995):
    """ADVICE r2 (high) repro: a prefix-clustered hot range that overflows
    block-granular candidate budgets even at cap >= n, plus one closer
    neighbor whose prefix differs by 1 bit per table. A dropped overflow
    flag silently loses the d=4 neighbor."""
    rng = np.random.default_rng(seed)
    q = codes.random_codes(seed, 1)[0]                     # uint32[4]
    # substring t == packed word t (codes.py); range pbits=8 at n~2000, so
    # prefix = top 8 bits of each word, "low" bits = positions 0..23
    c8 = q.copy()
    for t in range(4):
        lo = rng.choice(24, size=2, replace=False)
        c8[t] ^= (np.uint32(1) << lo[0]) | (np.uint32(1) << lo[1])
    c4 = q.copy()
    for t in range(4):
        c4[t] ^= np.uint32(1) << np.uint32(24 + rng.integers(8))
    db = np.concatenate([np.repeat(c8[None], n_hot, axis=0), c4[None]])
    return q[None], db


@pytest.mark.parametrize("fused", [False, True])
def test_terminal_overflow_never_silently_inexact(fused):
    """Overflow at cap >= n must fall back to the exact scan, not return:
    block-granular budgets (+1 block per straddling probe) can clip even
    when the cap nominally covers every entry (exactness invariant)."""
    q, db = _hot_prefix_adversary()
    cfg = MIHConfig(bits=128, n_tables=4)
    idx = build_index(db, cfg, directory="range")
    res = mih_search(idx, q, SearchConfig(fused=fused, knn=5,
                                          candidate_cap=4096))
    ld, _ = linear_search(q, db, 5, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1),
                          np.sort(np.asarray(ld), -1))
    assert res.dists.min() == 4, "closer neighbor lost to budget clipping"


def test_use_bitmap_rejected_on_range_engine():
    """A config knob must never silently no-op (VERDICT r2 weak #4)."""
    raw, packed = make_db(n=200, seed=29)
    idx = build_index(packed, MIHConfig(), directory="range")
    with pytest.raises(ValueError, match="use_bitmap"):
        mih_search(idx, packed[:2], SearchConfig(knn=3, use_bitmap=True))


def test_query_word_count_mismatch_raises():
    """A query batch with the wrong uint32 word count must raise, never
    silently probe garbage substrings (verify-drive edge probe; the
    reference validates code size at load, build_hash_tables.cc:42)."""
    import pytest
    from verticut_tpu.search import mih_search

    _, db = make_db(500)
    idx = build_index(db, MIHConfig(bits=128, n_tables=4))
    bad_q = np.asarray(db[:4])[:, :2]          # 64-bit queries
    with pytest.raises(ValueError, match="code width"):
        mih_search(idx, bad_q, SearchConfig(knn=3))
