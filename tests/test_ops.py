"""Enumeration masks and the dedup top-k pool merge."""

import math

import numpy as np
import jax.numpy as jnp

from verticut_tpu.ops import enumeration, topk


def test_flip_masks_counts_and_popcount():
    for s_bits in (8, 16, 32):
        for r in range(0, min(s_bits, 5) + 1):
            masks = enumeration.flip_masks(s_bits, r)
            assert len(masks) == math.comb(s_bits, r)
            assert len(np.unique(masks)) == len(masks)
            pop = np.array([bin(int(m)).count("1") for m in masks])
            assert (pop == r).all()
            assert (masks < (1 << s_bits) if s_bits < 32 else
                    np.ones_like(masks, bool)).all()


def test_ball_coverage():
    # All 2^8 values are within distance 8 of any center.
    total = sum(len(enumeration.flip_masks(8, r)) for r in range(9))
    assert total == 256


def test_merge_topk_dedup_matches_numpy():
    rng = np.random.default_rng(0)
    q, p, c = 5, 8, 23
    pd, pi = topk.empty_pool(q, p)
    seen = [dict() for _ in range(q)]
    for _ in range(4):  # several merge rounds
        cid = rng.integers(-1, 30, size=(q, c)).astype(np.int32)
        # distance is a pure function of id (as in real Hamming candidates)
        cdist = np.where(cid >= 0, (cid * 7 + 3) % 50, 0).astype(np.int32)
        pd, pi = topk.merge_topk_dedup(pd, pi,
                                       jnp.asarray(cdist), jnp.asarray(cid))
        for i in range(q):
            for j in range(c):
                if cid[i, j] >= 0:
                    seen[i][int(cid[i, j])] = int(cdist[i, j])
    pd, pi = np.asarray(pd), np.asarray(pi)
    for i in range(q):
        expect = sorted((d, idx) for idx, d in seen[i].items())[:p]
        got = [(int(pd[i, j]), int(pi[i, j])) for j in range(min(p, len(expect)))]
        assert got == expect
        # remaining slots invalid
        for j in range(len(expect), p):
            assert pi[i, j] == -1


def test_merge_topk_no_dup_path():
    pd, pi = topk.empty_pool(1, 4)
    cd = jnp.asarray([[5, 1, 3, 2, 4]], jnp.int32)
    ci = jnp.asarray([[10, 11, 12, 13, 14]], jnp.int32)
    pd, pi = topk.merge_topk(pd, pi, cd, ci)
    assert np.asarray(pd).tolist() == [[1, 2, 3, 4]]
    assert np.asarray(pi).tolist() == [[11, 13, 12, 14]]


def test_chunk_topk_ties_prefer_low_position():
    d = jnp.asarray([[3, 1, 1, 2]], jnp.int32)
    ids = jnp.asarray([[100, 101, 102, 103]], jnp.int32)
    cd, ci = topk.chunk_topk(d, ids, 2)
    assert np.asarray(cd).tolist() == [[1, 1]]
    assert np.asarray(ci).tolist() == [[101, 102]]


def test_kth_stats():
    pd = jnp.asarray([[1, 2, 0x7FFFFFFF]], jnp.int32)
    pi = jnp.asarray([[7, 8, -1]], jnp.int32)
    full, kth = topk.kth_stats(pd, pi, 2)
    assert bool(full[0]) and int(kth[0]) == 2
    full3, _ = topk.kth_stats(pd, pi, 3)
    assert not bool(full3[0])


def test_merge_topk_dedup_packed_matches_general():
    rng = np.random.default_rng(7)
    q, p, c, m = 4, 10, 40, 4
    pd1, pi1 = topk.empty_pool(q, p)
    pd2, pi2 = topk.empty_pool(q, p)
    for _ in range(3):
        # candidate ids with <= m copies each (as in an m-table radius)
        base = rng.integers(0, 60, size=(q, c // m)).astype(np.int32)
        cid = np.concatenate([base] * m, axis=1)
        mask = rng.random((q, c)) < 0.2
        cid = np.where(mask, -1, cid).astype(np.int32)
        cdist = np.where(cid >= 0, (cid * 13 + 1) % 120, 0).astype(np.int32)
        cd, ci = jnp.asarray(cdist), jnp.asarray(cid)
        pd1, pi1 = topk.merge_topk_dedup(pd1, pi1, cd, ci)
        pd2, pi2 = topk.merge_topk_dedup_packed(pd2, pi2, cd, ci, n_dup=p * m)
    assert np.array_equal(np.asarray(pd1), np.asarray(pd2))
    assert np.array_equal(np.asarray(pi1), np.asarray(pi2))


def test_packed_merge_max_dist_boundary():
    # dist = 128 (full 128-bit complement) must survive packing
    pd, pi = topk.empty_pool(1, 3)
    cd = jnp.asarray([[128, 0, 128]], jnp.int32)
    ci = jnp.asarray([[5, 6, 5]], jnp.int32)
    pd, pi = topk.merge_topk_dedup_packed(pd, pi, cd, ci, n_dup=6)
    assert np.asarray(pd).tolist() == [[0, 128, 0x7FFFFFFF]]
    assert np.asarray(pi).tolist() == [[6, 5, -1]]


def test_can_pack_bounds():
    assert topk.can_pack((1 << 24) - 1, 128)
    assert not topk.can_pack(1 << 24, 128)
    assert topk.can_pack(100, 254)
    assert not topk.can_pack(100, 255)  # all-ones key is the sentinel


def test_expand_buckets_matches_numpy():
    from verticut_tpu.search.single import expand_buckets
    rng = np.random.default_rng(3)
    for c, cap in [(1, 8), (8, 16), (32, 64), (33, 128), (500, 64)]:
        q = 5
        counts = rng.integers(0, 5, size=(q, c)).astype(np.int32)
        starts = rng.integers(0, 1000, size=(q, c)).astype(np.int32)
        entry, valid, total = expand_buckets(
            jnp.asarray(starts), jnp.asarray(counts), cap)
        entry, valid, total = (np.asarray(entry), np.asarray(valid),
                               np.asarray(total))
        for qi in range(q):
            expect = []
            for j in range(c):
                expect.extend(range(starts[qi, j],
                                    starts[qi, j] + counts[qi, j]))
            t = counts[qi].sum()
            assert total[qi] == t
            nv = min(t, cap)
            assert valid[qi, :nv].all() and not valid[qi, nv:].any()
            assert entry[qi, :nv].tolist() == expect[:nv], (c, cap, qi)


def test_chunk_topk_affine_matches_numpy():
    from verticut_tpu.ops.topk import chunk_topk_affine
    rng = np.random.default_rng(11)
    layouts = {
        "random": rng.integers(0, 129, (4, 8192)).astype(np.int32),
        "ascending": np.tile(np.arange(8192, dtype=np.int32), (2, 1)),
        "descending": np.tile(np.arange(8192, 0, -1).astype(np.int32), (2, 1)),
        "all-equal": np.full((2, 8192), 7, np.int32),
        "ties": np.sort(rng.integers(0, 3, (2, 8192)).astype(np.int32), -1),
    }
    k, base, n_valid = 50, 1000, 8000
    for name, d in layouts.items():
        got_d, got_i = chunk_topk_affine(jnp.asarray(d), base, k, n_valid)
        got_d, got_i = np.asarray(got_d), np.asarray(got_i)
        expect = np.sort(d[:, :n_valid], axis=-1)[:, :k]
        assert np.array_equal(np.sort(got_d, -1), expect), name
        # ids index back into the chunk correctly
        sel = got_i - base
        vals = np.take_along_axis(d, sel, axis=-1)
        assert np.array_equal(vals, got_d), name
        assert (sel < n_valid).all(), name


def test_packed_merge_equals_sort_merge_at_dup_boundary():
    """VERDICT r1 weak#7: the packed fast-path merge must match the
    two-pass sort merge exactly when the duplicate-copy count rides at its
    documented bound (each id once per table per radius plus once in the
    pool -> n_dup = P * n_tables). Adversarial construction: every winner
    duplicated in every table AND already present in the pool."""
    rng = np.random.default_rng(0)
    p, m = 16, 4          # pool size, tables
    q = 32
    for trial in range(20):
        # winners: p ids with small distances, each appearing m times
        win_ids = np.stack(
            [rng.choice(200, size=p, replace=False) for _ in range(q)])
        win_d = rng.integers(0, 4, (q, p))
        # pool pre-seeded with the same winners (the +1 copy)
        pool_d = np.sort(win_d, axis=1)
        order = np.argsort(win_d, axis=1, kind="stable")
        pool_i = np.take_along_axis(win_ids, order, axis=1)
        # candidates: m copies of each winner + noise at larger distances
        cd = np.concatenate([np.repeat(win_d, m, axis=1),
                             rng.integers(5, 100, (q, 64))], axis=1)
        ci = np.concatenate([np.repeat(win_ids, m, axis=1),
                             rng.integers(200, 1 << 20, (q, 64))], axis=1)
        perm = rng.permutation(cd.shape[1])
        cd, ci = cd[:, perm], ci[:, perm]

        a_d, a_i = topk.merge_topk_dedup_packed(
            jnp.asarray(pool_d, jnp.int32), jnp.asarray(pool_i, jnp.int32),
            jnp.asarray(cd, jnp.int32), jnp.asarray(ci, jnp.int32),
            n_dup=p * m)
        b_d, b_i = topk.merge_topk_dedup(
            jnp.asarray(pool_d, jnp.int32), jnp.asarray(pool_i, jnp.int32),
            jnp.asarray(cd, jnp.int32), jnp.asarray(ci, jnp.int32))
        assert np.array_equal(np.asarray(a_d), np.asarray(b_d)), trial
        assert np.array_equal(np.asarray(a_i), np.asarray(b_i)), trial


def test_packed_merge_hierarchical_blocks_exact():
    """The blockwise pre-reduction path (wide candidate sets) must stay
    exact with winners concentrated inside a single block."""
    rng = np.random.default_rng(1)
    p, q, width = 10, 8, 8192
    pool_d = np.full((q, p), topk.INF_DIST, np.int32)
    pool_i = np.full((q, p), -1, np.int32)
    cd = rng.integers(50, 120, (q, width)).astype(np.int32)
    ci = np.tile(np.arange(width, dtype=np.int32), (q, 1))
    # plant all winners inside one 2048-block (adversarial for blockwise)
    cd[:, 4000:4000 + p] = rng.integers(0, 5, (q, p))
    a_d, a_i = topk.merge_topk_dedup_packed(
        jnp.asarray(pool_d), jnp.asarray(pool_i), jnp.asarray(cd),
        jnp.asarray(ci), n_dup=p * 4, block=2048)
    b_d, b_i = topk.merge_topk_dedup(
        jnp.asarray(pool_d), jnp.asarray(pool_i), jnp.asarray(cd),
        jnp.asarray(ci))
    assert np.array_equal(np.asarray(a_d), np.asarray(b_d))
    assert np.array_equal(np.asarray(a_i), np.asarray(b_i))


def _rand_cands(rng, q, c, max_id, base=0):
    """Random candidates; dist is a pure function of id, ids unique per row
    (the per-table invariant the strip merges rely on)."""
    cid = np.full((q, c), -1, np.int64)
    for i in range(q):
        k = rng.integers(0, c + 1)
        cid[i, :k] = rng.choice(max_id, size=k, replace=False) + base
    cdist = np.where(cid >= 0, (cid * 13 + 5) % 120, 0)
    return cdist.astype(np.int32), cid.astype(np.int32)


def _oracle_topk(rows_of_pairs, p):
    out = []
    for pairs in rows_of_pairs:
        best = sorted(pairs.items(), key=lambda kv: (kv[1], kv[0]))[:p]
        out.append([(d, i) for i, d in best])
    return out


def _run_strip_merge(packed_path, p=7, n_tables=3, c=40, max_id=500,
                     base=0, seed=3):
    rng = np.random.default_rng(seed)
    q = 6
    pd, pi = topk.empty_pool(q, p)
    seen = [dict() for _ in range(q)]
    for _ in range(3):
        tables = [_rand_cands(rng, q, c, max_id, base)
                  for _ in range(n_tables)]
        for cdist, cid in tables:
            for i in range(q):
                for j in range(c):
                    if cid[i, j] >= 0:
                        seen[i][int(cid[i, j])] = int(cdist[i, j])
        if packed_path:
            strips = jnp.concatenate(
                [topk.table_topk_packed(jnp.asarray(d), jnp.asarray(i), p)
                 for d, i in tables], axis=-1)
            pd, pi = topk.merge_strips_packed(pd, pi, strips,
                                              n_copies=n_tables + 1)
        else:
            sd, si = zip(*[
                topk.table_topk_pos(jnp.asarray(d), jnp.asarray(i), p)
                for d, i in tables])
            pd, pi = topk.merge_strips_dedup_pos(
                pd, pi, jnp.concatenate(sd, -1), jnp.concatenate(si, -1))
    pd, pi = np.asarray(pd), np.asarray(pi)
    expect = _oracle_topk(seen, p)
    for i in range(q):
        got = [(int(pd[i, j]), int(pi[i, j]))
               for j in range(min(p, len(expect[i])))]
        assert got == expect[i], (i, got, expect[i])
        for j in range(len(expect[i]), p):
            assert pi[i, j] == -1


def test_strip_merge_packed_matches_oracle():
    _run_strip_merge(packed_path=True)


def test_strip_merge_pos_matches_oracle_small_ids():
    _run_strip_merge(packed_path=False)


def test_strip_merge_pos_matches_oracle_huge_ids():
    # ids >= 2^24: the regime the packed path cannot represent
    # (VERDICT r2 missing #3) — the pos path must be exact there
    _run_strip_merge(packed_path=False, base=(1 << 25) + 12345,
                     max_id=100_000_000)


def test_strip_merge_wide_pool_approx_shape():
    # approximate-mode shape: pool much wider than the candidate arrays
    _run_strip_merge(packed_path=True, p=60, c=25, max_id=300)
    _run_strip_merge(packed_path=False, p=60, c=25, max_id=300)


def test_chunkmin_strip_matches_direct():
    """Chunk-min pre-selected strips must equal the direct per-table
    selection on any chunk-major candidate layout (ids unique per row —
    the per-table invariant), including winners packed into ONE chunk
    (adversarial for the chunk pre-selection)."""
    rng = np.random.default_rng(17)
    q, blk, chb, p = 6, 32, 20, 7
    c = blk * chb
    for plant_one_chunk in (False, True):
        cd, ci = _rand_cands(rng, q, c, max_id=100_000)
        if plant_one_chunk:
            # all p winners inside chunk 13 (ids disjoint from _rand_cands'
            # 0..max_id range, keeping ids unique within each row)
            lo = 13 * blk
            ci[:, lo:lo + p] = np.arange(p, dtype=np.int32) + 200_000
            cd[:, lo:lo + p] = 0  # best possible distance
        jd, ji = jnp.asarray(cd), jnp.asarray(ci)
        a = np.asarray(topk.table_topk_chunkmin_packed(jd, ji, p, blk))
        b = np.asarray(topk.table_topk_packed(jd, ji, p))
        assert np.array_equal(a, b), plant_one_chunk
        ad, ai = topk.table_topk_chunkmin_pos(jd, ji, p, blk)
        bd, bi = topk.table_topk_pos(jd, ji, p)
        assert np.array_equal(np.asarray(ad), np.asarray(bd))
        assert np.array_equal(np.asarray(ai), np.asarray(bi))


def test_chunkmin_fallback_wide_p():
    # p >= chb//2 must route to the direct path (and stay exact)
    rng = np.random.default_rng(23)
    q, blk, chb = 4, 25, 8
    c = blk * chb
    cd, ci = _rand_cands(rng, q, c, max_id=3000)
    jd, ji = jnp.asarray(cd), jnp.asarray(ci)
    for p in (chb // 2, c // 2):
        a = np.asarray(topk.table_topk_chunkmin_packed(jd, ji, p, blk))
        b = np.asarray(topk.table_topk_packed(jd, ji, p))
        assert np.array_equal(a, b), p


def test_chunkmin_pos_huge_ids():
    # >2^24 ids: the pos-packed chunk-min path (the 100M corpus regime)
    rng = np.random.default_rng(29)
    q, blk, chb, p = 5, 32, 24, 9
    cd, ci = _rand_cands(rng, q, blk * chb, max_id=90_000_000,
                         base=(1 << 25) + 7)
    jd, ji = jnp.asarray(cd), jnp.asarray(ci)
    ad, ai = topk.table_topk_chunkmin_pos(jd, ji, p, blk)
    bd, bi = topk.table_topk_pos(jd, ji, p)
    assert np.array_equal(np.asarray(ad), np.asarray(bd))
    assert np.array_equal(np.asarray(ai), np.asarray(bi))


def test_select_desc_matches_sort():
    # the one wide-selection primitive (narrow native top_k compositions
    # only — the handwritten sorting networks it replaced returned wrong
    # results at unpredictable widths on an accelerator backend; see
    # CLAUDE.md)
    rng = np.random.default_rng(31)
    for w, m in [(40, 7), (1536, 200), (1537, 200), (16000, 500),
                 (5000, 2000), (131072, 100), (300, 512)]:
        keys = rng.integers(0, 1 << 32, size=(4, w), dtype=np.uint64) \
            .astype(np.uint32)
        got = np.asarray(topk.select_desc(jnp.asarray(keys), m))
        expect = -np.sort(-keys.astype(np.int64), axis=-1)[:, :m]
        expect = np.pad(expect, ((0, 0), (0, m - expect.shape[1])))
        assert np.array_equal(got.astype(np.int64), expect), (w, m)


def test_strip_merge_wide_pool_shapes():
    # approximate k*20 pools: widths past _TOPK_WIDE route every selection
    # through the shrink ladder (the lax.top_k compile bomb of VERDICT r2
    # missing #4) — exactness must be unchanged
    _run_strip_merge(packed_path=True, p=600, n_tables=3, c=900,
                     max_id=4000, seed=9)
    _run_strip_merge(packed_path=False, p=600, n_tables=3, c=900,
                     max_id=4000, base=(1 << 25), seed=10)


def test_chunk_topk_affine_under_scan_unique_ids():
    # regression: chunk_topk_affine runs inside every scan engine's
    # lax.scan/fori body — its wide tail once used a sorting network that
    # returned duplicated ids on an accelerator (exact on CPU, so this
    # guards the semantics and the on-card oracle drive guards the
    # lowering)
    import jax

    rng = np.random.default_rng(12)
    Q, T, k, C = 8, 16384, 500, 2
    d_all = rng.integers(30, 100, (C, Q, T)).astype(np.int32)

    def body(carry, args):
        d, base = args
        cd, ci = topk.chunk_topk_affine(d, base, k, C * T - base)
        return carry, (cd, ci)

    bases = jnp.arange(C, dtype=jnp.int32) * T
    _, (cds, cis) = jax.lax.scan(body, 0, (jnp.asarray(d_all), bases))
    cds, cis = np.asarray(cds), np.asarray(cis)
    for c in range(C):
        want = np.sort(d_all[c], -1)[:, :k]
        assert np.array_equal(np.sort(cds[c], -1), want)
        for qi in range(Q):
            ids = cis[c][qi] - c * T
            assert len(set(ids.tolist())) == k
            assert np.array_equal(cds[c][qi], d_all[c][qi][ids])
