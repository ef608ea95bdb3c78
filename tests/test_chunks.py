"""Aligned-block chunk descriptors + block fetch/score (ops/chunks.py) and
the range-directory search engine built on them."""

import numpy as np
import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.index import directory as dir_lib
from verticut_tpu.ops import topk
from verticut_tpu.ops.chunks import chunk_descriptors, fetch_score_blocks
from verticut_tpu.search import linear_search, mih_search


def _np_chunks(starts, counts, blk):
    """Reference model: list of (blk_id, lo, hi) per query."""
    out = []
    for s_row, c_row in zip(starts, counts):
        chunks = []
        for s, c in zip(s_row, c_row):
            if c <= 0:
                continue
            b0, b1 = s // blk, (s + c + blk - 1) // blk
            for b in range(b0, b1):
                lo = max(s - b * blk, 0)
                hi = min(s + c - b * blk, blk)
                chunks.append((b, lo, hi))
        out.append(chunks)
    return out


def test_chunk_descriptors_match_model():
    rng = np.random.default_rng(0)
    q, h, blk, chb = 37, 9, 16, 24
    starts = rng.integers(0, 500, (q, h)).astype(np.int32)
    counts = rng.integers(0, 40, (q, h)).astype(np.int32)
    counts[rng.random((q, h)) < 0.5] = 0  # plenty of empty probes
    blk_id, lo, hi, nch, ovf = (np.asarray(x) for x in chunk_descriptors(
        jnp.asarray(starts), jnp.asarray(counts), blk=blk, chb=chb,
        n_blocks=64))
    model = _np_chunks(starts, counts, blk)
    for i in range(q):
        want = model[i][:chb]
        assert ovf[i] == (len(model[i]) > chb)
        assert nch[i] == min(len(model[i]), chb)
        got = [(int(blk_id[i, j]), int(lo[i, j]), int(hi[i, j]))
               for j in range(nch[i])]
        assert got == want, f"query {i}"
        # slots past nch are inert
        for j in range(nch[i], chb):
            assert lo[i, j] >= hi[i, j]


def test_chunk_descriptors_overflow_flag():
    starts = jnp.asarray([[0, 64], [0, 0]], jnp.int32)
    counts = jnp.asarray([[40, 40], [1, 0]], jnp.int32)
    _, _, _, nch, ovf = chunk_descriptors(starts, counts, blk=16, chb=3,
                                          n_blocks=16)
    assert bool(ovf[0]) and not bool(ovf[1])
    assert int(nch[0]) == 3 and int(nch[1]) == 1


def test_fetch_score_blocks():
    from verticut_tpu.index.mih import entry_block_size, make_entry_rows
    rng = np.random.default_rng(1)
    n, w = 100, 4
    blk = entry_block_size(w)  # tight layout: 25 entries per 125-lane row
    cds = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    ids = np.arange(n, dtype=np.int32)
    rows = make_entry_rows(jnp.asarray(ids), jnp.asarray(cds))
    queries = rng.integers(0, 2**32, (3, w), dtype=np.uint32)
    blk_id = np.array([[0, 2], [5, 5], [7, 0]], np.int32)
    lo = np.array([[0, 4], [1, 0], [0, 0]], np.int32)
    hi = np.array([[16, 9], [3, 0], [16, 0]], np.int32)
    d, i = (np.asarray(x) for x in fetch_score_blocks(
        rows, jnp.asarray(blk_id), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(queries), blk=blk))
    for qi in range(3):
        got = {(int(ii), int(dd)) for ii, dd in zip(i[qi], d[qi]) if ii >= 0}
        want = set()
        for b, l, h in zip(blk_id[qi], lo[qi], hi[qi]):
            for r in range(b * blk + l, b * blk + h):
                if r < n:  # pad entries are invalid
                    want.add((r, int(bin(int.from_bytes(
                        (cds[r] ^ queries[qi]).tobytes(), "little")
                    ).count("1"))))
        assert got == want


def _check_vs_oracle(packed, queries, cfg, scfg, **build_kw):
    index = build_index(jnp.asarray(packed), cfg, **build_kw)
    assert isinstance(index.tables[0].directory, dir_lib.RangeDirectory)
    res = mih_search(index, queries, scfg)
    ld, _ = linear_search(queries, packed, scfg.knn, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))
    return res


def test_range_engine_exact_uniform():
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.random_codes(7, 3000, cfg.bits)
    queries = packed[:64]
    _check_vs_oracle(packed, queries, cfg,
                     SearchConfig(knn=5, candidate_cap=2048),
                     directory="range")


def test_range_engine_exact_clustered():
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.clustered_codes(8, 4000, cfg.bits, n_clusters=16,
                                   flip_p=0.03)
    queries = packed[100:196]
    for fused in (True, False):
        scfg = SearchConfig(knn=10, candidate_cap=4096, fused=fused)
        _check_vs_oracle(packed, queries, cfg, scfg, directory="range")


def test_range_engine_tight_cap_retries():
    """Chunk-budget overflow must trigger the exactness retry path."""
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.clustered_codes(9, 2000, cfg.bits, n_clusters=4,
                                   flip_p=0.02)  # huge hot ranges
    queries = packed[:48]
    scfg = SearchConfig(knn=10, candidate_cap=256, fused=False)
    res = _check_vs_oracle(packed, queries, cfg, scfg, directory="range")
    assert res.dists.shape == (48, 10)


def test_range_engine_save_load(tmp_path):
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.random_codes(11, 1500, cfg.bits)
    index = build_index(jnp.asarray(packed), cfg, directory="range")
    from verticut_tpu.index.mih import load_index, save_index
    p = str(tmp_path / "idx.npz")
    save_index(p, index)
    idx2 = load_index(p)
    assert isinstance(idx2.tables[0].directory, dir_lib.RangeDirectory)
    queries = packed[:32]
    r1 = mih_search(index, queries, SearchConfig(knn=5))
    r2 = mih_search(idx2, queries, SearchConfig(knn=5))
    assert np.array_equal(r1.dists, r2.dists)
    assert np.array_equal(r1.ids, r2.ids)


def test_range_native_build_matches_device_build():
    from verticut_tpu.index.build_native import build_index_native
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.clustered_codes(12, 2500, cfg.bits, n_clusters=10,
                                   flip_p=0.04)
    queries = packed[:40]
    scfg = SearchConfig(knn=8)
    i1 = build_index(jnp.asarray(packed), cfg, directory="range")
    i2 = build_index_native(packed, cfg, directory="range")
    for t in range(cfg.n_tables):
        assert np.array_equal(np.asarray(i1.tables[t].entry_rows),
                              np.asarray(i2.tables[t].entry_rows))
        assert np.array_equal(np.asarray(i1.tables[t].directory.se),
                              np.asarray(i2.tables[t].directory.se))
    r1 = mih_search(i1, queries, scfg)
    r2 = mih_search(i2, queries, scfg)
    assert np.array_equal(r1.dists, r2.dists)
    assert np.array_equal(r1.ids, r2.ids)


def test_range_engine_compact_mode():
    """Compact mode (ids-only blocks + shared code array) must be exact
    and match the inline-rows engine bit for bit."""
    from verticut_tpu.index.build_native import build_index_native
    cfg = MIHConfig(bits=128, n_tables=4)
    packed = codes.clustered_codes(21, 3000, cfg.bits, n_clusters=12,
                                   flip_p=0.03)
    queries = packed[:64]
    scfg = SearchConfig(knn=10)
    for builder in (lambda: build_index(jnp.asarray(packed), cfg,
                                        directory="range",
                                        store_codes=False),
                    lambda: build_index_native(packed, cfg,
                                               directory="range",
                                               store_codes=False,
                                               keep_entry_ids=False)):
        idx = builder()
        assert idx.tables[0].entry_rows is None
        assert idx.tables[0].entry_idrows is not None
        res = mih_search(idx, queries, scfg)
        ld, _ = linear_search(queries, packed, scfg.knn, method="popcount")
        assert np.array_equal(np.sort(res.dists, -1),
                              np.sort(np.asarray(ld), -1))
