"""LSH / ITQ encoders: determinism, packing semantics, retrieval quality."""

import numpy as np
import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.models import ITQEncoder, RandomProjectionLSH
from verticut_tpu.models.lsh import encode_corpus, write_code_file
from verticut_tpu.search import linear_search, mih_search


def _features(n, d=256, seed=0, n_clusters=16, noise=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    assign = rng.integers(0, n_clusters, n)
    return (centers[assign] + noise * rng.normal(size=(n, d))
            ).astype(np.float32), assign


def test_lsh_deterministic_and_packed():
    x, _ = _features(100)
    enc = RandomProjectionLSH.create(256, 128, seed=7)
    c1 = np.asarray(enc.encode(jnp.asarray(x)))
    c2 = np.asarray(enc.encode(jnp.asarray(x)))
    assert c1.shape == (100, 4) and c1.dtype == np.uint32
    assert np.array_equal(c1, c2)
    # packing matches the numpy byte layout
    proj = x @ np.asarray(enc.projection)
    bits = (proj >= 0)
    expect = codes.pack_bytes(np.packbits(bits, axis=1, bitorder="little"))
    assert np.array_equal(c1, expect)


def test_lsh_preserves_neighborhoods():
    x, assign = _features(2000, seed=1)
    enc = RandomProjectionLSH.create(256, 128)
    packed = np.asarray(enc.encode(jnp.asarray(x)))
    # same-cluster pairs must be closer in Hamming space than cross-cluster
    pc = jnp.asarray(packed)
    d = np.asarray(codes.pairwise_hamming(pc[:200], pc))
    same = (assign[:200, None] == assign[None, :])
    np.fill_diagonal(same[:, :200], False)
    d_same = d[same].mean()
    d_diff = d[~same].mean()
    assert d_same + 10 < d_diff, (d_same, d_diff)


def test_itq_beats_or_matches_lsh_quantization():
    x, assign = _features(3000, seed=2)
    itq = ITQEncoder.fit(jnp.asarray(x[:2000]), bits=128, n_iters=20)
    packed = np.asarray(itq.encode(jnp.asarray(x)))
    assert packed.shape == (3000, 4)
    pc = jnp.asarray(packed)
    d = np.asarray(codes.pairwise_hamming(pc[:200], pc))
    same = (assign[:200, None] == assign[None, :])
    np.fill_diagonal(same[:, :200], False)
    assert d[same].mean() + 10 < d[~same].mean()


def test_end_to_end_encode_index_search(tmp_path):
    """Features -> ITQ codes -> code file -> index -> MIH search finds the
    feature-space neighbors (the full reference pipeline, closed loop)."""
    x, assign = _features(4000, seed=3, noise=0.05)
    itq = ITQEncoder.fit(jnp.asarray(x[:2000]), bits=128, n_iters=15)
    packed = encode_corpus(itq, x, batch=1024)
    p = str(tmp_path / "lsh.code")
    write_code_file(p, packed)
    from verticut_tpu import native
    loaded = native.read_code_file(p, 16, 10**6)
    assert np.array_equal(loaded, packed)

    idx = build_index(loaded, MIHConfig())
    res = mih_search(idx, loaded[:32],
                     SearchConfig(fused=False, knn=10, candidate_cap=2048))
    ld, li = linear_search(loaded[:32], loaded, 10, method="popcount")
    assert np.array_equal(np.sort(res.dists, -1), np.sort(np.asarray(ld), -1))
    # retrieved neighbors are overwhelmingly same-cluster
    neigh_clusters = assign[np.clip(res.ids, 0, None)]
    frac_same = (neigh_clusters == assign[:32, None]).mean()
    assert frac_same > 0.9, frac_same


def test_encoders_match_float64_where_projection_is_clear():
    """Codes equal a float64 numpy encoding at every bit whose projection
    is clear of zero (|projection| > 1e-3): the float32 products run at
    full precision, so no sign flips from a reduced-precision matmul."""
    x, _ = _features(500, seed=3)
    lsh = RandomProjectionLSH.create(256, 128, seed=2)
    itq = ITQEncoder.fit(jnp.asarray(x), bits=128, n_iters=5)
    x64 = x.astype(np.float64)
    projections = [
        (lsh, x64 @ np.asarray(lsh.projection, np.float64)),
        (itq, (x64 - np.asarray(itq.mean, np.float64))
         @ np.asarray(itq.w, np.float64) @ np.asarray(itq.r, np.float64)),
    ]
    for enc, proj in projections:
        got = np.asarray(enc.encode(jnp.asarray(x)))
        bits = np.unpackbits(codes.unpack_to_bytes(got), axis=1,
                             bitorder="little").astype(bool)
        clear = np.abs(proj) > 1e-3
        assert clear.mean() > 0.99
        assert np.array_equal(bits[clear], (proj >= 0)[clear])
