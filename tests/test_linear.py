"""Brute-force oracle vs numpy ground truth (linear_search.cc analog)."""

import numpy as np
import pytest

from verticut_tpu import codes
from verticut_tpu.search import linear_search
from tests import reference_model as ref


@pytest.mark.parametrize("method", ["popcount", "matmul"])
@pytest.mark.parametrize("n,chunk", [(300, 128), (1000, 1024)])
def test_linear_matches_numpy(method, n, chunk):
    rng = np.random.default_rng(42)
    raw_db = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    raw_q = rng.integers(0, 256, size=(7, 16), dtype=np.uint8)
    db = codes.pack_bytes(raw_db)
    q = codes.pack_bytes(raw_q)
    k = 10
    d, i = linear_search(q, db, k, method=method, chunk=chunk)
    ed, ei = ref.brute_force(raw_q, raw_db, k)
    assert np.array_equal(np.asarray(d), ed)
    assert np.array_equal(np.asarray(i), ei)


def test_linear_k_larger_than_n():
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(5, 16), dtype=np.uint8)
    db = codes.pack_bytes(raw)
    d, i = linear_search(db[:2], db, 8)
    d, i = np.asarray(d), np.asarray(i)
    assert (d[:, :5] < 0x7FFFFFFF).all()
    assert (i[:, 5:] == -1).all()
    # self-match at distance 0
    assert d[0, 0] == 0 and i[0, 0] == 0
    assert d[1, 0] == 0 and i[1, 0] == 1


@pytest.mark.parametrize("seed,n,q,k", [(0, 5000, 37, 10), (1, 300, 8, 100),
                                        (2, 7000, 16, 3), (3, 1100, 4, 600)])
def test_scan_blockmin_matches_oracle(seed, n, q, k):
    """Block-min pre-selection scan (the production scan) is exact,
    including (dist, id) tie order, across k regimes and block boundaries."""
    import jax.numpy as jnp
    from verticut_tpu.ops.hamming import scan_blockmin, scan_popcount
    db = codes.clustered_codes(seed, n, 128, n_clusters=max(4, n // 100),
                               flip_p=0.03)
    qs = jnp.asarray(db[:q])
    d1, i1 = scan_blockmin(qs, jnp.asarray(db), k, block=512)
    d2, i2 = scan_popcount(qs, jnp.asarray(db), k, chunk=4096)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
