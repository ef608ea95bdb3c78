"""Randomized exactness fuzz: many random (corpus, config) draws, every
result checked against the brute-force oracle.

The deterministic suites pin known-tricky shapes; this sweeps the config
space (k, tables, caps, modes, duplicate-heavy and clustered corpora) so
a fixed-capacity bug anywhere in the budget/merge/retry machinery has
many chances to trip the multiset check. Seeded — failures reproduce.
(The reference's equivalent is integrity_check + accuracy_test driven
over ad-hoc corpora, src/integrity_check.cc:37-70.)
"""

import numpy as np
import pytest

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.search import linear_search, mih_search


def _draw(rng):
    n = int(rng.integers(50, 3000))
    n_tables = int(rng.choice([4, 8, 16]))
    k = int(rng.choice([1, 3, 10, 100, 500]))
    kind = rng.choice(["uniform", "clustered", "dup"])
    if kind == "clustered":
        packed = codes.clustered_codes(int(rng.integers(1 << 30)), n, 128,
                                       n_clusters=max(2, n // 50),
                                       flip_p=0.05)
    elif kind == "dup":
        base = rng.integers(0, 256, (max(2, n // 8), 16), dtype=np.uint8)
        raw = base[rng.integers(0, len(base), n)]
        packed = codes.pack_bytes(raw)
    else:
        packed = codes.pack_bytes(
            rng.integers(0, 256, (n, 16), dtype=np.uint8))
    scfg = SearchConfig(
        knn=k,
        candidate_cap=int(rng.choice([64, 256, 1024])),
        fused=bool(rng.integers(2)),
        approximate=bool(rng.integers(4) == 0),
        approximate_factor=int(rng.choice([2, 4, 20])),
    )
    return np.asarray(packed), n_tables, scfg, kind


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_exactness_vs_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    packed, n_tables, scfg, kind = _draw(rng)
    idx = build_index(packed, MIHConfig(bits=128, n_tables=n_tables))
    nq = 8
    qsel = rng.integers(0, len(packed), nq)
    q = packed[qsel]
    if rng.integers(2):      # half the draws: perturbed queries
        flips = rng.integers(0, 128, (nq, 2))
        raw = codes.unpack_to_bytes(q)
        for i in range(nq):
            for b in flips[i]:
                raw[i, b // 8] ^= 1 << (b % 8)
        q = codes.pack_bytes(raw)
    res = mih_search(idx, q, scfg)
    ld, _ = linear_search(q, packed, scfg.knn, method="popcount")
    want = np.sort(np.asarray(ld), -1)
    got = np.sort(np.asarray(res.dists), -1)
    ctx = (seed, kind, n_tables, scfg.knn, scfg.candidate_cap,
           scfg.fused, scfg.approximate)
    if scfg.approximate:
        valid = got < np.int32(0x7FFFFFFF)
        assert (got[valid] >= want[valid]).all(), ctx
        # approximate pools must still be duplicate-free
    else:
        assert np.array_equal(got, want), ctx
    I = np.asarray(res.ids)
    for j in range(nq):
        v = I[j][I[j] >= 0]
        assert len(set(v.tolist())) == len(v), ctx
