"""Scan-dominance routing, the overflow-to-scan ladder merge, and the
approx->exact crossover."""

import numpy as np
import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.config import MIHConfig, SearchConfig
from verticut_tpu.index import build_index
from verticut_tpu.search import mih_search
from verticut_tpu.search.linear import linear_search
from verticut_tpu.search.single import effective_scfg

import tests.reference_model as ref


def test_scan_dominated_batch_exact():
    """A big uniform-query batch against a clustered corpus triggers the
    scan-dominance gate (active count after stage 1 >= nq/2 at
    nq >= SCAN_DOMINANCE_MIN_NQ); results must still equal the
    brute-force oracle exactly."""
    n, nq, k = 20_000, 1024, 5
    packed = codes.clustered_codes(3, n, 128, n_clusters=100, flip_p=0.02)
    idx = build_index(jnp.asarray(packed), MIHConfig(bits=128, n_tables=4),
                      directory="range")
    q = codes.random_codes(17, nq, 128)
    res = mih_search(idx, q, SearchConfig(knn=k, candidate_cap=4096))
    ed, ei = linear_search(q, idx.codes, k, method="popcount")
    assert np.array_equal(np.asarray(res.dists), np.asarray(ed))
    assert np.array_equal(np.asarray(res.ids), np.asarray(ei))


def test_overflow_to_scan_exact():
    """Tiny candidate caps force overflow on nearly every query; with the
    merged ladder those rows resolve in the scan stage and must match the
    oracle (the exactness contract: a clipped pool is never trusted)."""
    rng = np.random.default_rng(8)
    n, nq, k = 6_000, 64, 10
    # heavy value-space skew: many duplicate substrings -> hot ranges
    raw = rng.integers(0, 4, (n, 16), dtype=np.uint8) * 64
    packed = codes.pack_bytes(raw)
    idx = build_index(jnp.asarray(packed), MIHConfig(bits=128, n_tables=4),
                      directory="range")
    q = packed[:nq]
    res = mih_search(idx, q, SearchConfig(knn=k, candidate_cap=256,
                                          overflow_to_scan=True))
    ed, _ = ref.brute_force(raw[:nq], raw, k)
    assert np.array_equal(np.sort(np.asarray(res.dists), -1), ed)
    # the default (two-ladder) policy must agree
    res2 = mih_search(idx, q, SearchConfig(knn=k, candidate_cap=256))
    assert np.array_equal(np.sort(np.asarray(res2.dists), -1), ed)


def test_approx_exact_crossover():
    """Approximate mode above the crossover pool width runs the exact
    engine (never slower than exact, strictly better answers); below it
    true approx semantics are preserved."""
    big = SearchConfig(knn=100, approximate=True)          # pool 2000
    assert not effective_scfg(big).approximate
    small = SearchConfig(knn=10, approximate=True)         # pool 200
    assert effective_scfg(small).approximate
    forced = SearchConfig(knn=100, approximate=True,
                          approx_exact_crossover=1 << 30)
    assert effective_scfg(forced).approximate

    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, (4_000, 16), dtype=np.uint8)
    packed = codes.pack_bytes(raw)
    idx = build_index(jnp.asarray(packed), MIHConfig(bits=128, n_tables=4))
    q = packed[:16]
    ra = mih_search(idx, q, SearchConfig(knn=100, approximate=True))
    re_ = mih_search(idx, q, SearchConfig(knn=100))
    assert np.array_equal(ra.dists, re_.dists)
    assert np.array_equal(ra.ids, re_.ids)
