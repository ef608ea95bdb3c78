"""The block-min scan: its Pallas-Triton pass-1 kernel (interpret mode on
the CPU; compiled for the card by chip_smoke.py), the chunked fold and tail
handling of scan_blockmin, and the engine choice."""

import numpy as np
import pytest

import jax.numpy as jnp

from verticut_tpu import codes
from verticut_tpu.ops import hamming
from verticut_tpu.ops.pallas import blockmin as kern


@pytest.fixture
def kernel_scan(monkeypatch):
    """scan_blockmin with its pass 1 on the kernel, as on the GPU; the
    jit cache is cleared so no trace of the other engine is reused."""
    monkeypatch.setattr(hamming, "use_scan_kernel", lambda platform: True)
    hamming.scan_blockmin.clear_cache()
    yield
    hamming.scan_blockmin.clear_cache()


def _blockmin_ref(raw_q, raw_db, block):
    """numpy oracle: per-block Hamming minima over whole blocks."""
    d = np.unpackbits(raw_q[:, None, :] ^ raw_db[None, :, :],
                      axis=-1).sum(-1).astype(np.int32)     # [Q, R]
    return d.reshape(d.shape[0], -1, block).min(-1)


@pytest.mark.parametrize("q,rows,block", [
    (10, 4096, 512),      # q pads to a 16-row tile
    (37, 8192, 128),      # q pads to 64; two programs along the corpus
    (130, 512, 512),      # two 128-query tiles (second one padded)
    (16, 1024, 128),      # exact tile, corpus shorter than one program
])
def test_kernel_matches_reference(q, rows, block):
    rng = np.random.default_rng(q + rows)
    raw_db = rng.integers(0, 256, size=(rows, 16), dtype=np.uint8)
    raw_q = rng.integers(0, 256, size=(q, 16), dtype=np.uint8)
    q_pm = kern.unpack_queries(jnp.asarray(codes.pack_bytes(raw_q)))
    assert q_pm.shape[0] % kern.q_tile(q) == 0
    got = np.asarray(kern.blockmin_pass1(
        q_pm, jnp.asarray(codes.pack_bytes(raw_db)), block=block,
        interpret=True))[:q]
    assert np.array_equal(got, _blockmin_ref(raw_q, raw_db, block))


def test_kernel_matches_xla_formulation():
    """The kernel and the plain XLA pass 1 (its reference on the card)
    agree exactly on ±1 operands."""
    rng = np.random.default_rng(5)
    db = jnp.asarray(rng.integers(0, 2**32, (4096, 4), dtype=np.uint32))
    q = jnp.asarray(rng.integers(0, 2**32, (20, 4), dtype=np.uint32))
    got = kern.blockmin_pass1(kern.unpack_queries(q), db, block=512,
                              interpret=True)[:20]
    want = hamming._blockmin_xla(codes.unpack_bits_pm1(q), db, 512)
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n,q,k,block,chunk_max", [
    (4096, 12, 10, 512, hamming.CHUNK_MAX),   # exact multiple of block
    (5000, 20, 9, 128, 1024),                 # multi-chunk fold + tail
    (4608, 8, 5, 512, 1024),                  # fold with a pulled-back chunk
    (100, 5, 7, 128, hamming.CHUNK_MAX),      # n < block: tail only
    (3000, 70, 30, 128, 2048),                # q pads; kb > blocks per chunk
    (640, 3, 700, 128, hamming.CHUNK_MAX),    # k > n: padded results
])
def test_scan_blockmin_kernel_matches_oracle(monkeypatch, kernel_scan, n, q,
                                             k, block, chunk_max):
    """scan_blockmin through the kernel equals the popcount scan,
    including (dist, id) tie order, with planted near-duplicates straddling
    chunk and tail boundaries."""
    monkeypatch.setattr(hamming, "CHUNK_MAX", chunk_max)
    db = codes.clustered_codes(n, n, 128, n_clusters=max(2, n // 200),
                               flip_p=0.03)
    qs = codes.random_codes(q, q, 128)
    qs[0] = db[n - 1]
    if n > block:
        db[block - 1] = db[block] = qs[0] ^ np.uint32(1)
    d1, i1 = hamming.scan_blockmin(jnp.asarray(qs), jnp.asarray(db), k,
                                   block=block, interpret=True)
    d2, i2 = hamming.scan_popcount(jnp.asarray(qs), jnp.asarray(db), k,
                                   chunk=1024)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(i1), np.asarray(i2))


def test_scan_blockmin_xla_fold_matches_oracle(monkeypatch):
    """The XLA pass 1 through the same multi-chunk fold."""
    monkeypatch.setattr(hamming, "CHUNK_MAX", 1024)
    db = codes.random_codes(3, 9000, 128)
    qs = codes.random_codes(4, 17, 128)
    d1, i1 = hamming.scan_blockmin(jnp.asarray(qs), jnp.asarray(db), 12,
                                   block=128)
    d2, i2 = hamming.scan_popcount(jnp.asarray(qs), jnp.asarray(db), 12)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(i1), np.asarray(i2))


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_use_scan_kernel(platform, kernel):
    assert hamming.use_scan_kernel(platform) is kernel


def test_pick_chunk_invariants():
    """Pass-1 chunks are power-of-two multiples of the block that fit the
    whole blocks, the row cap and the selection budget, and are maximal."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        block = int(rng.choice([128, 512]))
        nfull = int(rng.integers(1, 300_000))
        q = int(rng.choice([1, 64, 1024, 8192, 20000]))
        max_rows = int(rng.choice([hamming.CHUNK_MAX,
                                   hamming.XLA_SLAB // q]))
        ch = hamming._pick_chunk(nfull, block, q, max_rows)
        cb = ch // block
        assert ch % block == 0 and cb & (cb - 1) == 0
        assert cb <= nfull
        assert cb == 1 or (ch <= max_rows and q * cb <= hamming.TARGET_KEYS)
        assert (2 * cb > nfull or 2 * ch > max_rows
                or q * 2 * cb > hamming.TARGET_KEYS)
        assert ch % kern.rows_per_program(ch) == 0


@pytest.mark.parametrize("q,tile", [(1, 16), (16, 16), (17, 32), (100, 128),
                                    (8192, 128)])
def test_q_tile(q, tile):
    assert kern.q_tile(q) == tile


@pytest.mark.gpu
@pytest.mark.parametrize("block", [128, 512])
def test_kernel_compiled_on_card(block):
    """The kernel as compiled for the card, at the production query tile
    and program size, against the XLA formulation."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: the compiled kernel has no CPU "
                    "form (the interpret-mode tests above cover its "
                    "arithmetic; chip_smoke.py runs it at full width)")
    rng = np.random.default_rng(block)
    db = jnp.asarray(rng.integers(0, 2**32, (1 << 18, 4), dtype=np.uint32))
    q = jnp.asarray(rng.integers(0, 2**32, (1000, 4), dtype=np.uint32))
    got = kern.blockmin_pass1(kern.unpack_queries(q), db, block=block)[:1000]
    want = hamming._blockmin_xla(codes.unpack_bits_pm1(q), db, block)
    assert np.array_equal(np.asarray(got), np.asarray(want))
