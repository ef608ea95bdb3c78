"""Binary-code encoders: the model family that produces the codes the MIH
engine indexes.

The reference consumes a pre-computed ``lsh.code`` file
(``src/image_search_constants.h:12``: the canonical corpus is LSH codes of
image features) but ships no encoder; a complete framework closes the loop.
Both encoders are one ``[B, D] x [D, bits]`` matmul + sign + bit-pack.
Every float32 product runs at ``Precision.HIGHEST``: a reduced-precision
product (TF32 on a GPU) can flip the sign bit of a projection near zero,
i.e. change the code.

* :class:`RandomProjectionLSH` — classic signed random projections
  (Charikar SimHash): cos-similarity preserving, no training.
* :class:`ITQEncoder` — PCA + Iterative Quantization (Gong & Lazebnik):
  learns a rotation minimizing quantization error; the standard recipe for
  high-recall binary codes of CNN/SIFT features. Training runs on device
  (covariance eigendecomposition + alternating Procrustes updates).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from verticut_tpu import codes as codes_lib

_HIGHEST = jax.lax.Precision.HIGHEST


def _pack_bits_device(bits: jax.Array) -> jax.Array:
    """bool[..., n_bits] -> packed uint32[..., n_bits//32] (little-endian
    bit order, matching codes.pack_bytes/binaryToInt semantics)."""
    *lead, nb = bits.shape
    assert nb % 32 == 0
    b = bits.reshape(*lead, nb // 32, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


class RandomProjectionLSH(NamedTuple):
    """codes = pack(sign(X @ P)) with a fixed seeded projection."""

    projection: jax.Array  # f32[D, bits]

    @staticmethod
    def create(dim: int, bits: int = 128, seed: int = 0
               ) -> "RandomProjectionLSH":
        if bits % 32:
            raise ValueError("bits must be a multiple of 32")
        key = jax.random.PRNGKey(seed)
        p = jax.random.normal(key, (dim, bits), jnp.float32)
        return RandomProjectionLSH(projection=p)

    def encode(self, features: jax.Array) -> jax.Array:
        """f32[B, D] -> packed uint32[B, bits//32]."""
        proj = jnp.dot(features.astype(jnp.float32), self.projection,
                       precision=_HIGHEST,
                       preferred_element_type=jnp.float32)
        return _pack_bits_device(proj >= 0)


class ITQEncoder(NamedTuple):
    """codes = pack(sign((X - mean) @ W @ R))."""

    mean: jax.Array  # f32[D]
    w: jax.Array     # f32[D, bits] — top PCA directions
    r: jax.Array     # f32[bits, bits] — learned rotation

    @staticmethod
    def fit(features: jax.Array, bits: int = 128, n_iters: int = 50,
            seed: int = 0) -> "ITQEncoder":
        """Train on a feature sample (a few 10k rows is plenty)."""
        if bits % 32:
            raise ValueError("bits must be a multiple of 32")
        x = jnp.asarray(features, jnp.float32)
        n, d = x.shape
        if d < bits:
            raise ValueError(f"need feature dim >= bits ({d} < {bits})")
        mean = x.mean(axis=0)
        xc = x - mean
        cov = jnp.dot(xc.T, xc, precision=_HIGHEST) / max(n - 1, 1)
        eigval, eigvec = jnp.linalg.eigh(cov)        # ascending
        w = eigvec[:, -bits:][:, ::-1]               # top-`bits` PCs
        v = jnp.dot(xc, w, precision=_HIGHEST)       # [n, bits]

        key = jax.random.PRNGKey(seed)
        r0 = jnp.linalg.qr(
            jax.random.normal(key, (bits, bits), jnp.float32))[0]

        def itq_step(r, _):
            z = jnp.dot(v, r, precision=_HIGHEST)
            b = jnp.sign(z) + (z == 0)               # ±1
            # Procrustes: R = S @ S_hat^T from SVD of B^T V
            u, _s, vt = jnp.linalg.svd(jnp.dot(b.T, v, precision=_HIGHEST),
                                       full_matrices=False)
            return jnp.dot(u, vt, precision=_HIGHEST).T, None
        r, _ = jax.lax.scan(itq_step, r0, None, length=n_iters)
        return ITQEncoder(mean=mean, w=w, r=r)

    def encode(self, features: jax.Array) -> jax.Array:
        """f32[B, D] -> packed uint32[B, bits//32]."""
        z = jnp.dot(jnp.dot(features.astype(jnp.float32) - self.mean,
                            self.w, precision=_HIGHEST),
                    self.r, precision=_HIGHEST)
        return _pack_bits_device(z >= 0)


def encode_corpus(encoder, features: np.ndarray, batch: int = 65536
                  ) -> np.ndarray:
    """Stream a big feature matrix through the encoder -> packed codes."""
    out = []
    enc = jax.jit(encoder.encode)
    for lo in range(0, features.shape[0], batch):
        out.append(np.asarray(enc(jnp.asarray(features[lo:lo + batch]))))
    return np.concatenate(out) if out else np.empty(
        (0, 1), np.uint32)


def write_code_file(path: str, packed: np.ndarray) -> None:
    """Write codes in the reference's raw ``lsh.code`` layout (16 B rows,
    little-endian — build_hash_tables.cc:42 fread contract)."""
    codes_lib.unpack_to_bytes(np.asarray(packed)).tofile(path)
