"""Native runtime: ctypes bindings to the C++ KV store / builder / integrity
primitives (sources in ``src/``), compiled on demand with g++.

The native pieces cover the host side of the framework — the roles the
reference implements in C++ (SURVEY.md §2 "native" rows): the cuckoo-hash
KV store (Pilaf DHT analog), the streaming index builder
(build_hash_tables analog), bitmap generation (generate_bitmap analog),
and the CRC64/Murmur64 integrity primitives. The device compute path
never calls these; they feed it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libverticut_native.so")
_SOURCES = ["builder.cc", "dht_capi.cc", "hashdir.cc"]
_HEADERS = ["integrity.h", "dht.h"]

_lib: Optional[ctypes.CDLL] = None


def _needs_build() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for f in _SOURCES + _HEADERS:
        if os.path.getmtime(os.path.join(_SRC_DIR, f)) > lib_mtime:
            return True
    return False


def build(verbose: bool = False) -> str:
    """Compile the shared library if missing or stale."""
    if _needs_build():
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
               "-o", _LIB_PATH] + [os.path.join(_SRC_DIR, s) for s in _SOURCES]
        if verbose:
            print("building:", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=not verbose)
    return _LIB_PATH


def lib() -> ctypes.CDLL:
    """Load (building if needed) and return the CDLL with typed signatures."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    L = ctypes.CDLL(path)
    u64, i64, u32, i32 = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32,
                          ctypes.c_int32)
    vp, cp = ctypes.c_void_p, ctypes.c_char_p

    L.vt_build_csr.restype = i32
    L.vt_build_csr.argtypes = [vp, u64, u32, u32, u32, vp, vp]
    L.vt_gather_rows.restype = i32
    L.vt_gather_rows.argtypes = [vp, u64, u32, vp, u64, vp]
    L.vt_build_bitmap.restype = i32
    L.vt_build_bitmap.argtypes = [vp, u64, u32, vp]
    L.vt_build_hashdir.restype = i32
    L.vt_build_hashdir.argtypes = [vp, u64, u64, vp]
    L.vt_build_from_file.restype = i64
    L.vt_build_from_file.argtypes = [cp, u32, u32, u64, vp]
    L.vt_crc64.restype = u64
    L.vt_crc64.argtypes = [vp, u64]
    L.vt_murmur64.restype = u64
    L.vt_murmur64.argtypes = [vp, u64, u64]
    L.vt_hash_n.restype = u64
    L.vt_hash_n.argtypes = [vp, u64, i32]

    L.vt_dht_create.restype = vp
    L.vt_dht_create.argtypes = [u64, u64]
    L.vt_dht_destroy.argtypes = [vp]
    L.vt_dht_put.restype = i32
    L.vt_dht_put.argtypes = [vp, vp, u32, vp, u32]
    L.vt_dht_get.restype = i64
    L.vt_dht_get.argtypes = [vp, vp, u32, vp, u64]
    L.vt_dht_contains.restype = i32
    L.vt_dht_contains.argtypes = [vp, vp, u32]
    L.vt_dht_remove.restype = i32
    L.vt_dht_remove.argtypes = [vp, vp, u32]
    L.vt_dht_count.restype = u64
    L.vt_dht_count.argtypes = [vp]
    L.vt_dht_capacity.restype = u64
    L.vt_dht_capacity.argtypes = [vp]
    L.vt_dht_stats.argtypes = [vp, vp]
    _lib = L
    return L


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# numpy-facing wrappers
# ---------------------------------------------------------------------------

def build_csr(codes: np.ndarray, table_id: int, s_bits: int):
    """Sorted (keys, ids) for one table. codes: uint32[N, W] C-contiguous."""
    codes = np.ascontiguousarray(codes, np.uint32)
    n, w = codes.shape
    keys = np.empty(n, np.uint32)
    ids = np.empty(n, np.int32)
    rc = lib().vt_build_csr(_ptr(codes), n, w, table_id, s_bits,
                            _ptr(keys), _ptr(ids))
    if rc != 0:
        raise RuntimeError(f"vt_build_csr failed: {rc}")
    return keys, ids


def gather_rows(codes: np.ndarray, ids: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.uint32)
    ids = np.ascontiguousarray(ids, np.int32)
    out = np.empty((ids.shape[0], codes.shape[1]), np.uint32)
    lib().vt_gather_rows(_ptr(codes), codes.shape[0], codes.shape[1],
                         _ptr(ids), ids.shape[0], _ptr(out))
    return out


def build_bitmap(sorted_keys: np.ndarray, s_bits: int) -> np.ndarray:
    sorted_keys = np.ascontiguousarray(sorted_keys, np.uint32)
    words = np.zeros((1 << s_bits) // 32, np.uint32)
    rc = lib().vt_build_bitmap(_ptr(sorted_keys), sorted_keys.shape[0],
                               s_bits, _ptr(words))
    if rc != 0:
        raise RuntimeError(f"vt_build_bitmap failed: {rc}")
    return words


def build_hashdir(sorted_keys: np.ndarray, n_slots: int = 0) -> np.ndarray:
    """Cuckoo row table ``uint32[n_slots, 4]`` ([key, start, count, 0]) from
    a sorted (duplicated) key column. Doubles the table on insertion failure."""
    sorted_keys = np.ascontiguousarray(sorted_keys, np.uint32)
    n = sorted_keys.shape[0]
    if n_slots <= 0:
        n_uniq = 1 if n == 0 else int(
            (sorted_keys[1:] != sorted_keys[:-1]).sum()) + 1
        n_slots = 1 << max(3, int(np.ceil(np.log2(max(n_uniq, 1) / 0.4))))
    while True:
        table = np.empty((n_slots, 4), np.uint32)
        rc = lib().vt_build_hashdir(_ptr(sorted_keys), n, n_slots, _ptr(table))
        if rc == 0:
            return table
        if rc == -2:
            raise ValueError(f"bad n_slots {n_slots}")
        n_slots *= 2


def read_code_file(path: str, code_bytes: int, max_codes: int) -> np.ndarray:
    out = np.empty((max_codes, code_bytes // 4), np.uint32)
    n = lib().vt_build_from_file(path.encode(), code_bytes, 0, max_codes,
                                 _ptr(out))
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n]


def crc64(data: bytes) -> int:
    return int(lib().vt_crc64(ctypes.c_char_p(data), len(data)))


def murmur64(data: bytes, seed: int) -> int:
    return int(lib().vt_murmur64(ctypes.c_char_p(data), len(data),
                                 ctypes.c_uint64(seed)))


def hash_n(data: bytes, n: int) -> int:
    return int(lib().vt_hash_n(ctypes.c_char_p(data), len(data), n))


class NativeDHT:
    """Host cuckoo-hash KV store (the Pilaf store-server/DHT analog)."""

    def __init__(self, n_slots: int = 1024, arena_bytes: int = 1 << 20):
        self._L = lib()
        self._h = self._L.vt_dht_create(n_slots, arena_bytes)

    def put(self, key: bytes, value: bytes) -> None:
        rc = self._L.vt_dht_put(self._h, ctypes.c_char_p(key), len(key),
                                ctypes.c_char_p(value), len(value))
        if rc != 0:
            raise RuntimeError(f"dht put failed: {rc}")

    def get(self, key: bytes):
        cap = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._L.vt_dht_get(self._h, ctypes.c_char_p(key), len(key),
                                   buf, cap)
            if n < 0:
                return None
            if n <= cap:
                return buf.raw[:n]
            cap = int(n)

    def contains(self, key: bytes) -> bool:
        return bool(self._L.vt_dht_contains(self._h, ctypes.c_char_p(key),
                                            len(key)))

    def remove(self, key: bytes) -> bool:
        return self._L.vt_dht_remove(self._h, ctypes.c_char_p(key),
                                     len(key)) == 0

    def __len__(self) -> int:
        return int(self._L.vt_dht_count(self._h))

    @property
    def capacity(self) -> int:
        return int(self._L.vt_dht_capacity(self._h))

    def stats(self) -> dict:
        out = np.zeros(7, np.uint64)
        self._L.vt_dht_stats(self._h, _ptr(out))
        names = ["puts", "gets", "removes", "probes", "kicks", "resizes",
                 "crc_failures"]
        return dict(zip(names, out.tolist()))

    def close(self) -> None:
        if self._h:
            self._L.vt_dht_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
