// Native index builder: raw packed codes -> per-table CSR arrays.
//
// Replaces the reference's streaming read-modify-write build
// (src/build_hash_tables.cc:25-73 — O(bucket bytes) per append through the
// KV store) with a two-pass radix sort per table:
//   pass 1: histogram of the top 16 substring bits,
//   pass 2: scatter (substring, id) into partitions,
//   pass 3: per-partition comparison sort of packed (substring<<32 | id).
// O(N log(N/2^16)) with a sequential output layout; the sorted
// (key, id) columns feed the device directories directly.
//
// Also hosts the bitmap generator (src/generate_bitmap.cc analog) and the
// row gather used to materialize entry_codes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "integrity.h"

namespace {

// substring value of code row `row` for table `t`: s_bytes consecutive
// bytes starting at byte t*s_bytes, composed little-endian
// (Pilaf/image_tools.h binaryToInt semantics; bytes live inside uint32
// words little-endian, so this is pure shifts).
inline uint32_t Substring(const uint32_t* row, uint32_t table_id,
                          uint32_t s_bits) {
  const uint32_t s_bytes = s_bits / 8;
  const uint32_t start = table_id * s_bytes;
  uint32_t v = 0;
  for (uint32_t j = 0; j < s_bytes; ++j) {
    const uint32_t byte_idx = start + j;
    const uint32_t word = row[byte_idx >> 2];
    v |= ((word >> ((byte_idx & 3) * 8)) & 0xFFu) << (8 * j);
  }
  return v;
}

}  // namespace

extern "C" {

// Sorted (substring, id) build for one table.
// codes: uint32[n, n_words]; out_keys: uint32[n]; out_ids: int32[n].
int vt_build_csr(const uint32_t* codes, uint64_t n, uint32_t n_words,
                 uint32_t table_id, uint32_t s_bits, uint32_t* out_keys,
                 int32_t* out_ids) {
  if (s_bits > 32 || s_bits % 8) return -1;
  const int kPartBits = s_bits < 16 ? 0 : 16;
  const uint32_t shift = s_bits - kPartBits;
  const uint64_t n_parts = 1ULL << kPartBits;

  std::vector<uint64_t> offsets(n_parts + 1, 0);
  for (uint64_t i = 0; i < n; ++i) {
    const uint32_t sub = Substring(codes + i * n_words, table_id, s_bits);
    offsets[(sub >> shift) + 1]++;
  }
  for (uint64_t p = 0; p < n_parts; ++p) offsets[p + 1] += offsets[p];

  std::vector<uint64_t> packed(n);  // sub<<32 | id, per partition
  std::vector<uint64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (uint64_t i = 0; i < n; ++i) {
    const uint32_t sub = Substring(codes + i * n_words, table_id, s_bits);
    packed[cursor[sub >> shift]++] =
        (static_cast<uint64_t>(sub) << 32) | static_cast<uint32_t>(i);
  }
  for (uint64_t p = 0; p < n_parts; ++p) {
    std::sort(packed.begin() + offsets[p], packed.begin() + offsets[p + 1]);
  }
  for (uint64_t i = 0; i < n; ++i) {
    out_keys[i] = static_cast<uint32_t>(packed[i] >> 32);
    out_ids[i] = static_cast<int32_t>(packed[i] & 0xFFFFFFFFu);
  }
  return 0;
}

// Gather code rows by id: out[i] = codes[ids[i]].
int vt_gather_rows(const uint32_t* codes, uint64_t n, uint32_t n_words,
                   const int32_t* ids, uint64_t n_out, uint32_t* out) {
  for (uint64_t i = 0; i < n_out; ++i) {
    const int64_t id = ids[i];
    if (id < 0 || static_cast<uint64_t>(id) >= n) {
      std::memset(out + i * n_words, 0, n_words * 4);
    } else {
      std::memcpy(out + i * n_words, codes + id * n_words, n_words * 4);
    }
  }
  return 0;
}

// Occupancy bitmap from the sorted key column (generate_bitmap.cc analog);
// words must hold 2^s_bits / 32 zero-initialized uint32s (bit layout
// matches src/bitmap.cc:22-26: value v -> word v>>5, bit v&31).
int vt_build_bitmap(const uint32_t* sorted_keys, uint64_t n, uint32_t s_bits,
                    uint32_t* words) {
  if (s_bits > 32 || s_bits < 5) return -1;
  for (uint64_t i = 0; i < n; ++i) {
    const uint32_t v = sorted_keys[i];
    words[v >> 5] |= 1u << (v & 31);
  }
  return 0;
}

// Full multi-table build from a raw code file (the build_hash_tables main
// loop, one pass over the file instead of one KV round-trip per code).
// Writes keys/ids per table into caller-provided buffers.
// Returns the number of codes read, or -1 on error.
int64_t vt_build_from_file(const char* path, uint32_t code_bytes,
                           uint32_t n_tables, uint64_t max_codes,
                           uint32_t* codes_out /* [max, code_bytes/4] */) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const uint64_t row_words = code_bytes / 4;
  uint64_t n = 0;
  while (n < max_codes) {
    const size_t got =
        std::fread(codes_out + n * row_words, 1, code_bytes, f);
    if (got != code_bytes) break;
    ++n;
  }
  std::fclose(f);
  return static_cast<int64_t>(n);
}

uint64_t vt_crc64(const void* data, uint64_t len) {
  static verticut::Integrity integ;
  return integ.Crc(data, len);
}

uint64_t vt_murmur64(const void* data, uint64_t len, uint64_t seed) {
  return verticut::Integrity::Murmur64A(data, len, seed);
}

uint64_t vt_hash_n(const void* data, uint64_t len, int n) {
  return verticut::Integrity::HashN(data, len, n);
}

}  // extern "C"
