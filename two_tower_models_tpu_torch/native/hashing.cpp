// Batch entity-ID hashing for ingest — C++ with a C ABI for ctypes.
//
// Production two-tower ingest maps raw entity IDs (64-bit surrogate keys or
// string keys) onto embedding-table slots.  The reference assumes pre-hashed
// integer ids (every model takes `*_hash_size`, e.g.
// two_tower_base_retrieval.py:58-63) and never provides the hasher; this
// supplies it as a batch kernel over numpy arrays, called through ctypes
// (which releases the GIL for the call) on the host.
//
// Hash: xxHash64-style avalanche mix (public algorithm, implemented from
// the spec) — stable across platforms/runs, which checkpointed embedding
// tables require (Python's built-in hash() is salted per process).  The
// constants, the mix and the tail rule are the JAX package's hasher's, so
// the two packages map every key to the same slot.
//
// Build:  c++ -O3 -shared -fPIC -o _hashing.so hashing.cpp
// (done by native/__init__.py on first use, into the package's _build/;
// numpy fallback when no compiler builds it.)

#include <cstdint>
#include <cstddef>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= P2;
  x ^= x >> 29;
  x *= P3;
  x ^= x >> 32;
  return x;
}

inline uint64_t hash_u64(uint64_t key, uint64_t seed) {
  uint64_t h = seed + P1;
  h ^= mix64(key * P2);
  h = rotl(h, 27) * P1 + P2;
  return mix64(h);
}

}  // namespace

extern "C" {

// ids[n] -> out[n] = hash(ids[i], seed) % table_size
void hash_ids_u64(const uint64_t* ids, int64_t n, uint64_t seed,
                  uint64_t table_size, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint32_t>(hash_u64(ids[i], seed) % table_size);
  }
}

// Byte-string keys: offsets[n+1] delimit each key in `bytes`.  Whole 8-byte
// little-endian words first, then the 0-7 byte tail as one zero-padded word
// (an empty tail, a length that is a multiple of 8, included).
void hash_ids_bytes(const uint8_t* bytes, const int64_t* offsets, int64_t n,
                    uint64_t seed, uint64_t table_size, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = bytes + offsets[i];
    const int64_t len = offsets[i + 1] - offsets[i];
    uint64_t h = seed + P1 + static_cast<uint64_t>(len);
    int64_t j = 0;
    for (; j + 8 <= len; j += 8) {
      uint64_t w;
      __builtin_memcpy(&w, p + j, 8);
      h = rotl(h ^ mix64(w * P2), 27) * P1 + P2;
    }
    uint64_t tail = 0;
    for (int64_t k = 0; j + k < len; ++k) {
      tail |= static_cast<uint64_t>(p[j + k]) << (8 * k);
    }
    h = rotl(h ^ mix64(tail * P2), 27) * P1 + P2;
    out[i] = static_cast<uint32_t>(mix64(h) % table_size);
  }
}

}  // extern "C"
