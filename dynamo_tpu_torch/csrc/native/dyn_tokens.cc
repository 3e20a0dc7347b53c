// Native token-block hashing — C++ counterpart of dynamo_tpu_torch/tokens.py.
//
// Reference counterpart (semantics, not code): the dynamo-tokens Rust crate
// (lib/tokens/src/lib.rs:44-369) gives the reference a native fast path for
// chained block hashing; this library plays that role here.  The algorithm
// is XXH64 (public-domain spec) with seed 1337, matching python-xxhash's
// xxh64_intdigest, so hashes computed in Python and C++ agree bit-for-bit —
// a hard requirement: routing indexes and engine reuse pools compare these
// values across processes.
//
// Build: dynamo_tpu_torch/native.py runs g++ -O3 -std=c++17 -fPIC -shared
// over this file and dyn_kv_events.cc and loads the library via ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;  // little-endian hosts only (x86-64 / arm64)
}

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}

inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * P1 + P4;
}

uint64_t xxh64(const void* data, size_t len, uint64_t seed) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    do {
      v1 = xxh_round(v1, read64(p)); p += 8;
      v2 = xxh_round(v2, read64(p)); p += 8;
      v3 = xxh_round(v3, read64(p)); p += 8;
      v4 = xxh_round(v4, read64(p)); p += 8;
    } while (p + 32 <= end);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h ^= xxh_round(0, read64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

constexpr uint64_t kSeed = 1337;  // dynamo_tpu_torch.tokens.HASH_SEED

}  // namespace

extern "C" {

uint64_t dyn_xxh64(const void* data, uint64_t len, uint64_t seed) {
  return xxh64(data, static_cast<size_t>(len), seed);
}

// Hash complete blocks of `tokens` (u32 ids, little-endian packed — same
// bytes as tokens.py's struct.pack("<nI")).  parent_hash seeds the chain
// (0 = root, matching Python's None→0 packing; pass salt_hash for tenant
// isolation).  Writes per-block local + chained hashes; returns block count.
uint64_t dyn_hash_blocks(const uint32_t* tokens, uint64_t n_tokens,
                         uint64_t block_size, uint64_t parent_hash,
                         uint64_t* out_local, uint64_t* out_seq) {
  if (block_size == 0) return 0;
  const uint64_t n_blocks = n_tokens / block_size;
  uint64_t parent = parent_hash;
  for (uint64_t b = 0; b < n_blocks; ++b) {
    const uint32_t* blk = tokens + b * block_size;
    const uint64_t local = xxh64(blk, block_size * sizeof(uint32_t), kSeed);
    uint64_t chain_buf[2] = {parent, local};
    const uint64_t seq = xxh64(chain_buf, sizeof(chain_buf), kSeed);
    out_local[b] = local;
    out_seq[b] = seq;
    parent = seq;
  }
  return n_blocks;
}

}  // extern "C"
