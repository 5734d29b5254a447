// What kmer_hash.cu and seed_hash.cu share: ntHash2's split rotations, the
// code clamp, and the writes of one window's outputs.
#pragma once

#include <cuda_runtime.h>

namespace nthash {

constexpr unsigned long long kMask33 = (1ULL << 33) - 1;
constexpr unsigned long long kMask31 = (1ULL << 31) - 1;
constexpr int kMultiShift = 27;  // nte64 MULTISHIFT

// Split-rotate left by 1: bits 0..32 and bits 33..63 rotate independently.
__device__ __forceinline__ unsigned long long srol1(unsigned long long x) {
  unsigned long long lo = x & kMask33, hi = x >> 33;
  lo = ((lo << 1) | (lo >> 32)) & kMask33;
  hi = ((hi << 1) | (hi >> 30)) & kMask31;
  return (hi << 33) | lo;
}

__device__ __forceinline__ unsigned long long sror1(unsigned long long x) {
  unsigned long long lo = x & kMask33, hi = x >> 33;
  lo = ((lo >> 1) | (lo << 32)) & kMask33;
  hi = ((hi >> 1) | (hi << 30)) & kMask31;
  return (hi << 33) | lo;
}

// codes[i] with every value above 4 (and any negative one) read as 4.
__device__ __forceinline__ unsigned code_at(const int* __restrict__ codes,
                                            long long i) {
  return min(static_cast<unsigned>(codes[i]), 4u);
}

// Writes one window's outputs at element `at` of plane 0, the planes `plane`
// elements apart: the canonical hash fwd + rev and its num_hashes - 1 nte64
// extensions (multipliers `mult`), then fwd and rev if emit_fwd_rev, as
// uint64; or, with kBuckets, the low bucket_bits bits of the num_hashes
// values as int32, each the sentinel 2^bucket_bits where !valid.
template <bool kBuckets>
__device__ __forceinline__ void write_window(
    void* __restrict__ out, size_t at, size_t plane, unsigned long long fwd,
    unsigned long long rev, bool valid, int num_hashes, int emit_fwd_rev,
    int bucket_bits, const unsigned long long* mult) {
  const unsigned long long canon = fwd + rev;
  if (kBuckets) {
    int* o = static_cast<int*>(out);
    const unsigned long long mask = (1ULL << bucket_bits) - 1;
    const int sentinel = 1 << bucket_bits;
    o[at] = valid ? static_cast<int>(canon & mask) : sentinel;
    for (int i = 1; i < num_hashes; ++i) {
      unsigned long long e = canon * mult[i - 1];
      e ^= e >> kMultiShift;
      o[i * plane + at] = valid ? static_cast<int>(e & mask) : sentinel;
    }
  } else {
    unsigned long long* o = static_cast<unsigned long long*>(out);
    o[at] = canon;
    for (int i = 1; i < num_hashes; ++i) {
      unsigned long long e = canon * mult[i - 1];
      e ^= e >> kMultiShift;
      o[i * plane + at] = e;
    }
    if (emit_fwd_rev) {
      o[num_hashes * plane + at] = fwd;
      o[(num_hashes + 1) * plane + at] = rev;
    }
  }
}

}  // namespace nthash
