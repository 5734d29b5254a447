// Rolling ntHash2 over time-major reads: one thread per read.
//
// Replaces nthash_tpu/ops/kmer_pallas.py::_kernel (hash_kmers_tm) and computes
// what it computes: for codes [L, R] int32 (0-3 = ACGT, 4 = invalid; larger
// values count as 4) it rolls each read's forward and reverse hash one base per
// step, and for every window w = t - k + 1 writes
//   hashes mode: the canonical hash (fwd + rev) and its num_hashes - 1 nte64
//                extensions, then fwd and rev if emit_fwd_rev, as uint64
//                planes [nout, W, R];
//   bucket mode (bucket_bits = b > 0): the low b bits of each of those
//                num_hashes values as int32 planes [num_hashes, W, R], or the
//                sentinel 2^b where the window holds an invalid base (tracked
//                by a rolling invalid count, kmer_pallas.py:84-95, 106-115).
//
// The recurrence is the Pallas kernel's own (kmer_pallas.py:81-93):
//   fwd = srol1(fwd) ^ fwd_in[c_in] ^ fwd_out[c_out]
//   rev = sror1(rev) ^ rev_in[c_in] ^ rev_out_r[c_out]
// where rev_out_r = sror1(SEED[comp(b)]) folds the sror of the roll-out into
// the table, and the roll-out is skipped while t < k.
//
// What bounds it on the H100: output bytes. The work per window is a few
// dozen integer ops; the writes are 8 * W * R * nout bytes in hashes mode
// (3.8 GiB for 1M reads of 150 bp at k=32, h=4) and half that in bucket mode,
// against 4 * L * R * 2 bytes of code reads. The design keeps every byte it
// can out of device memory and makes the rest coalesced: fwd, rev and the
// invalid count live in registers for the whole read; thread r reads
// codes[t*R + r] and codes[(t-k)*R + r] (the second load hits L1/L2, it was
// read k steps earlier) and writes out[i][w*R + r], so a warp moves 128-byte
// (codes, buckets) or 256-byte (hashes) contiguous segments. The TPU kernel's
// (8,128)-tile interleave, VMEM budget, 5-way select chains and 16-bit
// multiply limbs have no counterpart: the tables are 20 + h - 1 uint64 in
// shared memory, indexed by code, and the multiply is native 64-bit. Fusing
// the histogram atomics into this kernel (no bucket array at all) is left to
// a later change.

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kMask33 = (1ULL << 33) - 1;
constexpr unsigned long long kMask31 = (1ULL << 31) - 1;
constexpr int kMultiShift = 27;  // nte64 MULTISHIFT
constexpr int kThreads = 256;

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

__device__ __forceinline__ unsigned code_at(const int* __restrict__ codes,
                                            long long i) {
  return min(static_cast<unsigned>(codes[i]), 4u);
}

// tables: [0,5) fwd_in, [5,10) fwd_out, [10,15) rev_in, [15,20) rev_out_r,
// [20, 19 + num_hashes) nte64 multipliers for hashes 1..num_hashes-1.
template <bool kBuckets>
__global__ void __launch_bounds__(kThreads)
kmer_hash_kernel(const int* __restrict__ codes, int L, long long R, int k,
                 int num_hashes, int emit_fwd_rev, int bucket_bits,
                 const unsigned long long* __restrict__ tables,
                 void* __restrict__ out) {
  extern __shared__ unsigned long long tab[];
  const int ntab = 19 + num_hashes;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const unsigned long long* fwd_in = tab;
  const unsigned long long* fwd_out = tab + 5;
  const unsigned long long* rev_in = tab + 10;
  const unsigned long long* rev_out_r = tab + 15;
  const unsigned long long* mult = tab + 20;

  const size_t plane = static_cast<size_t>(L - k + 1) * R;
  const unsigned long long mask = (1ULL << bucket_bits) - 1;
  const int sentinel = 1 << bucket_bits;

  unsigned long long fwd = 0, rev = 0;
  int inv = 0;
  for (int t = 0; t < L; ++t) {
    const unsigned c_in = code_at(codes, static_cast<long long>(t) * R + r);
    fwd = srol1(fwd) ^ fwd_in[c_in];
    rev = sror1(rev) ^ rev_in[c_in];
    inv += c_in >= 4;
    if (t >= k) {
      const unsigned c_out = code_at(codes, static_cast<long long>(t - k) * R + r);
      fwd ^= fwd_out[c_out];
      rev ^= rev_out_r[c_out];
      inv -= c_out >= 4;
    }
    if (t < k - 1) continue;
    const size_t at = static_cast<size_t>(t - k + 1) * R + r;
    const unsigned long long canon = fwd + rev;
    if (kBuckets) {
      int* o = static_cast<int*>(out);
      const bool valid = inv == 0;
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
}

}  // namespace

extern "C" {

// codes: [L, R] int32 device; tables: 19 + num_hashes uint64 device;
// out: [nout, L - k + 1, R] uint64 (bucket_bits == 0) or int32 buckets.
// Launches on `stream` of `device`; returns cudaGetLastError().
int nthash_kmer_hash(int device, const int* codes, int L, long long R, int k,
                     int num_hashes, int emit_fwd_rev, int bucket_bits,
                     const unsigned long long* tables, void* out,
                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (R + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(19 + num_hashes) * sizeof(unsigned long long);
  if (bucket_bits > 0) {
    kmer_hash_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        codes, L, R, k, num_hashes, emit_fwd_rev, bucket_bits, tables, out);
  } else {
    kmer_hash_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        codes, L, R, k, num_hashes, emit_fwd_rev, 0, tables, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
