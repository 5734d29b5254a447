// Rolling ntHash2 over time-major reads: one thread per (read, segment);
// and over one flat sequence (kmer_sequence_kernel, at the end).
//
// Replaces nthash_tpu/ops/kmer_pallas.py::_kernel (hash_kmers_tm, one segment
// per read) and ::_kernel_long (hash_kmers_tm_long, segments of `seg`
// windows), and computes what they compute: for codes [L, R] int32 (0-3 =
// ACGT, 4 = invalid; larger values count as 4) it rolls each read's forward
// and reverse hash one base per step, and for every window w = t - k + 1
// writes
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
// the table, and the roll-out is skipped during a segment's first k steps.
//
// Segments. Thread (r, j) owns windows [j*seg, min((j+1)*seg, W)) of read r:
// it starts at base j*seg with zero state and a zero invalid count, rolls
// seg + k - 1 bases, and writes from its k-th base on. A window's hash
// depends only on its own k bases, so a segment's warm-up is exact for the
// same reason the Pallas warm-up (kmer_pallas.py:243-247) and the
// pseudo-reads of parallel/sp.py are. The TPU kernel instead carries the
// state across a sequential grid axis of time tiles; CUDA blocks run in no
// order, so that scheme has no counterpart here. seg >= W is one segment per
// read, exactly A1, and compiles to its own instance (kSegmented = false)
// without the segment arithmetic, which slowed bucket mode on the 150-bp
// main path. The extra work is (k - 1) / seg of the roll (12% at
// k = 32, seg = 256); in return a batch of 4,096 reads of 10,000 bp runs
// 40 x 4,096 threads instead of 16 blocks of 256 on 132 SMs.
//
// What bounds it on the H100: output bytes. The work per window is a few
// dozen integer ops; the writes are 8 * W * R * nout bytes in hashes mode
// (3.8 GiB for 1M reads of 150 bp at k=32, h=4) and half that in bucket mode,
// against 4 * L * R * 2 bytes of code reads. The design keeps every byte it
// can out of device memory and makes the rest coalesced: fwd, rev and the
// invalid count live in registers for the whole segment; the read index runs
// fastest across threads, so thread r reads codes[t*R + r] and
// codes[(t-k)*R + r] (the second load hits L1/L2, it was read k steps
// earlier) and writes out[i][w*R + r], and a warp moves 128-byte (codes,
// buckets) or 256-byte (hashes) contiguous segments. The grid is 1-D with
// 64-bit thread indices (gridDim.y stops at 65,535; one 2^27-base read has
// 524k segments). The TPU kernel's (8,128)-tile interleave, VMEM budget,
// 5-way select chains and 16-bit multiply limbs have no counterpart: the
// tables are 20 + h - 1 uint64 in shared memory, indexed by code, and the
// multiply is native 64-bit. Fusing the histogram atomics into this kernel
// (no bucket array at all) is left to a later change.

#include <cuda_runtime.h>

#include <cstdint>

#include "roll.cuh"

namespace {

using nthash::code_at;
using nthash::srol1;
using nthash::sror1;

constexpr int kThreads = 256;
constexpr int kPairCopiesLog2 = 3;  // the sequence entry's pair-table copies
constexpr int kRun = 32;            // ... and its output runs, windows a lane

// tables: [0,5) fwd_in, [5,10) fwd_out, [10,15) rev_in, [15,20) rev_out_r,
// [20, 19 + num_hashes) nte64 multipliers for hashes 1..num_hashes-1.
template <bool kBuckets, bool kSegmented>
__global__ void __launch_bounds__(kThreads)
kmer_hash_kernel(const int* __restrict__ codes, int L, long long R, int k,
                 int seg, long long nseg, int num_hashes, int emit_fwd_rev,
                 int bucket_bits, const unsigned long long* __restrict__ tables,
                 void* __restrict__ out) {
  extern __shared__ unsigned long long tab[];
  const int ntab = 19 + num_hashes;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= nseg * R) return;
  const long long r = kSegmented ? gid % R : gid;
  const int t0 = kSegmented ? static_cast<int>(gid / R) * seg : 0;  // first base
  const unsigned long long* fwd_in = tab;
  const unsigned long long* fwd_out = tab + 5;
  const unsigned long long* rev_in = tab + 10;
  const unsigned long long* rev_out_r = tab + 15;
  const unsigned long long* mult = tab + 20;

  const int W = L - k + 1;
  const size_t plane = static_cast<size_t>(W) * R;
  const int t_end = kSegmented ? min(t0 + seg, W) + k - 1 : L;

  unsigned long long fwd = 0, rev = 0;
  int inv = 0;
  for (int t = t0; t < t_end; ++t) {
    const unsigned c_in = code_at(codes, static_cast<long long>(t) * R + r);
    fwd = srol1(fwd) ^ fwd_in[c_in];
    rev = sror1(rev) ^ rev_in[c_in];
    inv += c_in >= 4;
    if (t - t0 >= k) {
      const unsigned c_out = code_at(codes, static_cast<long long>(t - k) * R + r);
      fwd ^= fwd_out[c_out];
      rev ^= rev_out_r[c_out];
      inv -= c_out >= 4;
    }
    if (t - t0 < k - 1) continue;
    nthash::write_window<kBuckets>(
        out, static_cast<size_t>(t - k + 1) * R + r, plane, fwd, rev, inv == 0,
        num_hashes, emit_fwd_rev, bucket_bits, mult);
  }
}

// The one-sequence entry (hash_sequence): nthash::seq::kmer_sequence of
// roll.cuh, the recurrence above with the two taps 0 and k. It replaces, for
// one long sequence, the pseudo-reads of parallel/sp.py (overlapping rows
// copied from the sequence, transposed to int32, their [t, rows] output
// planes transposed back): lane l of a warp rolls windows [(j0 + l) s,
// (j0 + l + 1) s) of the flat uint8 codes in unrolled chunks of 32 steps,
// its bases staged one chunk ahead by 16-byte loads into its own ring in
// shared memory, and its outputs leave through an 8 KB stage a plane as
// 256-byte runs of 32 windows (roll.cuh says why: the earlier design lost
// its time in the roll's instruction stream and its one-window writes).
// Its bytes (the codes once, 8 * num_hashes + 1 bytes a window written, 16
// more with kFwdRev) set its floor on the H100. kFwdRev (the facade's tiles,
// api.NtHash) also writes each window's fwd and rev: its stage holds both.
template <bool kFwdRev>
__global__ void __launch_bounds__(256, kFwdRev ? 3 : 4)
kmer_sequence_kernel(const unsigned char* __restrict__ seq, long long C, int k,
                     int span, int num_hashes,
                     const unsigned long long* __restrict__ tables, int ring,
                     unsigned long long* __restrict__ out, long long pitch,
                     bool* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char sm[];
  const unsigned char* pairs;
  const unsigned long long* mult;
  const int* taps;
  unsigned char* warps = nthash::seq::load_tables(
      sm, 1, 1, num_hashes, kPairCopiesLog2, tables, nullptr, &pairs, &mult,
      &taps);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
  if (j0 * span >= C) return;  // whole warps only
  unsigned char* mine =
      warps + (threadIdx.x >> 5) * nthash::seq::warp_bytes(ring, kFwdRev ? 2 : 1, 0, kRun);
  nthash::seq::kmer_sequence<kFwdRev, kRun>(
      seq, C, k, span, num_hashes,
      pairs + ((lane & ((1 << kPairCopiesLog2) - 1)) << 4), 4 + kPairCopiesLog2,
      mult, reinterpret_cast<unsigned*>(mine), ring,
      mine + (ring / 4 + 8) * 128, j0, lane, out, pitch, valid);
}

size_t kmer_sequence_smem(int num_hashes, int warps, int ring, int fwd_rev) {
  return nthash::seq::tables_bytes(1, 1, num_hashes, kPairCopiesLog2) +
         warps * nthash::seq::warp_bytes(ring, fwd_rev ? 2 : 1, 0, kRun);
}

}  // namespace

extern "C" {

// codes: [L, R] int32 device; tables: 19 + num_hashes uint64 device;
// out: [nout, L - k + 1, R] uint64 (bucket_bits == 0) or int32 buckets;
// seg: windows per segment (>= 1; seg >= L - k + 1 is one segment per read).
// Launches on `stream` of `device`; returns cudaGetLastError().
int nthash_kmer_hash(int device, const int* codes, int L, long long R, int k,
                     int seg, int num_hashes, int emit_fwd_rev, int bucket_bits,
                     const unsigned long long* tables, void* out,
                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long nseg = (static_cast<long long>(L - k + 1) + seg - 1) / seg;
  const long long blocks = (nseg * R + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(19 + num_hashes) * sizeof(unsigned long long);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (bucket_bits > 0 && nseg > 1) {
    kmer_hash_kernel<true, true><<<grid, kThreads, smem, stream>>>(
        codes, L, R, k, seg, nseg, num_hashes, 0, bucket_bits, tables,
        out);
  } else if (bucket_bits > 0) {
    kmer_hash_kernel<true, false><<<grid, kThreads, smem, stream>>>(
        codes, L, R, k, seg, nseg, num_hashes, 0, bucket_bits, tables,
        out);
  } else if (nseg > 1) {
    kmer_hash_kernel<false, true><<<grid, kThreads, smem, stream>>>(
        codes, L, R, k, seg, nseg, num_hashes, emit_fwd_rev, 0, tables, out);
  } else {
    kmer_hash_kernel<false, false><<<grid, kThreads, smem, stream>>>(
        codes, L, R, k, seg, nseg, num_hashes, emit_fwd_rev, 0, tables, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// seq: [C] uint8 codes device, 16-byte aligned (values above 4 read as 4);
// out: [num_hashes (+ 2 with fwd_rev), pitch] uint64, pitch >= C a multiple
// of 32 (window w of plane i at out[i * pitch + w]); valid: [C rounded up to
// 32] bool; span: windows a lane (a multiple of 32); warps: a block (1-8);
// tables: the 25 (fwd, rev) pairs (fwd_in[c_in] ^ fwd_out[c_out],
// rev_in[c_in] ^ rev_out_r[c_out] at 5 c_in + c_out), then the num_hashes -
// 1 nte64 multipliers, as uint64; fwd_rev: also write fwd and rev. Each
// lane's ring holds 32 ((k - 1) / 32 + 3) bytes.
int nthash_kmer_sequence(int device, const unsigned char* seq, long long C,
                         int k, int span, int num_hashes, int fwd_rev,
                         const unsigned long long* tables, int warps,
                         unsigned long long* out, long long pitch, bool* valid,
                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || span < 32 || span % 32 || warps < 1 || warps > 8 ||
      pitch < C || pitch % 32 || reinterpret_cast<uintptr_t>(seq) % 16 ||
      reinterpret_cast<uintptr_t>(valid) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = (C + span - 1) / span;
  const long long blocks = ((threads + 31) / 32 + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ring = 32 * ((k - 1) / 32 + 3);
  const size_t smem = kmer_sequence_smem(num_hashes, warps, ring, fwd_rev);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fwd_rev ? &kmer_sequence_kernel<true> : &kmer_sequence_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      seq, C, k, span, num_hashes, tables, ring, out, pitch, valid);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
