// Exact int32 row histograms: private counters in shared memory merged once
// per block, the updates grouped by range and each range (or a hash table of
// a slice of it) counted in shared memory, or one global atomic add per
// update.
//
// Replaces nthash_tpu/ops/hist_pallas.py:133 _hist_kernel (reached through
// mxu_histogram_rows) and computes what it returns: for indices idx [R, N]
// int32 and optional int32 weights, shared [N] (row stride 0) or per row
// [R, N] (row stride N),
//   out[r, b] += w[r, n]  for every n with 0 <= idx[r, n] < width,
// into out [R, width] int32, which the caller zeroes or accumulates in (the
// count-min sketch's rows). Indices outside [0, width) are dropped by one
// unsigned compare. Sums wrap mod 2^32: shared and global atomicAdd on int
// are two's-complement additions, and so is the merge of a block's private
// sums, which is exactly what the TPU kernel's digit-plane recombination
// (hist_pallas.py:118-130) reproduces on the MXU. The TPU kernel keeps a
// tile of counters in VMEM across its sequential grid (its scratch,
// hist_pallas.py:142); a block's shared memory is the counterpart here.
//
// Four routes, chosen by the caller from the shapes alone
// (ops/hist_kernel.py::private_counts_grid, binned_counts_grid):
//
// Private counters (histogram_rows_private_kernel), widths 2^10..2^15. A
// block owns one row and one contiguous slice of its entries. It zeroes the
// row's 2^width_log2 counters in dynamic shared memory (4 KB at 2^10, 128 KB
// at 2^15), reads its slice with 16-byte loads (scalars for the unaligned
// head and the tail: a row may start anywhere and N need not be a multiple
// of 4), adds 1 or the weight to each in-range bucket by a shared-memory
// atomicAdd, and after a barrier merges: one global atomicAdd per non-zero
// counter. Block b works on row b % R, so the blocks in flight spread over
// all rows and their merges over all rows' counters. What bounds it: the
// bytes of its indices (and weights), each read once; the merge adds up to
// `width` atomics a block, so the caller gives every block at least two
// entries per counter (few, fat blocks).
//
// Binned (bin.cuh's binning pass, then histogram_ranges_kernel), widths
// 2^16 and up where the rows hold at most 4,096 ranges of 2^15 counters
// and a call brings at least 2^24 updates: the updates are grouped by range
// with no sort, staged as uint16 offsets, and each block of the range pass
// counts a slice of one range in 2^15 private counters (128 KB) and merges
// them into the range's counters. What bounds it: the indices' bytes, read
// twice, and the stage's, written and read once; a hot bucket costs shared
// atomics in one block, not serialised atomics on one L2 address.
//
// Clustered (the same binning pass, then wide::histogram_ranges_kernel),
// where the rows hold more than 4,096 ranges of 2^15 counters: ranges of
// the least of 2^16, 2^17 and 2^18 counters that makes at most 4,096 (with
// 4 rows 2^26..2^28, with one 2^28..2^30), staged as uint32 offsets, and
// each block of the range pass clusters a slice of at most 2^14 - 8 of its
// range's offsets in a hash table in shared memory, one slot and one count
// a distinct offset, then adds each count to its counter with one global
// atomic. A range's counters (256 KB to 1 MB) do not fit a block; the
// table holds only what a slice touches. At 4 x 2^28 a batch of 2^18 reads
// touches ~7M counters a row, each about 4.4 times, so the slices' merges
// send about a third of the atomics the direct route sends, each into a
// range of 1 MB that the slices in flight share, not into 4 GiB. What bounds
// it: the table's probes, claims and adds in shared memory (1.25 of the
// range pass's 2.08 ms there, by ablation), then the merge atomics (0.46),
// and the binning pass beside it (0.72: its scatter writes whole sectors,
// bin.cuh's "sectors" body, 0.99 before). Holding 16 offsets a thread and
// claiming their slots before waiting on any was slower (2.38 ms), as were
// tables of 2^14 slots (two blocks a multiprocessor) and one slice a range
// with 16-bit counts beside the keys. Counting each range in the
// distributed shared memory of a thread-block cluster (2^15 counters a
// block, 8 blocks at 2^18) was exact but slower: on one batch at 4 x 2^28
// its range pass took 7.80 ms (clusters of 8) against 2.12 ms here, since
// every update was an atomic on another SM's shared memory (3.61 and 1.48
// ms at 2^27 and 2^26, clusters of 4 and 2).
//
// Direct atomics (histogram_rows_kernel), every width up to 2^30: a
// grid-stride loop, one fire-and-forget atomic (RED) per in-range update
// into the row in device memory. For rows whose counters do not fit a
// block's shared memory and calls too small to pay for the binned passes,
// for weighted counts above 2^15, for ranges wider than 2^18 counters (4
// rows past 2^28), or for entries too few to pay for a merge. What bounds
// it: the L2's atomic unit, and badly so where the addresses are few.
// Blocks are scheduled x first, so every thread resident at one moment
// works on one row: at 2^14 on 64 KB of counters.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W as each route came in
// (CHANGES.md, readings behind the comments), per 1M reads of 150
// bp at k = 32 and 4 hashes (476M updates): at 2^14, one [4, n] launch a
// batch, private 0.7384 ms and direct 6.6382 ms against 0.5687 ms for the
// bytes at 3.35 TB/s; the 2^20 plan's sub-histograms (512 rows at 2^13)
// private 1.0495 ms, direct 4.5484 ms, bytes 0.8802 ms; at full width 2^20,
// one [4, n] launch a batch, binned 2.4685 ms (binning 2.0241, range pass
// 0.5230) against direct 4.2014 ms in turns, bytes 0.5884 ms. At 4 x 2^28, one
// [4, n] launch of 2^18 reads (124.8M updates): on reads from a random genome
// of E. coli's length (27.7M counters touched) clustered 2.8547 ms (binning
// 0.7244, range pass 2.1848) against direct 8.9155 ms in turns, bound 0.2152
// ms; on independent random reads (86.8M touched: few repeats to cluster)
// 5.1663 against 6.7830 ms. A hot bucket costs the direct route most: on one
// batch at 2^20, direct 12.1965 ms with every eighth entry one value and
// 86.7354 ms with all of them one value (atomics on one address serialise),
// binned 0.6678 and 1.0575 ms; at 4 x 2^28 with all of them one value direct
// 87.8002 ms, clustered 2.6636 ms. The sort-partitioned histogram overflows
// its windows there and falls back to the full-width launch (17.17 and 91.29
// ms when that was direct).
//
// The optional `gate` (one device int) lets a caller choose between two
// launches on the device, as the TPU path's lax.cond does: where *gate == 0
// every block returns at once and nothing is counted. The sort-partitioned
// path (part_kernel.py) gates its sub-histograms and its full-width skew
// fallback on the overflow flags that partition.cu writes, so the host never
// waits on the flag.

#include <cuda_runtime.h>

#include <cstdint>

#include "bin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;
constexpr long long kMaxBlocksY = 65535;
constexpr int kPrivateMaxThreads = 1024;
constexpr int kPrivateMaxWidthLog2 = 15;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kRangeLog2 = 15;  // counters of one range of the binned route
constexpr int kRangeThreads = 1024;
constexpr int kWideMaxRangeLog2 = 18;  // widest range of the clustered route

__global__ void __launch_bounds__(kThreads)
histogram_rows_kernel(const int* __restrict__ idx, long long R, long long N,
                      const int* __restrict__ weight, long long weight_stride,
                      unsigned width, int* __restrict__ out,
                      const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const int* row = idx + r * N;
    const int* wrow = weight ? weight + r * weight_stride : nullptr;
    int* orow = out + r * static_cast<long long>(width);
    for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         n < N; n += step) {
      const unsigned b = static_cast<unsigned>(row[n]);
      if (b < width) atomicAdd(orow + b, wrow ? wrow[n] : 1);
    }
  }
}

// Add w to bucket b of the block's private counters, if b is in range.
__device__ __forceinline__ void add_private(int* counts, int b, int w,
                                            unsigned width) {
  if (static_cast<unsigned>(b) < width) atomicAdd(counts + b, w);
}

// Block x counts entries [(x / R) * per_block, (x / R + 1) * per_block) of
// row x % R into `width` private counters, then merges them into the row.
__global__ void __launch_bounds__(kPrivateMaxThreads)
histogram_rows_private_kernel(const int* __restrict__ idx, long long R,
                              long long N, const int* __restrict__ weight,
                              long long weight_stride, unsigned width,
                              int* __restrict__ out,
                              const int* __restrict__ gate,
                              long long per_block) {
  if (gate && *gate == 0) return;
  extern __shared__ int counts[];
  const long long r = blockIdx.x % R;
  const long long lo = (blockIdx.x / R) * per_block;
  if (lo >= N) return;
  const long long len = (lo + per_block < N ? lo + per_block : N) - lo;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (unsigned b = tid; b < width; b += nt) counts[b] = 0;
  __syncthreads();
  const int* p = idx + r * N + lo;
  const int* wp = weight ? weight + r * weight_stride + lo : nullptr;
  // scalars up to the first 16-byte boundary, int4s, then the scalar tail
  long long head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
  if (head > len) head = len;
  const long long nvec = (len - head) >> 2;
  const long long tail = head + (nvec << 2);
  for (long long i = tid; i < head; i += nt) {
    add_private(counts, p[i], wp ? wp[i] : 1, width);
  }
  for (long long i = tail + tid; i < len; i += nt) {
    add_private(counts, p[i], wp ? wp[i] : 1, width);
  }
  const int4* v = reinterpret_cast<const int4*>(p + head);
  // four loads in flight per thread before their counts are added; the
  // weights need not share the indices' alignment, so they load as scalars
  for (long long i = tid; i < nvec; i += 4LL * nt) {
    int4 q[4];
    int4 wq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + static_cast<long long>(u) * nt;
      q[u] = j < nvec ? v[j] : make_int4(-1, -1, -1, -1);
      wq[u] = make_int4(1, 1, 1, 1);
      if (wp && j < nvec) {
        const int* ww = wp + head + (j << 2);
        wq[u] = make_int4(ww[0], ww[1], ww[2], ww[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      add_private(counts, q[u].x, wq[u].x, width);
      add_private(counts, q[u].y, wq[u].y, width);
      add_private(counts, q[u].z, wq[u].z, width);
      add_private(counts, q[u].w, wq[u].w, width);
    }
  }
  __syncthreads();
  // adding a zero sum is a no-op, so only non-zero counters are merged
  int* orow = out + r * static_cast<long long>(width);
  for (unsigned b = tid; b < width; b += nt) {
    const int c = counts[b];
    if (c != 0) atomicAdd(orow + b, c);
  }
}

// Binned route, range pass: block j counts `per` staged offsets of its range
// g (bin.cuh) into 2^15 private counters, then merges them into counters
// [g << 15, (g + 1) << 15) of the row-major [R, width] table.
__global__ void __launch_bounds__(kRangeThreads)
histogram_ranges_kernel(const unsigned short* __restrict__ stage,
                        const unsigned long long* __restrict__ meta,
                        int nranges, long long per, int* __restrict__ out,
                        const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ int counts[];
  const unsigned long long* starts = meta + nranges;
  const unsigned long long* blocks = starts + 2 * nranges + 1;
  const int g = nthash_bin::range_of_block(blocks, nranges);
  if (g < 0) return;
  const unsigned long long lo =
      starts[g] + (blockIdx.x - blocks[g]) * static_cast<unsigned long long>(per);
  const unsigned long long hi = min(lo + per, starts[g + 1]);
  constexpr int kWidth = 1 << kRangeLog2;
  for (int b = threadIdx.x; b < kWidth; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  nthash_bin::for_each_staged(stage, lo, hi,
                              [&](unsigned o) { atomicAdd(counts + o, 1); });
  __syncthreads();
  int* orow = out + (static_cast<long long>(g) << kRangeLog2);
  for (int b = threadIdx.x; b < kWidth; b += blockDim.x) {
    const int c = counts[b];
    if (c != 0) atomicAdd(orow + b, c);
  }
}

// Clustered route, range pass: block j counts `per` (at most
// kWideMaxEntries) staged offsets of its range g of 2^range_log2 counters
// (16..18, too many for a block's shared memory) in a hash table there: one
// 32-bit slot a distinct offset o, (o << 14) | its count, all ones where
// empty, probed linearly from a multiplicative hash of o. A slot is claimed
// by atomicCAS and counted by atomicAdd, whose result nothing waits on. The
// table has the least power of two of slots, from 2^10, that is at least
// twice the block's entries, so it is never more than half full and every
// probe ends; a count stays below 2^14 - 1, so it never reaches the key's
// bits nor makes a slot read as empty. Then one global atomicAdd a claimed
// slot into counters [g << range_log2, (g + 1) << range_log2) of the
// row-major [R, width] table. Nested only to keep the two range passes'
// kernel names apart for the compiler: both are histogram_ranges_kernel.
namespace wide {

constexpr int kLogSlots = 15;  // 128 KB of slots
constexpr int kMinLogSlots = 10;
constexpr int kCountBits = 14;
constexpr unsigned kCountMask = (1u << kCountBits) - 1;
constexpr unsigned kEmpty = 0xffffffffu;
constexpr unsigned kHash = 0x9e3779b1u;  // 2^32 / the golden ratio, odd
constexpr int kBytes = static_cast<int>(sizeof(unsigned)) << kLogSlots;

// Adds a claimed slot's count to its counter of the range at `base`.
__device__ __forceinline__ void merge_slot(int* base, unsigned v) {
  if (v != kEmpty) {
    atomicAdd(base + (v >> kCountBits), static_cast<int>(v & kCountMask));
  }
}

__global__ void __launch_bounds__(kRangeThreads)
histogram_ranges_kernel(const unsigned* __restrict__ stage,
                        const unsigned long long* __restrict__ meta,
                        int nranges, int range_log2, long long per,
                        int* __restrict__ out, const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ uint4 quads[];  // the table, four slots a quad
  unsigned* table = reinterpret_cast<unsigned*>(quads);
  const unsigned long long* starts = meta + nranges;
  const unsigned long long* blocks = starts + 2 * nranges + 1;
  const int g = nthash_bin::range_of_block_by_warp(blocks, nranges);
  if (g < 0) return;
  const unsigned long long lo =
      starts[g] + (blockIdx.x - blocks[g]) * static_cast<unsigned long long>(per);
  const unsigned long long hi = min(lo + per, starts[g + 1]);
  const int len = static_cast<int>(hi - lo);  // >= 1: a block has entries
  const int log_slots = max(kMinLogSlots, 32 - __clz(2 * len - 1));
  const unsigned mask = (1u << log_slots) - 1;
  const int nquads = 1 << (log_slots - 2);
  for (int i = threadIdx.x; i < nquads; i += blockDim.x) {
    quads[i] = make_uint4(kEmpty, kEmpty, kEmpty, kEmpty);
  }
  __syncthreads();
  nthash_bin::for_each_staged(stage, lo, hi, [&](unsigned o) {
    for (unsigned h = (o * kHash) >> (32 - log_slots);; h = (h + 1) & mask) {
      unsigned v = table[h];
      if (v == kEmpty) {
        v = atomicCAS(table + h, kEmpty, (o << kCountBits) | 1u);
        if (v == kEmpty) return;
      }
      if ((v >> kCountBits) == o) {
        atomicAdd(table + h, 1u);
        return;
      }
    }
  });
  __syncthreads();
  int* base = out + (static_cast<long long>(g) << range_log2);
  for (int i = threadIdx.x; i < nquads; i += blockDim.x) {
    const uint4 v = quads[i];
    merge_slot(base, v.x);
    merge_slot(base, v.y);
    merge_slot(base, v.z);
    merge_slot(base, v.w);
  }
}

}  // namespace wide

// Most staged entries a block of the clustered range pass takes: half the
// slots, and a count below 2^14 - 1.
constexpr long long kWideMaxEntries = (1LL << (wide::kLogSlots - 1)) - 8;

constexpr int kRangeBytes = static_cast<int>(sizeof(int)) << kRangeLog2;

}  // namespace

extern "C" {

// idx: [R, N] int32 device; weight: nullptr, [N] (weight_stride 0) or [R, N]
// (weight_stride N) int32 device; out: [R, 2^width_log2] int32 device, added
// into; gate: nullptr, or one device int that must be non-zero for anything
// to be counted. blocks_x == 0: direct atomics. blocks_x > 0: private
// counters, blocks_x blocks of `threads` threads (a multiple of 32, at most
// 1,024) per row, 2^width_log2 * 4 bytes of shared memory each (so
// width_log2 <= 15). Launches on `stream` of `device`; returns
// cudaGetLastError().
int nthash_histogram_rows(int device, const int* idx, long long R, long long N,
                          const int* weight, long long weight_stride,
                          int width_log2, int* out, const int* gate,
                          long long blocks_x, int threads,
                          cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_x == 0) {
    long long bx = (N + kThreads - 1) / kThreads;
    if (bx > kMaxBlocksX) bx = kMaxBlocksX;
    const dim3 grid(static_cast<unsigned>(bx),
                    static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY));
    histogram_rows_kernel<<<grid, kThreads, 0, stream>>>(
        idx, R, N, weight, weight_stride, 1u << width_log2, out, gate);
    return static_cast<int>(cudaGetLastError());
  }
  if (width_log2 > kPrivateMaxWidthLog2 || threads < 32 ||
      threads > kPrivateMaxThreads || threads % 32 != 0 || blocks_x < 0 ||
      R < 1 || blocks_x > 0x7fffffffLL / R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(histogram_rows_private_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // slices of whole int4s, so an aligned row keeps every slice aligned
  long long per = (N + blocks_x - 1) / blocks_x;
  per = (per + 3) & ~3LL;
  histogram_rows_private_kernel<<<static_cast<unsigned>(blocks_x * R),
                                  threads, static_cast<size_t>(4) << width_log2,
                                  stream>>>(
      idx, R, N, weight, weight_stride, 1u << width_log2, out, gate, per);
  return static_cast<int>(cudaGetLastError());
}

// The binned routes' binning pass (bin.cuh) over idx [R, N] int32 device
// into meta (6 * R * 2^(width_log2 - range_log2) + 2 unsigned 64-bit device
// words) and stage (R * N device entries: uint16 for ranges of 2^15
// counters, the binned route; uint32 for 2^16..2^18, the clustered route),
// `per` staged entries a block of the range pass; width_log2 in
// [range_log2 + 1, 31], R * 2^(width_log2 - range_log2) <= 4,096. Launches
// on `stream` of `device`; returns cudaGetLastError().
int nthash_histogram_bin(int device, const int* idx, long long R, long long N,
                         int width_log2, int range_log2, long long per,
                         unsigned long long* meta, void* stage,
                         const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (range_log2 == kRangeLog2) {
    return nthash_bin::bin_ranges(idx, R, N, nullptr, width_log2, kRangeLog2,
                                  per, meta,
                                  static_cast<unsigned short*>(stage), gate,
                                  stream);
  }
  if (range_log2 < kRangeLog2 || range_log2 > kWideMaxRangeLog2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return nthash_bin::bin_ranges(idx, R, N, nullptr, width_log2, range_log2,
                                per, meta, static_cast<unsigned*>(stage),
                                gate, stream);
}

// The range pass over the stage and meta of nthash_histogram_bin with the
// same range_log2 and `per`: `blocks` blocks (at least the binning pass's
// block total), added into out [R, width] int32 device; for ranges of 2^16
// and more (the clustered route) `per` is at most 2^14 - 8.
int nthash_histogram_ranges(int device, const void* stage,
                            const unsigned long long* meta, int nranges,
                            int range_log2, long long per, long long blocks,
                            int* out, const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nranges < 1 || nranges > nthash_bin::kMaxRanges || per < 1 ||
      blocks < 1 || blocks > 0x7fffffffLL || range_log2 < kRangeLog2 ||
      range_log2 > kWideMaxRangeLog2 ||
      (range_log2 > kRangeLog2 && per > kWideMaxEntries)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (range_log2 > kRangeLog2) {
    err = cudaFuncSetAttribute(wide::histogram_ranges_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wide::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide::histogram_ranges_kernel<<<static_cast<unsigned>(blocks),
                                    kRangeThreads, wide::kBytes, stream>>>(
        static_cast<const unsigned*>(stage), meta, nranges, range_log2, per,
        out, gate);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaFuncSetAttribute(histogram_ranges_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRangeBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  histogram_ranges_kernel<<<static_cast<unsigned>(blocks), kRangeThreads,
                            kRangeBytes, stream>>>(
      static_cast<const unsigned short*>(stage), meta, nranges, per, out,
      gate);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
