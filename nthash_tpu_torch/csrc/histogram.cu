// Exact int32 row histograms: private counters in shared memory merged once
// per block, the updates grouped by range and each range (or each slice of
// it) counted in shared memory, or one global atomic add per update.
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
// twice, or once where bin.cuh's "sectors" body pages the stage (512 ranges
// a row), and the stage's, written and read once; a hot bucket costs shared
// atomics in one block, not serialised atomics on one L2 address.
//
// Clustered (the same binning pass, then wide::histogram_ranges_kernel),
// where the rows hold more than 4,096 ranges of 2^15 counters: ranges of
// the least of 2^16, 2^17 and 2^18 counters that makes at most 4,096 (with
// 4 rows 2^26..2^28, with one 2^28..2^30), staged as uint32 offsets. A
// range's counters (256 KB to 1 MB) do not fit a block, so the range pass
// cuts a range's offsets into chunks of at most 2^16 - 8 and gives each
// chunk one owner block a 2^15-counter slice of the range (2, 4 or 8), which
// reads the whole chunk, counts its own offsets densely in 16-bit halves of
// shared words and adds each non-zero count to its counter with one global
// atomic. At 4 x 2^28 a batch of 2^18 genome reads stages ~30,460 offsets a
// range, so a range is one chunk and each of the ~27.7M counters it touches
// is merged once (~44M merges when a block took at most 2^14 - 8 offsets).
// What bounds it, by ablation of the same pass with 4 owners of 2^16
// counters in persistent blocks (1.72 ms on one genomic batch at 4 x 2^28):
// the merge's global atomics 0.76 ms (each touched counter its own 32-byte
// sector of the table), the owners' reads of the stage and their owner
// test 0.33, the shared atomics 0.29, the fixed steps of each (chunk,
// owner) (finding its range, barriers, scanning the words) 0.34; then the
// binning pass beside it (0.72). The range pass alone, in turns on that
// batch: 2.10-2.13 ms for the hash table it replaced (a block a slice of
// 2^14 - 8 offsets, one slot and one count a distinct offset, claimed by
// atomicCAS), 1.70-1.71 here; 4 owners of 2^16 counters in 128 KB (one
// block an SM) 1.76-1.77; 8 owners of 2^15 int32 counters in 128 KB
// 2.23-2.24; persistent blocks looping over the (chunk, owner) pairs 1.71
// with 4 owners (2.95 -> 3.13-3.17 ms on uniform random buckets) and 1.71
// here; each pair's non-zero counters listed and merged by one warp while
// the others counted the next pair 2.30, or by every warp, 32 to an atomic
// instruction, 2.81; an L2 prefetch of each owned counter while counting
// 2.01-2.02. Counting each range in the distributed shared memory of a
// thread-block cluster (2^15 counters a block, 8 blocks at 2^18) was exact
// but slower still: 7.80 ms (clusters of 8), every update an atomic on
// another SM's shared memory.
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
// of E. coli's length (27.7M counters touched) clustered 2.4210-2.4242 ms
// (binning 0.7202, range pass 1.7080-1.7116) against direct 8.9185 ms in
// turns (2.8490-2.8532 with the hash table), bound 0.2152 ms; on uniform
// random buckets (117.8M touched) 3.6234-3.6237 against 9.2933 ms direct
// (5.7594-5.8735 with the hash table); on independent random reads (86.8M
// touched) the hash table took 5.1663 against 6.7830 ms. A hot bucket costs
// the direct route most: on one
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
// g (bin.cuh's chunk_span) into 2^15 private counters, then merges them
// into counters [g << 15, (g + 1) << 15) of the row-major [R, width] table.
__global__ void __launch_bounds__(kRangeThreads)
histogram_ranges_kernel(const unsigned short* __restrict__ stage,
                        const unsigned long long* __restrict__ meta,
                        int nranges, long long per, int* __restrict__ out,
                        const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ int counts[];
  const unsigned long long* blocks = meta + 3 * nranges + 1;
  const int g = nthash_bin::range_of_block(blocks, nranges);
  if (g < 0) return;
  unsigned long long lo, hi;
  nthash_bin::chunk_span(meta, nranges, g, blockIdx.x - blocks[g], per, lo,
                         hi);
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

// Clustered route, range pass: the blocks of range g (2^range_log2
// counters, 16..18, more than a block's shared memory holds) come in chunks
// of `per` (at most kMaxEntries) of its staged offsets, and each chunk in
// 2^(range_log2 - 15) owner blocks with adjacent indices, so that the
// chunk's stage is read from device memory once and then from the L2. Owner
// j keeps the range's counters [j << 15, (j + 1) << 15) in shared memory as
// 2^14 words of two uint16 halves (counter c in word c & 0x3fff, its half
// c >> 14; 64 KB, so two blocks share a multiprocessor and one's merge
// overlaps the other's count). It reads every offset of its chunk, skips
// those of the other owners, and adds 1 or 1 << 16 to the word of each of
// its own by one shared atomicAdd whose result nothing waits on. A chunk
// has at most 2^16 - 1 entries, so no half wraps into the other. Then one
// global atomicAdd a non-zero half into counters [g << range_log2, (g + 1)
// << range_log2) of the row-major [R, width] table. Nested only to keep the
// two range passes' kernel names apart for the compiler: both are
// histogram_ranges_kernel.
namespace wide {

constexpr int kSliceLog2 = 15;  // counters an owner keeps
constexpr int kWords = 1 << (kSliceLog2 - 1);  // two counters a word
constexpr int kBytes = static_cast<int>(sizeof(unsigned)) * kWords;  // 64 KB
// Most staged entries a chunk holds: a half counts at most 2^16 - 1; whole
// 16-byte loads of the stage from each chunk's start on.
constexpr long long kMaxEntries = (1LL << 16) - 8;

// Adds a word's two halves, where non-zero, to counters w and w + kWords.
__device__ __forceinline__ void merge_word(int* base, int w, unsigned v) {
  if (v & 0xffffu) atomicAdd(base + w, static_cast<int>(v & 0xffffu));
  if (v >> 16) atomicAdd(base + w + kWords, static_cast<int>(v >> 16));
}

__global__ void __launch_bounds__(kRangeThreads, 2)
histogram_ranges_kernel(const unsigned* __restrict__ stage,
                        const unsigned long long* __restrict__ meta,
                        int nranges, int range_log2, long long per,
                        int* __restrict__ out, const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ uint4 quads[];  // the slice's words, four a quad
  unsigned* words = reinterpret_cast<unsigned*>(quads);
  const unsigned long long* blocks = meta + 3 * nranges + 1;
  const int g = nthash_bin::range_of_block_by_warp(blocks, nranges);
  if (g < 0) return;
  const int owner_bits = range_log2 - kSliceLog2;
  const unsigned long long j = blockIdx.x - blocks[g];
  const unsigned owner = static_cast<unsigned>(j) & ((1u << owner_bits) - 1);
  unsigned long long lo, hi;
  nthash_bin::chunk_span(meta, nranges, g, j >> owner_bits, per, lo, hi);
  for (int i = threadIdx.x; i < kWords / 4; i += blockDim.x) {
    quads[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  nthash_bin::for_each_staged(stage, lo, hi, [&](unsigned o) {
    if ((o >> kSliceLog2) == owner) {
      atomicAdd(words + (o & (kWords - 1)),
                1u << ((o >> (kSliceLog2 - 5)) & 16));
    }
  });
  __syncthreads();
  int* base = out + (static_cast<long long>(g) << range_log2) +
              (static_cast<long long>(owner) << kSliceLog2);
  for (int w = threadIdx.x; w < kWords; w += blockDim.x) {
    merge_word(base, w, words[w]);
  }
}

}  // namespace wide

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
// into meta (`meta_words` unsigned 64-bit device words) and stage
// (`stage_entries` device entries: uint16 for ranges of 2^15 counters, the
// binned route; uint32 for 2^16..2^18, the clustered route), at least what
// bin.cuh's scratch() names for nranges = R * 2^(width_log2 - range_log2),
// `per` staged entries a chunk of the range pass (a block, or on the
// clustered route 2^(range_log2 - 15) owner blocks); width_log2 in
// [range_log2 + 1, 31], nranges <= 4,096. Launches on `stream` of
// `device`; returns cudaGetLastError().
int nthash_histogram_bin(int device, const int* idx, long long R, long long N,
                         int width_log2, int range_log2, long long per,
                         unsigned long long* meta, long long meta_words,
                         void* stage, long long stage_entries,
                         const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (range_log2 == kRangeLog2) {
    return nthash_bin::bin_ranges(idx, R, N, nullptr, width_log2, kRangeLog2,
                                  per, 1, meta, meta_words,
                                  static_cast<unsigned short*>(stage),
                                  stage_entries, gate, stream);
  }
  if (range_log2 < kRangeLog2 || range_log2 > kWideMaxRangeLog2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return nthash_bin::bin_ranges(idx, R, N, nullptr, width_log2, range_log2,
                                per, 1 << (range_log2 - wide::kSliceLog2),
                                meta, meta_words,
                                static_cast<unsigned*>(stage), stage_entries,
                                gate, stream);
}

// The range pass over the stage and meta of nthash_histogram_bin with the
// same range_log2 and `per`: `blocks` blocks (at least the binning pass's
// block total), added into out [R, width] int32 device; for ranges of 2^16
// and more (the clustered route) `per` is at most 2^16 - 8.
int nthash_histogram_ranges(int device, const void* stage,
                            const unsigned long long* meta, int nranges,
                            int range_log2, long long per, long long blocks,
                            int* out, const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nranges < 1 || nranges > nthash_bin::kMaxRanges || per < 1 ||
      blocks < 1 || blocks > 0x7fffffffLL || range_log2 < kRangeLog2 ||
      range_log2 > kWideMaxRangeLog2 ||
      (range_log2 > kRangeLog2 && per > wide::kMaxEntries)) {
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
