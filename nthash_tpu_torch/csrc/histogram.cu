// Exact int32 row histograms: private counters in shared memory merged once
// per block, or one global atomic add per update.
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
// Three routes, chosen by the caller from the shapes alone
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
// Direct atomics (histogram_rows_kernel), every width up to 2^30: a
// grid-stride loop, one fire-and-forget atomic (RED) per in-range update
// into the row in device memory. For rows whose counters do not fit a
// block's shared memory and calls too small to pay for the binned passes,
// for weighted counts above 2^15, or for entries too few to pay for a
// merge. What bounds it: the L2's atomic unit, and badly so where the
// addresses are few. Blocks are scheduled x first, so every thread resident
// at one moment works on one row: at 2^14 on 64 KB of counters.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, per 1M
// reads of 150 bp at k = 32 and 4 hashes (476M updates): at 2^14, one
// [4, n] launch a batch, private 0.7384 ms and direct 6.6382 ms against
// 0.5687 ms for the bytes at 3.35 TB/s; the 2^20 plan's sub-histograms (512
// rows at 2^13) private 1.0495 ms, direct 4.5484 ms, bytes 0.8802 ms; at
// full width 2^20, one [4, n] launch a batch, binned 2.4674 ms (binning
// 2.0097, range pass 0.4636) against direct 4.2063 ms in turns, bytes
// 0.5884 ms (phase 31). A hot bucket costs the direct route most: on one
// batch at 2^20, direct 12.1965 ms with every eighth entry one value and
// 86.7354 ms with all of them one value (atomics on one address
// serialise), binned 0.6678 and 1.0575 ms. The sort-partitioned histogram
// overflows its windows there and falls back to the full-width launch
// (17.17 and 91.29 ms when that was direct).
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

// The binned route's binning pass (bin.cuh) over idx [R, N] int32 device
// into meta (4 * R * 2^(width_log2 - 15) + 2 unsigned 64-bit device words)
// and stage (R * N uint16 device), `per` staged entries a block of the range
// pass; width_log2 in [16, 31], R * 2^(width_log2 - 15) <= 4,096. Launches
// on `stream` of `device`; returns cudaGetLastError().
int nthash_histogram_bin(int device, const int* idx, long long R, long long N,
                         int width_log2, long long per,
                         unsigned long long* meta, unsigned short* stage,
                         const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return nthash_bin::bin_ranges(idx, R, N, nullptr, width_log2, kRangeLog2,
                                per, meta, stage, gate, stream);
}

// The binned route's range pass: `blocks` blocks (at least the binning
// pass's block total) over the stage and meta of nthash_histogram_bin with
// the same `per`, added into out [R, width] int32 device.
int nthash_histogram_ranges(int device, const unsigned short* stage,
                            const unsigned long long* meta, int nranges,
                            long long per, long long blocks, int* out,
                            const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nranges < 1 || nranges > nthash_bin::kMaxRanges || per < 1 ||
      blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kBytes = static_cast<int>(sizeof(int)) << kRangeLog2;
  err = cudaFuncSetAttribute(histogram_ranges_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  histogram_ranges_kernel<<<static_cast<unsigned>(blocks), kRangeThreads,
                            kBytes, stream>>>(stage, meta, nranges, per, out,
                                              gate);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
