// Bit-packed presence (Bloom filter words): private words in shared memory
// merged once per block, or one global atomic OR per update.
//
// Replaces nthash_tpu/ops/hist_pallas.py::_bloom_kernel (mxu_bloom_words)
// and ::_bloom_rows_kernel (mxu_bloom_words_rows) and computes what they
// return: for indices idx [R, N] int32 and, for one row, an optional int32
// weight [N] (non-zero = present),
//   words[r, word_index(b)] |= 1 << bit_index(b)   for every b = idx[r, n]
//                                                  with 0 <= b < width,
// into words [R, width / 32] (uint32 bit patterns in the caller's int32
// tensor), which the caller zeroes or accumulates in (the filter itself).
// The layout is the JAX package's: bucket b = q * 4096 + s * 128 + j lives
// in word q * 128 + j at bit s,
//   word_index(b) = ((b >> 12) << 7) | (b & 127),  bit_index(b) = (b >> 7) & 31,
// which the TPU chose so that it packs 32 sublanes of a count tile into one
// word; here it is only an address computation. Indices outside [0, width)
// are dropped by one unsigned compare, so -1, the sentinel `width` and
// anything above it never set a bit; width reaches 2^31 (a full 2^31-bit
// filter, 256 MB of words), where the sentinel no longer fits an int32 and
// callers fold invalid updates to -1.
//
// Three routes for int32 indices, chosen by the caller from the shapes alone
// (ops/hist_kernel.py::private_words_grid, binned_words_grid):
//
// Private words (bloom_rows_private_kernel). A block owns one row and one
// long contiguous slice of its entries; it zeroes width / 32 words of dynamic
// shared memory, reads its slice with 16-byte loads where the slice is
// aligned, sets bits in shared memory (testing the bit first: a filter that
// fills up stops issuing atomics at all), and then merges: one global atomic
// OR per non-zero private word, skipped where a read of the global word
// (from L2, past the L1) already shows all of its bits. The skip is exact:
// bits are only ever set during a launch, so a read that shows them is
// final, and a stale read costs one atomic. The merge costs up to width / 32
// atomics a block, so the caller gives every block several times more
// entries than the row has words (few, fat blocks). What bounds it: the
// bytes of its indices, each read once.
//
// Binned (bin.cuh's binning pass, then bloom_ranges_kernel), filters of
// 2^21 bits and more where the rows hold at most 4,096 ranges of 2^20 bits
// and a call brings at least 2^25 updates: the valid updates (zero weights
// dropped) are grouped by range with no sort, staged as uint32 offsets, and
// each block of the range pass sets a slice of one range's bits in 2^15
// private words (128 KB), as the private kernel does, and merges them into
// the range's words, which word_index keeps contiguous. What bounds it: the
// indices' bytes, read once where bin.cuh's "sectors" body pages the stage
// (512 or 1,024 ranges a row: rows of 2^29 or 2^30 bits), else twice, and
// the stage's, written and read once, in place of one read-modify-write of
// a random DRAM sector per update. At
// 2^30, per 1M reads (476M updates, one call a batch, into zeroed words):
// binned 4.3431 ms (binning 2.5918, range pass 1.4525) against direct
// 20.8668 ms in turns, bytes 0.7286 ms (CHANGES.md, readings behind
// the comments); the binning's scatter writes whole 32-byte sectors there
// (bin.cuh's "sectors" body: 1,024 ranges of an int32 stage).
//
// Filters past 2^31 bits (to 2^38) take int64 indices through the wide
// route, bloom_wide_kernel: direct atomics with 64-bit word offsets. (The
// binned route would need 2^17 ranges of 2^20 bits at 2^37, past its 4,096.)
//
// Direct atomics (bloom_rows_kernel): a grid-stride loop, one global atomic OR
// (a fire-and-forget RED) per valid update. For rows whose words do not fit a
// block's shared memory and calls too small to pay for the binned passes, or
// whose entries are too few to pay for a merge. What bounds it: the L2's
// atomic unit, and badly so where the addresses are few. Blocks are scheduled
// x first, so all threads resident at one moment work on one row; with 128
// rows of 256 words (the 2^20 plan's windows, 187M entries a batch) they hit
// 1 KB of words. Measured with the private route on an NVIDIA H100 80GB HBM3
// at 700.00 W (CHANGES.md, readings behind the comments), one batch: direct
// 15.7602 ms as the windows are, 25.0571 ms with each row's entries shuffled
// (no two neighbours of a warp stay neighbours, the row is as hot), 0.9217 ms
// with the rows interleaved in runs of 256 entries (the same neighbours, all
// 128 rows in flight at once); private words 0.2542 ms, against 0.2235 ms for
// its bytes at 3.35 TB/s. So it is the few hot addresses, not collisions
// inside a warp, that the private words remove.
//
// OR is idempotent and commutative, so every route is exact whatever order
// the atomics land in. The optional `gate` (one device int) works as in
// histogram.cu: where *gate == 0 every block returns at once. The
// partitioned path gates its per-partition launch and its full-width skew
// fallback on the overflow flags from partition.cu, so the host never waits
// on them.

#include <cuda_runtime.h>

#include <cstdint>

#include "bin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;
constexpr long long kMaxBlocksY = 65535;
constexpr int kPrivateMaxThreads = 1024;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kRangeLog2 = 20;  // buckets of one range of the binned route
constexpr int kRangeWords = 1 << (kRangeLog2 - 5);
constexpr int kRangeThreads = 1024;

// The body of the direct route's instances: indices of type B read as U.
template <typename B, typename U>
__device__ __forceinline__ void
direct_or(const B* __restrict__ idx, long long R, long long N,
          const int* __restrict__ weight, U width,
          unsigned* __restrict__ words, const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // 64-bit row offset: at 2^30 with 8,192 partitions the rows hold 2^25 words
  const long long row_words = static_cast<long long>(width >> 5);
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const B* row = idx + r * N;
    unsigned* wrow = words + r * row_words;
    for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         n < N; n += step) {
      const U b = static_cast<U>(row[n]);
      if (b < width && (!weight || weight[n] != 0)) {
        atomicOr(wrow + (((b >> 12) << 7) | (b & 127u)),
                 1u << static_cast<unsigned>((b >> 7) & 31u));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bloom_rows_kernel(const int* __restrict__ idx, long long R, long long N,
                  const int* __restrict__ weight, unsigned width,
                  unsigned* __restrict__ words, const int* __restrict__ gate) {
  direct_or<int, unsigned>(idx, R, N, weight, width, words, gate);
}

// Set bucket b's bit in the block's private words, unless it shows already.
__device__ __forceinline__ void set_private(unsigned* sw, unsigned b,
                                            unsigned width) {
  if (b < width) {
    const unsigned w = ((b >> 12) << 7) | (b & 127u);
    const unsigned bit = 1u << ((b >> 7) & 31u);
    if (!(reinterpret_cast<volatile unsigned*>(sw)[w] & bit)) atomicOr(sw + w, bit);
  }
}

// Block (x, y) packs entries [x * per_block, (x + 1) * per_block) of row y
// (and of rows y + gridDim.y, ...) into width / 32 private words, then merges
// them into the row's global words.
__global__ void __launch_bounds__(kPrivateMaxThreads)
bloom_rows_private_kernel(const int* __restrict__ idx, long long R,
                          long long N, const int* __restrict__ weight,
                          unsigned width, unsigned* __restrict__ words,
                          const int* __restrict__ gate, long long per_block) {
  if (gate && *gate == 0) return;
  extern __shared__ unsigned sw[];
  const int nwords = static_cast<int>(width >> 5);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long lo = static_cast<long long>(blockIdx.x) * per_block;
  if (lo >= N) return;
  const long long len = (lo + per_block < N ? lo + per_block : N) - lo;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    for (int w = tid; w < nwords; w += nt) sw[w] = 0;
    __syncthreads();
    const int* p = idx + r * N + lo;
    const int* wp = weight ? weight + lo : nullptr;
    // scalars up to the first 16-byte boundary, int4s, then the scalar tail
    long long head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
    if (head > len) head = len;
    const long long nvec = (len - head) >> 2;
    const long long tail = head + (nvec << 2);
    for (long long i = tid; i < head; i += nt) {
      if (!wp || wp[i] != 0) set_private(sw, static_cast<unsigned>(p[i]), width);
    }
    for (long long i = tail + tid; i < len; i += nt) {
      if (!wp || wp[i] != 0) set_private(sw, static_cast<unsigned>(p[i]), width);
    }
    const int4* v = reinterpret_cast<const int4*>(p + head);
    // four loads in flight per thread before their bits are set
    for (long long i = tid; i < nvec; i += 4LL * nt) {
      int4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long j = i + static_cast<long long>(u) * nt;
        q[u] = j < nvec ? v[j] : make_int4(-1, -1, -1, -1);
      }
      if (wp) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long j = i + static_cast<long long>(u) * nt;
          if (j < nvec) {
            const int* ww = wp + head + (j << 2);
            if (ww[0] == 0) q[u].x = -1;
            if (ww[1] == 0) q[u].y = -1;
            if (ww[2] == 0) q[u].z = -1;
            if (ww[3] == 0) q[u].w = -1;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        set_private(sw, static_cast<unsigned>(q[u].x), width);
        set_private(sw, static_cast<unsigned>(q[u].y), width);
        set_private(sw, static_cast<unsigned>(q[u].z), width);
        set_private(sw, static_cast<unsigned>(q[u].w), width);
      }
    }
    __syncthreads();
    unsigned* wrow = words + r * static_cast<long long>(nwords);
    for (int w = tid; w < nwords; w += nt) {
      const unsigned m = sw[w];
      if (m != 0 && (__ldcg(wrow + w) & m) != m) atomicOr(wrow + w, m);
    }
    __syncthreads();
  }
}

// Binned route, range pass: block j sets the bits of `per` staged offsets of
// its range g (bin.cuh's chunk_span) in 2^15 private words, then merges
// them into words [g << 15, (g + 1) << 15) of the row-major [R, width / 32]
// words, as the private kernel merges.
__global__ void __launch_bounds__(kRangeThreads)
bloom_ranges_kernel(const unsigned* __restrict__ stage,
                    const unsigned long long* __restrict__ meta, int nranges,
                    long long per, unsigned* __restrict__ words,
                    const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ unsigned sw[];
  const unsigned long long* blocks = meta + 3 * nranges + 1;
  const int g = nthash_bin::range_of_block(blocks, nranges);
  if (g < 0) return;
  unsigned long long lo, hi;
  nthash_bin::chunk_span(meta, nranges, g, blockIdx.x - blocks[g], per, lo,
                         hi);
  for (int w = threadIdx.x; w < kRangeWords; w += blockDim.x) sw[w] = 0;
  __syncthreads();
  nthash_bin::for_each_staged(stage, lo, hi, [&](unsigned o) {
    set_private(sw, o, 1u << kRangeLog2);
  });
  __syncthreads();
  unsigned* wrow = words + (static_cast<long long>(g) << (kRangeLog2 - 5));
  for (int w = threadIdx.x; w < kRangeWords; w += blockDim.x) {
    const unsigned m = sw[w];
    if (m != 0 && (__ldcg(wrow + w) & m) != m) atomicOr(wrow + w, m);
  }
}

// The wide route: int64 indices into a filter of up to 2^38 bits (32 GiB of
// words, offsets past 32 bits), the direct route's body on 64-bit indices.
// Where the filter is far larger than the L2, every update is a
// read-modify-write of a random sector of device memory.
__global__ void __launch_bounds__(kThreads)
bloom_wide_kernel(const long long* __restrict__ idx, long long R, long long N,
                  const int* __restrict__ weight, unsigned long long width,
                  unsigned* __restrict__ words, const int* __restrict__ gate) {
  direct_or<long long, unsigned long long>(idx, R, N, weight, width, words,
                                           gate);
}

}  // namespace

extern "C" {

// idx: [R, N] int32 device; weight: nullptr or [N] int32 device (R must be 1);
// words: [R, 2^width_log2 / 32] 32-bit device words, OR-ed into; width_log2
// in [12, 31]; gate: nullptr, or one device int that must be non-zero for
// anything to be set. blocks_x == 0: direct atomics. blocks_x > 0: private
// words, blocks_x blocks of `threads` threads (a multiple of 32, at most
// 1,024) per row, 2^width_log2 / 8 bytes of shared memory each (at most 227
// KB, so width_log2 <= 20). Launches on `stream` of `device`; returns
// cudaGetLastError().
int nthash_bloom_words_rows(int device, const int* idx, long long R, long long N,
                            const int* weight, int width_log2, unsigned* words,
                            const int* gate, long long blocks_x, int threads,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned by = static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY);
  if (blocks_x == 0) {
    long long bx = (N + kThreads - 1) / kThreads;
    if (bx > kMaxBlocksX) bx = kMaxBlocksX;
    bloom_rows_kernel<<<dim3(static_cast<unsigned>(bx), by), kThreads, 0,
                        stream>>>(idx, R, N, weight, 1u << width_log2, words,
                                  gate);
    return static_cast<int>(cudaGetLastError());
  }
  const long long bytes = (1LL << width_log2) >> 3;
  if (bytes > kMaxSharedBytes || threads < 32 || threads > kPrivateMaxThreads ||
      threads % 32 != 0 || blocks_x > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(bloom_rows_private_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // slices of whole int4s, so an aligned row keeps every slice aligned
  long long per = (N + blocks_x - 1) / blocks_x;
  per = (per + 3) & ~3LL;
  bloom_rows_private_kernel<<<dim3(static_cast<unsigned>(blocks_x), by),
                              threads, static_cast<size_t>(bytes), stream>>>(
      idx, R, N, weight, 1u << width_log2, words, gate, per);
  return static_cast<int>(cudaGetLastError());
}

// The wide route: idx [R, N] int64 device, words [R, 2^width_log2 / 32],
// width_log2 in [12, 38]; weight and gate as above. Direct atomics, at most
// 4,096 blocks a row. Launches on `stream` of `device`; returns
// cudaGetLastError().
int nthash_bloom_words_wide(int device, const long long* idx, long long R,
                            long long N, const int* weight, int width_log2,
                            unsigned* words, const int* gate,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (width_log2 < 12 || width_log2 > 38 || R < 0 || N < 0 ||
      (weight && R != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const unsigned by = static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY);
  long long bx = (N + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  bloom_wide_kernel<<<dim3(static_cast<unsigned>(bx), by), kThreads, 0,
                      stream>>>(idx, R, N, weight, 1ULL << width_log2, words,
                                gate);
  return static_cast<int>(cudaGetLastError());
}

// The binned route's binning pass (bin.cuh) over idx [R, N] int32 device
// (weight: nullptr or [N] int32 device, R == 1; zero weights dropped) into
// meta (`meta_words` unsigned 64-bit device words) and stage
// (`stage_entries` uint32 device entries), at least what bin.cuh's
// scratch() names for nranges = R * 2^(width_log2 - 20), `per` staged
// entries a block of the range pass; width_log2 in [21, 31], nranges <=
// 4,096. Launches on `stream` of `device`; returns cudaGetLastError().
int nthash_bloom_bin(int device, const int* idx, long long R, long long N,
                     const int* weight, int width_log2, long long per,
                     unsigned long long* meta, long long meta_words,
                     unsigned* stage, long long stage_entries,
                     const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return nthash_bin::bin_ranges(idx, R, N, weight, width_log2, kRangeLog2,
                                per, 1, meta, meta_words, stage,
                                stage_entries, gate, stream);
}

// The binned route's range pass: `blocks` blocks (at least the binning
// pass's block total) over the stage and meta of nthash_bloom_bin with the
// same `per`, OR-ed into words [R, width / 32] device.
int nthash_bloom_ranges(int device, const unsigned* stage,
                        const unsigned long long* meta, int nranges,
                        long long per, long long blocks, unsigned* words,
                        const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nranges < 1 || nranges > nthash_bin::kMaxRanges || per < 1 ||
      blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kBytes = static_cast<int>(sizeof(unsigned)) * kRangeWords;
  err = cudaFuncSetAttribute(bloom_ranges_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bloom_ranges_kernel<<<static_cast<unsigned>(blocks), kRangeThreads, kBytes,
                        stream>>>(stage, meta, nranges, per, words, gate);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
