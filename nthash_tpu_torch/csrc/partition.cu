// Sort-partitioned histogram kernels: chunk sort, partition table, windows.
//
// Replace the Pallas kernels of nthash_tpu/ops/part_pallas.py and compute
// what they return, on int32 directly:
//   sort_tiles       _sort_kernel (A3a) and _block_sort_kernel (A3b): a
//                    bitonic sort of each tile of n ints in shared memory,
//                    ascending, or in the direction its parity inside the
//                    chunk gives when the chunk is wider than one tile;
//   merge_phase      _merge_phase_kernel (A3c): one bitonic merge round per
//                    doubling, strides >= n through device memory (one
//                    launch each), strides < n in shared memory (one launch);
//   partition_bounds the first-row table that _sort_kernel fuses
//                    (part_pallas.py:259-265) or XLA's searchsorted builds
//                    (:374-381), plus check_overflow (:466-495), as two flags;
//   windows          _window_kernel (A3d): each partition's cap-row window of
//                    its sorted chunk, rebased by p << sub_log2.
//
// Layout: the padded chunks are [R, G, rows, 128] int32 (chunk = rows * 128
// ints, a power of two); indices lie in [0, width], width being the pad
// sentinel, so they are non-negative and compare as plain ints.
//
// What bounds them on the H100. The sort is bound by shared-memory
// compare-exchange work, not by bytes: a tile of 2^15 ints takes 120 stages
// of 2^14 compare-exchanges, each stage ending in a __syncthreads, and a
// 2^16 chunk two merge rounds more. Its bytes (one read and one write of the
// chunks per launch) are a small part of its time. The design is the
// simplest exact one: one block of 1024 threads per tile, the tile held in
// 128 KB of dynamic shared memory (one block per SM), no register-level
// sorting networks, no warp shuffles, no radix passes. merge_phase's global
// strides are bound by bytes (each reads and writes the whole array once).
// partition_bounds reads O(chunks * P * log(rows)) row maxima; windows is a
// coalesced copy (each window row is one 512-byte segment), bound by bytes.
// None of the TPU's scaffolding is carried over: no monotone-f32 bitcast, no
// lane/sublane rolls, no chunk grouping or VMEM blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSortThreads = 1024;
constexpr int kMaxTile = 1 << 15;  // ints per tile: 128 KB of shared memory
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

long long blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// The bitonic network's rounds k = k_lo .. k_hi (powers of two) on one tile
// of n ints in shared memory; base is the tile's first index inside its
// chunk. Round k, stride j compares i and i + j (bit j of i clear) and puts
// the smaller first where bit k of the chunk index is clear: the global
// network's direction, so alternating tiles come out in alternating
// directions and the last round (k = chunk) is ascending everywhere.
__device__ void tile_network(int* s, int n, long long base, long long k_lo,
                             long long k_hi) {
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = static_cast<int>((k < n ? k : n) >> 1); j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int a = s[i];
        const int b = s[i + j];
        const bool asc = ((base + i) & k) == 0;
        if ((a > b) == asc) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One block per tile: load, run rounds k_lo..k_hi, store (in may equal out).
__global__ void __launch_bounds__(kSortThreads)
bitonic_tiles_kernel(const int* in, int* out, int n, long long chunk,
                     long long k_lo, long long k_hi) {
  extern __shared__ int s[];
  const long long first = static_cast<long long>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = in[first + i];
  __syncthreads();
  tile_network(s, n, first & (chunk - 1), k_lo, k_hi);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[first + i] = s[i];
}

// One compare-exchange stride j >= tile of round k, in device memory.
__global__ void __launch_bounds__(kThreads)
merge_stride_kernel(int* x, long long pairs, long long chunk, long long k,
                    long long j) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < pairs; t += step) {
    const long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    const int a = x[i];
    const int b = x[i + j];
    const bool asc = ((i & (chunk - 1)) & k) == 0;
    if ((a > b) == asc) {
      x[i] = b;
      x[i + j] = a;
    }
  }
}

// Number of rows of a sorted chunk whose last (largest) entry, shifted right
// by sub_log2, is below q. The row maxima ascend, so a binary search.
__device__ int rows_below(const int* last, int rows, int sub_log2, int q) {
  int lo = 0, hi = rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((last[static_cast<long long>(mid) * kLanes] >> sub_log2) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One thread per (chunk, partition): fb = rows wholly below partition p, and
// the window check: p's entries end on row end = rows_below(p + 1) (for the
// last partition that counts rows below P, so trailing pad sentinels never
// trip it), and a cap-row window misses some iff end - fb + 1 > cap. Any
// miss sets flags = {1, 0}; the caller zeroes flags[0] and sets flags[1] = 1.
__global__ void __launch_bounds__(kThreads)
partition_bounds_kernel(const int* __restrict__ srt, long long chunks,
                        int rows, int sub_log2, int parts, int cap,
                        int* __restrict__ fb, int* __restrict__ flags) {
  const long long total = chunks * parts;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < total; q += step) {
    const long long c = q / parts;
    const int p = static_cast<int>(q - c * parts);
    const int* last = srt + c * rows * kLanes + (kLanes - 1);
    const int start = rows_below(last, rows, sub_log2, p);
    const int end = rows_below(last, rows, sub_log2, p + 1);
    fb[q] = start;
    if (end - start + 1 > cap) {
      flags[0] = 1;
      flags[1] = 0;
    }
  }
}

// One block of 128 threads per window (r, p, g), in the output's order:
// out[r, p, g, c, l] = srt[r, g, min(fb[r, g, p], rows - cap) + c, l]
//                      - (p << sub_log2).
__global__ void __launch_bounds__(kLanes)
windows_kernel(const int* __restrict__ srt, const int* __restrict__ fb,
               long long R, int G, int P, int rows, int cap, int sub_log2,
               int* __restrict__ out) {
  const long long total = R * P * G;
  for (long long w = blockIdx.x; w < total; w += gridDim.x) {
    const int g = static_cast<int>(w % G);
    const long long rp = w / G;
    const int p = static_cast<int>(rp % P);
    const long long r = rp / P;
    const long long chunk = r * G + g;
    int start = fb[chunk * P + p];
    if (start > rows - cap) start = rows - cap;
    const int* src = srt + (chunk * rows + start) * kLanes;
    int* dst = out + w * cap * kLanes;
    const int off = p << sub_log2;
    for (int e = threadIdx.x; e < cap * kLanes; e += blockDim.x) {
      dst[e] = src[e] - off;
    }
  }
}

}  // namespace

extern "C" {

// Largest tile sort_tiles takes, in ints.
int nthash_sort_max_tile() { return kMaxTile; }

// in, out: [total] int32 device, total a multiple of chunk, chunk a multiple
// of tile, both powers of two, tile <= nthash_sort_max_tile(). Sorts every
// tile of out = in by the network's rounds 2..tile.
int nthash_sort_tiles(int device, const int* in, int* out, long long total,
                      long long chunk, int tile, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = tile * static_cast<int>(sizeof(int));
  err = cudaFuncSetAttribute(bitonic_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxTile * static_cast<int>(sizeof(int)));
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_tiles_kernel<<<static_cast<unsigned>(total / tile), kSortThreads,
                         bytes, stream>>>(in, out, tile, chunk, 2, tile);
  return static_cast<int>(cudaGetLastError());
}

// x: [total] int32 device, every tile-sized run sorted in alternating
// directions up to round k / 2. Runs round k (2 * tile <= k <= chunk) in
// place: strides k/2 .. tile through device memory, then the strides below
// tile in shared memory.
int nthash_merge_phase(int device, int* x, long long total, long long chunk,
                       int tile, long long k, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = total / 2;
  for (long long j = k / 2; j >= tile; j /= 2) {
    merge_stride_kernel<<<static_cast<unsigned>(blocks_for(pairs, kThreads)),
                          kThreads, 0, stream>>>(x, pairs, chunk, k, j);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(bitonic_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxTile * static_cast<int>(sizeof(int)));
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_tiles_kernel<<<static_cast<unsigned>(total / tile), kSortThreads,
                         tile * static_cast<int>(sizeof(int)), stream>>>(
      x, x, tile, chunk, k, k);
  return static_cast<int>(cudaGetLastError());
}

// srt: [chunks, rows, 128] sorted int32 device; fb: [chunks, parts] int32
// out; flags: int32[2] device, {0, 1} on entry, {1, 0} after any window of
// cap rows misses part of its partition.
int nthash_partition_bounds(int device, const int* srt, long long chunks,
                            int rows, int sub_log2, int parts, int cap,
                            int* fb, int* flags, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_bounds_kernel<<<static_cast<unsigned>(
                                blocks_for(chunks * parts, kThreads)),
                            kThreads, 0, stream>>>(
      srt, chunks, rows, sub_log2, parts, cap, fb, flags);
  return static_cast<int>(cudaGetLastError());
}

// srt: [R, G, rows, 128], fb: [R, G, P] int32 device; out: [R, P, G, cap,
// 128] int32 device.
int nthash_windows(int device, const int* srt, const int* fb, long long R,
                   int G, int P, int rows, int cap, int sub_log2, int* out,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = R * P * G;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  windows_kernel<<<static_cast<unsigned>(blocks), kLanes, 0, stream>>>(
      srt, fb, R, G, P, rows, cap, sub_log2, out);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
