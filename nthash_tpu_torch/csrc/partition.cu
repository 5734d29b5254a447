// Sort-partitioned histogram kernels: chunk sort, partition table, windows.
//
// Replace the Pallas kernels of nthash_tpu/ops/part_pallas.py and compute
// what they return, on int32 directly:
//   sort_tiles       _sort_kernel (A3a) and _block_sort_kernel (A3b): a
//                    bitonic sort of each tile of n ints in registers,
//                    ascending, or in the direction its parity inside the
//                    chunk gives when the chunk is wider than one tile;
//   merge_phase      _merge_phase_kernel (A3c): one bitonic merge round per
//                    doubling, strides >= n through device memory (one
//                    launch each), strides < n by the tile network (one launch);
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
// What bounds them on the H100. The sort is bound by its compare-exchanges,
// not by bytes: a tile of 2^15 ints takes 120 strides of 2^14
// compare-exchanges, and integer min/max run at half the card's
// instruction rate. Over the four batches of 1M reads (3,808 tiles a batch)
// it takes 6.2199 ms, where the bytes would take 1.1469 ms and torch.sort
// takes 38.9282 ms (chip_smoke.py phase 10, NVIDIA H100 80GB HBM3, 700.00 W);
// run as one pass over shared memory per stride, each ending in a
// __syncthreads, the same network took 25.9783 ms (the same phase at the
// commit before this kernel). It keeps the tile in registers, 64 ints to
// each of 512 threads: most strides are min/max between a thread's own
// registers, a few go through __shfl_xor_sync inside a warp, and shared
// memory is only a padded (conflict-free) transpose between three register
// layouts, 19 barriers a tile. Direction is folded into the data (a
// descending run is kept complemented), so a compare-exchange is one min and
// one max. See the note above sort_span_kernel. merge_phase's global strides
// are bound by bytes (each reads and writes the whole array once); its
// strides below a tile are one launch of the same tile network.
// partition_bounds reads O(chunks * P * log(rows)) row maxima; windows is a
// coalesced copy (each window row is one 512-byte segment), bound by bytes.
// None of the TPU's scaffolding is carried over: no monotone-f32 bitcast, no
// lane/sublane rolls, no chunk grouping or VMEM blocks.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMinTile = 128;       // one row of a chunk
constexpr int kMaxTile = 1 << 15;  // ints per tile: 64 to each of 512 threads
constexpr long long kMaxChunk = 1LL << 30;  // chunk indices fit 32 bits
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

long long blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

// ---- the tile network: registers, warp shuffles, shared memory ----
//
// A block of T = 32 << WB threads holds a span of S = 64 T consecutive ints,
// 64 to a thread, and runs rounds k = k_lo .. k_hi (powers of two) of the
// bitonic network on it; stride 2^b of a round pairs elements whose span
// index differs in bit b. Three layouts put a stride's partner within reach:
//   blocked  thread t holds elements 64 t + e: strides 1..32 are
//            compare-exchanges between a thread's own registers, strides
//            64..1,024 reach a lane of the same warp (__shfl_xor_sync);
//   strided  thread t holds elements r T + t: the six top strides of the
//            span are between a thread's own registers;
//   middle   thread t holds elements (t >> 6) 4096 + 64 r + (t & 63):
//            strides 64..2,048 are between a thread's own registers. A
//            shuffled stride costs three integer instructions an element (a
//            min, a max and a select) against one in registers, and the
//            network is bound by integer instructions, so a round with three
//            or more such strides left goes through this layout instead.
// Shared memory only carries the span from one layout to the other, one word
// of padding per 64 so that neither side has a bank conflict, and the blocked
// side is where a round ends. Direction costs nothing inside a round: where
// the network sorts descending (bit k of the element's index inside its chunk
// is set) the element is kept as its complement ~x, which reverses the order
// of ints, so every compare-exchange is min to the lower index; going from
// round k to 2k complements the elements whose direction changes. A tile of
// 2^15 ints (512 threads) runs 75 of its 120 strides in blocked registers,
// 18 in strided and 24 in middle ones and 3 by shuffle, with 19 transposes
// (a barrier each), and 64 of a thread's 128 registers hold data.

constexpr int kPerThread = 64;
constexpr int kPerThreadLog2 = 6;

template <int Q>
__device__ __forceinline__ void local_stage(int (&v)[kPerThread]) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if ((e & (1 << Q)) == 0) {
      const int a = v[e];
      const int b = v[e | (1 << Q)];
      v[e] = min(a, b);
      v[e | (1 << Q)] = max(a, b);
    }
  }
}

// Register strides 2^q_hi down to 2^0 (none if q_hi < 0).
__device__ __forceinline__ void local_merge(int (&v)[kPerThread], int q_hi) {
  if (q_hi >= 5) local_stage<5>(v);
  if (q_hi >= 4) local_stage<4>(v);
  if (q_hi >= 3) local_stage<3>(v);
  if (q_hi >= 2) local_stage<2>(v);
  if (q_hi >= 1) local_stage<1>(v);
  if (q_hi >= 0) local_stage<0>(v);
}

// Rounds 2..64 on a thread's own 64 registers, ascending: inside one thread
// every direction is known when the kernel is compiled, so a descending
// compare-exchange just swaps the roles of min and max.
__device__ __forceinline__ void sort_registers(int (&v)[kPerThread]) {
#pragma unroll
  for (int k = 2; k <= kPerThread; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        if ((e & j) == 0) {
          const int a = v[e];
          const int b = v[e | j];
          const bool asc = (e & k) == 0;
          v[e] = asc ? min(a, b) : max(a, b);
          v[e | j] = asc ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// threadIdx.x and blockIdx.x, read anew: the network needs every register for
// data, so what derives from the thread's and the block's index is recomputed
// where it is used instead of being kept (and spilled) across the rounds.
__device__ __forceinline__ unsigned thread_now() {
  unsigned x;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(x));
  return x;
}

__device__ __forceinline__ unsigned block_now() {
  unsigned x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return x;
}

// One stride between lanes `mask` apart: the lane with the bit set keeps the
// larger of each pair.
__device__ __forceinline__ void shuffle_stage(int (&v)[kPerThread], int mask,
                                              bool upper) {
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int p = __shfl_xor_sync(0xffffffffu, v[e], mask);
    v[e] = upper ? max(v[e], p) : min(v[e], p);
  }
}

// One block per span of S = 2048 << WB ints of `in` (in may equal out):
// rounds k_lo..k_hi of the network restricted to strides below `tile` (a
// power of two from 128 up, tile <= S, S a multiple of tile; tile == S
// unless tile < 2048). k_lo == 2 sorts every tile (k_hi == tile); k_lo ==
// k_hi > tile finishes a merge round whose strides >= tile were done in
// device memory. cmask = chunk - 1 (below 2^30): an element's index inside
// its chunk.
template <int WB>
__global__ void __launch_bounds__(32 << WB)
sort_span_kernel(const int* in, int* out, long long total, unsigned cmask,
                 int tile, unsigned k_lo, unsigned k_hi) {
  constexpr int T = 32 << WB;
  constexpr int S = T * kPerThread;
  constexpr int TOP = 5 + WB;  // the strided layout's registers span bits TOP..TOP+5
  extern __shared__ int s[];
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * S;
  const int left = total - first < S ? static_cast<int>(total - first) : S;
  const unsigned cfirst = static_cast<unsigned>(first) & cmask;
  // element i of the span lives at s[i + (i >> 6)]
  int* blk = s + (kPerThread + 1) * t;  // element 64 t + e at blk[e]
  int* str = s + t + (t >> 6);  // element r T + t at str[r T + (r T >> 6)]
  int v[kPerThread];
  {
    const int* src = in + first + t;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      v[r] = r * T + t < left ? src[r * T] : 0x7fffffff;
    }
  }
  // Bit log2(k) of flip_mask(): complement this thread's elements after
  // round k, because their direction changes in round 2k or, after the last
  // round, because they are still complemented (cb: the thread's first
  // element's index inside its chunk; from round 64 on a thread's 64 elements
  // all go the same way).
  auto flip_mask = [&]() {
    const unsigned cb = (block_now() * S + kPerThread * thread_now()) & cmask;
    return ((cb ^ (cb >> 1)) & (k_hi - 1)) | (cb & k_hi);
  };
  bool strided = k_lo != 2;
  unsigned k = k_lo;
  if (strided) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if ((cfirst + r * T + t) & cmask & k_lo) v[r] = ~v[r];
    }
  } else {
    // A full sort of one tile per span may take its input in any order, so
    // the coalesced (strided) load is read as if it were blocked; with
    // several tiles to a span the elements go to their places first.
    if (tile != S) {
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) str[r * T + (r * T >> 6)] = v[r];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) v[e] = blk[e];
    }
    // round 64 sorts this thread descending where bit 6 of its index is set
    if ((cfirst + kPerThread * t) & cmask & kPerThread) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) v[e] = ~v[e];
    }
    sort_registers(v);
    if (flip_mask() & kPerThread) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) v[e] = ~v[e];
    }
    k = 2 * kPerThread;
  }
  for (; k <= k_hi; k <<= 1) {
    // the round's top stride is 2^tb
    int tb = 30 - __clz(static_cast<int>(min(k, static_cast<unsigned>(tile))));
    bool stored = false;  // the span is in shared memory, not in registers
    if (strided || tb >= 11) {
      if (!strided) {
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) blk[e] = v[e];
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kPerThread; ++r) v[r] = str[r * T + (r * T >> 6)];
      }
      local_merge(v, tb - TOP);  // strides 2^tb .. 2^TOP
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) str[r * T + (r * T >> 6)] = v[r];
      __syncthreads();
      strided = false;
      stored = true;
      if (tb >= TOP) tb = TOP - 1;
    }
    if (WB >= 1 && tb >= 8) {
      // three or more strides of 64 and up are left: in registers after a
      // transpose to the middle layout, instead of three shuffles' work each
      if (!stored) {
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) blk[e] = v[e];
        __syncthreads();
      }
      const int tn = static_cast<int>(thread_now());
      int* mid = s + (tn >> 6) * (65 * kPerThread) + (tn & 63);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) v[r] = mid[65 * r];
      local_merge(v, tb - kPerThreadLog2);  // strides 2^tb .. 64
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) mid[65 * r] = v[r];
      __syncthreads();
      stored = true;
      tb = kPerThreadLog2 - 1;
    }
    if (stored) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) v[e] = blk[e];
    }
    for (int b = tb < 10 ? tb : 10; b >= kPerThreadLog2; --b) {
      shuffle_stage(v, 1 << (b - kPerThreadLog2),
                    (thread_now() >> (b - kPerThreadLog2)) & 1);
    }
    local_merge(v, 5);
    if (flip_mask() & k) {
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) v[e] = ~v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) blk[e] = v[e];
  __syncthreads();
  {
    const int tn = static_cast<int>(thread_now());
    const long long start = static_cast<long long>(block_now()) * S;
    int* dst = out + start + tn;
    const long long rest = total - start;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (r * T + tn < rest) dst[r * T] = str[r * T + (r * T >> 6)];
    }
  }
}

template <int WB>
cudaError_t launch_span(const int* in, int* out, long long total,
                        long long chunk, int tile, long long k_lo,
                        long long k_hi, cudaStream_t stream) {
  constexpr int S = 2048 << WB;
  constexpr int bytes = (S + S / 64) * static_cast<int>(sizeof(int));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_span_kernel<WB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  sort_span_kernel<WB><<<static_cast<unsigned>((total + S - 1) / S), 32 << WB,
                         bytes, stream>>>(
      in, out, total, static_cast<unsigned>(chunk - 1), tile,
      static_cast<unsigned>(k_lo), static_cast<unsigned>(k_hi));
  return cudaGetLastError();
}

// The span kernel for tiles of `tile` ints: one tile per block from 2,048
// ints up, 2,048 / tile tiles per one-warp block below that.
cudaError_t launch_tiles(const int* in, int* out, long long total,
                         long long chunk, int tile, long long k_lo,
                         long long k_hi, cudaStream_t stream) {
  if (tile < kMinTile || tile > kMaxTile || (tile & (tile - 1)) ||
      chunk > kMaxChunk || k_hi > chunk) {
    return cudaErrorInvalidValue;
  }
  switch (tile >> 11) {
    case 0:
    case 1: return launch_span<0>(in, out, total, chunk, tile, k_lo, k_hi, stream);
    case 2: return launch_span<1>(in, out, total, chunk, tile, k_lo, k_hi, stream);
    case 4: return launch_span<2>(in, out, total, chunk, tile, k_lo, k_hi, stream);
    case 8: return launch_span<3>(in, out, total, chunk, tile, k_lo, k_hi, stream);
    default: return launch_span<4>(in, out, total, chunk, tile, k_lo, k_hi, stream);
  }
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
// of tile, both powers of two, 128 <= tile <= nthash_sort_max_tile(), chunk
// <= 2^30. Sorts every tile of out = in by the network's rounds 2..tile.
int nthash_sort_tiles(int device, const int* in, int* out, long long total,
                      long long chunk, int tile, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_tiles(in, out, total, chunk, tile, 2, tile, stream));
}

// x: [total] int32 device, every tile-sized run sorted in alternating
// directions up to round k / 2. Runs round k (2 * tile <= k <= chunk) in
// place: strides k/2 .. tile through device memory, then the strides below
// tile by one launch of the tile network.
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
  return static_cast<int>(
      launch_tiles(x, x, total, chunk, tile, k, k, stream));
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
