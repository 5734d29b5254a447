// Sort-partitioned histogram kernels: chunk sort, partition table, windows.
//
// Replace the Pallas kernels of nthash_tpu/ops/part_pallas.py and compute
// what they return, on int32 directly:
//   sort_tiles       _sort_kernel (A3a) and _block_sort_kernel (A3b): a
//                    bitonic sort of each tile of n ints in registers,
//                    ascending, or in the direction its parity inside the
//                    chunk gives when the chunk is wider than one tile;
//   merge_phase      _merge_phase_kernel (A3c): one bitonic merge round per
//                    doubling, in 1 + ceil(s / 6) passes over the array for
//                    a round with s strides of a tile and more;
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
// compare-exchanges, and integer min/max run at half the card's instruction
// rate. Over the four batches of 1M reads (3,808 tiles a batch) it takes
// 6.2199 ms, where the bytes would take 1.1469 ms and torch.sort takes
// 38.9282 ms (NVIDIA H100 80GB HBM3, 700.00 W; CHANGES.md, readings behind the
// comments); run as one pass over shared memory per stride, each ending in a
// __syncthreads, the same network took 25.9783 ms (the same run of the commit
// before this kernel). It keeps the tile in registers, 64 ints to each of 512
// threads: most strides are min/max between a thread's own registers, a few go
// through __shfl_xor_sync inside a warp, and shared memory is only a padded
// (conflict-free) transpose between three register layouts, 19 barriers a
// tile. Direction is folded into the data (a descending run is kept
// complemented), so a compare-exchange is one min and one max. See the note
// above sort_span_kernel.
//
// A merge round is bound by bytes: each pass reads and writes the whole array
// once, so the design counts passes. The strides of a tile and more go through
// device memory in grouped passes of up to six strides, each thread holding
// the 2^g elements that g strides link (merge_strides_kernel; one pass of 1 to
// 5 strides costs about as much as one of 1, 88% of the byte rate), and the
// strides below a tile run in one pass of the tile network. Where the strides
// of a tile and more number one more than a multiple of six, the last of them
// runs in the tile network's pass instead, between the two blocks of a
// thread-block cluster through each other's shared memory (cluster_strides),
// which saves a pass: a round of the 2^20 plan (two tiles a chunk) is one
// pass, where one launch a stride made it two. The cluster stops there because
// a stride exchanged between two SMs costs 0.86 ms per 1M reads at the 2^30
// plan against 1.44 ms for a whole grouped pass, and clusters of 4 and 8 tiles
// add that for every further stride (NVIDIA H100 80GB HBM3, 700.00 W;
// CHANGES.md, readings behind the comments). The six rounds of the 2^30 plan
// (64 tiles a chunk) take 11 passes where they took 27. merge_plan
// (ops/part_kernel.py) picks the launches.
//
// partition_bounds reads each row maximum once and writes each table entry
// once: the maxima of a sorted chunk ascend, so row r owns the entries
// (max[r - 1], max[r]] >> sub_log2, found by a search in shared memory, and
// a window misses part of its partition iff some run of cap equal maxima
// lies in [0, P). The maxima lie 512 bytes apart, a 32-byte sector each
// from device memory, and that gather bounds it: PyTorch's own strided copy
// of the same maxima takes as long. windows is a coalesced copy (each
// window row is one 512-byte segment), bound by bytes. None of the TPU's
// scaffolding is carried over: no monotone-f32 bitcast, no lane/sublane
// rolls, no chunk grouping or VMEM blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kMinTile = 128;       // one row of a chunk
constexpr int kMaxTile = 1 << 15;  // ints per tile: 64 to each of 512 threads
constexpr long long kMaxChunk = 1LL << 30;  // chunk indices fit 32 bits
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

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

// Strides S C/2 .. S of a merge round across the C blocks of a cluster,
// each holding one span of S = 64 T ints, v[r] = element r T + t. For the
// exchange the span sits in shared memory as quads, v[4 q .. 4 q + 3] of
// thread t at x[q T + t] (16-byte words, so that every access across the
// cluster moves 512 bytes a warp), with S / 2 ints after it to receive. The
// partner of an element across stride S m is the same element of block
// rank ^ m; direction is folded into the data, so the block whose rank has
// bit m clear keeps the smaller of each pair. Of the pairs between two
// blocks, the lower block does those of quads q < 8 and the upper block
// the rest. No block waits on a remote load: each pushes the quads its
// partner needs into the partner's `recv`, and after a cluster barrier
// compares them with its own, keeps its result and pushes the partner's
// into the partner's span; a cluster barrier before the first stride and
// after each half. v is dead meanwhile (reloaded after), so the exchange
// takes no register from the network. (Kept in registers, with the
// exchange areas alone in shared memory, it spilled and was no faster; as
// 4-byte words, or waiting on remote loads, it was slower.)
template <int T>
__device__ __forceinline__ void cluster_strides(int (&v)[kPerThread],
                                                int* s) {
  constexpr int kQuads = kPerThread / 4;
  constexpr int kHalf = kQuads / 2;
  int4* x = reinterpret_cast<int4*>(s) + threadIdx.x;
  int4* recv = reinterpret_cast<int4*>(s) + kQuads * T + threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    x[q * T] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  cluster.sync();
  for (unsigned m = cluster.num_blocks() >> 1; m > 0; m >>= 1) {
    const bool upper = (rank & m) != 0;
    const int4* send = x + (upper ? 0 : kHalf * T);
    int4* into = cluster.map_shared_rank(recv, rank ^ m);
#pragma unroll
    for (int h = 0; h < kHalf; ++h) into[h * T] = send[h * T];
    cluster.sync();
    int4* mine = x + (upper ? kHalf * T : 0);
    int4* theirs = cluster.map_shared_rank(mine, rank ^ m);
#pragma unroll
    for (int h = 0; h < kHalf; ++h) {
      const int4 a = mine[h * T];
      const int4 b = recv[h * T];
      const int4 lo = make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                                min(a.w, b.w));
      const int4 hi = make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                                max(a.w, b.w));
      mine[h * T] = upper ? hi : lo;
      theirs[h * T] = upper ? lo : hi;
    }
    cluster.sync();
  }
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int4 w = x[q * T];
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
  __syncthreads();  // before the network's transposes reuse the memory
}

// One block per span of S = 2048 << WB ints of `in` (in may equal out):
// rounds k_lo..k_hi of the network restricted to strides below `tile` (a
// power of two from 128 up, tile <= S, S a multiple of tile; tile == S
// unless tile < 2048). k_lo == 2 sorts every tile (k_hi == tile); k_lo ==
// k_hi finishes merge round k_lo from stride min(k_lo, tile) / 2 down, its
// higher strides done before: in device memory or, with kCluster, by the
// cluster's blocks in this launch (strides S C/2 .. S, tile == S). cmask =
// chunk - 1 (below 2^30): an element's index inside its chunk.
template <int WB, bool kCluster>
__global__ void __launch_bounds__(32 << WB)
sort_span_kernel(const int* in, int* out, long long total, unsigned cmask,
                 int tile, unsigned k_lo, unsigned k_hi) {
  constexpr int T = 32 << WB;
  constexpr int S = T * kPerThread;
  constexpr int TOP = 5 + WB;  // the strided layout's registers span bits TOP..TOP+5
  extern __shared__ __align__(16) int s[];
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
    if constexpr (kCluster) cluster_strides<T>(v, s);
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
        sort_span_kernel<WB, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  sort_span_kernel<WB, false><<<static_cast<unsigned>((total + S - 1) / S),
                                32 << WB, bytes, stream>>>(
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

// The cluster instance: tiles of kMaxTile ints, `cluster` blocks a cluster;
// its shared memory holds the tile (padded for the transposes, or as quads
// for the exchange) and the half tile it receives.
constexpr int kClusterWB = 4;
constexpr int kClusterBytes =
    (kMaxTile + kMaxTile / 2) * static_cast<int>(sizeof(int));

cudaLaunchConfig_t cluster_config(long long total, int cluster,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(total / kMaxTile));
  cfg.blockDim = dim3(32 << kClusterWB);
  cfg.dynamicSmemBytes = kClusterBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch_cluster(int* x, long long total, long long chunk,
                           long long k, int cluster, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sort_span_kernel<kClusterWB, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(total, cluster, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, sort_span_kernel<kClusterWB, true>,
                           static_cast<const int*>(x), x, total,
                           static_cast<unsigned>(chunk - 1), kMaxTile,
                           static_cast<unsigned>(k), static_cast<unsigned>(k));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- the merge's strides through device memory ----
//
// Strides j 2^(G-1), ..., j of round k in one pass: a thread takes the 2^G
// elements a hypercube of those strides links, W adjacent ints each (one
// 4W-byte load; neighbouring threads on neighbouring addresses), runs the G
// strides in registers, and writes them back: 16-byte loads up to G = 4,
// 8-byte at 5, 4-byte at 6 (64 ints a thread). Every pair lies inside one
// k-block, so one direction serves the thread.

template <int W>
struct Words;
template <>
struct Words<1> {
  using T = int;
};
template <>
struct Words<2> {
  using T = int2;
};
template <>
struct Words<4> {
  using T = int4;
};

__device__ __forceinline__ void exchange(int& a, int& b, bool asc) {
  const int lo = min(a, b);
  const int hi = max(a, b);
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

__device__ __forceinline__ void exchange(int2& a, int2& b, bool asc) {
  exchange(a.x, b.x, asc);
  exchange(a.y, b.y, asc);
}

__device__ __forceinline__ void exchange(int4& a, int4& b, bool asc) {
  exchange(a.x, b.x, asc);
  exchange(a.y, b.y, asc);
  exchange(a.z, b.z, asc);
  exchange(a.w, b.w, asc);
}

template <int G, int W>
__global__ void __launch_bounds__(kThreads)
merge_strides_kernel(int* __restrict__ x, long long items, long long chunk,
                     long long k, int lj) {
  using V = typename Words<W>::T;
  constexpr int N = 1 << G;
  const long long j = 1LL << lj;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < items; t += step) {
    // the first element: W t with G zero bits put in at bit lj
    const long long q = t * W;
    const long long base = ((q >> lj) << (lj + G)) | (q & (j - 1));
    const bool asc = (base & (chunk - 1) & k) == 0;
    V v[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      v[e] = *reinterpret_cast<const V*>(x + base + e * j);
    }
#pragma unroll
    for (int b = G - 1; b >= 0; --b) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if ((e & (1 << b)) == 0) exchange(v[e], v[e | (1 << b)], asc);
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      *reinterpret_cast<V*>(x + base + e * j) = v[e];
    }
  }
}

// Ints a thread takes at each point of a pass of g strides.
constexpr int words_for(int g) { return g <= 4 ? 4 : g == 5 ? 2 : 1; }

constexpr int kMaxGroup = 6;

// ---- the partition table and the window check ----

constexpr int kBoundsThreads = 256;
constexpr int kBoundsPerThread = 1;
constexpr int kBoundsRows = kBoundsThreads * kBoundsPerThread;
constexpr int kBoundsHalo = kBoundsThreads / 8;  // rows past a block staged

__global__ void flags_init_kernel(int* flags) {
  flags[0] = 0;
  flags[1] = 1;
}

// Rows g0 .. g0 + 255 of the sorted chunks (global row g = c rows + r) a
// block, one a thread; their maxima q[g] = srt[g, 127] >> sub_log2, with
// the row before the block and up to 32 rows after it, are staged in
// shared memory by one round of loads (more rows a block measured slower:
// the loads, a 32-byte sector each, bound the kernel). The maxima of a chunk ascend, so
// fb[c, p] (the rows whose maximum is below p) is the first row r with
// q[r] >= p: row r owns the entries p in (q[r - 1], q[r]] of [0, P), and
// the chunk's last row's successor (rows) the entries above its maximum.
// The block writes the entries its rows own, each found by a search over
// its maxima, neighbouring threads on neighbouring entries. Partition p < P
// spans rows fb[p] .. fb[p] + n_p (n_p rows have maximum p; the last
// partition ends where the maxima reach P, so trailing pad sentinels never
// count), and a cap-row window misses some iff n_p >= cap: iff some row r
// of a chunk has q[r] == q[r + cap - 1] in [0, P). Any miss sets flags =
// {1, 0}, one write a block; flags_init_kernel set {0, 1} before.
__global__ void __launch_bounds__(kBoundsThreads)
partition_bounds_kernel(const int* __restrict__ srt, long long total_rows,
                        int rows_log2, int sub_log2, int parts, int cap,
                        int* __restrict__ fb, int* __restrict__ flags) {
  constexpr int kLoads =
      (kBoundsRows + kBoundsHalo + kBoundsThreads - 1) / kBoundsThreads;
  __shared__ int staged[1 + kBoundsRows + kBoundsHalo];
  int* q = staged + 1;  // q[-1]: the row before the block
  const int t = threadIdx.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * kBoundsRows;
  const int n = static_cast<int>(
      min(static_cast<long long>(kBoundsRows), total_rows - g0));
  const int reach = n + static_cast<int>(min(
      static_cast<long long>(kBoundsHalo), total_rows - g0 - n));
  const long long rmask = (1LL << rows_log2) - 1;
  const auto maximum = [&](long long row) {
    return __ldg(srt + row * kLanes + (kLanes - 1)) >> sub_log2;
  };
  {
    int v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = t + i * kBoundsThreads;
      v[i] = row < reach ? maximum(g0 + row) : 0;
    }
    const int before = t == 0 && g0 > 0 ? maximum(g0 - 1) : 0;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = t + i * kBoundsThreads;
      if (row < reach) q[row] = v[i];
    }
    if (t == 0) q[-1] = before;
  }
  __syncthreads();
  bool over = false;
#pragma unroll
  for (int i = 0; i < kBoundsPerThread; ++i) {
    const int row = t + i * kBoundsThreads;
    if (row >= n) break;
    const long long r = (g0 + row) & rmask;
    const int v = q[row];
    if (cap < 1) {
      over = true;
    } else if (v >= 0 && v < parts && r + cap - 1 <= rmask) {
      const long long h = row + static_cast<long long>(cap) - 1;
      over |= v == (h < reach ? q[h] : maximum(g0 + h));
    }
  }
  if (__syncthreads_or(over) && t == 0) {
    flags[0] = 1;
    flags[1] = 0;
  }
  const long long c_last = (g0 + n - 1) >> rows_log2;
  for (long long c = g0 >> rows_log2; c <= c_last; ++c) {
    const long long c0 = c << rows_log2;  // the chunk's first global row
    const long long c1 = c0 + rmask + 1;
    const int a = static_cast<int>(max(c0, g0) - g0);  // its rows in q: [a, b)
    const int b = static_cast<int>(min(c1, g0 + n) - g0);
    // the entries this block owns of the chunk: [lo, hi)
    int lo = 0;
    if (c0 < g0) {
      const int prev = q[-1];
      lo = prev < 0 ? 0 : prev >= parts ? parts : prev + 1;
    }
    int hi = parts;
    if (c1 > g0 + n) {
      const int last = q[b - 1];
      hi = last < 0 ? 0 : last >= parts ? parts : last + 1;
    }
    int* row = fb + c * parts;
    for (int p = lo + t; p < hi; p += kBoundsThreads) {
      int l = a, h = b;
      while (l < h) {
        const int m = (l + h) >> 1;
        if (q[m] < p) {
          l = m + 1;
        } else {
          h = m;
        }
      }
      row[p] = static_cast<int>(g0 + l - c0);
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

// x: [total] int32 device, 16-byte aligned, total a multiple of chunk, every
// run of 2 j 2^(g-1) ints a bitonic sequence. Runs strides j 2^(g-1), ...,
// j of round k in place, in one pass: 1 <= g <= 6, j >= 4, j 2^g <= k <=
// chunk <= 2^30, all powers of two.
int nthash_merge_strides(int device, int* x, long long total, long long chunk,
                         long long k, long long j, int g,
                         cudaStream_t stream) {
  if (g < 1 || g > kMaxGroup || j < 4 || !pow2(j) || !pow2(k) ||
      !pow2(chunk) || (j << g) > k || k > chunk || chunk > kMaxChunk ||
      total % chunk || reinterpret_cast<unsigned long long>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total == 0) return 0;
  const long long items = (total >> g) / words_for(g);
  const unsigned blocks = static_cast<unsigned>(blocks_for(items, kThreads));
  const int lj = 63 - __builtin_clzll(static_cast<unsigned long long>(j));
  switch (g) {
    case 1: merge_strides_kernel<1, words_for(1)><<<blocks, kThreads, 0, stream>>>(x, items, chunk, k, lj); break;
    case 2: merge_strides_kernel<2, words_for(2)><<<blocks, kThreads, 0, stream>>>(x, items, chunk, k, lj); break;
    case 3: merge_strides_kernel<3, words_for(3)><<<blocks, kThreads, 0, stream>>>(x, items, chunk, k, lj); break;
    case 4: merge_strides_kernel<4, words_for(4)><<<blocks, kThreads, 0, stream>>>(x, items, chunk, k, lj); break;
    case 5: merge_strides_kernel<5, words_for(5)><<<blocks, kThreads, 0, stream>>>(x, items, chunk, k, lj); break;
    default: merge_strides_kernel<6, words_for(6)><<<blocks, kThreads, 0, stream>>>(x, items, chunk, k, lj); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [total] int32 device, total a multiple of chunk, every run of k ints a
// bitonic sequence after round k's strides above span * cluster. Runs the
// rest of round k (2 <= k <= chunk <= 2^30) in place, in one pass of the
// tile network over spans of `span` ints (2,048 <= span <= 2^15): with
// cluster == 1 the strides below min(k, span); with cluster in {2, 4, 8}
// (span == 2^15, span * cluster <= k) first the strides span * cluster / 2
// .. span across each cluster's blocks.
int nthash_merge_span(int device, int* x, long long total, long long chunk,
                      long long k, int span, int cluster,
                      cudaStream_t stream) {
  if (span < 2048 || span > kMaxTile || !pow2(span) || k < 2 || !pow2(k) ||
      !pow2(chunk) || k > chunk || total % chunk ||
      (cluster != 1 && (cluster != 2 && cluster != 4 && cluster != 8)) ||
      (cluster > 1 && (span != kMaxTile || span * cluster > k))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total == 0) return 0;
  if (cluster > 1) {
    return static_cast<int>(launch_cluster(x, total, chunk, k, cluster, stream));
  }
  return static_cast<int>(launch_tiles(x, x, total, chunk, span, k, k, stream));
}

// srt: [chunks, rows, 128] sorted int32 device (rows a power of two); fb:
// [chunks, parts] int32 out; flags: int32[2] device out, {1, 0} if any
// window of cap rows misses part of its partition, else {0, 1}.
int nthash_partition_bounds(int device, const int* srt, long long chunks,
                            int rows, int sub_log2, int parts, int cap,
                            int* fb, int* flags, cudaStream_t stream) {
  if (rows < 1 || !pow2(rows) || parts < 1 || sub_log2 < 0 || sub_log2 > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  flags_init_kernel<<<1, 1, 0, stream>>>(flags);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 0) return static_cast<int>(err);
  const long long total_rows = chunks * rows;
  partition_bounds_kernel<<<static_cast<unsigned>(
                                (total_rows + kBoundsRows - 1) / kBoundsRows),
                            kBoundsThreads, 0, stream>>>(
      srt, total_rows, 31 - __builtin_clz(static_cast<unsigned>(rows)),
      sub_log2, parts, cap, fb, flags);
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
