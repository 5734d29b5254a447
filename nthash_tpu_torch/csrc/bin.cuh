// What histogram.cu and bloom.cu share: one pass that groups a scatter's
// updates by address range, with no sort, so that each range can be counted
// or set in one block's shared memory (the binned routes of both kernels and
// the histogram's clustered route). Part of the ports of
// nthash_tpu/ops/hist_pallas.py's _hist_kernel (A2) and _bloom_kernel (C1)
// at the widths the JAX package serves by sorting and partitioning
// (ops/part_pallas.py): neither a sum mod 2^32 nor an OR needs an order, so
// grouping is enough, and it needs no cap on a partition.
//
// An update b of row r (0 <= b < width = 2^width_log2) belongs to range
//   g = (r << (width_log2 - shift)) | (b >> shift)
// and is staged as its offset b & (2^shift - 1). Ranges are numbered row by
// row, so range g covers entries [g << shift, (g + 1) << shift) of the
// row-major table [R, width]. The three range passes that follow: the
// histogram's 2^15 counters (shift 15, 128 KB of int32, a uint16 stage);
// its clustered route's ranges of 2^16..2^18 counters (shift 16..18, a
// uint32 stage), too wide for a block, whose range pass counts a slice of a
// range in a hash table of the offsets it touches; the presence words' 2^15
// words (shift 20, uint32: word_index keeps b >> 20 in its top bits, so a
// range's words are contiguous). Out of range indices (-1, the sentinel,
// anything past the width) and, with a weight, entries whose weight is 0
// are dropped here.
//
// Three kernels, all on the device, no host sync between them:
//   1. bin_count_kernel: a block counts its slice of one row by range in a
//      shared-memory histogram (one a warp where the ranges are few, so the
//      warps' atomics on one range do not serialise) and adds each non-zero
//      count to the range's global count (one atomic a range a block);
//   2. bin_scan_kernel (one block): the exclusive scan of the range counts
//      (each range's first stage position, and its cursor), and of the
//      range pass's blocks per range, ceil(count / per);
//   3. bin_scatter_kernel: a block holds its slice in registers, ranks each
//      entry within its range by a shared atomicAdd, sorts the slice by
//      range in shared memory, reserves one run per non-empty range with
//      one atomicAdd on the range's cursor, and writes each run out by
//      consecutive threads. Its blocks are of 1,024 threads where the
//      ranges are many (C1 at 2^30: 1,024; A2's clustered route at 4 x
//      2^28: 1,024 a row), 512 where they are few (A2 at 2^20: 32 a row):
//      the longer a block's runs, the fewer sectors of the stage are
//      written in part.
// Entries of one range may land in any order: an int32 add mod 2^32 is
// commutative, and an OR is commutative and idempotent, so the range pass
// that follows is exact whatever the order.
//
// The range pass (histogram.cu, bloom.cu) runs a grid of (range, chunk)
// blocks sized on the host from n and the number of ranges: block j finds
// its range g by a search of the blocks' prefix (range g owns blocks
// [blocks[g], blocks[g + 1]); one thread's binary search, or a warp's 32
// probes a step for the clustered route), takes `per` staged entries of it,
// and counts or sets them in shared memory (every bucket of the range, or a
// hash table of those the slice touches) before one merge into the range's
// slice of the table. Blocks past the last range's return at once.
//
// What bounds the pass: the bytes of the indices, read twice (count,
// scatter), and of the stage, written once and read once by the range pass
// (2 bytes an entry for the histogram's binned route, 4 for its clustered
// route and the words). A hot range or a hot bucket costs shared atomics
// inside one block, not serialised atomics on one address of the L2.
//
// Scratch (meta, stage) comes from the caller; the kernels allocate
// nothing. meta holds 4 * nranges + 2 unsigned 64-bit words: counts
// [nranges], starts [nranges + 1], cursors [nranges], blocks [nranges + 1].
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace nthash_bin {

using u64 = unsigned long long;

constexpr int kThreads = 512;       // threads of a count block, and of a
                                    // scatter block with few bins
constexpr int kWideThreads = 1024;  // of a scatter block with many bins
constexpr int kPerThread = 16;      // entries a thread holds in registers
constexpr long long kChunk = static_cast<long long>(kThreads) * kPerThread;
constexpr int kCountChunks = 4;     // chunks a count block covers
constexpr int kMaxRanges = 4096;    // ranges one pass takes, all rows
constexpr int kGroupedMaxBins = 256;  // most bins with one histogram a warp
constexpr int kScanThreads = 1024;
constexpr long long kMaxBlocksY = 65535;

// Entries [lo, lo + kT * kPerThread) of a row of n, this thread's
// kPerThread of them (16-byte loads where the row is aligned and the chunk
// whole), -1 past n and where the weight is 0.
template <int kT>
__device__ __forceinline__ void load_chunk(const int* __restrict__ row,
                                           const int* __restrict__ wrow,
                                           long long n, long long lo,
                                           int (&v)[kPerThread]) {
  const int t = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 &&
      lo + static_cast<long long>(kT) * kPerThread <= n) {
    const int4* p = reinterpret_cast<const int4*>(row + lo);
#pragma unroll
    for (int u = 0; u < kPerThread / 4; ++u) {
      const int4 q = p[u * kT + t];
      v[4 * u] = q.x;
      v[4 * u + 1] = q.y;
      v[4 * u + 2] = q.z;
      v[4 * u + 3] = q.w;
    }
    if (wrow) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const long long i = lo + 4LL * ((j >> 2) * kT + t) + (j & 3);
        if (wrow[i] == 0) v[j] = -1;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = lo + static_cast<long long>(j) * kT + t;
    v[j] = (i < n && (!wrow || wrow[i] != 0)) ? row[i] : -1;
  }
}

// The sub-histograms a block of kT threads keeps: one a warp where the bins
// are few (so the warps' shared atomics on one bin do not serialise), else
// one.
template <int kT>
__host__ __device__ __forceinline__ int hist_groups(int nbins) {
  return nbins <= kGroupedMaxBins ? kT / 32 : 1;
}

__global__ void __launch_bounds__(kThreads)
bin_count_kernel(const int* __restrict__ idx, long long R, long long N,
                 const int* __restrict__ weight, unsigned width, int shift,
                 int nbins, u64* __restrict__ counts,
                 const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ int hist[];  // [groups][nbins]
  const long long lo0 = static_cast<long long>(blockIdx.x) * kCountChunks * kChunk;
  if (lo0 >= N) return;
  const int groups = hist_groups<kThreads>(nbins);
  int* mine = hist + ((threadIdx.x >> 5) % groups) * nbins;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    for (int i = threadIdx.x; i < groups * nbins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const int* row = idx + r * N;
    for (int c = 0; c < kCountChunks; ++c) {
      const long long lo = lo0 + c * kChunk;
      if (lo >= N) break;
      int v[kPerThread];
      load_chunk<kThreads>(row, weight, N, lo, v);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const unsigned b = static_cast<unsigned>(v[j]);
        if (b < width) atomicAdd(mine + (b >> shift), 1);
      }
    }
    __syncthreads();
    u64* crow = counts + r * nbins;
    for (int i = threadIdx.x; i < nbins; i += kThreads) {
      int c = 0;
      for (int g = 0; g < groups; ++g) c += hist[g * nbins + i];
      if (c) atomicAdd(crow + i, static_cast<u64>(c));
    }
    __syncthreads();
  }
}

// One block: starts and cursors = exclusive scan of counts; blocks =
// exclusive scan of ceil(counts / per); starts[n] and blocks[n] the totals.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(u64* __restrict__ meta, int nranges, long long per,
                const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  __shared__ u64 sa[kScanThreads];
  __shared__ u64 sb[kScanThreads];
  const u64* counts = meta;
  u64* starts = meta + nranges;
  u64* cursors = starts + nranges + 1;
  u64* blocks = cursors + nranges;
  const int t = threadIdx.x;
  const int each = (nranges + kScanThreads - 1) / kScanThreads;
  const int lo = t * each;
  const int hi = min(lo + each, nranges);
  const u64 p = static_cast<u64>(per);
  u64 a = 0, b = 0;
  for (int i = lo; i < hi; ++i) {
    a += counts[i];
    b += (counts[i] + p - 1) / p;
  }
  sa[t] = a;
  sb[t] = b;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan
    const u64 xa = t >= off ? sa[t - off] : 0;
    const u64 xb = t >= off ? sb[t - off] : 0;
    __syncthreads();
    sa[t] += xa;
    sb[t] += xb;
    __syncthreads();
  }
  u64 ea = sa[t] - a, eb = sb[t] - b;
  for (int i = lo; i < hi; ++i) {
    starts[i] = ea;
    cursors[i] = ea;
    blocks[i] = eb;
    ea += counts[i];
    eb += (counts[i] + p - 1) / p;
  }
  if (t == kScanThreads - 1) {
    starts[nranges] = sa[t];
    blocks[nranges] = sb[t];
  }
}

// Exclusive scan of x[0, n) in place by a block of kT threads; returns the
// total. Each thread sums a run of ceil(n / kT), the warps scan the runs'
// sums by shuffles, the warps' totals are scanned in `tmp` (kT / 32 + 1
// ints).
template <int kT>
__device__ __forceinline__ int block_exclusive_scan(int* x, int n, int* tmp) {
  constexpr int kWarps = kT / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int each = (n + kT - 1) / kT;
  const int lo = min(t * each, n), hi = min(lo + each, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += x[i];
  int inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? tmp[lane] : 0;
    int winc = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, off);
      if (lane >= off) winc += y;
    }
    if (lane < kWarps) tmp[lane] = winc - w;
    if (lane == kWarps - 1) tmp[kWarps] = winc;
  }
  __syncthreads();
  int run = tmp[warp] + inc - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = x[i];
    x[i] = run;
    run += c;
  }
  const int total = tmp[kWarps];
  __syncthreads();
  return total;
}

// Shared memory of bin_scatter_kernel<T, kT> for `nbins` bins, in bytes.
template <int kT>
__host__ __device__ __forceinline__ size_t scatter_shared_bytes(int nbins) {
  return sizeof(u64) * nbins +
         sizeof(int) * (nbins + 1 + hist_groups<kT>(nbins) * nbins + kT / 32 +
                        1 + static_cast<long long>(kT) * kPerThread);
}

// A block ranks its chunk of one row by range (a shared atomicAdd on its
// warp's sub-histogram), sorts it by range in shared memory (each range's
// entries one run), reserves each non-empty range's run in the stage with
// one atomicAdd on the range's cursor, and writes the runs out by
// consecutive threads, so stores to one range are contiguous. The longer a
// block's runs, the fewer partly written sectors: blocks of kWideThreads
// where the bins are many.
template <typename T, int kT>
__global__ void __launch_bounds__(kT, 1024 / kT)
bin_scatter_kernel(const int* __restrict__ idx, long long R, long long N,
                   const int* __restrict__ weight, unsigned width, int shift,
                   int nbins, u64* __restrict__ cursors, T* __restrict__ stage,
                   const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  extern __shared__ u64 base[];  // see scatter_shared_bytes
  const int groups = hist_groups<kT>(nbins);
  int* start = reinterpret_cast<int*>(base + nbins);  // [nbins + 1]
  int* hist = start + nbins + 1;                      // [groups][nbins]
  int* tmp = hist + groups * nbins;                   // [kT / 32 + 1]
  int* sorted = tmp + kT / 32 + 1;                    // [kT * kPerThread]
  const long long lo = static_cast<long long>(blockIdx.x) * kT * kPerThread;
  if (lo >= N) return;
  const unsigned mask = (1u << shift) - 1;
  const int t = threadIdx.x;
  int* mine = hist + ((t >> 5) % groups) * nbins;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    for (int i = t; i < groups * nbins; i += kT) hist[i] = 0;
    __syncthreads();
    int v[kPerThread];
    int rank[kPerThread];
    load_chunk<kT>(idx + r * N, weight, N, lo, v);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned b = static_cast<unsigned>(v[j]);
      if (b < width) rank[j] = atomicAdd(mine + (b >> shift), 1);
    }
    __syncthreads();
    // each group's offset within its bin's run, and the runs' lengths
    for (int i = t; i < nbins; i += kT) {
      int run = 0;
      for (int g = 0; g < groups; ++g) {
        const int c = hist[g * nbins + i];
        hist[g * nbins + i] = run;
        run += c;
      }
      start[i] = run;
    }
    __syncthreads();
    u64* crow = cursors + r * nbins;
    for (int i = t; i < nbins; i += kT) {
      const int c = start[i];
      if (c) base[i] = atomicAdd(crow + i, static_cast<u64>(c));
    }
    const int nvalid = block_exclusive_scan<kT>(start, nbins, tmp);
    if (t == 0) start[nbins] = nvalid;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned b = static_cast<unsigned>(v[j]);
      if (b < width) {
        const unsigned bin = b >> shift;
        sorted[start[bin] + mine[bin] + rank[j]] = static_cast<int>(b);
      }
    }
    __syncthreads();
    for (int k = t; k < nvalid; k += kT) {
      const unsigned b = static_cast<unsigned>(sorted[k]);
      const unsigned bin = b >> shift;
      stage[base[bin] + static_cast<unsigned>(k - start[bin])] =
          static_cast<T>(b & mask);
    }
    __syncthreads();  // before the next row reuses the shared memory
  }
}

// Range pass: the range of block j (largest g with blocks[g] <= j), or -1
// past the last block; found by one thread, shared with the block.
__device__ __forceinline__ int range_of_block(const u64* __restrict__ blocks,
                                              int nranges) {
  __shared__ int s_g;
  if (threadIdx.x == 0) {
    const u64 j = blockIdx.x;
    int g = -1;
    if (j < blocks[nranges]) {
      int lo = 0, hi = nranges - 1;  // blocks[0] = 0 <= j
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (blocks[mid] <= j) lo = mid; else hi = mid - 1;
      }
      g = lo;
    }
    s_g = g;
  }
  __syncthreads();
  return s_g;
}

// The same, found by the block's first warp: 32 probes a step, each step
// narrowing the candidates 32-fold (three steps for 4,096 ranges, where one
// thread takes twelve dependent loads). For the clustered route's range
// pass, a block to each of ~11,700 slices: 2.07 ms against 2.21 with one
// thread's search, on one genomic batch at 4 x 2^28.
__device__ __forceinline__ int range_of_block_by_warp(
    const u64* __restrict__ blocks, int nranges) {
  __shared__ int s_g;
  if (threadIdx.x < 32) {
    const u64 j = blockIdx.x;
    int g = -1;
    if (j < blocks[nranges]) {
      int lo = 0, hi = nranges - 1;  // blocks[lo] <= j; the range in [lo, hi]
      while (lo < hi) {
        const int step = (hi - lo + 31) / 32;
        const int probe = lo + (static_cast<int>(threadIdx.x) + 1) * step;
        const unsigned le =
            __ballot_sync(0xffffffffu, probe <= hi && blocks[probe] <= j);
        if (le) lo += (32 - __clz(le)) * step;  // the last probe <= j
        hi = min(hi, lo + step - 1);
      }
      g = lo;
    }
    if (threadIdx.x == 0) s_g = g;
  }
  __syncthreads();
  return s_g;
}

// Calls f(offset) for each staged entry [lo, hi) of T, by this block's
// threads: 16-byte loads after a scalar head up to the first boundary,
// four in flight a thread, then a scalar tail.
template <typename T, typename F>
__device__ __forceinline__ void for_each_staged(const T* __restrict__ stage,
                                                u64 lo, u64 hi, F f) {
  constexpr int kVec = 16 / sizeof(T);
  const T* p = stage + lo;
  const long long len = static_cast<long long>(hi - lo);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  long long head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  if (head > len) head = len;
  const long long nvec = (len - head) / kVec;
  const long long tail = head + nvec * kVec;
  for (long long i = tid; i < head; i += nt) f(static_cast<unsigned>(p[i]));
  for (long long i = tail + tid; i < len; i += nt) f(static_cast<unsigned>(p[i]));
  const int4* v = reinterpret_cast<const int4*>(p + head);
  for (long long i = tid; i < nvec; i += 4LL * nt) {
    int4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + static_cast<long long>(u) * nt;
      q[u] = j < nvec ? v[j] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + static_cast<long long>(u) * nt >= nvec) break;
      const unsigned w[4] = {static_cast<unsigned>(q[u].x),
                             static_cast<unsigned>(q[u].y),
                             static_cast<unsigned>(q[u].z),
                             static_cast<unsigned>(q[u].w)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(T) == 2) {
          f(w[e] & 0xffffu);
          f(w[e] >> 16);
        } else {
          f(w[e]);
        }
      }
    }
  }
}

// Launches bin_scatter_kernel<T, kT> over idx [R, N].
template <typename T, int kT>
int scatter(const int* idx, long long R, long long N, const int* weight,
            unsigned width, int shift, int nbins, unsigned by, u64* cursors,
            T* stage, const int* gate, cudaStream_t stream) {
  const size_t bytes = scatter_shared_bytes<kT>(nbins);
  cudaError_t err = cudaFuncSetAttribute(
      bin_scatter_kernel<T, kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = static_cast<long long>(kT) * kPerThread;
  bin_scatter_kernel<T, kT><<<dim3(static_cast<unsigned>((N + per - 1) / per),
                                   by),
                              kT, bytes, stream>>>(idx, R, N, weight, width,
                                                   shift, nbins, cursors,
                                                   stage, gate);
  return static_cast<int>(cudaGetLastError());
}

// The binning pass over idx [R, N] (weight: nullptr or [N], only with
// R == 1) into meta and stage (at least R * N entries of T), ranges of
// 2^shift buckets, `per` staged entries a block of the range pass.
template <typename T>
int bin_ranges(const int* idx, long long R, long long N, const int* weight,
               int width_log2, int shift, long long per, u64* meta, T* stage,
               const int* gate, cudaStream_t stream) {
  if (width_log2 <= shift || width_log2 > 31 || R < 1 || N < 1 || per < 1 ||
      (weight && R != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nbins = 1LL << (width_log2 - shift);
  if (R * nbins > kMaxRanges) return static_cast<int>(cudaErrorInvalidValue);
  const int nranges = static_cast<int>(R * nbins);
  cudaError_t err = cudaMemsetAsync(meta, 0, sizeof(u64) * nranges, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned width = static_cast<unsigned>(1ULL << width_log2);
  const unsigned by = static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY);
  const long long count_blocks =
      (N + kCountChunks * kChunk - 1) / (kCountChunks * kChunk);
  const size_t count_bytes =
      sizeof(int) * hist_groups<kThreads>(static_cast<int>(nbins)) * nbins;
  bin_count_kernel<<<dim3(static_cast<unsigned>(count_blocks), by), kThreads,
                     count_bytes, stream>>>(
      idx, R, N, weight, width, shift, static_cast<int>(nbins), meta, gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_scan_kernel<<<1, kScanThreads, 0, stream>>>(meta, nranges, per, gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* cursors = meta + 2 * nranges + 1;
  return nbins > kGroupedMaxBins
             ? scatter<T, kWideThreads>(idx, R, N, weight, width, shift,
                                        static_cast<int>(nbins), by, cursors,
                                        stage, gate, stream)
             : scatter<T, kThreads>(idx, R, N, weight, width, shift,
                                    static_cast<int>(nbins), by, cursors,
                                    stage, gate, stream);
}

}  // namespace nthash_bin
