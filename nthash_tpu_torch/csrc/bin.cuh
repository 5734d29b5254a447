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
// uint32 stage), too wide for a block, whose range pass counts each
// 2^15-counter slice of a range in its own block; the presence words' 2^15
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
//      range pass's blocks per range, owners * ceil(count / per);
//   3. bin_scatter_kernel, by one of two bodies, chosen by the ranges a row
//      (nbins) and the stage's entry size:
//      "sectors", for more than 256 ranges a row where a 32-byte sector of
//      carried entries a range fits the shared memory (int32 stage: up to
//      1,024 ranges; uint16: up to 512): the count-min cell (4 x 2^28 in
//      ranges of 2^18) and the Bloom cell (2^30 in ranges of 2^20). A
//      persistent block an SM owns every bpr-th tile of one row. It holds
//      a tile in registers, counts it by range in shared memory, claims
//      each range's whole 32-byte sectors with one atomicAdd on the range's
//      sector counter, sorts the tile by range behind the entries it
//      carried from its last tile, writes only the claimed whole sectors
//      (on 32-byte boundaries of the range's slice) and carries the rest,
//      fewer than a sector a range, to its next tile. The next tile's loads
//      are in flight while it writes. Its leftovers, and claims past a
//      slice's whole sectors, fill the slice's head and top sectors at the
//      end.
//      "runs", elsewhere (PipelineConfig()'s 2^20: 32 ranges a row): a
//      block a tile, in registers, ranks each entry within its range by a
//      shared atomicAdd (one histogram a warp where the ranges are few),
//      sorts the tile by range in shared memory, reserves one run a range
//      with one atomicAdd on the range's cursor, and writes the runs out
//      by consecutive threads; 512 threads where the ranges are few, else
//      1,024. With few ranges the runs are long, and with more than 1,024
//      the carries do not fit.
// Entries of one range may land in any order: an int32 add mod 2^32 is
// commutative, and an OR is commutative and idempotent, so the range pass
// that follows is exact whatever the order.
//
// The range pass (histogram.cu, bloom.cu) runs a grid of (range, chunk,
// owner) blocks sized on the host from n and the number of ranges: block j
// finds its range g by a search of the blocks' prefix (range g owns blocks
// [blocks[g], blocks[g + 1]); one thread's binary search, or a warp's 32
// probes a step for the clustered route), takes chunk (j - blocks[g]) /
// owners, `per` staged entries of it, and counts or sets them in shared
// memory before one merge into the range's slice of the table. The binned
// passes have one owner a chunk (every bucket of the range in one block),
// the clustered one 2, 4 or 8 (each a 2^15-counter slice of the range,
// reading the whole chunk and keeping its own offsets). Blocks past the
// last range's return at once.
//
// What bounds the pass: the bytes of the indices, read twice (count,
// scatter), and of the stage, written once and read once by the range pass
// (2 bytes an entry for the histogram's binned route, 4 for its clustered
// route and the words). A hot range or a hot bucket costs shared atomics
// inside one block, not serialised atomics on one address of the L2.
//
// What bounded the scatter on the H100 (one batch of 2^18 genome reads at
// either cell's shape, 124.8M indices, 0.98 GB, a byte bound of 0.293 ms):
// the "runs" body took 0.71 ms. Dropping its stores took it to 0.42 ms;
// replacing the cursor atomics by bases loaded with the tile left it
// unchanged or slower; 8K tiles at two blocks an SM, 0.84 ms. So the
// stores cost 0.28 ms, and what they wait on is the sectors that two
// blocks write at different times: a range's run of ~16 entries (64
// bytes) starts and ends inside sectors that the runs of other tiles
// finish later. Writing each tile contiguously instead, 0.51 ms; confining
// the same stores to 16 MB, 0.48 ms; padding every run to whole sectors
// (22% more bytes), 0.50 ms against 0.74 for the same spread with shared
// sectors. Overlapping the loads (a TMA ring, two blocks an SM, an L2
// prefetch) and longer runs (32K tiles) each moved it by under 5%, and
// every sector shared between two writes even a few microseconds apart
// (a range's carried entries written before its tile's) cost more than
// they saved. The "sectors" body writes each sector once, whole: 0.52-0.54
// ms at both shapes. Of that, by ablation, the loads, counts, claims and
// scan take 0.29 ms, the placing atomics 0.05, the write-out's shared loads
// most of the rest and its stores 0.065.
//
// Scratch (meta, stage) comes from the caller; the kernels allocate
// nothing. meta holds 6 * nranges + 2 unsigned 64-bit words: counts
// [nranges], starts [nranges + 1], cursors [nranges], blocks [nranges + 1],
// then the "sectors" body's claims: sectors [nranges] and leftover slots
// [nranges] a range.
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
constexpr int kSectorMaxCarried = 8192;  // most bins * sector entries a
                                         // whole-sector scatter carries
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
// exclusive scan of owners * ceil(counts / per); starts[n] and blocks[n] the
// totals.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(u64* __restrict__ meta, int nranges, long long per,
                int owners, const int* __restrict__ gate) {
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
  const u64 q = static_cast<u64>(owners);
  u64 a = 0, b = 0;
  for (int i = lo; i < hi; ++i) {
    a += counts[i];
    b += q * ((counts[i] + p - 1) / p);
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
    eb += q * ((counts[i] + p - 1) / p);
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

// Exclusive scan of one int a thread over a block of kT threads: returns
// the sum of x over the threads before this one; the total is left in
// tmp[kT / 32] (tmp: kT / 32 + 1 ints). Two barriers.
template <int kT>
__device__ __forceinline__ int scan_one(int x, int* tmp) {
  constexpr int kWarps = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
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
  return tmp[warp] + inc - x;
}

// A range's place in the whole-sector scatter's write-out, one 16-byte
// shared load: its stage offset (from the sorted tile's index) and where
// its claimed and its whole sectors end in the sorted tile.
struct alignas(16) RunPlace {
  u64 off;
  int lim, cut;
};

// Shared memory of the whole-sector bin_scatter_kernel<T, kT> for `nbins`
// bins (at most kT, more than kGroupedMaxBins: one histogram) and sectors
// of `sector` entries, in bytes: the runs' places [nbins] (RunPlace); the
// sorted tile with the carried entries [kT * kPerThread + (sector - 1) *
// nbins], the histogram [nbins] and the scan's [kT / 32 + 1] (ints); the
// carried entries [nbins][sector - 1] (T).
template <typename T, int kT>
__host__ __device__ __forceinline__ size_t sector_shared_bytes(int nbins,
                                                               int sector) {
  const size_t carry = static_cast<size_t>(sector - 1) * nbins;
  return sizeof(RunPlace) * nbins +
         sizeof(int) * (static_cast<size_t>(kT) * kPerThread + carry +
                        static_cast<size_t>(nbins) + kT / 32 + 1) +
         sizeof(T) * carry;
}

// Range g's slice [s, e) of the stage, cut into whole sectors of `sector`
// entries: [a, a + sector * cap) starts on a 32-byte boundary (`lead` is
// the stage's first entry's place in its sector); the rest, the head
// [s, min(a, e)) and the top, is filled by the leftover slots: slot p at
// s + p in the head, then downwards from e - 1.
struct Slice {
  u64 s = 0, e = 0, a = 0, cap = 0;
  Slice() = default;
  __device__ __forceinline__ Slice(const u64* starts, int g, int sector,
                                   int lead) {
    s = starts[g];
    e = starts[g + 1];
    const u64 v = static_cast<u64>(sector);
    a = (s + lead + v - 1) / v * v - lead;
    const u64 z = (e + lead) / v * v;  // the last boundary, counted from lead
    cap = z > a + lead ? (z - a - lead) / v : 0;
  }
  __device__ __forceinline__ u64 leftover(u64 p) const {
    const u64 h = (a < e ? a : e) - s;
    return p < h ? s + p : e - 1 - (p - h);
  }
};

// The whole-sector scatter, for more than kGroupedMaxBins and at most kT
// ranges a row. A persistent block owns every bpr-th tile of one row (bpr
// blocks a row), kT * kPerThread entries a tile, kPerThread a thread in
// registers; thread i owns range i of the row. Per range it carries fewer
// than `sector` entries (32 bytes of the stage) from tile to tile, so that
// it writes only whole sectors, each claimed by one atomicAdd on the
// range's sector counter (`claims`, the first [nranges]) and each on a
// 32-byte boundary of the range's slice (Slice). What its tiles leave over,
// and a claim past the slice's whole sectors (at most two sectors a range),
// takes leftover slots (`claims` + nranges): the head and top sectors,
// written in part, once per block and range. Each range's cursor gains its
// entries, so the cursors end at the next range's start. A tile runs
//   1. each entry counted by range (a shared atomicAdd, no result);
//   2. per range: carried + counted entries, their whole sectors claimed
//      (the claim's result waits in a register through the scan), a scan
//      of one range a thread gives each range's start in the sorted tile;
//   3. the carried entries first in each range, then each counted entry
//      placed by an atomicAdd on its range's cursor;
//   4. the next tile's loads issued into the same registers; claims past
//      the slice to leftover slots;
//   5. the runs written out by consecutive threads (whole sectors, stores
//      to one range contiguous), the remainder carried in shared memory;
//   6. after its last tile, the carries to leftover slots.
template <typename T, int kT>
__global__ void __launch_bounds__(kT, 1)
bin_scatter_kernel(const int* __restrict__ idx, long long R, long long N,
                   const int* __restrict__ weight, unsigned width, int shift,
                   int nbins, const u64* __restrict__ starts,
                   u64* __restrict__ cursors, u64* __restrict__ claims,
                   int sector, T* __restrict__ stage,
                   const int* __restrict__ gate) {
  constexpr int kTile = kT * kPerThread;
  if (gate && *gate == 0) return;
  const long long row_tiles = (N + kTile - 1) / kTile;
  const int bpr = static_cast<int>(gridDim.x / R);  // blocks a row
  const long long r = blockIdx.x / bpr;
  long long j = blockIdx.x % bpr;
  if (r >= R || j >= row_tiles) return;
  const long long nranges = R * nbins;
  const int keep = sector - 1;
  extern __shared__ __align__(16) RunPlace place[];  // [nbins]
  int* sorted = reinterpret_cast<int*>(place + nbins);  // [kTile + keep nbins]
  int* hist = sorted + kTile + keep * nbins;  // [nbins]
  int* tmp = hist + nbins;                    // [kT / 32 + 1]
  T* carry = reinterpret_cast<T*>(tmp + kT / 32 + 1);  // [nbins][keep]
  const int t = threadIdx.x;
  const bool owner = t < nbins;  // of range t of the row
  const unsigned mask = (1u << shift) - 1;
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(stage) / sizeof(T)) % sector);
  int carried = 0;  // entries range t carries
  Slice sl;

  if (owner) {
    hist[t] = 0;
    sl = Slice(starts, static_cast<int>(r * nbins + t), sector, lead);
  }
  const long long g = r * nbins + t;  // range t's index over all rows
  int v[kPerThread];
  load_chunk<kT>(idx + r * N, weight, N, j * kTile, v);
  __syncthreads();
  for (;;) {
    // 1. count
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const unsigned b = static_cast<unsigned>(v[e]);
      if (b < width) atomicAdd(hist + (b >> shift), 1);
    }
    __syncthreads();
    // 2. claim each range's whole sectors; each range's start in `sorted`
    int all = 0, whole = 0;
    u64 f = 0;
    if (owner) {
      const int run = hist[t];
      all = carried + run;
      whole = all / sector;
      if (run) atomicAdd(cursors + g, static_cast<u64>(run));
      if (whole) f = atomicAdd(claims + g, static_cast<u64>(whole));
    }
    const int s0 = scan_one<kT>(all, tmp);
    const int nvalid = tmp[kT / 32];
    // 3. carried entries first, then the cursors
    if (owner) {
      for (int e = 0; e < carried; ++e) {
        sorted[s0 + e] = static_cast<int>(
            (static_cast<unsigned>(t) << shift) | carry[t * keep + e]);
      }
      hist[t] = s0 + carried;
      const u64 ok = f >= sl.cap ? 0 : min(static_cast<u64>(whole), sl.cap - f);
      place[t] = {sl.a + f * sector - static_cast<u64>(s0),
                  s0 + sector * static_cast<int>(ok), s0 + sector * whole};
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const unsigned b = static_cast<unsigned>(v[e]);
      if (b < width) {
        sorted[atomicAdd(hist + (b >> shift), 1)] = static_cast<int>(b);
      }
    }
    __syncthreads();
    // 4. the next tile in flight; claims past the slice to leftover slots
    j += bpr;
    if (j < row_tiles) load_chunk<kT>(idx + r * N, weight, N, j * kTile, v);
    if (owner) {
      hist[t] = 0;
      carried = all - sector * whole;
      const RunPlace w = place[t];
      if (w.cut > w.lim) {
        const u64 p = atomicAdd(claims + nranges + g,
                                static_cast<u64>(w.cut - w.lim));
        for (int k = w.lim; k < w.cut; ++k) {
          stage[sl.leftover(p + (k - w.lim))] =
              static_cast<T>(static_cast<unsigned>(sorted[k]) & mask);
        }
      }
    }
    // 5. whole sectors out, the rest carried
#pragma unroll 4
    for (int k = t; k < nvalid; k += kT) {
      const unsigned b = static_cast<unsigned>(sorted[k]);
      const unsigned bin = b >> shift;
      const RunPlace w = place[bin];
      if (k < w.lim) {
        stage[w.off + static_cast<unsigned>(k)] = static_cast<T>(b & mask);
      } else if (k >= w.cut) {
        carry[bin * keep + (k - w.cut)] = static_cast<T>(b & mask);
      }
    }
    __syncthreads();
    if (j >= row_tiles) break;
  }
  // 6. the row done: the carries to leftover slots
  if (owner && carried) {
    const u64 p = atomicAdd(claims + nranges + g, static_cast<u64>(carried));
    for (int e = 0; e < carried; ++e) {
      stage[sl.leftover(p + e)] = carry[t * keep + e];
    }
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
  void (*kernel)(const int*, long long, long long, const int*, unsigned, int,
                 int, u64*, T*, const int*) = bin_scatter_kernel<T, kT>;
  const size_t bytes = scatter_shared_bytes<kT>(nbins);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = static_cast<long long>(kT) * kPerThread;
  kernel<<<dim3(static_cast<unsigned>((N + per - 1) / per), by), kT, bytes,
           stream>>>(idx, R, N, weight, width, shift, nbins, cursors, stage,
                     gate);
  return static_cast<int>(cudaGetLastError());
}

// Launches the whole-sector bin_scatter_kernel<T, kWideThreads> over idx
// [R, N]: as many blocks as are resident at once on the device's SMs, a
// whole number a row (at least one, at most the row's tiles), sectors of 32
// bytes.
template <typename T>
int scatter_sectors(const int* idx, long long R, long long N,
                    const int* weight, unsigned width, int shift, int nbins,
                    const u64* starts, u64* cursors, u64* claims, T* stage,
                    const int* gate, cudaStream_t stream) {
  void (*kernel)(const int*, long long, long long, const int*, unsigned, int,
                 int, const u64*, u64*, u64*, int, T*, const int*) =
      bin_scatter_kernel<T, kWideThreads>;
  const int sector = 32 / static_cast<int>(sizeof(T));
  const size_t bytes = sector_shared_bytes<T, kWideThreads>(nbins, sector);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, resident = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kWideThreads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_tiles = (N + kWideThreads * kPerThread - 1) /
                              (kWideThreads * kPerThread);
  long long per_row =
      static_cast<long long>(sms) * (resident > 0 ? resident : 1) / R;
  if (per_row > row_tiles) per_row = row_tiles;
  if (per_row < 1) per_row = 1;
  const long long blocks = per_row * R;
  err = cudaMemsetAsync(claims, 0, sizeof(u64) * 2 * R * nbins, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kWideThreads, bytes, stream>>>(
      idx, R, N, weight, width, shift, nbins, starts, cursors, claims, sector,
      stage, gate);
  return static_cast<int>(cudaGetLastError());
}

// The binning pass over idx [R, N] (weight: nullptr or [N], only with
// R == 1) into meta and stage (at least R * N entries of T), ranges of
// 2^shift buckets, `per` staged entries a chunk of the range pass and
// `owners` blocks a chunk.
template <typename T>
int bin_ranges(const int* idx, long long R, long long N, const int* weight,
               int width_log2, int shift, long long per, int owners, u64* meta,
               T* stage, const int* gate, cudaStream_t stream) {
  if (width_log2 <= shift || width_log2 > 31 || R < 1 || N < 1 || per < 1 ||
      owners < 1 || (weight && R != 1)) {
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
  bin_scan_kernel<<<1, kScanThreads, 0, stream>>>(meta, nranges, per, owners,
                                                  gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* cursors = meta + 2 * nranges + 1;
  if (nbins > kGroupedMaxBins && nbins <= kWideThreads &&
      nbins * (32 / static_cast<long long>(sizeof(T))) <= kSectorMaxCarried) {
    return scatter_sectors<T>(
        idx, R, N, weight, width, shift, static_cast<int>(nbins),
        meta + nranges, cursors, meta + 4 * nranges + 2, stage, gate, stream);
  }
  return nbins > kGroupedMaxBins
             ? scatter<T, kWideThreads>(idx, R, N, weight, width, shift,
                                        static_cast<int>(nbins), by, cursors,
                                        stage, gate, stream)
             : scatter<T, kThreads>(idx, R, N, weight, width, shift,
                                    static_cast<int>(nbins), by, cursors,
                                    stage, gate, stream);
}

}  // namespace nthash_bin
