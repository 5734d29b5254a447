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
// Three kernels, all on the device, no host sync between them, in one of
// two orders, chosen by the ranges a row (nbins) and the stage's entry
// size:
//   "sectors", for more than 256 ranges a row where a 32-byte sector of
//   carried entries a range fits the shared memory (int32 stage: up to
//   1,024 ranges; uint16: up to 512): the count-min cell (4 x 2^28 in
//   ranges of 2^18) and the Bloom cell (2^30 in ranges of 2^20). No count
//   first: the stage is a pool of pages, each taken by one range as it
//   fills. A page holds the fewest whole chunks of the range pass (`per`
//   entries) that hold a tile (page_entries): one chunk at both cells'
//   shapes.
//     1. bin_scatter_kernel: a persistent block an SM owns every bpr-th
//        tile of one row. It holds a tile in registers, counts it by range
//        in shared memory, claims each range's whole 32-byte sectors with
//        one atomicAdd on the range's sector counter, sorts the tile by
//        range behind the entries it carried from its last tile, writes
//        only the claimed whole sectors and carries the rest, fewer than a
//        sector a range, to its next tile. Sector f of range g is entries
//        [f * sector, (f + 1) * sector) of the range, in its page c = f *
//        sector / page: the claim that holds a page's first entry takes the
//        pool's next page (one atomicAdd) and publishes it in the page table
//        [nranges][pages]; a claim that starts inside a page another claim
//        took reads it there, waiting (rarely, briefly) until it shows. A
//        claim is at most a tile, so it touches at most two pages. The
//        next tile's loads are in flight while it writes. After its last
//        tile every block waits for the others (the launch is cooperative,
//        so all are resident), and then places its leftovers after the
//        range's claimed sectors, by one atomicAdd on the range's leftover
//        count.
//     2. bin_scan_kernel (one block): each range's count (sector * its
//        claims + its leftovers), their exclusive scan (each range's
//        first entry in range order) and that of the range pass's blocks
//        per range, owners * ceil(count / per).
//   "runs", elsewhere (PipelineConfig()'s 2^20: 32 ranges a row): the
//   stage holds the ranges one after another.
//     1. bin_count_kernel: a block counts its slice of one row by range in a
//        shared-memory histogram (one a warp where the ranges are few, so the
//        warps' atomics on one range do not serialise) and adds each non-zero
//        count to the range's global count (one atomic a range a block);
//     2. bin_scan_kernel: the exclusive scan of the range counts (each
//        range's first stage position, and its cursor), and of the blocks;
//     3. bin_scatter_kernel: a block a tile, in registers, ranks each entry
//        within its range by a shared atomicAdd (one histogram a warp where
//        the ranges are few), sorts the tile by range in shared memory,
//        reserves one run a range with one atomicAdd on the range's cursor,
//        and writes the runs out by consecutive threads; 512 threads where
//        the ranges are few, else 1,024. With few ranges the runs are long,
//        and with more than 1,024 the carries do not fit.
// Entries of one range may land in any order: an int32 add mod 2^32 is
// commutative, and an OR is commutative and idempotent, so the range pass
// that follows is exact whatever the order.
//
// The range pass (histogram.cu, bloom.cu) runs a grid of (range, chunk,
// owner) blocks sized on the host from n and the number of ranges: block j
// finds its range g by a search of the blocks' prefix (range g owns blocks
// [blocks[g], blocks[g + 1]); one thread's binary search, or a warp's 32
// probes a step for the clustered route), takes chunk c = (j - blocks[g]) /
// owners, `per` staged entries of it (chunk_span: from its page, or from
// the range's start where the stage is not paged), and counts or sets
// them in shared memory before one merge into the range's slice of the
// table. The binned passes have one owner a chunk (every bucket of the
// range in one block), the clustered one 2, 4 or 8 (each a 2^15-counter
// slice of the range, reading the whole chunk and keeping its own offsets).
// Blocks past the last range's return at once.
//
// What bounds the pass: the bytes of the indices, read once ("sectors") or
// twice ("runs": count, scatter), and of the stage, written once and read
// once by the range pass (2 bytes an entry for the histogram's binned
// route, 4 for its clustered route and the words). A hot range or a hot
// bucket costs shared atomics inside one block, not serialised atomics on
// one address of the L2. The pool has room for the worst split: each range
// leaves less than a page unfilled, so floor((n - k) / page) + k pages hold
// any n entries over k <= nranges non-empty ranges (scratch()).
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
// most of the rest and its stores 0.065. With its slices from a count pass
// before it, that pass read the indices a second time: 0.17 ms a batch at
// both cells' shapes, at its byte bound.
//
// Scratch (meta, stage) comes from the caller, of the sizes scratch()
// names; the kernels allocate nothing. meta holds 6 * nranges + 5 unsigned
// 64-bit words: counts [nranges], starts [nranges + 1], cursors [nranges],
// blocks [nranges + 1], then the "sectors" body's claims: sectors [nranges]
// and leftovers [nranges] a range, the pages taken and the blocks past its
// barrier; then the page table's row length (pages, 0 where the stage is
// not paged); after them, for the "sectors" body, the page table, unsigned
// [nranges][pages] (page + 1; 0 until taken), pages = ceil(N / page).
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
// Entries of the whole-sector scatter's tile, the most a claim holds.
constexpr long long kSectorTile = static_cast<long long>(kWideThreads) *
                                  kPerThread;
// Words of meta before the "sectors" body's page table.
__host__ __device__ __forceinline__ long long meta_head(long long nranges) {
  return 6 * nranges + 5;
}

// Entries of a page of the "sectors" body's pool for range-pass chunks of
// `per` entries: the fewest whole chunks that hold a tile, so that one
// claim touches at most two pages and a chunk lies in one page.
__host__ __device__ __forceinline__ long long page_entries(long long per) {
  return (kSectorTile + per - 1) / per * per;
}

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
// totals; `pages` into the page table's row length word. With `sector` > 0
// (the "sectors" body, after its scatter) each count is first made from
// the range's claims: sector * its whole sectors + its leftovers.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(u64* __restrict__ meta, int nranges, long long per,
                int owners, int sector, long long pages,
                const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  __shared__ u64 sa[kScanThreads];
  __shared__ u64 sb[kScanThreads];
  u64* counts = meta;
  u64* starts = meta + nranges;
  u64* cursors = starts + nranges + 1;
  u64* blocks = cursors + nranges;
  const u64* claims = blocks + nranges + 1;
  const int t = threadIdx.x;
  const int each = (nranges + kScanThreads - 1) / kScanThreads;
  const int lo = t * each;
  const int hi = min(lo + each, nranges);
  const u64 p = static_cast<u64>(per);
  const u64 q = static_cast<u64>(owners);
  u64 a = 0, b = 0;
  for (int i = lo; i < hi; ++i) {
    if (sector) {
      counts[i] = static_cast<u64>(sector) * claims[i] + claims[nranges + i];
    }
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
    meta[meta_head(nranges) - 1] = static_cast<u64>(pages);
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

// Whether `nbins` ranges a row of an entry of `entry_bytes` take the
// "sectors" body (and its pages): more than the grouped histograms' bins,
// at most a block's threads, and a sector of carried entries a range in
// kSectorMaxCarried.
__host__ __device__ __forceinline__ bool paged_body(int nbins,
                                                    int entry_bytes) {
  return nbins > kGroupedMaxBins && nbins <= kWideThreads &&
         nbins * (32 / entry_bytes) <= kSectorMaxCarried;
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
// shared load: sorted entry k < brk goes to stage[off + k] (the claim's
// first page), brk <= k < cut to stage[far + k] (the page after it, `far`
// a shared word of its own, read only there), k >= cut is carried.
struct alignas(16) RunPlace {
  u64 off;
  int cut, brk;
};

// The page a range's owner thread last wrote: its first entry in the range
// (`lo`, none at first) and in the stage.
struct alignas(16) Page {
  u64 lo = ~0ULL, base = 0;
};

// Shared memory of the whole-sector bin_scatter_kernel<T, kT> for `nbins`
// bins (at most kT, more than kGroupedMaxBins: one histogram) and sectors
// of `sector` entries, in bytes: the runs' places [nbins] (RunPlace), each
// range's last page [nbins] (Page) and the runs' second pages [nbins]
// (u64); the sorted tile with the carried entries
// [kT * kPerThread + (sector - 1) * nbins], the histogram [nbins] and the
// scan's [kT / 32 + 1] (ints); the carried entries [nbins][sector - 1] (T).
template <typename T, int kT>
__host__ __device__ __forceinline__ size_t sector_shared_bytes(int nbins,
                                                               int sector) {
  const size_t carry = static_cast<size_t>(sector - 1) * nbins;
  return (sizeof(RunPlace) + sizeof(Page) + sizeof(u64)) * nbins +
         sizeof(int) * (static_cast<size_t>(kT) * kPerThread + carry +
                        static_cast<size_t>(nbins) + kT / 32 + 1) +
         sizeof(T) * carry;
}

// The pool's next page, taken for a range's page-table slot and published
// there; its first stage entry.
__device__ __forceinline__ u64 take_page(unsigned* slot, u64* taken,
                                         u64 page) {
  const unsigned p = static_cast<unsigned>(atomicAdd(taken, 1ULL)) + 1;
  *reinterpret_cast<volatile unsigned*>(slot) = p;
  return static_cast<u64>(p - 1) * page;
}

// Polls a wait loop makes before it takes the wait for a fault and traps
// (seconds), so that a fault ends the launch with an error, not a hang.
constexpr unsigned kMaxPolls = 1u << 25;

// The first stage entry of the page in `slot`, which another claim takes:
// read past the L1 until it shows.
__device__ __forceinline__ u64 wait_page(const unsigned* slot, u64 page) {
  unsigned p;
  for (unsigned polls = 0;
       (p = *reinterpret_cast<const volatile unsigned*>(slot)) == 0;
       ++polls) {
    if (polls == kMaxPolls) __trap();
    __nanosleep(64);
  }
  return static_cast<u64>(p - 1) * page;
}

// Where a claim's entries go: entry a of the range at stage[at], through
// the end of a's page (`end`, in the range); past it, entry end at
// stage[next].
struct Claim {
  u64 at, end, next;
};

// A claim of entries [a, b) of a range, b - a <= page (row: the range's
// page-table row), by the range's owner thread. The page past a's it takes
// (the claim holds that page's first entry), then a's page: `last`'s, or
// taken where the claim holds its first entry, else another claim's, from
// the table (that claim takes its pages before it waits on any). `last`
// becomes the claim's last page.
__device__ __forceinline__ Claim claim_pages(unsigned* row, u64 a, u64 b,
                                             u64 page, u64* taken,
                                             Page& last) {
  const u64 c = a / page, lo = c * page;
  Claim k;
  k.end = lo + page;
  const bool two = b > k.end;
  k.next = two ? take_page(row + c + 1, taken, page) : 0;
  const u64 base = lo == last.lo ? last.base
                   : a == lo     ? take_page(row + c, taken, page)
                                 : wait_page(row + c, page);
  last.lo = two ? k.end : lo;
  last.base = two ? k.next : base;
  k.at = base + (a - lo);
  return k;
}

// Every block of the grid past this point once, all resident (a
// cooperative launch): the leftovers wait for every claim.
__device__ __forceinline__ void grid_barrier(u64* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1ULL);
    for (unsigned polls = 0;
         *reinterpret_cast<volatile u64*>(arrived) < gridDim.x; ++polls) {
      if (polls == kMaxPolls) __trap();
      __nanosleep(128);
    }
    __threadfence();
  }
  __syncthreads();
}

// The whole-sector scatter, for more than kGroupedMaxBins and at most kT
// ranges a row, into a pool of pages of `page` entries (a multiple of
// `sector`, at least a tile). A persistent block owns every bpr-th tile of
// one row (bpr blocks a row), kT * kPerThread entries a tile, kPerThread a
// thread in registers; thread i owns range i of the row. Per range it
// carries fewer than `sector` entries (32 bytes of the stage) from tile to
// tile, so that it writes only whole sectors, each claimed by one atomicAdd
// on the range's sector counter (`claims`, the first [nranges]) and each on
// a 32-byte boundary of its page (claim_pages). `claims` + nranges counts
// each range's leftovers, then the pages taken and the blocks past the
// barrier; `table` is the page table [nranges][pages]. A tile runs
//   1. each entry counted by range (a shared atomicAdd, no result);
//   2. per range: carried + counted entries, their whole sectors claimed
//      (the claim's result waits in a register through the scan), a scan
//      of one range a thread gives each range's start in the sorted tile;
//   3. the carried entries first in each range, then each counted entry
//      placed by an atomicAdd on its range's cursor; with the tile's
//      registers free, the claim's pages;
//   4. the next tile's loads issued into the same registers;
//   5. the runs written out by consecutive threads (whole sectors, stores
//      to one range contiguous), the remainder carried in shared memory;
//   6. after its last tile and the barrier, the carries after the range's
//      sectors.
template <typename T, int kT>
__global__ void __launch_bounds__(kT, 1)
bin_scatter_kernel(const int* __restrict__ idx, long long R, long long N,
                   const int* __restrict__ weight, unsigned width, int shift,
                   int nbins, u64* claims, unsigned* table, long long pages,
                   long long page, int sector, T* __restrict__ stage,
                   const int* __restrict__ gate) {
  constexpr int kTile = kT * kPerThread;
  if (gate && *gate == 0) return;
  const long long row_tiles = (N + kTile - 1) / kTile;
  const int bpr = static_cast<int>(gridDim.x / R);  // blocks a row
  const long long r = blockIdx.x / bpr;
  long long j = blockIdx.x % bpr;
  const long long nranges = R * nbins;
  u64* lefts = claims + nranges;
  u64* taken = lefts + nranges;
  const int keep = sector - 1;
  extern __shared__ __align__(16) RunPlace place[];  // [nbins]
  Page* last = reinterpret_cast<Page*>(place + nbins);  // [nbins]
  u64* far = reinterpret_cast<u64*>(last + nbins);      // [nbins]
  int* sorted = reinterpret_cast<int*>(far + nbins);  // [kTile + keep nbins]
  int* hist = sorted + kTile + keep * nbins;  // [nbins]
  int* tmp = hist + nbins;                    // [kT / 32 + 1]
  T* carry = reinterpret_cast<T*>(tmp + kT / 32 + 1);  // [nbins][keep]
  const int t = threadIdx.x;
  const bool owner = t < nbins;  // of range t of the row
  const unsigned mask = (1u << shift) - 1;
  const long long g = r * nbins + t;  // range t's index over all rows
  int carried = 0;  // entries range t carries

  if (owner) {
    hist[t] = 0;
    last[t] = Page();
  }
  int v[kPerThread];
  if (j < row_tiles) load_chunk<kT>(idx + r * N, weight, N, j * kTile, v);
  __syncthreads();
  while (j < row_tiles) {
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
      all = carried + hist[t];
      whole = all / sector;
      if (whole) f = atomicAdd(claims + g, static_cast<u64>(whole));
    }
    const int s0 = scan_one<kT>(all, tmp);
    const int nvalid = tmp[kT / 32];
    // 3. carried entries first, then the cursors, then the claim's pages
    if (owner) {
      for (int e = 0; e < carried; ++e) {
        sorted[s0 + e] = static_cast<int>(
            (static_cast<unsigned>(t) << shift) | carry[t * keep + e]);
      }
      hist[t] = s0 + carried;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const unsigned b = static_cast<unsigned>(v[e]);
      if (b < width) {
        sorted[atomicAdd(hist + (b >> shift), 1)] = static_cast<int>(b);
      }
    }
    if (owner) {
      const int cut = s0 + sector * whole;
      RunPlace w = {0, cut, cut};
      if (whole) {
        const u64 a = f * sector, b = a + static_cast<u64>(sector) * whole;
        const Claim k = claim_pages(table + g * pages, a, b, page, taken,
                                    last[t]);
        w.off = k.at - static_cast<u64>(s0);
        if (b > k.end) {  // past the first page: the page after it
          w.brk = s0 + static_cast<int>(k.end - a);
          far[t] = k.next - static_cast<u64>(w.brk);
        }
      }
      place[t] = w;
    }
    __syncthreads();
    // 4. the next tile in flight
    j += bpr;
    if (j < row_tiles) load_chunk<kT>(idx + r * N, weight, N, j * kTile, v);
    if (owner) {
      hist[t] = 0;
      carried = all - sector * whole;
    }
    // 5. whole sectors out, the rest carried
#pragma unroll 4
    for (int k = t; k < nvalid; k += kT) {
      const unsigned b = static_cast<unsigned>(sorted[k]);
      const unsigned bin = b >> shift;
      const RunPlace w = place[bin];
      const T o = static_cast<T>(b & mask);
      if (k < w.brk) {
        stage[w.off + static_cast<unsigned>(k)] = o;
      } else if (k < w.cut) {
        stage[far[bin] + static_cast<unsigned>(k)] = o;
      } else {
        carry[bin * keep + (k - w.cut)] = o;
      }
    }
    __syncthreads();
  }
  // 6. every claim in: the carries after the range's whole sectors
  grid_barrier(taken + 1);
  if (owner && carried) {
    const u64 a = __ldcg(claims + g) * sector +
                  atomicAdd(lefts + g, static_cast<u64>(carried));
    const Claim k = claim_pages(table + g * pages, a, a + carried, page,
                                taken, last[t]);
    for (int e = 0; e < carried; ++e) {
      const u64 i = a + e;
      stage[i < k.end ? k.at + e : k.next + (i - k.end)] =
          carry[t * keep + e];
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

// The staged entries [lo, hi) of chunk c of range g (`per` entries a
// chunk): in its page, from the page table after meta's head, where the
// stage is paged (meta's row length word not 0), else from the range's
// start.
__device__ __forceinline__ void chunk_span(const u64* __restrict__ meta,
                                           int nranges, int g, u64 c,
                                           long long per, u64& lo, u64& hi) {
  const u64 p = static_cast<u64>(per);
  const u64* starts = meta + nranges;
  const u64 pages = meta[meta_head(nranges) - 1];
  if (pages) {
    const unsigned* table =
        reinterpret_cast<const unsigned*>(meta + meta_head(nranges));
    const u64 page = static_cast<u64>(page_entries(per));
    const u64 e = c * p;  // the chunk's first entry in the range
    lo = static_cast<u64>(table[g * pages + e / page] - 1) * page + e % page;
    hi = lo + min(p, meta[g] - e);
  } else {
    lo = starts[g] + c * p;
    hi = min(lo + p, starts[g + 1]);
  }
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
// [R, N], cooperatively (cudaLaunchKernelEx's cooperative attribute, so
// that a profiler's launch rows name it as they name the other kernels'):
// as many blocks as are resident at once on the device's SMs, a whole
// number a row (at least one, at most the row's tiles), sectors of 32
// bytes, pages of `page` entries, `pages` a range.
template <typename T>
int scatter_sectors(const int* idx, long long R, long long N,
                    const int* weight, unsigned width, int shift, int nbins,
                    u64* claims, unsigned* table, long long pages,
                    long long page, T* stage, const int* gate,
                    cudaStream_t stream) {
  void (*kernel)(const int*, long long, long long, const int*, unsigned, int,
                 int, u64*, unsigned*, long long, long long, int, T*,
                 const int*) = bin_scatter_kernel<T, kWideThreads>;
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
  const long long row_tiles = (N + kSectorTile - 1) / kSectorTile;
  long long per_row =
      static_cast<long long>(sms) * (resident > 0 ? resident : 1) / R;
  if (per_row > row_tiles) per_row = row_tiles;
  if (per_row < 1) per_row = 1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(per_row * R));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, idx, R, N, weight, width, shift, nbins, claims, table,
      pages, page, sector, stage, gate));
}

// The scratch bin_ranges needs over idx [R, N] in `nranges` ranges of
// `nbins` a row, with a stage entry of `entry_bytes` and chunks of `per`:
// meta's unsigned 64-bit words and the stage's entries. By the "sectors"
// body (paged_body) meta's head and a page table of ceil(N / page) pages a
// range, and a pool of floor((R * N - k) / page) + k pages (k = min(nranges,
// R * N): each non-empty range leaves less than a page unfilled); else
// meta's head and R * N entries. Returns the table's row length, 0 where
// the stage is not paged, or -1 where the pool's pages would not fit the
// table's 32-bit entries.
inline long long scratch(long long R, long long N, long long nbins,
                         int entry_bytes, long long per,
                         long long& meta_words, long long& stage_entries) {
  const long long nranges = R * nbins;
  meta_words = meta_head(nranges);
  stage_entries = R * N;
  if (!paged_body(static_cast<int>(nbins), entry_bytes)) return 0;
  const long long page = page_entries(per);
  const long long k = nranges < R * N ? nranges : R * N;
  const long long pool = (R * N - k) / page + k;
  if (pool >= 0xffffffffLL) return -1;
  const long long pages = (N + page - 1) / page;
  meta_words += (nranges * pages + 1) / 2;
  stage_entries = pool * page;
  return pages;
}

// The binning pass over idx [R, N] (weight: nullptr or [N], only with
// R == 1) into meta and stage (of at least the words and entries that
// scratch() names; refused where they are fewer), ranges of 2^shift
// buckets, `per` staged entries a chunk of the range pass and `owners`
// blocks a chunk. By the "sectors" body (paged_body) `per` is a multiple of
// a 32-byte sector's entries.
template <typename T>
int bin_ranges(const int* idx, long long R, long long N, const int* weight,
               int width_log2, int shift, long long per, int owners, u64* meta,
               long long meta_words, T* stage, long long stage_entries,
               const int* gate, cudaStream_t stream) {
  if (width_log2 <= shift || width_log2 > 31 || R < 1 || N < 1 || per < 1 ||
      owners < 1 || (weight && R != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nbins = 1LL << (width_log2 - shift);
  if (R * nbins > kMaxRanges) return static_cast<int>(cudaErrorInvalidValue);
  const int nranges = static_cast<int>(R * nbins);
  const unsigned width = static_cast<unsigned>(1ULL << width_log2);
  const long long sector = 32 / static_cast<long long>(sizeof(T));
  long long need_meta = 0, need_stage = 0;
  const long long pages = scratch(R, N, nbins, static_cast<int>(sizeof(T)),
                                  per, need_meta, need_stage);
  if (pages < 0 || meta_words < need_meta || stage_entries < need_stage ||
      (pages && per % sector != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pages) {
    cudaError_t err = cudaMemsetAsync(meta, 0, sizeof(u64) * need_meta,
                                      stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    u64* claims = meta + 4 * nranges + 2;
    const int status = scatter_sectors<T>(
        idx, R, N, weight, width, shift, static_cast<int>(nbins), claims,
        reinterpret_cast<unsigned*>(meta + meta_head(nranges)), pages,
        page_entries(per), stage, gate, stream);
    if (status != 0) return status;
    bin_scan_kernel<<<1, kScanThreads, 0, stream>>>(
        meta, nranges, per, owners, static_cast<int>(sector), pages, gate);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(meta, 0, sizeof(u64) * nranges, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
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
                                                  0, 0, gate);
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
