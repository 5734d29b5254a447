// Rolling spaced-seed ntHash2 ("ntmsm64") over time-major reads, and over one
// flat sequence.
//
// Replaces nthash_tpu/ops/seed_pallas.py::_kernel (hash_seeds_tm, one
// segment per read) and ::_kernel_long (hash_seeds_tm_long, segments of `seg`
// windows), and computes what they compute. For codes [L, R] int32 (0-3 =
// ACGT, 4 = invalid; larger values count as 4) and S seed patterns of one
// length k, every window w = t - k + 1 of every read gets
//   hashes mode: each seed's canonical hash (fwd + rev) and its
//                num_hashes - 1 nte64 extensions (multiplier for k = the
//                pattern length), then fwd and rev if emit_fwd_rev, into the
//                uint64 planes [S * per_seed, W, R] in the reference's
//                seed-major hash_arr order;
//   bucket mode (bucket_bits = b > 0): the low b bits of those num_hashes
//                values as int32 planes [S * num_hashes, W, R], or the
//                sentinel 2^b where any of the window's k bases is invalid,
//                don't-care positions included (strict validity, a rolling
//                count as in seed_pallas.py:112-128); the wide buckets
//                (seed_staged_wide_kernel, seed_hash_wide_kernel: the same
//                bodies) write them as int64, b up to 38, for filters past
//                2^31 bits, where the sentinel and the buckets from 2^31 on
//                no longer fit an int32.
//
// The recurrence is the Pallas kernel's (seed_pallas.py:8-11, 130-141): for
// each maximal care run [s, e) of the seed, a step is two taps,
//   fwd = srol1(fwd) ^ fwd_in[c(t - off_in)] ^ fwd_out[c(t - off_out)]
//   rev = sror1(rev) ^ rev_in[c(t - off_in)] ^ rev_out[c(t - off_out)]
// with off_in = k - e, off_out = k - s and the rotated seed tables built on
// the host (seed_kernel.seed_taps; srol^(s-1) at s = 0 is srol^1022 in the
// order-1,023 split-rotation group). An invalid code selects the zero seed.
//
// Segments, as in kmer_hash.cu: the thread of read r and segment j starts at
// base j*seg with zero state; every base before it reads as code 4, so a
// base p >= j*seg enters and leaves every run it passes through and no
// earlier base does anything: each window the thread writes (w >= j*seg) is
// exact. The TPU kernel's sequential time tiles with a k-deep history ring
// have no counterpart: CUDA blocks run in no order. seg >= W is one segment
// per read (B1); B3 cuts long reads so that a few of them still fill the
// card.
//
// The staged kernel (seed_staged_kernel), the rule. What bounds it on the
// H100 is output bytes (7.0 GB for the BASELINE seeds {10101, 11011}, 3
// hashes each, over 1M reads of 150 bp, against 0.6 GB of codes) once the
// roll costs few instructions and shared loads a window. A warp takes 32
// reads (one a lane: its writes are 256 contiguous bytes a plane) and one
// segment, and rolls every seed: 32 rows of codes at a time are staged by
// 16-byte loads into the warp's ring of uint8 rows in shared memory (roll.cuh)
// and rolled seed by seed, each seed's (fwd, rev) kept in shared memory
// between the row batches. So the codes are read from device memory once for
// all seeds, a tap is a one-byte shared load at a 32-bit offset, and a care
// run is one 16-byte pair-table lookup per step; the warm-up reads code 4, so
// no tap carries a guard. Its shared memory (pair tables, ring, seed states)
// is sized on the host (seed_kernel.seed_grid), which picks the warps a block.
//
// The global kernel (seed_hash_kernel), for seeds whose pair tables and ring
// do not fit a block: one thread per (read, seed, segment), the codes read
// from device memory per tap (lines loaded at most k steps earlier, so they
// hit L1/L2), every care run's four 5-entry tables in shared memory.
//
// The one-sequence entry (seed_sequence_kernel): nthash::seq::seed_sequence
// of roll.cuh over a flat uint8 sequence, every window in one pass (see
// there): the codes are staged once a chunk for all seeds, each care run's
// index words computed once a chunk, each seed rolled from its state parked
// in shared memory; its kFwdRev instance also writes every seed's fwd and
// rev (the facade's tiles, api.SeedNtHash).
//
// The grids are 1-D with 64-bit indices and every offset is 64-bit (the
// BASELINE planes pass 2^31 elements at ~2.5M reads per call).

#include <cuda_runtime.h>

#include <cstdint>

#include "roll.cuh"

namespace {

using nthash::code_at;
using nthash::srol1;
using nthash::sror1;

constexpr int kThreads = 256;
constexpr int kGlobalMinBlocks = 6;  // seed_hash_kernel's resident blocks
constexpr int kTabPerRun = 20;   // fwd_in, fwd_out, rev_in, rev_out: 5 each
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into

// tables: per run q, [20q, 20q+5) fwd_in, +5 fwd_out, +10 rev_in, +15 rev_out;
// then the num_hashes - 1 nte64 multipliers.
// meta: per run q, off_in at 2q and off_out at 2q + 1; then the S + 1 run
// offsets (seed s owns runs [meta[2*nruns + s], meta[2*nruns + s + 1])).
// The body of the global kernel's instances, buckets of type B.
template <bool kBuckets, typename B>
__device__ __forceinline__ void
global_roll(const int* __restrict__ codes, int L, long long R, int k,
            int nseeds, int nruns, int seg, long long nseg, int num_hashes,
            int emit_fwd_rev, int bucket_bits,
            const unsigned long long* __restrict__ tables,
            const int* __restrict__ meta, void* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int ntab = nruns * kTabPerRun + num_hashes - 1;
  const int nmeta = 2 * nruns + nseeds + 1;
  unsigned long long* tab = smem;
  int* m = reinterpret_cast<int*>(smem + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) m[i] = meta[i];
  __syncthreads();

  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= nseg * nseeds * R) return;
  const long long r = gid % R;
  const long long rest = gid / R;
  const int s = static_cast<int>(rest % nseeds);
  const int t0 = static_cast<int>(rest / nseeds) * seg;  // segment's first base
  const int q0 = m[2 * nruns + s], q1 = m[2 * nruns + s + 1];
  const unsigned long long* mult = tab + nruns * kTabPerRun;

  const int W = L - k + 1;
  const size_t plane = static_cast<size_t>(W) * R;
  const int t_end = min(t0 + seg, W) + k - 1;
  const int per_seed = num_hashes + (!kBuckets && emit_fwd_rev ? 2 : 0);
  const size_t first = static_cast<size_t>(s) * per_seed * plane;

  unsigned long long fwd = 0, rev = 0;
  int inv = 0;
  for (int t = t0; t < t_end; ++t) {
    const int dt = t - t0;
    fwd = srol1(fwd);
    rev = sror1(rev);
    for (int q = q0; q < q1; ++q) {
      const unsigned long long* tq = tab + q * kTabPerRun;
      const int off_in = m[2 * q], off_out = m[2 * q + 1];
      if (dt >= off_in) {
        const unsigned c = code_at(codes, static_cast<long long>(t - off_in) * R + r);
        fwd ^= tq[c];
        rev ^= tq[10 + c];
      }
      if (dt >= off_out) {
        const unsigned c = code_at(codes, static_cast<long long>(t - off_out) * R + r);
        fwd ^= tq[5 + c];
        rev ^= tq[15 + c];
      }
    }
    if (kBuckets) {
      inv += code_at(codes, static_cast<long long>(t) * R + r) >= 4;
      if (dt >= k) inv -= code_at(codes, static_cast<long long>(t - k) * R + r) >= 4;
    }
    if (dt < k - 1) continue;
    nthash::write_window<kBuckets, B>(
        out, first + static_cast<size_t>(t - k + 1) * R + r, plane, fwd, rev,
        inv == 0, num_hashes, emit_fwd_rev, bucket_bits, mult);
  }
}

// Six blocks a multiprocessor (40 registers): left to itself ptxas gives
// the hashes instance 32 and spills (each launch bound timed on the card;
// CHANGES.md, readings behind the comments).
template <bool kBuckets>
__global__ void __launch_bounds__(kThreads, kGlobalMinBlocks)
seed_hash_kernel(const int* __restrict__ codes, int L, long long R, int k,
                 int nseeds, int nruns, int seg, long long nseg,
                 int num_hashes, int emit_fwd_rev, int bucket_bits,
                 const unsigned long long* __restrict__ tables,
                 const int* __restrict__ meta, void* __restrict__ out) {
  global_roll<kBuckets, int>(codes, L, R, k, nseeds, nruns, seg, nseg,
                             num_hashes, emit_fwd_rev, bucket_bits, tables,
                             meta, out);
}

// The wide buckets (int64, widths past 2^30): the bucket instance's body
// writing 8 bytes a bucket.
__global__ void __launch_bounds__(kThreads, kGlobalMinBlocks)
seed_hash_wide_kernel(const int* __restrict__ codes, int L, long long R,
                      int k, int nseeds, int nruns, int seg, long long nseg,
                      int num_hashes, int emit_fwd_rev, int bucket_bits,
                      const unsigned long long* __restrict__ tables,
                      const int* __restrict__ meta, void* __restrict__ out) {
  global_roll<true, long long>(codes, L, R, k, nseeds, nruns, seg, nseg,
                               num_hashes, emit_fwd_rev, bucket_bits, tables,
                               meta, out);
}

// Layout of the staged kernel's shared memory: the tables (as in
// nthash::load_tables), then per warp the seeds' states [nseeds][32] and the
// ring [ring_rows][32]. The body of its instances, buckets of type B.
template <bool kBuckets, typename B>
__device__ __forceinline__ void
staged_roll(const int* __restrict__ codes, int L, long long R, int k,
            int nseeds, int nruns, int seg, long long nseg, int num_hashes,
            int emit_fwd_rev, int bucket_bits,
            const unsigned long long* __restrict__ tables,
            const int* __restrict__ meta, int rmask, int vec,
            void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sm[];
  const ulonglong2* pairs;
  const unsigned long long* mult;
  const int2* offs;
  const int* starts;
  unsigned char* warps = nthash::load_tables(sm, nseeds, nruns, num_hashes,
                                             tables, meta, &pairs, &mult,
                                             &offs, &starts);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const size_t warp_bytes = static_cast<size_t>(nseeds) * 32 * 16 +
                            static_cast<size_t>(rmask + 1) * 32;
  ulonglong2* state = reinterpret_cast<ulonglong2*>(
      warps + (threadIdx.x >> 5) * warp_bytes);
  unsigned char* ring = reinterpret_cast<unsigned char*>(state + nseeds * 32);
  const long long groups = (R + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                       (threadIdx.x >> 5);
  if (gw >= groups * nseg) return;  // whole warps only
  const long long r0 = gw % groups * 32, r = r0 + lane;
  const int t0 = static_cast<int>(gw / groups) * seg;  // segment's first base
  const int W = L - k + 1;
  const int t_hi = min(t0 + seg, W) + k - 1;  // bases past it are never read
  const int nsteps = t_hi - t0;
  const size_t plane = static_cast<size_t>(W) * R;
  const int per_seed = num_hashes + (!kBuckets && emit_fwd_rev ? 2 : 0);

  nthash::ring_prefill(ring, k, rmask, lane);
  for (int s = 0; s < nseeds; ++s) state[s * 32 + lane] = make_ulonglong2(0, 0);
  int inv = k;
  for (int c0 = 0; c0 < nsteps; c0 += nthash::kRows) {
    __syncwarp();
    nthash::stage_tm(ring, rmask, codes, R, r0, t0, t_hi, c0, lane, vec);
    __syncwarp();
    const int n = min(nthash::kRows, nsteps - c0);
    unsigned vbits = 0;
    if (kBuckets) {
      for (int i = 0; i < n; ++i) {
        nthash::roll_invalid(ring, rmask, lane, c0 + i, k, inv);
        vbits |= static_cast<unsigned>(inv == 0) << i;
      }
    }
    for (int s = 0; s < nseeds; ++s) {
      const ulonglong2 st = state[s * 32 + lane];
      unsigned long long fwd = st.x, rev = st.y;
      const int q0 = starts[s], q1 = starts[s + 1];
      const size_t first = static_cast<size_t>(s) * per_seed * plane;
      for (int i = 0; i < n; ++i) {
        const int dt = c0 + i;
        nthash::roll_step(ring, rmask, lane, dt, offs, pairs, q0, q1, fwd, rev);
        if (dt < k - 1 || r >= R) continue;
        nthash::write_window<kBuckets, B>(
            out, first + static_cast<size_t>(t0 + dt - k + 1) * R + r, plane,
            fwd, rev, (vbits >> i) & 1, num_hashes, emit_fwd_rev, bucket_bits,
            mult);
      }
      state[s * 32 + lane] = make_ulonglong2(fwd, rev);
    }
  }
}

template <bool kBuckets>
__global__ void __launch_bounds__(256)
seed_staged_kernel(const int* __restrict__ codes, int L, long long R, int k,
                   int nseeds, int nruns, int seg, long long nseg,
                   int num_hashes, int emit_fwd_rev, int bucket_bits,
                   const unsigned long long* __restrict__ tables,
                   const int* __restrict__ meta, int rmask, int vec,
                   void* __restrict__ out) {
  staged_roll<kBuckets, int>(codes, L, R, k, nseeds, nruns, seg, nseg,
                             num_hashes, emit_fwd_rev, bucket_bits, tables,
                             meta, rmask, vec, out);
}

// The wide buckets: the bucket instance's body writing 8 bytes a bucket.
__global__ void __launch_bounds__(256)
seed_staged_wide_kernel(const int* __restrict__ codes, int L, long long R,
                        int k, int nseeds, int nruns, int seg, long long nseg,
                        int num_hashes, int emit_fwd_rev, int bucket_bits,
                        const unsigned long long* __restrict__ tables,
                        const int* __restrict__ meta, int rmask, int vec,
                        void* __restrict__ out) {
  staged_roll<true, long long>(codes, L, R, k, nseeds, nruns, seg, nseg,
                               num_hashes, emit_fwd_rev, bucket_bits, tables,
                               meta, rmask, vec, out);
}

// Output runs, windows a lane: 32, or 16 without fwd/rev, where a warp's
// larger stage would cost resident warps (roll.cuh).
__host__ __device__ constexpr int seed_run(bool fwd_rev) {
  return fwd_rev ? 32 : 16;
}

// meta: per run its two tap deltas (b - 32 - off_in, b - 32 - off_out, b =
// (k - 1) mod 32), then the nseeds + 1 run offsets.
template <bool kFwdRev>
__global__ void __launch_bounds__(256, kFwdRev ? 1 : 2)
seed_sequence_kernel(const unsigned char* __restrict__ seq, long long C, int k,
                     int span, int nseeds, int nruns, int num_hashes,
                     const unsigned long long* __restrict__ tables,
                     const int* __restrict__ meta, int ring, int copies_log2,
                     unsigned long long* __restrict__ out, long long pitch,
                     bool* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char sm[];
  const unsigned char* pairs;
  const unsigned long long* mult;
  const int* taps;
  unsigned char* warps = nthash::seq::load_tables(
      sm, nseeds, nruns, num_hashes, copies_log2, tables, meta, &pairs, &mult,
      &taps);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
  if (j0 * span >= C) return;  // whole warps only
  unsigned char* mine = warps + (threadIdx.x >> 5) *
      nthash::seq::warp_bytes(ring, kFwdRev ? 2 : 1, nseeds, seed_run(kFwdRev));
  unsigned char* stage = mine + (ring / 4 + 8) * 128;
  nthash::seq::seed_sequence<kFwdRev, seed_run(kFwdRev)>(
      seq, C, k, span, nseeds, nruns, num_hashes,
      pairs + ((lane & ((1 << copies_log2) - 1)) << 4), 4 + copies_log2, mult,
      taps, reinterpret_cast<unsigned*>(mine), ring, stage,
      reinterpret_cast<unsigned*>(
          stage + (kFwdRev ? 2 : 1) * nthash::seq::stage_bytes(seed_run(kFwdRev))),
      j0, lane, out, pitch, valid);
}

// The sequence entry's pair-table copies: 8 (no bank conflict in a
// quarter-warp) while they take at most 8 runs' worth, else 1.
int seed_copies_log2(int nruns) { return nruns <= 8 ? 3 : 0; }

size_t seed_sequence_smem(int nseeds, int nruns, int num_hashes, int warps,
                          int ring, int fwd_rev) {
  return nthash::seq::tables_bytes(nseeds, nruns, num_hashes,
                                   seed_copies_log2(nruns)) +
         warps * nthash::seq::warp_bytes(ring, fwd_rev ? 2 : 1, nseeds,
                                         seed_run(fwd_rev));
}

using GlobalKernel = void (*)(const int*, int, long long, int, int, int, int,
                             long long, int, int, int,
                             const unsigned long long*, const int*, void*);
using StagedKernel = void (*)(const int*, int, long long, int, int, int, int,
                             long long, int, int, int,
                             const unsigned long long*, const int*, int, int,
                             void*);

cudaError_t launch_global(GlobalKernel kernel, const int* codes, int L,
                          long long R, int k, int nseeds, int nruns, int seg,
                          int num_hashes, int emit_fwd_rev, int bucket_bits,
                          const unsigned long long* tables, const int* meta,
                          void* out, cudaStream_t stream) {
  const long long nseg = (static_cast<long long>(L - k + 1) + seg - 1) / seg;
  const long long blocks = (nseg * nseeds * R + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      static_cast<size_t>(nruns * kTabPerRun + num_hashes - 1) * sizeof(unsigned long long) +
      static_cast<size_t>(2 * nruns + nseeds + 1) * sizeof(int);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      codes, L, R, k, nseeds, nruns, seg, nseg, num_hashes, emit_fwd_rev,
      bucket_bits, tables, meta, out);
  return cudaGetLastError();
}

cudaError_t launch_staged(StagedKernel kernel, const int* codes, int L,
                          long long R, int k, int nseeds, int nruns, int seg,
                          int num_hashes, int emit_fwd_rev, int bucket_bits,
                          const unsigned long long* tables, const int* meta,
                          int warps, int ring, void* out, cudaStream_t stream) {
  const long long nseg = (static_cast<long long>(L - k + 1) + seg - 1) / seg;
  const long long blocks = ((R + 31) / 32 * nseg + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      nthash::staged_tables_bytes(nseeds, nruns, num_hashes) +
      static_cast<size_t>(warps) * (static_cast<size_t>(nseeds) * 32 * 16 +
                                    static_cast<size_t>(ring) * 32);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      codes, L, R, k, nseeds, nruns, seg, nseg, num_hashes, emit_fwd_rev,
      bucket_bits, tables, meta, ring - 1, vec, out);
  return cudaGetLastError();
}

bool valid_ring(int ring, int k) {
  return ring >= k + nthash::kRows && (ring & (ring - 1)) == 0;
}

}  // namespace

extern "C" {

// codes: [L, R] int32 device; out: [nseeds * per_seed, L - k + 1, R] uint64
// (bucket_bits == 0; per_seed = num_hashes + 2 * emit_fwd_rev) or
// [nseeds * num_hashes, L - k + 1, R] buckets, int32 (bucket_bits 1..30) or,
// with wide, int64 (bucket_bits 1..38); seg: windows per segment (>= 1; seg
// >= L - k + 1 is one segment per read).
// warps > 0: the staged kernel, `warps` a block, a ring of `ring` rows (a
// power of two >= k + 32); tables: per run its 25 (fwd, rev) pairs, then the
// num_hashes - 1 nte64 multipliers, as uint64.
// warps == 0: the global kernel; tables: per run its four 5-entry tables,
// then the multipliers.
// meta: per run (off_in, off_out), then the nseeds + 1 run offsets, int32.
// Launches on `stream` of `device`; returns cudaGetLastError().
int nthash_seed_hash(int device, const int* codes, int L, long long R, int k,
                     int nseeds, int nruns, int seg, int num_hashes,
                     int emit_fwd_rev, int bucket_bits, int wide,
                     const unsigned long long* tables, const int* meta,
                     int warps, int ring, void* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (seg < 1 || nseeds < 1 || nruns < nseeds || warps < 0 || warps > 8 ||
      (warps > 0 && !valid_ring(ring, k)) || bucket_bits < 0 ||
      bucket_bits > (wide ? 38 : 30) || (wide && bucket_bits == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool buckets = bucket_bits > 0;
  const int fr = buckets ? 0 : emit_fwd_rev;
  if (warps > 0) {
    StagedKernel kernel = seed_staged_kernel<false>;
    if (buckets) kernel = seed_staged_kernel<true>;
    if (wide) kernel = seed_staged_wide_kernel;
    err = launch_staged(kernel, codes, L, R, k, nseeds, nruns, seg,
                        num_hashes, fr, bucket_bits, tables, meta, warps, ring,
                        out, stream);
  } else {
    GlobalKernel kernel = seed_hash_kernel<false>;
    if (buckets) kernel = seed_hash_kernel<true>;
    if (wide) kernel = seed_hash_wide_kernel;
    err = launch_global(kernel, codes, L, R, k, nseeds, nruns, seg,
                        num_hashes, fr, bucket_bits, tables, meta, out, stream);
  }
  return static_cast<int>(err);
}

// seq: [C] uint8 codes device, 16-byte aligned (values above 4 read as 4);
// out: [nseeds * (num_hashes + 2 fwd_rev), pitch] uint64, pitch >= C a
// multiple of 32 (with fwd_rev each seed's group is followed by its fwd and
// rev); valid: [C rounded up to 32] bool; span: windows a lane (a multiple
// of 32); warps: a block (1-8); tables: per run its 25 (fwd, rev) pairs,
// then the num_hashes - 1 nte64 multipliers, as uint64; meta as for
// seed_sequence_kernel. Each lane's ring holds 32 ((k - 1) / 32 + 3) bytes.
int nthash_seed_sequence(int device, const unsigned char* seq, long long C,
                         int k, int span, int nseeds, int nruns,
                         int num_hashes, int fwd_rev,
                         const unsigned long long* tables, const int* meta,
                         int warps, unsigned long long* out, long long pitch,
                         bool* valid, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || span < 32 || span % 32 || nseeds < 1 || nruns < nseeds ||
      warps < 1 || warps > 8 || pitch < C || pitch % 32 ||
      reinterpret_cast<uintptr_t>(seq) % 16 ||
      reinterpret_cast<uintptr_t>(valid) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = (C + span - 1) / span;
  const long long blocks = ((threads + 31) / 32 + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int ring = 32 * ((k - 1) / 32 + 3);
  const size_t smem = seed_sequence_smem(nseeds, nruns, num_hashes, warps,
                                         ring, fwd_rev);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fwd_rev ? &seed_sequence_kernel<true> : &seed_sequence_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      seq, C, k, span, nseeds, nruns, num_hashes, tables, meta, ring,
      seed_copies_log2(nruns), out, pitch, valid);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
