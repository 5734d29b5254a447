// Rolling spaced-seed ntHash2 ("ntmsm64") over time-major reads: one thread
// per (read, seed, segment).
//
// Replaces nthash_tpu/ops/seed_pallas.py::_kernel (hash_seeds_tm, one
// segment per read) and ::_kernel_long (hash_seeds_tm_long, segments of `seg`
// windows), and computes what they compute. For codes [L, R] int32 (0-3 =
// ACGT, 4 = invalid; larger values count as 4) and S seed patterns of one
// length k, each thread rolls one seed's forward and reverse hash over its
// segment of one read and, for every window w = t - k + 1, writes
//   hashes mode: that seed's canonical hash (fwd + rev) and its
//                num_hashes - 1 nte64 extensions (multiplier for k = the
//                pattern length), then fwd and rev if emit_fwd_rev, into the
//                uint64 planes [S * per_seed, W, R] in the reference's
//                seed-major hash_arr order;
//   bucket mode (bucket_bits = b > 0): the low b bits of those num_hashes
//                values as int32 planes [S * num_hashes, W, R], or the
//                sentinel 2^b where any of the window's k bases is invalid,
//                don't-care positions included (strict validity, a rolling
//                count as in seed_pallas.py:112-128).
//
// The recurrence is the Pallas kernel's (seed_pallas.py:8-11, 130-141): for
// each maximal care run [s, e) of the seed, a step is two taps,
//   fwd = srol1(fwd) ^ fwd_in[c(t - off_in)] ^ fwd_out[c(t - off_out)]
//   rev = sror1(rev) ^ rev_in[c(t - off_in)] ^ rev_out[c(t - off_out)]
// with off_in = k - e, off_out = k - s and the rotated seed tables built on
// the host (seed_kernel.seed_taps; srol^(s-1) at s = 0 is srol^1022 in the
// order-1,023 split-rotation group). An invalid code selects the zero seed.
//
// Segments, as in kmer_hash.cu: thread (r, s, j) starts at base j*seg with
// zero state and applies a tap only once it is off_in (or off_out) bases
// into its segment. A base p >= j*seg then enters and leaves every run it
// passes through, and no earlier base does anything, so each window the
// thread writes (w >= j*seg) is exact. The TPU kernel's sequential time tiles
// with a k-deep history ring have no counterpart: CUDA blocks run in no
// order. seg >= W is one segment per read (B1); B3 cuts long reads so that a
// few of them still fill the card.
//
// What bounds it on the H100: output bytes (7.0 GB for the BASELINE seeds
// {10101, 11011}, 3 hashes each, over 1M reads of 150 bp, against 0.6 GB of
// codes). The design keeps the state (two uint64 and the invalid count) in
// registers and makes the traffic coalesced: the read index runs fastest
// across threads, so a warp reads 128 contiguous bytes of codes per tap and
// writes 256 (hashes) or 128 (buckets) contiguous bytes per plane. The taps
// read codes[(t - off) * R + r] for off in [0, k]: lines loaded at most k
// steps earlier, so they hit L1/L2. All runs of all seeds are flattened into
// shared memory (off_in, off_out and four 5-entry uint64 tables per run,
// the per-seed run offsets and the nte64 multipliers), so S and the run
// counts are runtime values. The grid is 1-D with 64-bit thread indices and
// every offset is 64-bit (the BASELINE planes pass 2^31 elements at ~2.5M
// reads per call).

#include <cuda_runtime.h>

#include "roll.cuh"

namespace {

using nthash::code_at;
using nthash::srol1;
using nthash::sror1;

constexpr int kThreads = 256;
constexpr int kTabPerRun = 20;   // fwd_in, fwd_out, rev_in, rev_out: 5 each
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into

// tables: per run q, [20q, 20q+5) fwd_in, +5 fwd_out, +10 rev_in, +15 rev_out;
// then the num_hashes - 1 nte64 multipliers.
// meta: per run q, off_in at 2q and off_out at 2q + 1; then the S + 1 run
// offsets (seed s owns runs [meta[2*nruns + s], meta[2*nruns + s + 1])).
template <bool kBuckets>
__global__ void __launch_bounds__(kThreads)
seed_hash_kernel(const int* __restrict__ codes, int L, long long R, int k,
                 int nseeds, int nruns, int seg, long long nseg,
                 int num_hashes, int emit_fwd_rev, int bucket_bits,
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
    nthash::write_window<kBuckets>(
        out, first + static_cast<size_t>(t - k + 1) * R + r, plane, fwd, rev,
        inv == 0, num_hashes, emit_fwd_rev, bucket_bits, mult);
  }
}

template <bool kBuckets>
cudaError_t launch(const int* codes, int L, long long R, int k, int nseeds,
                   int nruns, int seg, int num_hashes, int emit_fwd_rev,
                   int bucket_bits, const unsigned long long* tables,
                   const int* meta, void* out, cudaStream_t stream) {
  const long long nseg = (static_cast<long long>(L - k + 1) + seg - 1) / seg;
  const long long blocks = (nseg * nseeds * R + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      static_cast<size_t>(nruns * kTabPerRun + num_hashes - 1) * sizeof(unsigned long long) +
      static_cast<size_t>(2 * nruns + nseeds + 1) * sizeof(int);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        seed_hash_kernel<kBuckets>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  seed_hash_kernel<kBuckets><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      codes, L, R, k, nseeds, nruns, seg, nseg, num_hashes, emit_fwd_rev,
      bucket_bits, tables, meta, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes: [L, R] int32 device; tables: 20 * nruns + num_hashes - 1 uint64
// device; meta: 2 * nruns + nseeds + 1 int32 device (layout above);
// out: [nseeds * per_seed, L - k + 1, R] uint64 (bucket_bits == 0; per_seed
// = num_hashes + 2 * emit_fwd_rev) or [nseeds * num_hashes, L - k + 1, R]
// int32 buckets; seg: windows per segment (>= 1; seg >= L - k + 1 is one
// segment per read). Launches on `stream` of `device`; returns
// cudaGetLastError().
int nthash_seed_hash(int device, const int* codes, int L, long long R, int k,
                     int nseeds, int nruns, int seg, int num_hashes,
                     int emit_fwd_rev, int bucket_bits,
                     const unsigned long long* tables, const int* meta,
                     void* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (seg < 1 || nseeds < 1 || nruns < nseeds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bucket_bits > 0) {
    err = launch<true>(codes, L, R, k, nseeds, nruns, seg, num_hashes, 0,
                       bucket_bits, tables, meta, out, stream);
  } else {
    err = launch<false>(codes, L, R, k, nseeds, nruns, seg, num_hashes,
                        emit_fwd_rev, 0, tables, meta, out, stream);
  }
  return static_cast<int>(err);
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
