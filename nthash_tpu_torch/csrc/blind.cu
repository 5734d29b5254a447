// Blind rolling of B independent walks over caller-fed base streams: the
// batched BlindNtHash / BlindSeedNtHash roll (ops/blind_scan.py and
// ops/blind_seed_scan.py roll_many).
//
// Replaces nthash_tpu/ops/blind_scan.py::roll_many and
// nthash_tpu/ops/blind_seed_scan.py::roll_many, which are lax.scan engines,
// not Pallas kernels: the TPU compiles the T-step scan into one program. In
// plain PyTorch that scan is T Python steps of about a dozen launches each,
// and each step also shifts the [B, k] window; this kernel is its counterpart
// on the H100. It computes what they compute: for walk b with state (fwd,
// rev per seed) and window window[b, 0..k) (oldest base first), step t feeds
// chars[t, b] and, per seed, rolls
//   fwd = srol1(fwd) ^ fwd_in[c_enter] ^ fwd_out[c_leave]  (per care run)
//   rev = sror1(rev) ^ rev_in[c_enter] ^ rev_out[c_leave]
// with the two taps of every maximal care run [s, e) of the seed
// (seed_pallas.seed_taps: c_enter is base e of the rolled window's
// predecessor extended by the incoming base, c_leave base s), then writes the
// canonical hash fwd + rev and its num_hashes - 1 nte64 extensions into
// out[t, b, seed * num_hashes + i]. A k-mer is the seed of k care positions
// (one run [0, k)), so ops/blind_scan.py launches the same kernel with one
// seed. Codes outside 0-3 hash as the zero seed (the JAX lookup5); the
// window keeps the codes as given.
//
// One thread a walk. Base i of walk b's stream is window[b, i] for i < k and
// chars[i - k, b] after: before step t the window is stream[t .. t + k), the
// incoming base is stream[t + k], and a care run's taps are stream[t + e]
// and stream[t + s]. So the loop needs no [B, k] shift; the final window is
// stream[T .. T + k), written once at the end.
//
// What bounds it on the H100: bytes. A step is a few dozen integer ops a
// care run, while every step writes 8 * S * num_hashes bytes a walk (2.1 GB
// at B = 2^20, T = 64, h = 4) against 4 bytes of chars read. Threads take
// consecutive walks, so a warp's chars[t, :] loads are one 128-byte line; the
// window's rows (k ints a walk) are read and written once, strided by the
// walk, and the taps into it at t < k hit lines loaded just before.
//
// Two kernels, picked on the host from the shapes (blind_kernel.blind_warps):
// - blind_staged_kernel (the rule): a warp rolls 32 walks, every seed at
//   every step, the seeds' (fwd, rev) parked in shared memory between
//   steps, and the step's hashes go through a warp stage in shared memory:
//   the warp's 32 * S * num_hashes outputs of a step are one contiguous run
//   of out[t], written by 16-byte stores, every sector whole. (A thread
//   writing its own num_hashes values would cover each 32-byte sector in 8-
//   byte pieces, four store transactions where one does.)
// - blind_roll_kernel, where the stage and the states do not fit a block
//   beside the tables (hundreds of seeds or care runs): each thread rolls one
//   seed after the other in registers and writes its values itself.
// The tables (20 uint64 a care run) and the multipliers sit in shared
// memory in both.

#include <cuda_runtime.h>

#include <cstdint>

#include "roll.cuh"

namespace {

using nthash::srol1;
using nthash::sror1;

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may opt into

// Base i of walk b's stream: the window, then the fed bases.
__device__ __forceinline__ int stream_at(const int* __restrict__ window,
                                         const int* __restrict__ chars,
                                         long long B, int k, long long b,
                                         int i) {
  return i < k ? window[b * k + i]
               : chars[static_cast<long long>(i - k) * B + b];
}

__device__ __forceinline__ unsigned clamp_code(int c) {
  return min(static_cast<unsigned>(c), 4u);
}

// tables: per run q, [20q, 20q+5) fwd_in, +5 fwd_out, +10 rev_in, +15
// rev_out; then the num_hashes - 1 nte64 multipliers. meta: per run q, off_in
// = k - e at 2q and off_out = k - s at 2q + 1; then the S + 1 run offsets.
__global__ void __launch_bounds__(kThreads)
blind_roll_kernel(const int* __restrict__ chars, int T, long long B,
                  const int* __restrict__ window, int k, int nseeds,
                  int nruns, int num_hashes,
                  const unsigned long long* __restrict__ tables,
                  const int* __restrict__ meta,
                  const unsigned long long* __restrict__ fwd0,
                  const unsigned long long* __restrict__ rev0,
                  unsigned long long* __restrict__ out,
                  unsigned long long* __restrict__ fwd1,
                  unsigned long long* __restrict__ rev1,
                  int* __restrict__ window1) {
  extern __shared__ unsigned long long smem[];
  const int ntab = nruns * 20 + num_hashes - 1;
  const int nmeta = 2 * nruns + nseeds + 1;
  unsigned long long* tab = smem;
  int* m = reinterpret_cast<int*>(smem + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) m[i] = meta[i];
  __syncthreads();

  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned long long* mult = tab + nruns * 20;
  const int* starts = m + 2 * nruns;
  const long long per_walk = static_cast<long long>(nseeds) * num_hashes;

  for (int si = 0; si < nseeds; ++si) {
    unsigned long long f = fwd0[b * nseeds + si];
    unsigned long long r = rev0[b * nseeds + si];
    const int q0 = starts[si], q1 = starts[si + 1];
    for (int t = 0; t < T; ++t) {
      f = srol1(f);
      r = sror1(r);
      for (int q = q0; q < q1; ++q) {
        const unsigned ce = clamp_code(stream_at(window, chars, B, k, b, t + k - m[2 * q]));
        const unsigned cl = clamp_code(stream_at(window, chars, B, k, b, t + k - m[2 * q + 1]));
        const unsigned long long* tq = tab + 20 * q;
        f ^= tq[ce] ^ tq[5 + cl];
        r ^= tq[10 + ce] ^ tq[15 + cl];
      }
      const unsigned long long canon = f + r;
      unsigned long long* o =
          out + (static_cast<long long>(t) * B + b) * per_walk + si * num_hashes;
      o[0] = canon;
      for (int h = 1; h < num_hashes; ++h) {
        unsigned long long e = canon * mult[h - 1];
        e ^= e >> nthash::kMultiShift;
        o[h] = e;
      }
    }
    fwd1[b * nseeds + si] = f;
    rev1[b * nseeds + si] = r;
  }
  for (int j = 0; j < k; ++j) {
    window1[b * k + j] = stream_at(window, chars, B, k, b, T + j);
  }
}

// Shared memory of blind_staged_kernel: the tables (as blind_roll_kernel's,
// rounded to 16 bytes), then per warp its seeds' states ([S][32] (fwd, rev))
// and its output stage (32 * S * num_hashes uint64).
__host__ __device__ inline size_t staged_tables_bytes(int nseeds, int nruns,
                                                      int num_hashes) {
  const size_t b = static_cast<size_t>(nruns * 20 + num_hashes - 1) * 8 +
                   static_cast<size_t>(2 * nruns + nseeds + 1) * 4;
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline size_t staged_warp_bytes(int nseeds,
                                                    int num_hashes) {
  return static_cast<size_t>(nseeds) * 32 * 16 +
         static_cast<size_t>(nseeds) * num_hashes * 32 * 8;
}

__global__ void __launch_bounds__(kThreads)
blind_staged_kernel(const int* __restrict__ chars, int T, long long B,
                    const int* __restrict__ window, int k, int nseeds,
                    int nruns, int num_hashes,
                    const unsigned long long* __restrict__ tables,
                    const int* __restrict__ meta,
                    const unsigned long long* __restrict__ fwd0,
                    const unsigned long long* __restrict__ rev0,
                    unsigned long long* __restrict__ out,
                    unsigned long long* __restrict__ fwd1,
                    unsigned long long* __restrict__ rev1,
                    int* __restrict__ window1) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int ntab = nruns * 20 + num_hashes - 1;
  const int nmeta = 2 * nruns + nseeds + 1;
  unsigned long long* tab = reinterpret_cast<unsigned long long*>(sm);
  int* m = reinterpret_cast<int*>(tab + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) m[i] = meta[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * 32;
  if (b0 >= B) return;  // whole warps only
  const long long b = b0 + lane;
  const bool live = b < B;
  const int per_walk = nseeds * num_hashes;
  const int nw = static_cast<int>(min(32LL, B - b0));
  unsigned char* mine =
      sm + staged_tables_bytes(nseeds, nruns, num_hashes) +
      warp * staged_warp_bytes(nseeds, num_hashes);
  ulonglong2* state = reinterpret_cast<ulonglong2*>(mine);  // [S][32]
  unsigned long long* stage =
      reinterpret_cast<unsigned long long*>(mine + nseeds * 32 * 16);
  const unsigned long long* mult = tab + nruns * 20;
  const int* starts = m + 2 * nruns;
  if (live) {
    for (int si = 0; si < nseeds; ++si) {
      state[si * 32 + lane] =
          make_ulonglong2(fwd0[b * nseeds + si], rev0[b * nseeds + si]);
    }
  }
  const int n = nw * per_walk;  // the warp's outputs of a step
  for (int t = 0; t < T; ++t) {
    if (live) {
      for (int si = 0; si < nseeds; ++si) {
        const ulonglong2 st = state[si * 32 + lane];
        unsigned long long f = srol1(st.x), r = sror1(st.y);
        for (int q = starts[si]; q < starts[si + 1]; ++q) {
          const unsigned ce = clamp_code(stream_at(window, chars, B, k, b, t + k - m[2 * q]));
          const unsigned cl = clamp_code(stream_at(window, chars, B, k, b, t + k - m[2 * q + 1]));
          const unsigned long long* tq = tab + 20 * q;
          f ^= tq[ce] ^ tq[5 + cl];
          r ^= tq[10 + ce] ^ tq[15 + cl];
        }
        state[si * 32 + lane] = make_ulonglong2(f, r);
        const unsigned long long canon = f + r;
        unsigned long long* o = stage + lane * per_walk + si * num_hashes;
        o[0] = canon;
        for (int h = 1; h < num_hashes; ++h) {
          unsigned long long e = canon * mult[h - 1];
          e ^= e >> nthash::kMultiShift;
          o[h] = e;
        }
      }
    }
    __syncwarp();
    unsigned long long* dst =
        out + (static_cast<long long>(t) * B + b0) * per_walk;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      const ulonglong2* src2 = reinterpret_cast<const ulonglong2*>(stage);
      ulonglong2* dst2 = reinterpret_cast<ulonglong2*>(dst);
      for (int i = lane; i < n / 2; i += 32) dst2[i] = src2[i];
      if ((n & 1) && lane == 0) dst[n - 1] = stage[n - 1];
    } else {
      for (int i = lane; i < n; i += 32) dst[i] = stage[i];
    }
    __syncwarp();
  }
  if (!live) return;
  for (int si = 0; si < nseeds; ++si) {
    const ulonglong2 st = state[si * 32 + lane];
    fwd1[b * nseeds + si] = st.x;
    rev1[b * nseeds + si] = st.y;
  }
  for (int j = 0; j < k; ++j) {
    window1[b * k + j] = stream_at(window, chars, B, k, b, T + j);
  }
}

}  // namespace

extern "C" {

// chars: [T, B] int32; window: [B, k] int32; fwd0, rev0: [B, nseeds] uint64;
// out: [T, B, nseeds * num_hashes] uint64; fwd1, rev1, window1 as fwd0, rev0,
// window. tables, meta as above, device. warps: warps a block of
// blind_staged_kernel (1-8), or 0 for blind_roll_kernel. Launches on `stream`
// of `device`; returns cudaGetLastError().
int nthash_blind_roll(int device, const int* chars, int T, long long B,
                      const int* window, int k, int nseeds, int nruns,
                      int num_hashes, const unsigned long long* tables,
                      const int* meta, const unsigned long long* fwd0,
                      const unsigned long long* rev0, unsigned long long* out,
                      unsigned long long* fwd1, unsigned long long* rev1,
                      int* window1, int warps, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 0 || k < 1 || nseeds < 1 || nruns < nseeds || num_hashes < 1 ||
      warps < 0 || warps > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (warps > 0) {
    const long long blocks = ((B + 31) / 32 + warps - 1) / warps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const size_t smem = staged_tables_bytes(nseeds, nruns, num_hashes) +
                        warps * staged_warp_bytes(nseeds, num_hashes);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(blind_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blind_staged_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
        chars, T, B, window, k, nseeds, nruns, num_hashes, tables, meta, fwd0,
        rev0, out, fwd1, rev1, window1);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem =
      static_cast<size_t>(nruns * 20 + num_hashes - 1) * sizeof(unsigned long long) +
      static_cast<size_t>(2 * nruns + nseeds + 1) * sizeof(int);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(blind_roll_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blind_roll_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      chars, T, B, window, k, nseeds, nruns, num_hashes, tables, meta, fwd0,
      rev0, out, fwd1, rev1, window1);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
