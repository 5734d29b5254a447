// Exact int32 row histograms: private counters in shared memory merged once
// per block, or one global atomic add per update.
//
// Replaces nthash_tpu/ops/hist_pallas.py:133 _hist_kernel (reached through
// mxu_histogram_rows) and computes what it returns: for indices idx [R, N]
// int32 and optional int32 weights, shared [N] (row stride 0) or per row
// [R, N] (row stride N),
//   out[r, b] += w[r, n]  for every n with 0 <= idx[r, n] < width,
// into out [R, width] int32, which the caller zeroes or accumulates in (the
// count-min sketch's rows). Indices outside [0, width) are dropped by one
// unsigned compare. Sums wrap mod 2^32: shared and global atomicAdd on int
// are two's-complement additions, and so is the merge of a block's private
// sums, which is exactly what the TPU kernel's digit-plane recombination
// (hist_pallas.py:118-130) reproduces on the MXU. The TPU kernel keeps a
// tile of counters in VMEM across its sequential grid (its scratch,
// hist_pallas.py:142); a block's shared memory is the counterpart here.
//
// Two routes, chosen by the caller from the shapes alone (blocks_x > 0 or 0,
// ops/hist_kernel.py::private_counts_grid):
//
// Private counters (histogram_rows_private_kernel), widths 2^10..2^15. A
// block owns one row and one contiguous slice of its entries. It zeroes the
// row's 2^width_log2 counters in dynamic shared memory (4 KB at 2^10, 128 KB
// at 2^15), reads its slice with 16-byte loads (scalars for the unaligned
// head and the tail: a row may start anywhere and N need not be a multiple
// of 4), adds 1 or the weight to each in-range bucket by a shared-memory
// atomicAdd, and after a barrier merges: one global atomicAdd per non-zero
// counter. Block b works on row b % R, so the blocks in flight spread over
// all rows and their merges over all rows' counters. What bounds it: the
// bytes of its indices (and weights), each read once; the merge adds up to
// `width` atomics a block, so the caller gives every block at least two
// entries per counter (few, fat blocks).
//
// Direct atomics (histogram_rows_kernel), every width up to 2^30: a
// grid-stride loop, one fire-and-forget atomic (RED) per in-range update
// into the row in device memory. For rows whose counters do not fit a
// block's shared memory (2^16 and up) or whose entries are too few to pay
// for a merge. What bounds it: the L2's atomic unit, and badly so where the
// addresses are few. Blocks are scheduled x first, so every thread resident
// at one moment works on one row: at 2^14 on 64 KB of counters.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, per 1M
// reads of 150 bp at k = 32 and 4 hashes (476M updates): at 2^14, one
// [4, n] launch a batch, private 0.7384 ms and direct 6.6382 ms against
// 0.5687 ms for the bytes at 3.35 TB/s; the 2^20 plan's sub-histograms (512
// rows at 2^13) private 1.0495 ms, direct 4.5484 ms, bytes 0.8802 ms; at
// full width 2^20 direct 4.1321 ms (bytes 0.5734 ms), the L2's atomic rate.
// A hot bucket costs the direct route most: on one batch at 2^20, 1.09 ms
// as hashed, 12.23 ms with every eighth entry one value, 86.67 ms with all
// of them one value (atomics on one address serialise). The sort-partitioned
// histogram overflows its windows there and falls back to this same launch,
// so it is slower still (17.17 and 91.29 ms).
//
// The optional `gate` (one device int) lets a caller choose between two
// launches on the device, as the TPU path's lax.cond does: where *gate == 0
// every block returns at once and nothing is counted. The sort-partitioned
// path (part_kernel.py) gates its sub-histograms and its full-width skew
// fallback on the overflow flags that partition.cu writes, so the host never
// waits on the flag.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;
constexpr long long kMaxBlocksY = 65535;
constexpr int kPrivateMaxThreads = 1024;
constexpr int kPrivateMaxWidthLog2 = 15;
constexpr int kMaxSharedBytes = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
histogram_rows_kernel(const int* __restrict__ idx, long long R, long long N,
                      const int* __restrict__ weight, long long weight_stride,
                      unsigned width, int* __restrict__ out,
                      const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const int* row = idx + r * N;
    const int* wrow = weight ? weight + r * weight_stride : nullptr;
    int* orow = out + r * static_cast<long long>(width);
    for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         n < N; n += step) {
      const unsigned b = static_cast<unsigned>(row[n]);
      if (b < width) atomicAdd(orow + b, wrow ? wrow[n] : 1);
    }
  }
}

// Add w to bucket b of the block's private counters, if b is in range.
__device__ __forceinline__ void add_private(int* counts, int b, int w,
                                            unsigned width) {
  if (static_cast<unsigned>(b) < width) atomicAdd(counts + b, w);
}

// Block x counts entries [(x / R) * per_block, (x / R + 1) * per_block) of
// row x % R into `width` private counters, then merges them into the row.
__global__ void __launch_bounds__(kPrivateMaxThreads)
histogram_rows_private_kernel(const int* __restrict__ idx, long long R,
                              long long N, const int* __restrict__ weight,
                              long long weight_stride, unsigned width,
                              int* __restrict__ out,
                              const int* __restrict__ gate,
                              long long per_block) {
  if (gate && *gate == 0) return;
  extern __shared__ int counts[];
  const long long r = blockIdx.x % R;
  const long long lo = (blockIdx.x / R) * per_block;
  if (lo >= N) return;
  const long long len = (lo + per_block < N ? lo + per_block : N) - lo;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (unsigned b = tid; b < width; b += nt) counts[b] = 0;
  __syncthreads();
  const int* p = idx + r * N + lo;
  const int* wp = weight ? weight + r * weight_stride + lo : nullptr;
  // scalars up to the first 16-byte boundary, int4s, then the scalar tail
  long long head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2;
  if (head > len) head = len;
  const long long nvec = (len - head) >> 2;
  const long long tail = head + (nvec << 2);
  for (long long i = tid; i < head; i += nt) {
    add_private(counts, p[i], wp ? wp[i] : 1, width);
  }
  for (long long i = tail + tid; i < len; i += nt) {
    add_private(counts, p[i], wp ? wp[i] : 1, width);
  }
  const int4* v = reinterpret_cast<const int4*>(p + head);
  // four loads in flight per thread before their counts are added; the
  // weights need not share the indices' alignment, so they load as scalars
  for (long long i = tid; i < nvec; i += 4LL * nt) {
    int4 q[4];
    int4 wq[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + static_cast<long long>(u) * nt;
      q[u] = j < nvec ? v[j] : make_int4(-1, -1, -1, -1);
      wq[u] = make_int4(1, 1, 1, 1);
      if (wp && j < nvec) {
        const int* ww = wp + head + (j << 2);
        wq[u] = make_int4(ww[0], ww[1], ww[2], ww[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      add_private(counts, q[u].x, wq[u].x, width);
      add_private(counts, q[u].y, wq[u].y, width);
      add_private(counts, q[u].z, wq[u].z, width);
      add_private(counts, q[u].w, wq[u].w, width);
    }
  }
  __syncthreads();
  // adding a zero sum is a no-op, so only non-zero counters are merged
  int* orow = out + r * static_cast<long long>(width);
  for (unsigned b = tid; b < width; b += nt) {
    const int c = counts[b];
    if (c != 0) atomicAdd(orow + b, c);
  }
}

}  // namespace

extern "C" {

// idx: [R, N] int32 device; weight: nullptr, [N] (weight_stride 0) or [R, N]
// (weight_stride N) int32 device; out: [R, 2^width_log2] int32 device, added
// into; gate: nullptr, or one device int that must be non-zero for anything
// to be counted. blocks_x == 0: direct atomics. blocks_x > 0: private
// counters, blocks_x blocks of `threads` threads (a multiple of 32, at most
// 1,024) per row, 2^width_log2 * 4 bytes of shared memory each (so
// width_log2 <= 15). Launches on `stream` of `device`; returns
// cudaGetLastError().
int nthash_histogram_rows(int device, const int* idx, long long R, long long N,
                          const int* weight, long long weight_stride,
                          int width_log2, int* out, const int* gate,
                          long long blocks_x, int threads,
                          cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_x == 0) {
    long long bx = (N + kThreads - 1) / kThreads;
    if (bx > kMaxBlocksX) bx = kMaxBlocksX;
    const dim3 grid(static_cast<unsigned>(bx),
                    static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY));
    histogram_rows_kernel<<<grid, kThreads, 0, stream>>>(
        idx, R, N, weight, weight_stride, 1u << width_log2, out, gate);
    return static_cast<int>(cudaGetLastError());
  }
  if (width_log2 > kPrivateMaxWidthLog2 || threads < 32 ||
      threads > kPrivateMaxThreads || threads % 32 != 0 || blocks_x < 0 ||
      R < 1 || blocks_x > 0x7fffffffLL / R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(histogram_rows_private_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // slices of whole int4s, so an aligned row keeps every slice aligned
  long long per = (N + blocks_x - 1) / blocks_x;
  per = (per + 3) & ~3LL;
  histogram_rows_private_kernel<<<static_cast<unsigned>(blocks_x * R),
                                  threads, static_cast<size_t>(4) << width_log2,
                                  stream>>>(
      idx, R, N, weight, weight_stride, 1u << width_log2, out, gate, per);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
