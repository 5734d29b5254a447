// Exact int32 row histograms by global atomics.
//
// Replaces nthash_tpu/ops/hist_pallas.py::_hist_kernel (mxu_histogram_rows)
// and computes what it returns: for indices idx [R, N] int32 and optional
// int32 weights, shared [N] (row stride 0) or per row [R, N] (row stride N),
//   out[r, b] += w[r, n]  for every n with 0 <= idx[r, n] < width,
// into out [R, width] int32, which the caller zeroes or accumulates in
// (the count-min sketch's rows). Indices outside
// [0, width) are dropped; sums wrap mod 2^32 because atomicAdd on int is
// two's-complement addition, which is exactly what the TPU kernel's digit-plane
// recombination (hist_pallas.py:118-130) reproduces on the MXU.
//
// What bounds it on the H100: L2 atomic throughput. Each update is one
// 4-byte read of its index (coalesced, streamed once) and one fire-and-forget
// reduction (RED) into the counters; at width 2^14 x 4 rows the 256 KiB of
// counters sit in the 50 MB L2, so the atomics never reach device memory but
// serialise in L2 where updates collide. The design is the simplest exact
// one: a grid-stride loop over each row, rows on the grid's y axis, no
// one-hot matmuls, digit planes, chunk padding or weight_bits. Privatising
// the counters in shared memory, or fusing these atomics into the hash
// kernel, is left to a later change.
//
// The optional `gate` (one device int) lets a caller choose between two
// launches on the device, as the TPU path's lax.cond does: where *gate == 0
// every block returns at once and nothing is counted. The sort-partitioned
// path (part_kernel.py) gates its sub-histograms and its full-width skew
// fallback on the overflow flags that partition.cu writes, so the host never
// waits on the flag.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;
constexpr long long kMaxBlocksY = 65535;

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

}  // namespace

extern "C" {

// idx: [R, N] int32 device; weight: nullptr, [N] (weight_stride 0) or [R, N]
// (weight_stride N) int32 device; out: [R, 2^width_log2] int32 device, added
// into; gate: nullptr, or one device int that must be non-zero for anything
// to be counted. Launches on `stream` of `device`; returns cudaGetLastError().
int nthash_histogram_rows(int device, const int* idx, long long R, long long N,
                          const int* weight, long long weight_stride,
                          int width_log2, int* out, const int* gate,
                          cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long bx = (N + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx),
                  static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY));
  histogram_rows_kernel<<<grid, kThreads, 0, stream>>>(
      idx, R, N, weight, weight_stride, 1u << width_log2, out, gate);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
