// Bit-packed presence (Bloom filter words) by global atomic ORs.
//
// Replaces nthash_tpu/ops/hist_pallas.py::_bloom_kernel (mxu_bloom_words)
// and ::_bloom_rows_kernel (mxu_bloom_words_rows) and computes what they
// return: for indices idx [R, N] int32 and, for one row, an optional int32
// weight [N] (non-zero = present),
//   words[r, word_index(b)] |= 1 << bit_index(b)   for every b = idx[r, n]
//                                                  with 0 <= b < width,
// into words [R, width / 32] (uint32 bit patterns in the caller's int32
// tensor), which the caller zeroes or accumulates in (the filter itself).
// The layout is the JAX package's: bucket b = q * 4096 + s * 128 + j lives
// in word q * 128 + j at bit s,
//   word_index(b) = ((b >> 12) << 7) | (b & 127),  bit_index(b) = (b >> 7) & 31,
// which the TPU chose so that it packs 32 sublanes of a count tile into one
// word; here it is only an address computation. Indices outside [0, width)
// are dropped by one unsigned compare, so -1, the sentinel `width` and
// anything above it never set a bit; width reaches 2^31 (a full 2^31-bit
// filter, 256 MB of words), where the sentinel no longer fits an int32 and
// callers fold invalid updates to -1.
//
// What bounds it on the H100: L2 atomic throughput. Each update is one
// coalesced 4-byte read of its index and one fire-and-forget reduction (RED)
// into the words; at width 2^17 the 16 KB of words sit in L2 and every
// update of the whole stream lands on one of 4,096 words, so collisions
// serialise there. OR is idempotent and commutative, so the result is exact
// whatever order the atomics land in. The design is the simplest exact one:
// a grid-stride loop per row, rows on the grid's y axis (one row for
// mxu_bloom_words, one per partition under the sort-partitioned path), no
// one-hot matmuls, VMEM count tiles or 32-sublane pack. A private word array
// in shared memory for widths up to 2^18 (32 KB), or a test of the bit
// before the atomic, is left to a later change.
//
// The optional `gate` (one device int) works as in histogram.cu: where
// *gate == 0 every block returns at once. The partitioned path gates its
// per-partition launch and its full-width skew fallback on the overflow
// flags from partition.cu, so the host never waits on them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;
constexpr long long kMaxBlocksY = 65535;

__global__ void __launch_bounds__(kThreads)
bloom_rows_kernel(const int* __restrict__ idx, long long R, long long N,
                  const int* __restrict__ weight, unsigned width,
                  unsigned* __restrict__ words, const int* __restrict__ gate) {
  if (gate && *gate == 0) return;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // 64-bit row offset: at 2^30 with 8,192 partitions the rows hold 2^25 words
  const long long row_words = static_cast<long long>(width >> 5);
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const int* row = idx + r * N;
    unsigned* wrow = words + r * row_words;
    for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         n < N; n += step) {
      const unsigned b = static_cast<unsigned>(row[n]);
      if (b < width && (!weight || weight[n] != 0)) {
        atomicOr(wrow + (((b >> 12) << 7) | (b & 127u)), 1u << ((b >> 7) & 31u));
      }
    }
  }
}

}  // namespace

extern "C" {

// idx: [R, N] int32 device; weight: nullptr or [N] int32 device (R must be 1);
// words: [R, 2^width_log2 / 32] 32-bit device words, OR-ed into; width_log2
// in [12, 31]; gate: nullptr, or one device int that must be non-zero for
// anything to be set. Launches on `stream` of `device`; returns
// cudaGetLastError().
int nthash_bloom_words_rows(int device, const int* idx, long long R, long long N,
                            const int* weight, int width_log2, unsigned* words,
                            const int* gate, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long bx = (N + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx),
                  static_cast<unsigned>(R < kMaxBlocksY ? R : kMaxBlocksY));
  bloom_rows_kernel<<<grid, kThreads, 0, stream>>>(
      idx, R, N, weight, 1u << width_log2, words, gate);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
