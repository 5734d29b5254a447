// Unpack the 2-bit host->device wire format into the hash kernels' layout.
//
// No TPU kernel stands behind this one: the JAX package unpacks in jnp,
// outside any Pallas kernel (nthash_tpu/parallel/dp.py:86 unpack_codes_tm,
// reached through fused_count_packed when PipelineConfig.pack_h2d is set).
// It computes, for packed [B, P] uint8 (P = ceil(L/4)) and nmask [B, M]
// uint8 (M = ceil(ceil4(L)/8)), both row-major and contiguous,
//   out[p, b] = 4                                   if bit p & 7 of
//                                                   nmask[b, p >> 3] is set,
//             = (packed[b, p >> 2] >> 2 * (p & 3)) & 3  otherwise,
// into out [L, B] int32, time-major, as ops/kmer_kernel.py::prepare_codes
// lays out unpacked codes.
//
// What bounds it: bytes. A read moves P + M bytes in and 4 L out, so the
// output is 92% of the traffic at L = 150. The transpose is the difficulty:
// a read's bytes are contiguous on input, a position's reads on output. A
// block takes 128 reads x 128 positions. It stages their 32 packed bytes
// and 16 bitmap bytes a read into shared memory (a warp loads one read's 32
// bytes at a time), rows padded to an odd number of 32-bit words so that
// the 32 reads a warp reads next fall in 32 banks; then each warp writes
// one position for 32 consecutive reads, one coalesced 128-byte store.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kReads = 128;                     // reads a block
constexpr int kPositions = 128;                 // positions a block
constexpr int kThreads = 256;
constexpr int kPackedBytes = kPositions / 4;    // 32 bytes a read
constexpr int kMaskBytes = kPositions / 8;      // 16 bytes a read
constexpr int kPackedPitch = kPackedBytes + 4;  // 9 words
constexpr int kMaskPitch = kMaskBytes + 4;      // 5 words
constexpr long long kMaxBlocksX = 0x7fffffffLL;
constexpr int kMaxBlocksY = 65535;

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ packed, int packed_width,
              const uint8_t* __restrict__ nmask, int mask_width, int length,
              long long reads, int* __restrict__ out) {
  __shared__ uint8_t sp[kReads * kPackedPitch];
  __shared__ uint8_t sm[kReads * kMaskPitch];
  const long long b0 = static_cast<long long>(blockIdx.x) * kReads;
  const int p0 = blockIdx.y * kPositions;
  const int pc0 = p0 / 4;
  const int mc0 = p0 / 8;
  for (int j = threadIdx.x; j < kReads * kPackedBytes; j += kThreads) {
    const int r = j / kPackedBytes;
    const int c = j % kPackedBytes;
    const long long b = b0 + r;
    uint8_t v = 0;
    if (b < reads && pc0 + c < packed_width) {
      v = packed[b * packed_width + pc0 + c];
    }
    sp[r * kPackedPitch + c] = v;
  }
  for (int j = threadIdx.x; j < kReads * kMaskBytes; j += kThreads) {
    const int r = j / kMaskBytes;
    const int c = j % kMaskBytes;
    const long long b = b0 + r;
    uint8_t v = 0;
    if (b < reads && mc0 + c < mask_width) {
      v = nmask[b * mask_width + mc0 + c];
    }
    sm[r * kMaskPitch + c] = v;
  }
  __syncthreads();
  const int r = threadIdx.x % kReads;
  const long long b = b0 + r;
  if (b >= reads) return;
  const int end = min(kPositions, length - p0);
  for (int p = threadIdx.x / kReads; p < end; p += kThreads / kReads) {
    int code = (sp[r * kPackedPitch + (p >> 2)] >> (2 * (p & 3))) & 3;
    if ((sm[r * kMaskPitch + (p >> 3)] >> (p & 7)) & 1) code = 4;
    out[static_cast<long long>(p0 + p) * reads + b] = code;
  }
}

}  // namespace

extern "C" {

// packed: [reads, packed_width] uint8 device, packed_width = ceil(length/4);
// nmask: [reads, mask_width] uint8 device, mask_width = ceil(ceil4(length)/8);
// out: [length, reads] int32 device, written whole. Launches on `stream` of
// `device`; returns cudaGetLastError() (cudaErrorInvalidValue for shapes
// the grid cannot cover).
int nthash_unpack_codes(int device, const uint8_t* packed, int packed_width,
                        const uint8_t* nmask, int mask_width, int length,
                        long long reads, int* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bx = (reads + kReads - 1) / kReads;
  const long long by = (static_cast<long long>(length) + kPositions - 1) /
                       kPositions;
  if (length < 1 || reads < 1 || bx > kMaxBlocksX || by > kMaxBlocksY ||
      packed_width < (length + 3) / 4 ||
      mask_width * 8LL < 4LL * ((length + 3) / 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  unpack_kernel<<<grid, kThreads, 0, stream>>>(packed, packed_width, nmask,
                                               mask_width, length, reads, out);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
