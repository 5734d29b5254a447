// Probe of a packed Bloom filter by the buckets the hash kernels emit: per
// seed, the windows of each read whose bits are all set.
//
// Replaces no TPU kernel. The JAX package queries a filter with
// nthash_tpu/models/bloom.py::contains, a jnp gather over uint64 hashes, and
// the port's models/bloom.contains is the same few PyTorch gathers; at a
// screening batch (2^18 reads of 150 bp, 4 seeds x 4 hashes) they would
// first need the 16 planes as int64 hashes, 4 GB a batch. This kernel reads
// the int32 buckets that csrc/seed_hash.cu emits in bucket mode, in their
// seed-major planes [S * h, W, R] (plane j * h + i holds hash i of seed j),
// and for every read r and seed j adds into out[j, r] the number of windows
// w for which every bucket b = planes[j * h + i][w, r], i < h, lies in
// [0, width) and has its bit set,
//   (words[word_index(b)] >> bit_index(b)) & 1,
//   word_index(b) = ((b >> 12) << 7) | (b & 127),  bit_index(b) = (b >> 7) & 31
// (the filter's layout, bloom.cu). The sentinel `width` of a window holding
// an invalid base, and anything else outside [0, width), is a miss.
//
// What bounds it on the H100: the buckets' bytes, each read once (2 GB a
// batch at the sizes above, 0.6 ms at 3.35 TB/s), and the rate at which the
// L2 serves random 32-byte sectors to the gathers, one a bucket tested: a
// filter of up to 2^28 bits (32 MiB) fits the 50 MB L2, and the
// words of one window are unrelated. The design: one thread per (read,
// seed), so a warp's bucket loads are 128 contiguous bytes of one plane and
// its count stays in a register, with one writer a counter and no atomics.
// The buckets are loaded with the streaming hint (ld.global.cs): they pass
// through the L2 once and are evicted first, which leaves the filter's
// lines resident. A window's hashes are tested in turn and the test stops
// at the first zero bit, so a window that misses costs about one gather: on
// an H100, one batch of the sizes above at 2^28 takes 1.87 ms in reads that
// miss (0.3% of windows hit) against 5.12 ms with all h loads and gathers of
// a window issued together, and 4.95 against 5.11 ms in reads of the
// filter's genome (94% hit), where the threads in flight hide the chain of
// round trips. The count is exact.
//
// Filters past 2^31 bits (to 2^38, 32 GiB) take int64 buckets and word
// offsets past 32 bits: bloom_probe_wide_kernel, the same body on 64-bit
// buckets. Such a filter lies in device memory, not in the L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxSeeds = 65535;  // the grid's y extent

// The filter's layout for a bucket b of unsigned type U: 32 bits for the
// int32 buckets, 64 for the wide ones, whose word offsets pass 32 bits.
template <typename U>
__device__ __forceinline__ U word_of(U b) {
  return ((b >> 12) << 7) | (b & 127u);
}

template <typename U>
__device__ __forceinline__ unsigned bit_of(U b) {
  return static_cast<unsigned>((b >> 7) & 31u);
}

// The body of the probe's instances, buckets of type B read as U.
// buckets: plane q = j * h + i starts at buckets + q * plane, window w of
// read r at w * R + r. out: seed j's counts at out + j * pitch.
template <typename B, typename U>
__device__ __forceinline__ void
probe_windows(const B* __restrict__ buckets, long long plane, int h,
              long long W, long long R, const unsigned* __restrict__ words,
              U width, int* __restrict__ out, long long pitch) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= R) return;
  const B* first = buckets + static_cast<long long>(blockIdx.y) * h * plane + r;
  int hits = 0;
#pragma unroll 2
  for (long long w = 0; w < W; ++w) {
    const B* at = first + w * R;
    bool hit = true;
    for (int i = 0; i < h && hit; ++i) {
      const U b = static_cast<U>(__ldcs(at + i * plane));
      hit = b < width && ((__ldg(words + word_of(b)) >> bit_of(b)) & 1u);
    }
    hits += hit;
  }
  out[blockIdx.y * pitch + r] += hits;
}

__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const int* __restrict__ buckets, long long plane, int h,
                   long long W, long long R, const unsigned* __restrict__ words,
                   unsigned width, int* __restrict__ out, long long pitch) {
  probe_windows<int, unsigned>(buckets, plane, h, W, R, words, width, out,
                               pitch);
}

// The wide probe: int64 buckets (seed_hash.cu's wide buckets) into a filter
// of up to 2^38 bits. Past 2^28 bits the filter no longer fits the L2, so
// each bucket tested is a random 32-byte sector of device memory.
__global__ void __launch_bounds__(kThreads)
bloom_probe_wide_kernel(const long long* __restrict__ buckets,
                        long long plane, int h, long long W, long long R,
                        const unsigned* __restrict__ words,
                        unsigned long long width, int* __restrict__ out,
                        long long pitch) {
  probe_windows<long long, unsigned long long>(buckets, plane, h, W, R, words,
                                               width, out, pitch);
}

bool valid_shape(int nseeds, int h, long long W, long long R, long long plane,
                 long long pitch) {
  return nseeds >= 1 && nseeds <= kMaxSeeds && h >= 1 && W >= 0 && R >= 0 &&
         plane >= W * R && pitch >= R &&
         (R + kThreads - 1) / kThreads <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// buckets: nseeds * h planes of [W, R] int32 device, plane q at buckets + q *
// plane (plane >= W * R); words: [2^width_log2 / 32] 32-bit device words,
// width_log2 in [12, 30]; out: [nseeds, R] int32 device, seed j's row at out
// + j * pitch (pitch >= R), added into. Launches on `stream` of `device`;
// returns cudaGetLastError().
int nthash_bloom_probe(int device, const int* buckets, long long plane,
                       int nseeds, int h, long long W, long long R,
                       const unsigned* words, int width_log2, int* out,
                       long long pitch, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(nseeds, h, W, R, plane, pitch) || width_log2 < 12 ||
      width_log2 > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (W == 0 || R == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(nseeds));
  bloom_probe_kernel<<<grid, kThreads, 0, stream>>>(
      buckets, plane, h, W, R, words, 1u << width_log2, out, pitch);
  return static_cast<int>(cudaGetLastError());
}

// As nthash_bloom_probe, over int64 buckets into words [2^width_log2 / 32],
// width_log2 in [12, 38].
int nthash_bloom_probe_wide(int device, const long long* buckets,
                            long long plane, int nseeds, int h, long long W,
                            long long R, const unsigned* words, int width_log2,
                            int* out, long long pitch, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(nseeds, h, W, R, plane, pitch) || width_log2 < 12 ||
      width_log2 > 38) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (W == 0 || R == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((R + kThreads - 1) / kThreads),
                  static_cast<unsigned>(nseeds));
  bloom_probe_wide_kernel<<<grid, kThreads, 0, stream>>>(
      buckets, plane, h, W, R, words, 1ULL << width_log2, out, pitch);
  return static_cast<int>(cudaGetLastError());
}

const char* nthash_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
