// What kmer_hash.cu and seed_hash.cu share: ntHash2's split rotations, the
// code clamp, the writes of one window's outputs, and the staged roll: a
// warp's codes as uint8 rows in shared memory, rolled through 25-entry pair
// tables, with the one-sequence entry that both files instantiate.
#pragma once

#include <cuda_runtime.h>

namespace nthash {

constexpr unsigned long long kMask33 = (1ULL << 33) - 1;
constexpr unsigned long long kMask31 = (1ULL << 31) - 1;
constexpr int kMultiShift = 27;  // nte64 MULTISHIFT

// Split-rotate left by 1: bits 0..32 and bits 33..63 rotate independently.
__device__ __forceinline__ unsigned long long srol1(unsigned long long x) {
  unsigned long long lo = x & kMask33, hi = x >> 33;
  lo = ((lo << 1) | (lo >> 32)) & kMask33;
  hi = ((hi << 1) | (hi >> 30)) & kMask31;
  return (hi << 33) | lo;
}

__device__ __forceinline__ unsigned long long sror1(unsigned long long x) {
  unsigned long long lo = x & kMask33, hi = x >> 33;
  lo = ((lo >> 1) | (lo << 32)) & kMask33;
  hi = ((hi >> 1) | (hi << 30)) & kMask31;
  return (hi << 33) | lo;
}

// codes[i] with every value above 4 (and any negative one) read as 4.
__device__ __forceinline__ unsigned code_at(const int* __restrict__ codes,
                                            long long i) {
  return min(static_cast<unsigned>(codes[i]), 4u);
}

// Writes one window's outputs at element `at` of plane 0, the planes `plane`
// elements apart: the canonical hash fwd + rev and its num_hashes - 1 nte64
// extensions (multipliers `mult`), then fwd and rev if emit_fwd_rev, as
// uint64; or, with kBuckets, the low bucket_bits bits of the num_hashes
// values as int32, each the sentinel 2^bucket_bits where !valid.
template <bool kBuckets>
__device__ __forceinline__ void write_window(
    void* __restrict__ out, size_t at, size_t plane, unsigned long long fwd,
    unsigned long long rev, bool valid, int num_hashes, int emit_fwd_rev,
    int bucket_bits, const unsigned long long* mult) {
  const unsigned long long canon = fwd + rev;
  if (kBuckets) {
    int* o = static_cast<int*>(out);
    const unsigned long long mask = (1ULL << bucket_bits) - 1;
    const int sentinel = 1 << bucket_bits;
    o[at] = valid ? static_cast<int>(canon & mask) : sentinel;
    for (int i = 1; i < num_hashes; ++i) {
      unsigned long long e = canon * mult[i - 1];
      e ^= e >> kMultiShift;
      o[i * plane + at] = valid ? static_cast<int>(e & mask) : sentinel;
    }
  } else {
    unsigned long long* o = static_cast<unsigned long long*>(out);
    o[at] = canon;
    for (int i = 1; i < num_hashes; ++i) {
      unsigned long long e = canon * mult[i - 1];
      e ^= e >> kMultiShift;
      o[i * plane + at] = e;
    }
    if (emit_fwd_rev) {
      o[num_hashes * plane + at] = fwd;
      o[(num_hashes + 1) * plane + at] = rev;
    }
  }
}

// ---------------------------------------------------------------------------
// The staged roll. A warp rolls 32 segments in step, one a lane: at step dt
// every lane takes row dt of its warp's ring, byte `lane`. The ring is a
// power of two of 32-byte rows (rmask = rows - 1), at least k + kRows, so it
// holds rows dt - k .. dt + kRows - 1 while kRows new rows are staged ahead.
// Rows -k .. -1 hold code 4 (the zero seed): a segment then starts from zero
// state and every tap applies from its first step, with no guard per tap,
// and an invalid count started at k is exact once the first window closes.
//
// A step of one seed XORs, for each maximal care run q, one 16-byte entry
// pairs[25 q + 5 c_in + c_out] = (fwd_in[c_in] ^ fwd_out[c_out],
// rev_in[c_in] ^ rev_out[c_out]) into the rotated state, where c_in and
// c_out are the codes off_in and off_out rows back (offs[q]): the two taps
// of seed_pallas.py:130-141 in one shared load. An ntHash2 k-mer is the seed
// of k care positions: one run, offsets 0 and k.

constexpr int kRows = 32;  // rows staged at a time

__device__ __forceinline__ unsigned char* ring_row(unsigned char* ring, int dt,
                                                   int rmask) {
  return ring + ((dt & rmask) << 5);
}

// Rows -k .. -1 of the ring to code 4.
__device__ __forceinline__ void ring_prefill(unsigned char* ring, int k,
                                             int rmask, int lane) {
  for (int i = lane; i < 8 * k; i += 32) {
    reinterpret_cast<unsigned*>(ring_row(ring, i / 8 - k, rmask))[i % 8] =
        0x04040404u;
  }
}

// Rows [dt0, dt0 + kRows) from time-major int32 codes [L, R]: row dt, byte
// lane holds base tb + dt of read r0 + lane, clamped to 4; a base at or past
// t_hi or a read at or past R reads 4. With vec (R % 4 == 0 and 16-byte
// aligned codes) lane l loads 16 bytes: reads r0 + 4 (l % 8) .. + 3 of rows
// l / 8 + 4 i, and stores them as one 4-byte word.
__device__ __forceinline__ void stage_tm(unsigned char* ring, int rmask,
                                         const int* __restrict__ codes,
                                         long long R, long long r0, int tb,
                                         int t_hi, int dt0, int lane, bool vec) {
  if (vec) {
    const int col = 4 * (lane & 7);
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int dt = dt0 + (lane >> 3) + 4 * i;
      const int t = tb + dt;
      unsigned packed = 0x04040404u;
      if (t < t_hi && r0 + col < R) {
        const int4 v = *reinterpret_cast<const int4*>(
            codes + static_cast<long long>(t) * R + r0 + col);
        packed = min(static_cast<unsigned>(v.x), 4u) |
                 min(static_cast<unsigned>(v.y), 4u) << 8 |
                 min(static_cast<unsigned>(v.z), 4u) << 16 |
                 min(static_cast<unsigned>(v.w), 4u) << 24;
      }
      reinterpret_cast<unsigned*>(ring_row(ring, dt, rmask))[lane & 7] = packed;
    }
  } else {
    for (int i = 0; i < kRows; ++i) {
      const int t = tb + dt0 + i;
      unsigned c = 4;
      if (t < t_hi && r0 + lane < R) {
        c = code_at(codes, static_cast<long long>(t) * R + r0 + lane);
      }
      ring_row(ring, dt0 + i, rmask)[lane] = static_cast<unsigned char>(c);
    }
  }
}

// Rows [dt0, dt0 + kRows) from a flat uint8 sequence of C codes: row dt,
// byte lane holds base base + dt, clamped to 4; bases at or past C read 4.
// With vec (base + dt0 a multiple of 16 in a 16-byte aligned sequence) the
// lane's 32 bases come in two 16-byte loads.
__device__ __forceinline__ void stage_flat(unsigned char* ring, int rmask,
                                           const unsigned char* __restrict__ seq,
                                           long long C, long long base, int dt0,
                                           int lane, bool vec) {
  const long long p = base + dt0;
  if (vec && p + kRows <= C) {
    const uint4* src = reinterpret_cast<const uint4*>(seq + p);
    const uint4 a = src[0], b = src[1];
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned v = __vminu4(w[i], 0x04040404u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ring_row(ring, dt0 + 4 * i + j, rmask)[lane] =
            static_cast<unsigned char>(v >> (8 * j));
      }
    }
  } else {
    for (int i = 0; i < kRows; ++i) {
      const unsigned c = p + i < C ? min(static_cast<unsigned>(seq[p + i]), 4u) : 4u;
      ring_row(ring, dt0 + i, rmask)[lane] = static_cast<unsigned char>(c);
    }
  }
}

// One step of one seed (care runs [q0, q1)) at row dt.
__device__ __forceinline__ void roll_step(unsigned char* ring, int rmask,
                                          int lane, int dt, const int2* offs,
                                          const ulonglong2* pairs, int q0,
                                          int q1, unsigned long long& fwd,
                                          unsigned long long& rev) {
  fwd = srol1(fwd);
  rev = sror1(rev);
  for (int q = q0; q < q1; ++q) {
    const int2 o = offs[q];
    const unsigned ci = ring_row(ring, dt - o.x, rmask)[lane];
    const unsigned co = ring_row(ring, dt - o.y, rmask)[lane];
    const ulonglong2 e = pairs[q * 25 + ci * 5 + co];
    fwd ^= e.x;
    rev ^= e.y;
  }
}

// Invalid bases in the window that closes at row dt, rolled: enters row dt,
// leaves row dt - k.
__device__ __forceinline__ void roll_invalid(unsigned char* ring, int rmask,
                                             int lane, int dt, int k, int& inv) {
  inv += ring_row(ring, dt, rmask)[lane] >= 4;
  inv -= ring_row(ring, dt - k, rmask)[lane] >= 4;
}

constexpr int kStagePitch = 33;  // u64 a lane row of the output stage

// One warp of the one-sequence entry: lane l rolls windows [base, base + s)
// of a flat sequence of C codes, base = (j0 + l) s, after k - 1 warm-up
// bases, each seed in turn (seeds [0, nseeds), runs starts[s]..starts[s+1]),
// and writes, for every window w < C, the seed's canonical hash and its
// num_hashes - 1 nte64 extensions, then with kFwdRev its forward and reverse
// hash, into planes [nseeds * (num_hashes + 2 kFwdRev), C] (seed-major, the
// batch entries' layout), and valid[w] (no invalid base among bases w .. w +
// k - 1; bases at or past C read 4). Every 32 windows the lanes' states go
// through `stage` ([32][kStagePitch] u64 a plane, the pitch keeps 8-byte
// stores free of bank conflicts): fwd + rev in one plane, or with kFwdRev
// fwd and rev in two, the canonical hash formed at the store. The warp then
// writes lane i's 32 windows as one contiguous 256-byte store per output
// plane, i = 0..31, by streaming stores.
template <bool kFwdRev>
__device__ __forceinline__ void roll_sequence(
    const unsigned char* __restrict__ seq, long long C, int k, int s,
    int nseeds, const int* starts, const int2* offs, const ulonglong2* pairs,
    int num_hashes, const unsigned long long* mult, unsigned char* ring,
    int rmask, unsigned long long* stage, long long j0, int lane, bool vec,
    unsigned long long* __restrict__ out, bool* __restrict__ valid) {
  const long long base = (j0 + lane) * s;
  const int nsteps = s + k - 1;
  const int per_seed = num_hashes + (kFwdRev ? 2 : 0);
  unsigned long long* stage_rev = stage + 32 * kStagePitch;
  for (int si = 0; si < nseeds; ++si) {
    const int q0 = starts[si], q1 = starts[si + 1];
    unsigned long long* o = out + static_cast<long long>(si) * per_seed * C;
    __syncwarp();
    ring_prefill(ring, k, rmask, lane);
    unsigned long long fwd = 0, rev = 0;
    int inv = k;
    unsigned vbits = 0;
    for (int dt = 0; dt < nsteps; ++dt) {
      if ((dt & (kRows - 1)) == 0) {
        __syncwarp();
        stage_flat(ring, rmask, seq, C, base, dt, lane, vec);
        __syncwarp();
      }
      roll_step(ring, rmask, lane, dt, offs, pairs, q0, q1, fwd, rev);
      if (si == 0) roll_invalid(ring, rmask, lane, dt, k, inv);
      const int u = dt - (k - 1);
      if (u < 0) continue;
      if (kFwdRev) {
        stage[lane * kStagePitch + (u & 31)] = fwd;
        stage_rev[lane * kStagePitch + (u & 31)] = rev;
      } else {
        stage[lane * kStagePitch + (u & 31)] = fwd + rev;
      }
      vbits |= static_cast<unsigned>(inv == 0) << (u & 31);
      if ((u & 31) != 31) continue;
      __syncwarp();
      for (int i = 0; i < 32; ++i) {
        const unsigned vb = __shfl_sync(0xffffffffu, vbits, i);
        const long long w = (j0 + i) * s + (u - 31) + lane;
        if (w >= C) continue;
        unsigned long long canon = stage[i * kStagePitch + lane];
        if (kFwdRev) {
          const unsigned long long r = stage_rev[i * kStagePitch + lane];
          __stcs(o + num_hashes * C + w, canon);
          __stcs(o + (num_hashes + 1) * C + w, r);
          canon += r;
        }
        __stcs(o + w, canon);
        for (int h = 1; h < num_hashes; ++h) {
          unsigned long long e = canon * mult[h - 1];
          e ^= e >> kMultiShift;
          __stcs(o + h * C + w, e);
        }
        if (si == 0) valid[w] = (vb >> lane) & 1;
      }
      __syncwarp();
      vbits = 0;
    }
  }
}

// Shared memory of the one-sequence entry: the tables, then per warp its
// ring (ring_rows x 32 bytes) and its output stage (`planes` of 32 x
// kStagePitch u64: 1, or 2 with fwd and rev).
__host__ __device__ inline size_t sequence_tables_bytes(int nseeds, int nruns,
                                                        int num_hashes) {
  const size_t b = static_cast<size_t>(nruns) * 25 * 16 +
                   static_cast<size_t>(num_hashes - 1) * 8 +
                   static_cast<size_t>(nruns) * 8 +
                   static_cast<size_t>(nseeds + 1) * 4;
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline size_t sequence_warp_bytes(int ring_rows,
                                                      int planes) {
  return static_cast<size_t>(ring_rows) * 32 +
         static_cast<size_t>(planes) * 32 * kStagePitch * 8;
}

// Loads the tables into shared memory (layout: pairs [25 nruns] ulonglong2,
// mult [num_hashes - 1] u64, offs [nruns] int2, starts [nseeds + 1] int)
// from `tables` (pairs then mult, as uint64) and `meta` (offs then starts,
// as int32); returns the first byte past them.
__device__ __forceinline__ unsigned char* load_tables(
    unsigned char* smem, int nseeds, int nruns, int num_hashes,
    const unsigned long long* __restrict__ tables, const int* __restrict__ meta,
    const ulonglong2** pairs, const unsigned long long** mult,
    const int2** offs, const int** starts) {
  const int ntab = nruns * 50 + num_hashes - 1;
  const int nmeta = 2 * nruns + nseeds + 1;
  unsigned long long* tab = reinterpret_cast<unsigned long long*>(smem);
  int* m = reinterpret_cast<int*>(tab + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) m[i] = meta[i];
  *pairs = reinterpret_cast<const ulonglong2*>(tab);
  *mult = tab + nruns * 50;
  *offs = reinterpret_cast<const int2*>(m);
  *starts = m + 2 * nruns;
  return smem + sequence_tables_bytes(nseeds, nruns, num_hashes);
}

}  // namespace nthash
