// What kmer_hash.cu and seed_hash.cu share: ntHash2's split rotations, the
// code clamp, the writes of one window's outputs, the staged roll of the
// read kernels (a warp's codes as uint8 rows in shared memory, rolled through
// 25-entry pair tables), and the one-sequence entries' roll that both files
// instantiate (namespace nthash::seq).
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
// values as B (int to 2^30, long long for the wide buckets past it), each
// the sentinel 2^bucket_bits where !valid.
template <bool kBuckets, typename B = int>
__device__ __forceinline__ void write_window(
    void* __restrict__ out, size_t at, size_t plane, unsigned long long fwd,
    unsigned long long rev, bool valid, int num_hashes, int emit_fwd_rev,
    int bucket_bits, const unsigned long long* mult) {
  const unsigned long long canon = fwd + rev;
  if (kBuckets) {
    B* o = static_cast<B*>(out);
    const unsigned long long mask = (1ULL << bucket_bits) - 1;
    const B sentinel = static_cast<B>(1) << bucket_bits;
    o[at] = valid ? static_cast<B>(canon & mask) : sentinel;
    for (int i = 1; i < num_hashes; ++i) {
      unsigned long long e = canon * mult[i - 1];
      e ^= e >> kMultiShift;
      o[i * plane + at] = valid ? static_cast<B>(e & mask) : sentinel;
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

// Shared bytes of the staged read kernel's tables (load_tables).
__host__ __device__ inline size_t staged_tables_bytes(int nseeds, int nruns,
                                                        int num_hashes) {
  const size_t b = static_cast<size_t>(nruns) * 25 * 16 +
                   static_cast<size_t>(num_hashes - 1) * 8 +
                   static_cast<size_t>(nruns) * 8 +
                   static_cast<size_t>(nseeds + 1) * 4;
  return (b + 15) / 16 * 16;
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
  return smem + staged_tables_bytes(nseeds, nruns, num_hashes);
}


// ---------------------------------------------------------------------------
// The one-sequence entries (kmer_hash.cu's kmer_sequence_kernel, seed_hash.cu's
// seed_sequence_kernel): every window of one flat uint8 sequence of C codes in
// one pass. Lane l of a warp rolls windows [base, base + s) of the sequence,
// base = (j0 + l) s, s a multiple of 32, from zero state; bases before base
// and at or past C read as code 4 (the zero seed: no tap applies), so every
// window is exact from the first one.
//
// What bounds it on the H100: its bytes set the floor (the codes once, 8 *
// num_hashes + 1 bytes a window written, 16 more with kFwdRev), but the
// earlier design of this entry (a runtime step loop with four branches, one-
// byte taps, 64-bit rotations and one-window writes) ran at 2.5x that floor
// on both its roll and its writes; PERF.md section 6 has the ablations. So:
//  - Chunks of 32 steps, unrolled. Chunk c stages the aligned bases [base +
//    32c, base + 32c + 32) by two 16-byte loads issued one chunk ahead, into
//    the lane's own ring in shared memory, and rolls the 32 steps whose
//    newest base is base + 32(c - 1) + b + i (b = (k - 1) mod 32): step i of
//    chunk c closes window 32(c - M) + i, M = (k - 1) / 32 + 1. Outputs land
//    at compile-time offsets; chunks 0 .. M - 1 are the warm-up.
//  - Taps by word: a tap's codes for a chunk are ring words funnel-shifted
//    by a byte offset that is the same for every chunk. The k-mer's two taps
//    (0 and k) give 8 index words 5 c_in + c_out by one multiply-add a word;
//    a step extracts a byte and makes one 16-byte pair lookup in a table
//    replicated 8 times (copy lane % 8), so a quarter-warp never conflicts.
//    Spaced seeds take 8 steps at a time: each care run's lookups for them
//    XOR into 8 registers first, so none waits on the state.
//  - Split rotations on 32-bit halves: 3 to 4 operations each, no 64-bit
//    shifts.
//  - Validity from masks: a chunk's invalid bases as a 32-bit mask (bit 2 of
//    each clamped byte), smeared over k; 32 valid bytes a lane by two 16-byte
//    stores.
//  - Output runs of kRun windows a lane (32: 256 bytes a plane; 16, one
//    128-byte line, for the seed entry without fwd/rev, whose larger warps
//    need the occupancy more): two windows a 16-byte store into a swizzled
//    stage, then 16-byte streaming stores, kRun / 2 lanes to a run. Runs of
//    8 windows (half a line) ran the fwd/rev instance at 1.5x the time of
//    runs of 16, and runs of 32 beat 16 wherever they did not cost
//    resident warps (a run-length sweep on the card; CHANGES.md, readings
//    behind the comments).
//
// The ring of a lane holds R bytes, R = 32 (M + 2) (kmer_kernel.sequence_ring):
// chunks c - M - 1 .. c. Word w of lane l is ring[32 w + l]; words R/4 ..
// R/4 + 7 mirror words 0 .. 7, so a tap's words never wrap.
namespace seq {

constexpr int kChunk = 32;   // bases staged and steps rolled at a time
// Bytes of one plane of the stage at runs of `run` windows a lane.
__host__ __device__ constexpr int stage_bytes(int run) { return 32 * run * 8; }

// The stage slot (16 bytes) of pair t of row r at runs of kRun windows:
// swizzled so that 8 rows' stores of one t, and a quarter-warp's loads in
// the flush, hit 8 distinct 16-byte bank groups.
template <int kRun>
__device__ __forceinline__ int stage_slot(int r, int t) {
  constexpr int row = kRun / 2;
  return r * row + (t ^ (row == 4 ? (r >> 1) & 3 : r & 7));
}

// A (fwd, rev) state or window: the four 32-bit halves.
struct Pair {
  unsigned fl, fh, rl, rh;
};

// srol1 of roll.cuh on halves (lo = bits 0..31, hi = bits 32..63): lo33 is
// lo with bit 0 of hi, hi31 is hi >> 1.
__device__ __forceinline__ void srol1_32(unsigned& lo, unsigned& hi) {
  const unsigned y0 = (lo << 1) | (hi & 1u);
  const unsigned y1 = (__funnelshift_l(lo, hi, 1) & ~2u) | ((hi >> 30) & 2u);
  lo = y0;
  hi = y1;
}

__device__ __forceinline__ void sror1_32(unsigned& lo, unsigned& hi) {
  const unsigned y0 = __funnelshift_r(lo, hi, 1);
  const unsigned y1 = ((hi >> 1) & ~1u) | (lo & 1u) | ((hi << 30) & 0x80000000u);
  lo = y0;
  hi = y1;
}

// One step: both rotations, then the XOR of a 16-byte pair entry.
__device__ __forceinline__ void rotate(Pair& st) {
  srol1_32(st.fl, st.fh);
  sror1_32(st.rl, st.rh);
}

__device__ __forceinline__ void apply(Pair& st, const unsigned char* entry) {
  const uint4 e = *reinterpret_cast<const uint4*>(entry);
  st.fl ^= e.x;
  st.fh ^= e.y;
  st.rl ^= e.z;
  st.rh ^= e.w;
}

__device__ __forceinline__ void xor_in(Pair& st, const Pair& e) {
  st.fl ^= e.fl;
  st.fh ^= e.fh;
  st.rl ^= e.rl;
  st.rh ^= e.rh;
}

__device__ __forceinline__ unsigned long long u64of(unsigned lo, unsigned hi) {
  return static_cast<unsigned long long>(hi) << 32 | lo;
}

// Bases [p, p + 32) as 8 words, unclamped; bases at or past C read 4. The
// sequence is 16-byte aligned and p a multiple of 32.
__device__ __forceinline__ void load_chunk(const unsigned char* __restrict__ seq,
                                           long long C, long long p,
                                           unsigned (&w)[8]) {
  if (p + kChunk <= C) {
    const uint4* src = reinterpret_cast<const uint4*>(seq + p);
    const uint4 a = __ldcs(src), b = __ldcs(src + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned v = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long q = p + 4 * j + t;
        v |= (q < C ? static_cast<unsigned>(seq[q]) : 4u) << (8 * t);
      }
      w[j] = v;
    }
  }
}

// The 4N codes at ring byte p .. p + 4N - 1 (0 <= p < R) of a lane's
// column, as N words.
template <int N>
__device__ __forceinline__ void ring_read(const unsigned* col, int p,
                                          unsigned (&w)[N]) {
  const unsigned* src = col + (p >> 2) * 32;
  const unsigned sh = (p & 3) * 8;
  unsigned a = src[0];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const unsigned b = src[(j + 1) * 32];
    w[j] = __funnelshift_r(a, b, sh);
    a = b;
  }
}

// Ring byte of chunk c's slot (at byte wr) moved back by d (-R < d < 0).
__device__ __forceinline__ int ring_at(int wr, int d, int R) {
  const int p = wr + d;
  return p < 0 ? p + R : p;
}

// Clamps `cur` to 4, writes it to the slot at byte wr (and the mirror when
// wr is 0); returns the chunk's invalid mask (bit j: base j is code 4).
__device__ __forceinline__ unsigned put_chunk(unsigned* col, int wr, int R,
                                              unsigned (&cur)[8]) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned v = __vminu4(cur[j], 0x04040404u);
    col[(wr / 4 + j) * 32] = v;
    if (wr == 0) col[(R / 4 + j) * 32] = v;
    m |= (((v & 0x04040404u) * 0x204081u) >> 23 & 0xFu) << (4 * j);
  }
  return m;
}

// Bit i set where bit i - j of m is set for some j in [0, k): the windows of
// k bases ending at i that hold an invalid base of this mask.
__device__ __forceinline__ unsigned smear(unsigned m, int k) {
  if (k >= 32) return ~((m & (0u - m)) - 1u);
  int w = 1;
  while (2 * w <= k) {
    m |= m << w;
    w *= 2;
  }
  return w < k ? m | m << (k - w) : m;
}

// Bits at and above lb.
__device__ __forceinline__ unsigned from_bit(int lb) {
  return lb <= 0 ? ~0u : lb >= 32 ? 0u : ~0u << lb;
}

// Validity of the chunk's 32 windows: m_in holds the invalid bases ending
// them (bit i: base P0 + i), `last` the last invalid base before P0 (updated).
__device__ __forceinline__ unsigned window_bits(unsigned m_in, int k, int P0,
                                                int& last) {
  const unsigned vb = ~smear(m_in, k) & from_bit(last - P0 + k);
  if (m_in) last = P0 + 31 - __clz(m_in);
  return vb;
}

// valid[at .. at + 31] = the bits of vb, as two 16-byte stores.
__device__ __forceinline__ void put_valid(bool* __restrict__ valid, long long at,
                                          unsigned vb) {
  unsigned w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = ((vb >> (4 * j) & 0xFu) * 0x204081u) & 0x01010101u;
  uint4* dst = reinterpret_cast<uint4*>(valid + at);
  __stcs(dst, make_uint4(w[0], w[1], w[2], w[3]));
  __stcs(dst + 1, make_uint4(w[4], w[5], w[6], w[7]));
}

// Windows 2t and 2t + 1 of the lane's run into the stage: fwd + rev in
// plane 0, or with kFwdRev fwd in plane 0 and rev in plane 1 (stage_slot).
template <bool kFwdRev, int kRun>
__device__ __forceinline__ void stage_two(unsigned char* stage, int lane, int t,
                                          const Pair& a, const Pair& b) {
  uint4* row = reinterpret_cast<uint4*>(stage) + stage_slot<kRun>(lane, t);
  if (kFwdRev) {
    row[0] = make_uint4(a.fl, a.fh, b.fl, b.fh);
    row[stage_bytes(kRun) / 16] = make_uint4(a.rl, a.rh, b.rl, b.rh);
  } else {
    const unsigned long long ca = u64of(a.fl, a.fh) + u64of(a.rl, a.rh);
    const unsigned long long cb = u64of(b.fl, b.fh) + u64of(b.rl, b.rh);
    row[0] = make_uint4(static_cast<unsigned>(ca), static_cast<unsigned>(ca >> 32),
                        static_cast<unsigned>(cb), static_cast<unsigned>(cb >> 32));
  }
}

__device__ __forceinline__ uint4 as_uint4(unsigned long long a,
                                          unsigned long long b) {
  return make_uint4(static_cast<unsigned>(a), static_cast<unsigned>(a >> 32),
                    static_cast<unsigned>(b), static_cast<unsigned>(b >> 32));
}

// Writes the warp's staged runs: windows u0 .. u0 + kRun - 1 of every
// lane's segment into planes o + i * pitch (canonical, its num_hashes - 1
// nte64 extensions, then with kFwdRev fwd and rev). Lane q stores 16 bytes
// of row q / (kRun / 2) + (64 / kRun) p. A run starting at or past C is
// skipped; planes are padded to a multiple of 32, so every other run is
// whole.
template <bool kFwdRev, int kRun>
__device__ __forceinline__ void flush(const unsigned char* stage, int lane,
                                      long long j0, int s, long long u0,
                                      long long C, long long pitch,
                                      unsigned long long* __restrict__ o,
                                      int num_hashes,
                                      const unsigned long long* mult) {
  __syncwarp();
  const uint4* st = reinterpret_cast<const uint4*>(stage);
  constexpr int lanes = kRun / 2;  // a run's 16-byte stores
  const int t = lane % lanes;
#pragma unroll
  for (int p = 0; p < lanes; ++p) {
    const int r = lane / lanes + (32 / lanes) * p;
    const long long w = (j0 + r) * s + u0;
    if (w >= C) continue;
    const int slot = stage_slot<kRun>(r, t);
    const uint4 a = st[slot];
    unsigned long long c0 = u64of(a.x, a.y), c1 = u64of(a.z, a.w);
    unsigned long long* at = o + w + 2 * t;
    if (kFwdRev) {
      const uint4 b = st[stage_bytes(kRun) / 16 + slot];
      __stcs(reinterpret_cast<uint4*>(at + num_hashes * pitch), a);
      __stcs(reinterpret_cast<uint4*>(at + (num_hashes + 1) * pitch), b);
      c0 += u64of(b.x, b.y);
      c1 += u64of(b.z, b.w);
    }
    __stcs(reinterpret_cast<uint4*>(at), as_uint4(c0, c1));
    for (int h = 1; h < num_hashes; ++h) {
      unsigned long long e0 = c0 * mult[h - 1], e1 = c1 * mult[h - 1];
      e0 ^= e0 >> kMultiShift;
      e1 ^= e1 >> kMultiShift;
      __stcs(reinterpret_cast<uint4*>(at + h * pitch), as_uint4(e0, e1));
    }
  }
  __syncwarp();
}

// Shared memory: the tables (pairs [nruns][25][copies] 16 bytes, copies =
// 2^copies_log2; mult [num_hashes - 1] u64; meta [2 nruns + nseeds + 1]
// int32), then per warp its ring ((R / 4 + 8) x 128 bytes), its stage
// (planes x stage_bytes(run)) and, for spaced seeds, the seeds' states
// (nseeds x 4 words x 32 lanes).
__host__ __device__ inline size_t tables_bytes(int nseeds, int nruns,
                                               int num_hashes, int copies_log2) {
  const size_t b = (static_cast<size_t>(nruns) * 25 * 16 << copies_log2) +
                   static_cast<size_t>(num_hashes - 1) * 8 +
                   static_cast<size_t>(2 * nruns + nseeds + 1) * 4;
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline size_t warp_bytes(int ring, int planes,
                                             int state_seeds, int run) {
  return static_cast<size_t>(ring / 4 + 8) * 128 +
         static_cast<size_t>(planes) * stage_bytes(run) +
         static_cast<size_t>(state_seeds) * 4 * 128;
}

// Loads the tables (`tables`: per run its 25 (fwd, rev) pairs, then the
// multipliers, as uint64; `meta`: per run its two tap deltas, then the
// seeds' run offsets, int32) into shared memory; returns the first byte past
// them.
__device__ __forceinline__ unsigned char* load_tables(
    unsigned char* smem, int nseeds, int nruns, int num_hashes, int copies_log2,
    const unsigned long long* __restrict__ tables, const int* __restrict__ meta,
    const unsigned char** pairs, const unsigned long long** mult,
    const int** taps) {
  uint4* pr = reinterpret_cast<uint4*>(smem);
  const int npairs = nruns * 25;
  for (int i = threadIdx.x; i < npairs << copies_log2; i += blockDim.x) {
    const ulonglong2 v =
        reinterpret_cast<const ulonglong2*>(tables)[i >> copies_log2];
    pr[i] = as_uint4(v.x, v.y);
  }
  unsigned long long* mu = reinterpret_cast<unsigned long long*>(
      pr + (npairs << copies_log2));
  for (int i = threadIdx.x; i < num_hashes - 1; i += blockDim.x) {
    mu[i] = tables[2 * npairs + i];
  }
  int* m = reinterpret_cast<int*>(mu + num_hashes - 1);
  if (meta != nullptr) {
    for (int i = threadIdx.x; i < 2 * nruns + nseeds + 1; i += blockDim.x) {
      m[i] = meta[i];
    }
  }
  *pairs = smem;
  *mult = mu;
  *taps = m;
  return smem + tables_bytes(nseeds, nruns, num_hashes, copies_log2);
}

// What a lane keeps across chunks: its segment, ring column, staged chunk
// and validity.
struct Lane {
  long long base;
  unsigned* col;   // ring word w at col[32 w]
  int R, wr;       // ring bytes; byte of the current chunk's slot
  unsigned cur[8];
  unsigned m_prev;  // invalid mask of the previous aligned chunk
  int last;         // last invalid base before the chunk's first window end
};

__device__ __forceinline__ void lane_start(Lane& L, const unsigned char* seq,
                                           long long C, long long base,
                                           unsigned* ring, int lane, int R) {
  L.base = base;
  L.col = ring + lane;
  L.R = R;
  L.wr = 0;
  for (int w = 0; w < R / 4 + 8; ++w) L.col[w * 32] = 0x04040404u;
  load_chunk(seq, C, base, L.cur);
  L.m_prev = ~0u;
  L.last = -1;
}

// Stages chunk c (the current one), issues the loads of chunk c + 1 and
// returns the validity bits of chunk c's windows.
__device__ __forceinline__ unsigned lane_chunk(Lane& L, const unsigned char* seq,
                                               long long C, int c, int nchunks,
                                               int k, int b, unsigned (&nxt)[8]) {
  const unsigned m_cur = put_chunk(L.col, L.wr, L.R, L.cur);
  if (c + 1 < nchunks) load_chunk(seq, C, L.base + kChunk * (c + 1), nxt);
  const unsigned m_in = __funnelshift_r(L.m_prev, m_cur, b);
  L.m_prev = m_cur;
  return window_bits(m_in, k, kChunk * (c - 1) + b, L.last);
}

__device__ __forceinline__ void lane_next(Lane& L, const unsigned (&nxt)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) L.cur[j] = nxt[j];
  L.wr += kChunk;
  if (L.wr == L.R) L.wr = 0;
}

// The k-mer entry: one care run, taps 0 and k. pairs: the lane's copy of
// the 25 entries (entry e at pairs + (e << pshift)).
template <bool kFwdRev, int kRun>
__device__ __forceinline__ void kmer_sequence(
    const unsigned char* __restrict__ seq, long long C, int k, int s,
    int num_hashes, const unsigned char* pairs, int pshift,
    const unsigned long long* mult, unsigned* ring, int R,
    unsigned char* stage, long long j0, int lane,
    unsigned long long* __restrict__ out, long long pitch,
    bool* __restrict__ valid) {
  const int M = (k - 1) / kChunk + 1, b = (k - 1) & (kChunk - 1);
  const int nchunks = M + s / kChunk;
  const int d_in = b - kChunk, d_out = b - kChunk - k;
  Lane L;
  lane_start(L, seq, C, (j0 + lane) * s, ring, lane, R);
  Pair st = {0u, 0u, 0u, 0u};
  for (int c = 0; c < nchunks; ++c) {
    unsigned nxt[8];
    const unsigned vb = lane_chunk(L, seq, C, c, nchunks, k, b, nxt);
    unsigned in[8], idx[8];
    ring_read(L.col, ring_at(L.wr, d_in, R), in);
    ring_read(L.col, ring_at(L.wr, d_out, R), idx);
#pragma unroll
    for (int j = 0; j < 8; ++j) idx[j] = in[j] * 5u + idx[j];
    const bool emit = c >= M;
    const long long u = static_cast<long long>(kChunk) * (c - M);
#pragma unroll
    for (int g = 0; g < kChunk / kRun; ++g) {
#pragma unroll
      for (int t = 0; t < kRun / 2; ++t) {
        const int i = kRun * g + 2 * t;
        rotate(st);
        apply(st, pairs + ((idx[i >> 2] >> (8 * (i & 3)) & 0xFFu) << pshift));
        const Pair a = st;
        rotate(st);
        apply(st, pairs + ((idx[i >> 2] >> (8 * (i & 3) + 8) & 0xFFu) << pshift));
        if (emit) stage_two<kFwdRev, kRun>(stage, lane, t, a, st);
      }
      if (emit) {
        flush<kFwdRev, kRun>(stage, lane, j0, s, u + kRun * g, C, pitch,
                             out, num_hashes, mult);
      }
    }
    if (emit && L.base + u < C) put_valid(valid, L.base + u, vb);
    lane_next(L, nxt);
  }
}

// The spaced-seed entry. Per chunk the codes are staged once for all
// seeds; each seed then rolls the chunk from its state parked in shared
// memory, 8 steps at a time: first, for each of its care runs (a runtime
// loop), the run's two taps for the 8 steps (3 ring words each) give 8
// pair lookups that XOR into E[0..7], none waiting on the state; then the 8
// steps rotate the state and XOR E[i]. taps: per run the two deltas (b - 32
// - off_in, b - 32 - off_out), then the seeds' run offsets.
constexpr int kSeedSteps = 8;

template <bool kFwdRev, int kRun>
__device__ __forceinline__ void seed_sequence(
    const unsigned char* __restrict__ seq, long long C, int k, int s,
    int nseeds, int nruns, int num_hashes, const unsigned char* pairs,
    int pshift, const unsigned long long* mult, const int* taps,
    unsigned* ring, int R, unsigned char* stage, unsigned* states,
    long long j0, int lane, unsigned long long* __restrict__ out,
    long long pitch, bool* __restrict__ valid) {
  const int M = (k - 1) / kChunk + 1, b = (k - 1) & (kChunk - 1);
  const int nchunks = M + s / kChunk;
  const int per_seed = num_hashes + (kFwdRev ? 2 : 0);
  const int run_bytes = 25 * 16 << (pshift - 4);
  const int* starts = taps + 2 * nruns;
  Lane L;
  lane_start(L, seq, C, (j0 + lane) * s, ring, lane, R);
  unsigned* sv = states + lane;
  for (int i = 0; i < 4 * nseeds; ++i) sv[32 * i] = 0u;
  for (int c = 0; c < nchunks; ++c) {
    unsigned nxt[8];
    const unsigned vb = lane_chunk(L, seq, C, c, nchunks, k, b, nxt);
    const bool emit = c >= M;
    const long long u = static_cast<long long>(kChunk) * (c - M);
    for (int si = 0; si < nseeds; ++si) {
      const int q0 = starts[si], q1 = starts[si + 1];
      Pair st = {sv[(4 * si) * 32], sv[(4 * si + 1) * 32],
                 sv[(4 * si + 2) * 32], sv[(4 * si + 3) * 32]};
      unsigned long long* o = out + static_cast<long long>(si) * per_seed * pitch;
#pragma unroll 1
      for (int sg = 0; sg < kChunk / kSeedSteps; ++sg) {
        Pair E[kSeedSteps];
#pragma unroll
        for (int i = 0; i < kSeedSteps; ++i) E[i] = Pair{0u, 0u, 0u, 0u};
        for (int q = q0; q < q1; ++q) {
          int pi = ring_at(L.wr, taps[2 * q], R) + kSeedSteps * sg;
          int po = ring_at(L.wr, taps[2 * q + 1], R) + kSeedSteps * sg;
          pi -= pi >= R ? R : 0;
          po -= po >= R ? R : 0;
          unsigned in[kSeedSteps / 4], ou[kSeedSteps / 4];
          ring_read(L.col, pi, in);
          ring_read(L.col, po, ou);
          const unsigned char* pq = pairs + q * run_bytes;
#pragma unroll
          for (int j = 0; j < kSeedSteps / 4; ++j) in[j] = in[j] * 5u + ou[j];
#pragma unroll
          for (int i = 0; i < kSeedSteps; ++i) {
            apply(E[i], pq + ((in[i >> 2] >> (8 * (i & 3)) & 0xFFu) << pshift));
          }
        }
#pragma unroll
        for (int t = 0; t < kSeedSteps / 2; ++t) {
          rotate(st);
          xor_in(st, E[2 * t]);
          const Pair a = st;
          rotate(st);
          xor_in(st, E[2 * t + 1]);
          if (emit) {
            stage_two<kFwdRev, kRun>(stage, lane,
                                     (sg * (kSeedSteps / 2) + t) % (kRun / 2),
                                     a, st);
          }
        }
        if (emit && (sg + 1) * kSeedSteps % kRun == 0) {
          flush<kFwdRev, kRun>(stage, lane, j0, s,
                               u + (sg + 1) * kSeedSteps - kRun, C, pitch, o,
                               num_hashes, mult);
        }
      }
      sv[(4 * si) * 32] = st.fl;
      sv[(4 * si + 1) * 32] = st.fh;
      sv[(4 * si + 2) * 32] = st.rl;
      sv[(4 * si + 3) * 32] = st.rh;
    }
    if (emit && L.base + u < C) put_valid(valid, L.base + u, vb);
    lane_next(L, nxt);
  }
}

}  // namespace seq

}  // namespace nthash
