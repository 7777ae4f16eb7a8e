// Chained triangular-MMA prefix scan for Hopper (sm_90a): kernel B6 of
// the port, with a plain C interface bound from Python through ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/mma_scan.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mma_scan.py
// mma_scan_kernel (launched by scan_call): the inclusive prefix sum of
// the row-major flat view of a (T, 16) tile array, returned in f32.
//
// Encoding (Dakkak et al.; Navarro et al. 2020, m = 16).  A tile of
// chain * block_rows rows of 16 elements belongs to one thread block;
// link r of the chain is the tile's rows [r * block_rows,
// (r + 1) * block_rows), and warp w owns the 16 x 16 slab at rows
// 16w..16w+15 of every link.  For each slab X the warp forms
//
//   P = X x U_16          the rows' inclusive prefixes, on the tensor
//                         cores (U_16[k][j] = 1 iff k <= j),
//   t = P[:, 15]          the rows' totals,
//
// and each output is P + (slab carry + row carry) + tile carry, the
// reference's p + c + carry with its row carries c = L' t split into
// a carry per slab and one per row inside the slab.
//
// The fragment layout matters here.  B1-B3 feed their ones-MMAs 8
// consecutive elements per lane in any slot order, which an all-ones B
// forgives; against U_16 every element must sit in its true (row,
// column) slot.  Each slab therefore lands in shared memory (cp.async,
// 16 bytes a lane; rows padded by 4 words so the fragment reads hit 32
// distinct banks) and the mma.sync A fragment is read from there; each
// element of the D fragment is stored to its own row and column.
//
//   bf16 / fp16: two mma.sync.m16n8k16, one for U's columns 0-7, one
//     for columns 8-15.
//   f32: Hopper has no f32 MMA.  As in B1, each value splits into two
//     TF32 words hi = rna_tf32(x), lo = rna_tf32(x - hi), and
//     mma.sync.m16n8k8 runs over both into one f32 accumulator.  With
//     U split into 8 x 8 blocks, columns 0-7 need X[:, 0:8] x tri and
//     columns 8-15 X[:, 0:8] x ones + X[:, 8:16] x tri (the block
//     U[8:16, 0:8] is zero): six MMAs per slab.  U is 0 / 1, exact in
//     TF32.
//
// The carries stay on the CUDA cores in f32 (on the TPU they are an
// f32 MMA; a TF32 product of the carries would keep 11 bits): warp
// shuffles and a fixed order, every add an _rn intrinsic, no
// --use_fast_math, no float atomics.
//
// One pass over x.  The TPU carried the running total across its
// sequential grid in VMEM; here one launch does it with a decoupled
// look-back (Merrill and Garland, 2016) whose carries are the same bits
// on every run:
//
//   1. ticket:  thread 0 takes the block's tile index from an atomic
//               counter, so every tile a block waits on belongs to a
//               block that has already started (blocks are not
//               scheduled in blockIdx order) and no wait can deadlock;
//               beside it, it reads the hint (below);
//   2. load:    the tile goes to shared memory once, by cp.async (the
//               ragged tail reads as 0; nothing past n is read).  A
//               tile too large for shared memory keeps its first
//               `resident` links there and reads the rest twice
//               through one staging slab a warp (chain x block_rows
//               beyond 5 x 512 in f32; never on the sweep's plans);
//   3. totals:  each warp forms P and the row scan of its slabs; warp
//               0 scans the slab totals into slab carries and the tile
//               total a_i;
//   4. publish: lane 0 of warp 0 stores A_i, the complement of a_i's
//               bits (0 means not yet published);
//   5. look-back: warp 0 then finds (S, c), the fold of a_0 ..
//               a_{i-1}.  It starts from the newest published inclusive
//               state B_j at or before the hint (a header word that
//               blocks raise to j + 1 with atomicMax once B_j is out;
//               thread 0 read it beside the ticket), then steps
//               forward: each step reads the words A of the next 256
//               tiles at once and folds their totals, in tile order, up
//               to the first not yet published; when the hint runs
//               further ahead, it moves to the newest B it finds there.
//               (A warp of its own that walked while the others loaded
//               ran slower on the H100 wherever several blocks share
//               an SM);
//   6. fold:    the tile carry is a left fold in tile order, the
//               reference's `carry = carry + total`, compensated:
//               (S_i, c_i) = (S_{i-1} + a_i, c_{i-1} + e_i) with e_i the
//               exact rounding error of that add (TwoSum), and tile
//               i's carry fl(S_{i-1} + c_{i-1}).  Each B_j the walk
//               starts from or moves to is that same fold, so the
//               result is the same bits whichever it met.  A textbook
//               look-back adds the totals back to front from whatever
//               it found first, and its bits change with the timing.
//               A plain f32 fold would grow its rounding with the
//               number of tiles; the compensated one stays within a
//               few roundings of the running sum;
//   7. write:   lane 0 of warp 0 stores B_i, the complement of
//               (c_i, S_i)'s bits in one 64-bit word, and raises the
//               hint; every warp that scans forms P again from shared
//               memory and writes P + carries in f32, for the first n
//               positions only.
//
// The state words need no ordering between them: each is one 32- or
// 64-bit word, stored and loaded whole with st / ld.relaxed.gpu (never
// read torn; no L1 copy), whose value itself says whether it is there.
// A published word would read 0 only for the NaN 0xffffffff, and the
// stored values are canonical (a NaN is written as 0x7fffffff).  The
// wrapper zeroes the scratch (header, A, B) on the stream before each
// call; nothing is shared between calls or streams.  Header word 2
// counts the walks' forward steps (look_back_steps in the wrapper reads
// it); words 3-7 pad.
//
// Deterministic: every sum runs in a fixed order, so the kernel gives
// the same bits on every run, whatever the blocks' timing.
//
// Bound on the H100: bytes.  The function reads its input once and
// writes f32 once (8 bytes per f32 element, 6 per bf16 / fp16 one),
// and this design moves just that, plus 12 bytes of state a tile; it
// spends 32-48 tensor-core flops per element (twice, as P is formed
// again for the write), far under the ~295 flops per byte at which the
// tensor cores would become the limit.  What it loses to the bound is
// the wait for the carry: a block holds its tile in shared memory from
// its load until its predecessors' totals have reached it through L2.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kM = 16;                   // slab: 16 x 16
constexpr int kSlab = kM * kM;           // elements per warp per link
constexpr int kMaxThreads = 1024;        // block_rows <= 512
constexpr int kSmallThreads = 256;       // block_rows <= 128
// Blocks of the small form an SM must hold, by dtype: registers 48 in
// f32, 64 in 16 bits (at 48 they spill).
constexpr int kSmallBlocks[3] = {5, 4, 4};
constexpr int kMaxChain = 1024;          // the slab carries fit in shared memory
constexpr int kSmemLimit = 232448 - 64;  // 227 KB a block on the H100,
                                         // less the static words

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The scratch buffer: a header, then A (one word a tile, padded to an
// even count), then B (two words a tile).
constexpr int kHeaderWords = 8;          // ticket, hint, steps, padding

// 32-bit words per slab row in shared memory: 16 f32 values or 16
// 16-bit values packed in pairs, plus 4 words of padding.
template <int DT>
struct Stage {
  static constexpr int kWords = DT == kF32 ? 16 : 8;
  static constexpr int kStride = kWords + 4;
  static constexpr int kSlabWords = kM * kStride;
};

// Selects triangular_mma's form by the input's dtype.
template <int DT>
struct Tag {};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// One slab, flat index i on, into its place in shared memory: 16-byte
// chunk q * 32 + l of the slab goes by lane l, so each cp.async of the
// warp reads 512 contiguous bytes.  A chunk that ends past n is read
// element by element, with 0 past n; one that starts past n is written
// as 0 without reading.
template <int DT>
__device__ __forceinline__ void stage_async(uint32_t* slab, const void* x,
                                            long long n, long long i,
                                            int lane) {
  constexpr int kPerChunk = DT == kF32 ? 4 : 8;      // elements a chunk
#pragma unroll
  for (int q = 0; q < kSlab / kPerChunk / 32; ++q) {
    const int k = (q * 32 + lane) * kPerChunk;       // in the slab
    const long long e = i + k;
    uint32_t* dst = slab + (k / kM) * Stage<DT>::kStride +
                    (k % kM) * Stage<DT>::kWords / kM;
    if (e + kPerChunk <= n) {
      if (DT == kF32)
        cp_async16(dst, static_cast<const float*>(x) + e);
      else
        cp_async16(dst, static_cast<const uint16_t*>(x) + e);
      continue;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (DT == kF32) {
      const float* p = static_cast<const float*>(x) + e;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < n) w[j] = __float_as_uint(p[j]);
    } else {
      const uint16_t* p = static_cast<const uint16_t*>(x) + e;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = (e + 2 * j < n) ? p[2 * j] : 0u;
        const uint32_t hi = (e + 2 * j + 1 < n) ? p[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the bits the MMA reads
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DT>
__device__ __forceinline__ void mma_16bit(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if (DT == kBF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// P = X x U_16 for the staged slab.  Lane 4g + t gets (the mma.sync
// accumulator layout) lo[0..1] = P[g][2t..2t+1], lo[2..3] =
// P[g+8][2t..2t+1], hi[0..1] = P[g][2t+8..2t+9], hi[2..3] =
// P[g+8][2t+8..2t+9].
__device__ __forceinline__ void triangular_mma(const uint32_t* stage,
                                               int lane, float (&lo)[4],
                                               float (&hi)[4],
                                               Tag<kF32>) {
  constexpr int kS = Stage<kF32>::kStride;
  const int g = lane >> 2, t = lane & 3;
  // A fragment of m16n8k8 (16 x 8, row-major) for columns 8kb..8kb+7:
  // a0 = X[g][8kb+t], a1 = X[g+8][8kb+t], a2 = X[g][8kb+t+4],
  // a3 = X[g+8][8kb+t+4]; as hi and lo TF32 words.
  uint32_t ahi[2][4], alo[2][4];
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    const int c = 8 * kb + t;
    const float v[4] = {__uint_as_float(stage[g * kS + c]),
                        __uint_as_float(stage[(g + 8) * kS + c]),
                        __uint_as_float(stage[g * kS + c + 4]),
                        __uint_as_float(stage[(g + 8) * kS + c + 4])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ahi[kb][j] = tf32_bits(v[j]);
      alo[kb][j] = tf32_bits(__fsub_rn(v[j], __uint_as_float(ahi[kb][j])));
    }
  }
  // B fragment of m16n8k8 (8 x 8, column n = g): b0 = U[8kb+t][8nb+g],
  // b1 = U[8kb+t+4][8nb+g].  The diagonal blocks are the triangle
  // (k <= n), the block above the diagonal all ones.
  const uint32_t one = 0x3f800000u;  // 1.0 as TF32
  const uint32_t tri0 = t <= g ? one : 0u, tri1 = t + 4 <= g ? one : 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) lo[j] = hi[j] = 0.0f;
  mma_tf32(lo, ahi[0], tri0, tri1);
  mma_tf32(lo, alo[0], tri0, tri1);
  mma_tf32(hi, ahi[0], one, one);
  mma_tf32(hi, alo[0], one, one);
  mma_tf32(hi, ahi[1], tri0, tri1);
  mma_tf32(hi, alo[1], tri0, tri1);
}

template <int DT>
__device__ __forceinline__ void triangular_mma(const uint32_t* stage,
                                               int lane, float (&lo)[4],
                                               float (&hi)[4],
                                               Tag<DT>) {
  constexpr int kS = Stage<DT>::kStride;
  const int g = lane >> 2, t = lane & 3;
  // A fragment of m16n8k16 (16 x 16, row-major, pairs packed low
  // column first): a0 = X[g][2t..2t+1], a1 = X[g+8][2t..2t+1],
  // a2 = X[g][2t+8..2t+9], a3 = X[g+8][2t+8..2t+9].
  const uint32_t a[4] = {stage[g * kS + t], stage[(g + 8) * kS + t],
                         stage[g * kS + t + 4], stage[(g + 8) * kS + t + 4]};
  // B fragment (16 x 8, column n): b0 = U[2t..2t+1][n],
  // b1 = U[2t+8..2t+9][n], the lower row in the low half.
  const uint32_t one = DT == kBF16 ? 0x3f80u : 0x3c00u;
  auto pair = [one](bool k0, bool k1) -> uint32_t {
    return (k0 ? one : 0u) | ((k1 ? one : 0u) << 16);
  };
  // Columns 0-7 (n = g): rows 8-15 of U are zero there.
  const uint32_t lo0 = pair(2 * t <= g, 2 * t + 1 <= g), lo1 = 0u;
  // Columns 8-15 (n = g + 8): rows 0-7 are all ones.
  const uint32_t hi0 = pair(true, true);
  const uint32_t hi1 = pair(2 * t <= g, 2 * t + 1 <= g);
#pragma unroll
  for (int j = 0; j < 4; ++j) lo[j] = hi[j] = 0.0f;
  mma_16bit<DT>(lo, a, lo0, lo1);
  mma_16bit<DT>(hi, a, hi0, hi1);
}

// The slab's row scan: lane i < 16 ends with the inclusive f32 prefix
// of row totals 0..i (a Hillis-Steele scan in a fixed order).  Row g's
// total P[g][15] sits in lane 4g + 3's hi[1], row g + 8's in its hi[3].
__device__ __forceinline__ float row_scan(const float (&hi)[4], int lane) {
  const int src = 4 * (lane & 7) + 3;
  const float a = __shfl_sync(0xffffffffu, hi[1], src);
  const float b = __shfl_sync(0xffffffffu, hi[3], src);
  float v = lane < 8 ? a : (lane < 16 ? b : 0.0f);
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = __fadd_rn(v, y);
  }
  return v;
}

// Inclusive f32 scan over the warp's 32 lanes, in a fixed order.
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = __fadd_rn(v, y);
  }
  return v;
}

// The inclusive scan of one staged slab: P, and the row scan of its row
// totals.  Called by every lane of the warp.
template <int DT>
__device__ __forceinline__ float slab_scan(const uint32_t* slab, int lane,
                                           float (&lo)[4], float (&hi)[4]) {
  triangular_mma(slab, lane, lo, hi, Tag<DT>{});
  return row_scan(hi, lane);
}

// The compensated left fold: (s, c) takes in a, s rounding as a plain
// f32 fold does and c gathering the exact error of each of its adds
// (TwoSum, six f32 operations).
__device__ __forceinline__ void fold(float& s, float& c, float a) {
  const float t = __fadd_rn(s, a);
  const float bp = __fsub_rn(t, s);
  const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)), __fsub_rn(a, bp));
  c = __fadd_rn(c, e);
  s = t;
}

// The carry a state hands the next tile.  Once a total is infinite or
// NaN, the error term is NaN and s alone is the prefix.
__device__ __forceinline__ float carry_of(float s, float c) {
  return c != c ? s : __fadd_rn(s, c);
}

// A tile's state in the scratch buffer: its total a_i as one 32-bit
// word A_i, and its inclusive state (S_i, c_i) as one 64-bit word B_i
// (c_i's bits high), each the complement of the value's bits.  Each is
// written and read whole (st / ld.relaxed.gpu), so it is never read
// torn and says itself whether it is there: 0 until published.  A
// published word could be 0 only for the NaN 0xffffffff, and the
// published values are canonical (a NaN is written as 0x7fffffff).
using Word = unsigned long long;

__device__ __forceinline__ unsigned ld_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ Word ld_word(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_u32(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_word(Word* p, Word v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned canonical(float v) {
  return v != v ? 0x7fffffffu : __float_as_uint(v);
}

__device__ __forceinline__ Word inclusive_word(float s, float c) {
  return ~((static_cast<Word>(canonical(c)) << 32) | canonical(s));
}

constexpr int kWinA = 8;  // totals a forward step reads: kWinA x 32 tiles
constexpr int kWinB = 4;  // states a backward step reads: kWinB x 32 tiles

// Moves (pos, s, c) to the newest published inclusive state among
// tiles (pos, hi], if there is one, walking back kWinB x 32 tiles a
// step.  Called by every lane of the warp.
__device__ __forceinline__ void find_state(const Word* B, long long hi,
                                           int lane, long long& pos,
                                           float& s, float& c) {
  for (; hi > pos; hi -= 32 * kWinB) {
    const long long lo = hi - 32 * kWinB + 1;
    Word w[kWinB];
#pragma unroll
    for (int m = 0; m < kWinB; ++m) {
      const long long t = lo + 32 * m + lane;
      w[m] = t > pos && t <= hi ? ld_word(B + t) : 0ull;
    }
#pragma unroll
    for (int m = kWinB - 1; m >= 0; --m) {
      const unsigned mask = __ballot_sync(0xffffffffu, w[m] != 0ull);
      if (mask) {
        const int q = 31 - __clz(mask);
        const Word v = ~__shfl_sync(0xffffffffu, w[m], q);
        s = __uint_as_float(static_cast<unsigned>(v));
        c = __uint_as_float(static_cast<unsigned>(v >> 32));
        pos = lo + 32 * m + q;
        return;
      }
    }
  }
}

// Steps 5 and 6, by every lane of one warp: (s, c), the fold of the
// totals of tiles 0 .. tile - 1.  hint is the header word that blocks
// raise to their tile + 1 once they publish B, first_hint its value when
// the block took its ticket.  The walk starts from
// the newest published inclusive state at or before the hint (or from
// (0, 0) before tile 0), then goes forward: each step reads the totals
// of the next kWinA x 32 tiles at once and folds them, in tile order,
// up to the first not yet published; when the hint runs more than a
// step ahead, it moves to the newest inclusive state it can find
// there.  Every state it starts from or moves to is that same fold, so
// the result does not depend on which it met.  Returns the number of
// forward steps.
__device__ __forceinline__ unsigned look_back(const unsigned* A,
                                              const Word* B,
                                              const unsigned* hint,
                                              unsigned first_hint,
                                              long long tile, int lane,
                                              float* buf, float& s,
                                              float& c) {
  long long pos = -1;  // (s, c) folds the totals of tiles 0 .. pos
  s = 0.0f;
  c = 0.0f;
  long long h = static_cast<long long>(first_hint) - 1;
  find_state(B, h < tile - 1 ? h : tile - 1, lane, pos, s, c);
  unsigned steps = 0;
  while (pos < tile - 1) {
    ++steps;
    const long long b = pos + 1;
    unsigned w[kWinA];
#pragma unroll
    for (int m = 0; m < kWinA; ++m) {
      const long long t = b + 32 * m + lane;
      w[m] = t < tile ? ld_u32(A + t) : 0u;
    }
    h = static_cast<long long>(__shfl_sync(0xffffffffu, lane == 0 ? ld_u32(hint) : 0u, 0)) - 1;
    // The first tile from b on whose total is not in yet.
    long long end = b + 32 * kWinA < tile ? b + 32 * kWinA : tile;
#pragma unroll
    for (int m = kWinA - 1; m >= 0; --m) {
      const long long t = b + 32 * m + lane;
      const unsigned gap = __ballot_sync(0xffffffffu, t < tile && w[m] == 0u);
      if (gap) end = b + 32 * m + __ffs(gap) - 1;
    }
#pragma unroll
    for (int m = 0; m < kWinA; ++m) buf[32 * m + lane] = __uint_as_float(~w[m]);
    __syncwarp();
#pragma unroll 4
    for (int q = 0; q < static_cast<int>(end - b); ++q) fold(s, c, buf[q]);
    __syncwarp();  // buf is free again
    pos = end - 1;
    if (pos == tile - 1) break;
    if (h > pos + 32 * kWinA)
      find_state(B, h < tile - 1 ? h : tile - 1, lane, pos, s, c);
    else if (end == b)
      __nanosleep(100);  // nothing new: wait a little
  }
  return steps;
}

// Stores a lane's two adjacent outputs at flat index i (even), only
// those below n; exclusive mode shifts them one place right.
__device__ __forceinline__ void store2(float* out, long long n, long long i,
                                       float a, float b, bool exclusive) {
  if (exclusive) {
    if (i + 1 < n) out[i + 1] = a;
    if (i + 2 < n) out[i + 2] = b;
  } else if (i + 1 < n) {
    *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
  } else if (i < n) {
    out[i] = a;
  }
}

// Shared memory: `resident` links of slabs, one staging slab a warp when
// resident < chain, then the chain * warps slab carries.
template <int DT>
long long smem_bytes(int chain, int warps, int resident) {
  const long long regions = resident + (resident < chain ? 1 : 0);
  const long long carries = (static_cast<long long>(chain) * warps + 3) / 4 * 4;
  return (regions * warps * Stage<DT>::kSlabWords + carries) * 4;
}

// One block a tile; warp 0 walks back once the tile total is out.
template <int DT, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_kernel(const void* x, long long n, int chain, int block_rows,
                int resident, int exclusive, unsigned* scratch, float* out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ long long tile_s;
  __shared__ unsigned hint_s;
  __shared__ float carry_s;
  __shared__ float buf[32 * kWinA];  // the look-back's totals
  constexpr int kSW = Stage<DT>::kSlabWords;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int slabs = chain * warps;
  const int regions = resident + (resident < chain ? 1 : 0);
  float* carries = reinterpret_cast<float*>(smem + regions * warps * kSW);
  uint32_t* staging = smem + (resident * warps + warp) * kSW;
  unsigned* totals = scratch + kHeaderWords;
  Word* states = reinterpret_cast<Word*>(totals + ((gridDim.x + 1) & ~1u));

  if (threadIdx.x == 0) {                                      // 1. ticket
    const unsigned hint = ld_u32(scratch + 1);  // beside the atomic
    const unsigned ticket = atomicAdd(scratch, 1u);
    hint_s = hint;
    tile_s = ticket;
  }
  __syncthreads();
  const long long tile = tile_s;
  const long long link = static_cast<long long>(block_rows) * kM;
  const long long w0 = tile * link * chain + warp * kSlab;
  for (int r = 0; r < resident; ++r)                           // 2. load
    stage_async<DT>(smem + (r * warps + warp) * kSW, x, n, w0 + r * link, lane);
  cp_async_wait_all();
  __syncwarp();
  for (int r = 0; r < chain; ++r) {                            // 3. totals
    const uint32_t* slab = smem + (r * warps + warp) * kSW;
    if (r >= resident) {
      stage_async<DT>(staging, x, n, w0 + r * link, lane);
      cp_async_wait_all();
      __syncwarp();
      slab = staging;
    }
    float lo[4], hi[4];
    const float total =
        __shfl_sync(0xffffffffu, slab_scan<DT>(slab, lane, lo, hi), 15);
    if (lane == 0) carries[r * warps + warp] = total;
    __syncwarp();  // the staging slab is free again
  }
  __syncthreads();  // the slab totals are visible to warp 0
  if (warp == 0) {
    float running = 0.0f;
    for (int s0 = 0; s0 < slabs; s0 += 32) {
      const int sl = s0 + lane;
      const float v = sl < slabs ? carries[sl] : 0.0f;
      const float incl = warp_scan(v, lane);
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      if (sl < slabs) carries[sl] = __fadd_rn(running, excl);
      running = __fadd_rn(running, __shfl_sync(0xffffffffu, incl, 31));
    }
    if (lane == 0) st_u32(totals + tile, ~canonical(running));  // 4.
    float s = 0.0f, c = 0.0f;  // the fold of tiles 0 .. tile - 1
    unsigned steps = 0;
    if (tile > 0)                                              // 5, 6.
      steps = look_back(totals, states, scratch + 1, hint_s, tile, lane,
                        buf, s, c);
    if (lane == 0) {                                           // 7.
      carry_s = carry_of(s, c);
      fold(s, c, running);
      st_word(states + tile, inclusive_word(s, c));
      atomicMax(scratch + 1, static_cast<unsigned>(tile + 1));
      atomicAdd(scratch + 2, steps);
    }
  }
  __syncthreads();

  const float tile_carry = carry_s;
  const int g = lane >> 2, t = lane & 3;
  if (exclusive && tile == 0 && threadIdx.x == 0 && n > 0) out[0] = 0.0f;
  for (int r = 0; r < chain; ++r) {
    const uint32_t* slab = smem + (r * warps + warp) * kSW;
    if (r >= resident) {
      stage_async<DT>(staging, x, n, w0 + r * link, lane);
      cp_async_wait_all();
      __syncwarp();
      slab = staging;
    }
    float lo[4], hi[4];
    const float incl = slab_scan<DT>(slab, lane, lo, hi);
    __syncwarp();  // the staging slab is free again
    // Exclusive row carries of rows g and g + 8.
    float c_g = __shfl_sync(0xffffffffu, incl, (g + 31) & 31);
    const float c_g8 = __shfl_sync(0xffffffffu, incl, g + 7);
    if (g == 0) c_g = 0.0f;
    const float slab_carry = carries[r * warps + warp];
    const float row_g = __fadd_rn(slab_carry, c_g);
    const float row_g8 = __fadd_rn(slab_carry, c_g8);
    const long long sb = w0 + r * link;
    const long long i_g = sb + g * kM + 2 * t, i_g8 = i_g + 8 * kM;
    store2(out, n, i_g,
           __fadd_rn(__fadd_rn(lo[0], row_g), tile_carry),
           __fadd_rn(__fadd_rn(lo[1], row_g), tile_carry), exclusive);
    store2(out, n, i_g + 8,
           __fadd_rn(__fadd_rn(hi[0], row_g), tile_carry),
           __fadd_rn(__fadd_rn(hi[1], row_g), tile_carry), exclusive);
    store2(out, n, i_g8,
           __fadd_rn(__fadd_rn(lo[2], row_g8), tile_carry),
           __fadd_rn(__fadd_rn(lo[3], row_g8), tile_carry), exclusive);
    store2(out, n, i_g8 + 8,
           __fadd_rn(__fadd_rn(hi[2], row_g8), tile_carry),
           __fadd_rn(__fadd_rn(hi[3], row_g8), tile_carry), exclusive);
  }
}

bool bad_geometry(int chain, int block_rows) {
  return chain < 1 || chain > kMaxChain || block_rows < kM ||
         block_rows % kM != 0 || 2 * block_rows > kMaxThreads;
}

// Tiles for n elements at `tile` elements a tile; 0 when the grid
// would exceed the launch limit.
long long tiles_for(long long n, long long tile) {
  const long long g = n > 0 ? (n + tile - 1) / tile : 1;
  return g <= 0x7fffffffLL ? g : 0;
}

template <int DT>
cudaError_t launch(const void* x, long long n, int chain, int block_rows,
                   int exclusive, unsigned* scratch, float* out,
                   cudaStream_t s) {
  const long long tiles = tiles_for(n, static_cast<long long>(chain) * block_rows * kM);
  if (tiles == 0) return cudaErrorInvalidValue;
  const int threads = 2 * block_rows, warps = threads / 32;
  int resident = chain;
  while (resident >= 0 && smem_bytes<DT>(chain, warps, resident) > kSmemLimit)
    --resident;
  if (resident < 0) return cudaErrorInvalidValue;
  const int bytes = static_cast<int>(smem_bytes<DT>(chain, warps, resident));
  // Blocks of up to 128 rows run four or five to an SM; registers are
  // held to what that many blocks leave.
  auto kernel = threads <= kSmallThreads
                    ? scan_kernel<DT, kSmallThreads, kSmallBlocks[DT]>
                    : scan_kernel<DT, kMaxThreads, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles), threads, bytes, s>>>(
      x, n, chain, block_rows, resident, exclusive, scratch, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mma_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B6: out[0..n) = the inclusive (exclusive != 0: exclusive) f32 prefix
// sum of x, in one launch.  scratch holds 4 + 4 G zeroed 32-bit words
// for G tiles of chain * block_rows * 16 elements (the ticket counter,
// then each tile's state), 16-byte aligned.
int b6_scan(const void* x, long long n, int dtype, int chain,
            int block_rows, int exclusive, unsigned* scratch, float* out,
            void* stream) {
  if (bad_geometry(chain, block_rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<kF32>(x, n, chain, block_rows, exclusive, scratch, out, s);
  if (dtype == kBF16)
    return launch<kBF16>(x, n, chain, block_rows, exclusive, scratch, out, s);
  if (dtype == kF16)
    return launch<kF16>(x, n, chain, block_rows, exclusive, scratch, out, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
