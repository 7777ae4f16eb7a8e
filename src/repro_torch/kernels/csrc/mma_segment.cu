// Segmented sum against a factored in-register one-hot for Hopper
// (sm_90a): kernel B7 of the port, with a plain C interface bound from
// Python through ctypes (repro_torch/kernels/_build.py,
// repro_torch/kernels/mma_segment.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mma_scan.py
// mma_segment_sum_kernel (launched by segment_sum_call): out[s] = the
// f32 sum of the values whose id is s, for s in [0, S); an id outside
// [0, S), -1 included, adds nothing.
//
// Encoding (the paper's ones-MMA with a one-hot segment matrix in place
// of the ones matrix, factored).  A group is 16 consecutive elements, the
// k of one mma.sync.m16n8k16.  A pass takes the segments [base, base +
// count); write u = id - base = 16 h + r (r = u mod 16).  For a block j
// of 128 segments,
//
//   D (16 x 8, f32) = A (16 x 16) x B (16 x 8)
//   A[r][k] = (r_k == r)                      1.0 or 0.0, exact in bf16
//                                             and fp16; the same for
//                                             every block
//   B[k][c] = (h_k == 8 j + c) ? word(v_k) : 0
//
// so D[r][c] is the word's sum over the group's elements of segment
// base + 128 j + 16 c + r: one MMA covers 128 segments.  f32 values go
// in as three bf16 words (hi, mid, lo, the port's split_f32_words),
// which rebuild a normal-range f32 exactly; bf16 and fp16 values as
// they are.  The words of a group chain in the tensor core (lo, then
// mid, then hi, from zero: three adds a group, far inside the 2^-20
// the plain version is held to, and exact on integer data), and each
// group's D is added into the warp's f32 sums on the CUDA cores with
// _rn intrinsics, never chained from group to group.
//
// The fragment.  Lane (g, t) holds A's rows g and g + 8 and B's column
// g at k slots 2t, 2t + 1, 2t + 8, 2t + 9.  The contraction order inside
// a group is free, so those slots take elements 4t .. 4t + 3, one slot
// of 4 consecutive elements.  One cvt.pack.sat.s16.s32 per pair packs u
// (saturated to 16 bits, so a stray id lands past every block), and one
// logic op each makes A's keys (0x3f80 | r) and B's keys
// ((u & 0xfff0) ^ 0x4000) per half: distinct finite floats that one
// packed compare (heq2) against the lane's row or column key turns into
// A's register or a 1.0 / 0.0 mask that one packed multiply applies to
// a word pair.  Its four D registers end as segments 16 * 2t + g,
// 16 * (2t + 1) + g and the same + 8 of the block.
//
// Layout of the work.  A block has block_rows / 16 warps.  Warps take
// steps of 256 elements (16 groups) grid-stride: global warp gw takes
// steps gw, gw + W_total, ...  Each warp streams its steps through its
// own ring of stages in shared memory: lane 0 keeps cp.async.bulk
// copies (1-D TMA, ids and values of a step on one mbarrier) in flight
// for the next stages while the warp computes the current one.  Once a
// step has landed, each lane prepares 8 of its elements once (their
// ids packed, f32 values split into words) into the warp's operands,
// which the 8 lanes that share a slot then read with one or two 16-byte
// loads a group: the work those 8 lanes would repeat is done once, and
// every load and store of it runs on consecutive 16 bytes (no bank
// conflicts).  A pass of one block (S <= 128) keeps its sums in 4
// registers a lane, of two blocks in 8 (a step that hits both walks its
// groups once per block); past that in a float4 a lane and block in
// shared memory.  For more than one block a step first finds the blocks
// between its least and greatest id (a warp-wide min / max) and skips
// the rest: sorted ids hit one.  No sum is written by two lanes or two
// warps, so no atomics: the block then sums its warps' sums in warp
// order into one partial per (block, segment).  A second launch sums
// each column of the (G, S) partials in a fixed order (one warp per
// column: a strided run per lane, then a shuffle tree).  Every sum runs
// in a fixed order, so the result has the same bits on every run;
// nothing uses float atomics.
//
// Passes.  A pass holds at most 64 blocks (8192 segments; the column
// keys stay positive normal floats), and as many as the block's shared
// memory beside its rings holds in f32 (pass_segments).  A larger S
// runs in passes, each re-reading the input.
//
// The ragged tail is masked in the kernel: the last step, when it is not
// whole, is read straight from global memory, an element at or past n
// as id -1 and value 0; no padded copy of values or ids is made.
//
// Bound on the H100.  The function reads 4 bytes of id and 2-4 bytes of
// value per element once per pass (8 per f32 element, 6 per 16-bit
// one) and writes S floats: 0.64 / 0.48 ms at n = 2^28 and 3.35 TB/s.
// The tensor cores take one MMA per group, word and block hit (at S =
// 128, 0.21 ms of bf16 MMAs in f32 at 989 TFLOP/s), so below a few
// blocks the bytes bound it.  What it takes beyond the bytes is the
// lane work a group: from a prepared slot the keys (two logic ops), six
// compares, a mask multiply a word pair, one MMA a word and four adds,
// ~20 instructions in 16 bits and ~28 in f32 against the ~26 and ~35
// that the memory's rate leaves a group on an SM; the ring's depth
// beyond 2 stages buys nothing (probes/b7_forms.py).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int kM = 16;                     // elements per group (the MMA's k)
constexpr int kStep = 256;                 // elements a warp takes per step
constexpr int kGroups = kStep / kM;        // groups per step
constexpr int kBlockSegs = 128;            // segments one MMA covers
constexpr bool kRing = true;               // steps through a ring of stages
constexpr int kStages = 2;                 // ring stages a warp, at most
constexpr int kRingBytes = 98304;          // a block's rings beyond: fewer
                                           // stages (2 at least)
constexpr int kUnroll = 16;                // groups of a staged step
                                           // unrolled together
constexpr int kRegBlocks = 2;              // blocks kept in registers
constexpr int kMaxPassBlocks = 64;         // blocks one pass takes at most
constexpr int kMaxThreads = 1024;          // block_rows <= 512
constexpr int kSmemPerBlock = 232448;      // 227 KB, opt-in dynamic
constexpr int kColumnThreads = 256;        // launch 2: 8 columns a block

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// Where a pass keeps its warps' sums: registers for one or two blocks,
// shared memory past that.
enum Sums { kShared = 0, kReg1 = 1, kReg2 = 2 };

__host__ __device__ constexpr int value_bytes(int dt) {
  return dt == kF32 ? 4 : 2;
}
__host__ __device__ constexpr int stage_bytes(int vb) {
  return kStep * (4 + vb);
}

// Stages of each warp's ring: kStages, fewer (at least 2) where a
// block's rings would pass kRingBytes.
int stages(int vb, int warps) {
  const int fit = kRingBytes / (warps * stage_bytes(vb));
  return fit < 2 ? 2 : (fit > kStages ? kStages : fit);
}

// Bytes of a block's mbarriers (a multiple of 16).
int bar_bytes(int vb, int warps) {
  return (warps * stages(vb, warps) * 8 + 15) / 16 * 16;
}

// Bytes of a lane slot's operands (4 elements: their packed ids, then
// their value words) and of a warp's operands of a step.
__host__ __device__ constexpr int slot_bytes(int vb) {
  return vb == 4 ? 32 : 16;
}
__host__ __device__ constexpr int operand_bytes(int vb) {
  return kStep / 4 * slot_bytes(vb);
}

// Bytes of a block's rings, their mbarriers and its warps' operands (a
// multiple of 16).
int ring_bytes(int vb, int warps) {
  return warps * (stages(vb, warps) * stage_bytes(vb) + operand_bytes(vb)) +
         bar_bytes(vb, warps);
}

// Segments one pass takes: whole 128-segment blocks whose per-warp f32
// sums fit the block's shared memory beside its rings, at most
// kMaxPassBlocks of them.
int pass_segments(int vb, int warps) {
  const int fit =
      (kSmemPerBlock - ring_bytes(vb, warps)) / (4 * warps * kBlockSegs);
  return (fit < kMaxPassBlocks ? fit : kMaxPassBlocks) * kBlockSegs;
}

// A 1-D bulk copy of `bytes` (a multiple of 16) from global memory into
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// id - base, wrapping: an id below a pass's base wraps past every block
// or stays negative.
__device__ __forceinline__ int offset(int id, int base) {
  return static_cast<int>(static_cast<unsigned>(id) -
                          static_cast<unsigned>(base));
}

// Two ints saturated to 16 bits and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_sat(int lo, int hi) {
  uint32_t d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;\n" : "=r"(d) : "r"(hi), "r"(lo));
  return d;
}

// Packed compare: 1.0 or 0.0 per half, in the MMA's 16-bit type (bf16
// for f32 and bf16 values, fp16 for fp16).
template <int DT>
__device__ __forceinline__ uint32_t eq2(uint32_t x, uint32_t y) {
  uint32_t r;
  if constexpr (DT == kF16) {
    const __half2 e = __heq2(*reinterpret_cast<const __half2*>(&x),
                             *reinterpret_cast<const __half2*>(&y));
    r = *reinterpret_cast<const uint32_t*>(&e);
  } else {
    const __nv_bfloat162 e =
        __heq2(*reinterpret_cast<const __nv_bfloat162*>(&x),
               *reinterpret_cast<const __nv_bfloat162*>(&y));
    r = *reinterpret_cast<const uint32_t*>(&e);
  }
  return r;
}

// Packed multiply by a 1.0 / 0.0 mask: the word itself or zero.
template <int DT>
__device__ __forceinline__ uint32_t mul2(uint32_t x, uint32_t y) {
  uint32_t r;
  if constexpr (DT == kF16) {
    const __half2 e = __hmul2(*reinterpret_cast<const __half2*>(&x),
                              *reinterpret_cast<const __half2*>(&y));
    r = *reinterpret_cast<const uint32_t*>(&e);
  } else {
    const __nv_bfloat162 e =
        __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                *reinterpret_cast<const __nv_bfloat162*>(&y));
    r = *reinterpret_cast<const uint32_t*>(&e);
  }
  return r;
}

template <int DT>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (DT == kF16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats as a bf16 pair rounded to nearest, the first in the low
// half (the last word of the split: its rest is zero).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// lop3.b32 with both constants in operands, one instruction (the
// compiler splits a logic op with two immediates in two).
template <uint32_t kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
}
constexpr uint32_t kAndOr = 0xEA;   // (a & b) | c
constexpr uint32_t kAndXor = 0x6A;  // (a & b) ^ c

// One group's operands in lane (g, t): A's four registers, B's keys of
// elements (4t, 4t + 1) and (4t + 2, 4t + 3), and their word pairs, most
// significant first.
template <int DT>
struct Operands {
  static constexpr int kWords = DT == kF32 ? 3 : 1;
  uint32_t a[4];
  uint32_t key[2];
  uint32_t w[kWords][2];
};

// Four ids packed in two words: id - base of each pair, saturated to 16
// bits (a stray id lands past every block).
__device__ __forceinline__ uint2 packed_ids(int4 id, int base) {
  return make_uint2(pack_sat(offset(id.x, base), offset(id.y, base)),
                    pack_sat(offset(id.z, base), offset(id.w, base)));
}

// A and B's keys from the lane's four packed ids.
template <int DT>
__device__ __forceinline__ void keys(Operands<DT>& op, uint2 packed,
                                     uint32_t row_g, uint32_t row_g8) {
  const uint32_t p01 = packed.x, p23 = packed.y;
  const uint32_t a01 = lop3<kAndOr>(p01, 0x000f000fu, 0x3f803f80u);
  const uint32_t a23 = lop3<kAndOr>(p23, 0x000f000fu, 0x3f803f80u);
  // a0 / a1: rows g / g + 8 at k 2t, 2t + 1; a2 / a3 at 2t + 8, 2t + 9.
  op.a[0] = eq2<DT>(a01, row_g);
  op.a[1] = eq2<DT>(a01, row_g8);
  op.a[2] = eq2<DT>(a23, row_g);
  op.a[3] = eq2<DT>(a23, row_g8);
  op.key[0] = lop3<kAndXor>(p01, 0xfff0fff0u, 0x40004000u);
  op.key[1] = lop3<kAndXor>(p23, 0xfff0fff0u, 0x40004000u);
}

// The four values' words, split in the lane: raw holds f32 bits, or two
// 16-bit pairs in raw.x, raw.y.
template <int DT>
__device__ __forceinline__ void words(Operands<DT>& op, const uint4 raw) {
  if constexpr (DT == kF32) {
    float x0 = __uint_as_float(raw.x), x1 = __uint_as_float(raw.y);
    float x2 = __uint_as_float(raw.z), x3 = __uint_as_float(raw.w);
    op.w[0][0] = hopper::split(x0, x1);
    op.w[0][1] = hopper::split(x2, x3);
    op.w[1][0] = hopper::split(x0, x1);
    op.w[1][1] = hopper::split(x2, x3);
    op.w[2][0] = bf16_pair(x0, x1);
    op.w[2][1] = bf16_pair(x2, x3);
  } else {
    op.w[0][0] = raw.x;
    op.w[0][1] = raw.y;
  }
}

// Block j's MMAs of a group, added into d in the tensor core (col: the
// lane's column key in that block): d0 = segment 128 j + 32 t + g,
// d1 = + 16, d2 = + 8, d3 = + 24.
template <int DT>
__device__ __forceinline__ void block_mma(float (&d)[4],
                                          const Operands<DT>& op,
                                          uint32_t col) {
  const uint32_t m0 = eq2<DT>(op.key[0], col), m1 = eq2<DT>(op.key[1], col);
#pragma unroll
  for (int w = Operands<DT>::kWords - 1; w >= 0; --w)
    mma<DT>(d, op.a, mul2<DT>(op.w[w][0], m0), mul2<DT>(op.w[w][1], m1));
}

constexpr uint32_t kColStep = 0x00800080u;  // the next block's column key

// A group into shared-memory sums: blocks jlo .. jhi, each from zero.
template <int DT>
__device__ __forceinline__ void add_shared(float4* mine,
                                           const Operands<DT>& op,
                                           uint32_t col0, int jlo, int jhi,
                                           int lane) {
  for (int j = jlo; j <= jhi; ++j) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    block_mma<DT>(d, op, col0 + j * kColStep);
    float4 v = mine[j * 32 + lane];
    v.x = __fadd_rn(v.x, d[0]);
    v.y = __fadd_rn(v.y, d[1]);
    v.z = __fadd_rn(v.z, d[2]);
    v.w = __fadd_rn(v.w, d[3]);
    mine[j * 32 + lane] = v;
  }
}

// A group into register sums, the blocks in MASK (bit j: block j), each
// from zero.
template <int DT, int MASK>
__device__ __forceinline__ void add_registers(float (&acc)[kRegBlocks][4],
                                              const Operands<DT>& op,
                                              uint32_t col0) {
#pragma unroll
  for (int j = 0; j < kRegBlocks; ++j) {
    if (!(MASK >> j & 1)) continue;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    block_mma<DT>(d, op, col0 + j * kColStep);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = __fadd_rn(acc[j][k], d[k]);
  }
}

// A group's four ids and values for this lane from global memory,
// element e (a multiple of 4) on: masked past n (id -1, value 0).
template <int DT>
__device__ __forceinline__ void load_global(int4& id, uint4& raw,
                                            const int* ids,
                                            const void* values, long long e,
                                            long long n) {
  if (e + 4 <= n) {
    id = __ldg(reinterpret_cast<const int4*>(ids + e));
    if constexpr (DT == kF32) {
      raw = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const float*>(values) + e));
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const uint16_t*>(values) + e));
      raw = make_uint4(v.x, v.y, 0u, 0u);
    }
    return;
  }
  int i[4];
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = e + k < n;
    i[k] = in ? __ldg(ids + e + k) : -1;
    if constexpr (DT == kF32)
      v[k] = in ? __float_as_uint(__ldg(static_cast<const float*>(values) +
                                        e + k))
                : 0u;
    else
      v[k] = in ? static_cast<uint32_t>(
                      __ldg(static_cast<const unsigned short*>(values) + e +
                            k))
                : 0u;
  }
  id = make_int4(i[0], i[1], i[2], i[3]);
  if constexpr (DT == kF32)
    raw = make_uint4(v[0], v[1], v[2], v[3]);
  else
    raw = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16), 0u, 0u);
}

// The blocks of the pass between a step's least and greatest id, [lo,
// hi] (lo > hi: none), warp-wide, from each lane's least and greatest
// of its 8 ids.  Every block a valid id hits is in it; an id outside the
// pass widens it to the pass's edge (a block no id hits adds zeros).
__device__ __forceinline__ int2 step_blocks(int lo, int hi, int base,
                                            int count) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const long long l = static_cast<long long>(lo) - base;
  const long long h = static_cast<long long>(hi) - base;
  if (h < 0 || l >= count) return make_int2(1, 0);
  return make_int2(static_cast<int>(l < 0 ? 0 : l / kBlockSegs),
                   static_cast<int>((h < count ? h : count - 1) /
                                    kBlockSegs));
}

// Each lane prepares 8 of a staged step's elements once, slots lane and
// lane + 32 (slot 4q + t, elements 4 (4q + t) .. + 3, is lane t's share
// of group q): their ids packed, and their values as they are (16-bit:
// a 16-byte slot) or split into three bf16 words (f32: the packed ids
// and hi in one plane of 16-byte slots, mid and lo in a second), into
// the warp's operands.  Lanes read and write consecutive 16 bytes, no
// bank conflicts.  lo and hi: the least and greatest of its ids, for the
// step's blocks.
template <int DT>
__device__ __forceinline__ void prepare_step(unsigned char* operands,
                                             const unsigned char* stage,
                                             int base, int lane, int& lo,
                                             int& hi) {
  const unsigned char* vals = stage + 4 * kStep;
  uint4* slots = reinterpret_cast<uint4*>(operands);
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = lane + 32 * h;
    const int4 id = reinterpret_cast<const int4*>(stage)[slot];
    lo = min(lo, min(min(id.x, id.y), min(id.z, id.w)));
    hi = max(hi, max(max(id.x, id.y), max(id.z, id.w)));
    const uint2 p = packed_ids(id, base);
    if constexpr (DT == kF32) {
      const float4 x = reinterpret_cast<const float4*>(vals)[slot];
      float x0 = x.x, x1 = x.y, x2 = x.z, x3 = x.w;
      const uint32_t hi01 = hopper::split(x0, x1);
      const uint32_t hi23 = hopper::split(x2, x3);
      const uint32_t mid01 = hopper::split(x0, x1);
      const uint32_t mid23 = hopper::split(x2, x3);
      slots[slot] = make_uint4(p.x, p.y, hi01, hi23);
      slots[kStep / 4 + slot] = make_uint4(mid01, mid23, bf16_pair(x0, x1),
                                           bf16_pair(x2, x3));
    } else {
      const uint2 v = reinterpret_cast<const uint2*>(vals)[slot];
      slots[slot] = make_uint4(p.x, p.y, v.x, v.y);
    }
  }
}

// A prepared step's 16 groups into the warp's sums: register sums in the
// blocks of MASK, or shared-memory sums in blocks jlo .. jhi.
template <int DT, int SUMS, int MASK>
__device__ __forceinline__ void staged_groups(
    float (&acc)[kRegBlocks][4], float4* mine, const unsigned char* operands,
    uint32_t row_g, uint32_t row_g8, uint32_t col0, int jlo, int jhi,
    int lane, int t) {
  const uint4* slot = reinterpret_cast<const uint4*>(operands);
#pragma unroll kUnroll
  for (int q = 0; q < kGroups; ++q) {
    Operands<DT> op;
    if constexpr (DT == kF32) {
      const uint4 a = slot[4 * q + t], b = slot[kStep / 4 + 4 * q + t];
      keys<DT>(op, make_uint2(a.x, a.y), row_g, row_g8);
      op.w[0][0] = a.z;
      op.w[0][1] = a.w;
      op.w[1][0] = b.x;
      op.w[1][1] = b.y;
      op.w[2][0] = b.z;
      op.w[2][1] = b.w;
    } else {
      const uint4 a = slot[4 * q + t];
      keys<DT>(op, make_uint2(a.x, a.y), row_g, row_g8);
      op.w[0][0] = a.z;
      op.w[0][1] = a.w;
    }
    if constexpr (SUMS == kShared)
      add_shared<DT>(mine, op, col0, jlo, jhi, lane);
    else
      add_registers<DT, MASK>(acc, op, col0);
  }
}

// Launch 1, one pass over segments [base, base + count): the (block,
// segment) partials.  Shared memory: each warp's ring of nst stages,
// their mbarriers, each warp's split words (f32), then (SUMS == kShared)
// each warp's f32 sums, a float4 a lane and block.
template <int DT, int SUMS>
__global__ void __launch_bounds__(kMaxThreads)
    partials_kernel(const void* values, const int* ids, long long n,
                    int num_segments, int base, int count, int nst,
                    float* partials) {
  constexpr int kVB = value_bytes(DT), kSB = stage_bytes(kVB);
  constexpr int kOB = operand_bytes(kVB);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nblk = (count + kBlockSegs - 1) / kBlockSegs;
  const int rings = warps * nst * kSB;
  const int bars = (warps * nst * 8 + 15) / 16 * 16;
  unsigned char* ring = smem + warp * nst * kSB;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + rings) + warp * nst;
  unsigned char* operands = smem + rings + bars + warp * kOB;
  float4* mine = reinterpret_cast<float4*>(smem + rings + bars +
                                           warps * kOB) +
                 warp * nblk * (kBlockSegs / 4);
  if (SUMS == kShared)
    for (int i = lane; i < nblk * 32; i += 32)
      mine[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kRing && lane == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  const long long full = n / kStep, steps = (n + kStep - 1) / kStep;
  const long long first = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  const int my_steps =
      first < steps ? static_cast<int>((steps - 1 - first) / stride + 1) : 0;
  // This warp's i-th step into stage s = i mod nst (whole steps only).
  auto load = [&](int i, int s) {
    const long long step = first + i * stride;
    if (step >= full) return;
    unsigned char* d = ring + s * kSB;
    mbar_expect_tx(&bar[s], kSB);
    bulk_load(d, ids + step * kStep, 4 * kStep, &bar[s]);
    bulk_load(d + 4 * kStep,
              static_cast<const unsigned char*>(values) + step * kStep * kVB,
              kVB * kStep, &bar[s]);
  };
  if (kRing && lane == 0)
    for (int i = 0; i < nst; ++i) load(i, i);

  const uint32_t row_g = (0x3f80u | g) * 0x00010001u;
  const uint32_t row_g8 = (0x3f80u | (g + 8)) * 0x00010001u;
  const uint32_t col0 = (0x4000u + 16u * g) * 0x00010001u;
  float acc[kRegBlocks][4];
#pragma unroll
  for (int j = 0; j < kRegBlocks; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  int st = 0, phase = 0;  // step i's stage (i mod nst) and its parity
  for (int i = 0; i < my_steps; ++i) {
    const long long step = first + i * stride, e0 = step * kStep;
    int jlo = 0, jhi = 0;
    if (kRing && step < full) {
      const unsigned char* stage = ring + st * kSB;
      mbar_wait(&bar[st], phase);
      int lo, hi;
      prepare_step<DT>(operands, stage, base, lane, lo, hi);
      __syncwarp();
      if (SUMS != kReg1) {
        const int2 r = step_blocks(lo, hi, base, count);
        jlo = r.x;
        jhi = r.y;
      }
      if constexpr (SUMS == kReg1) {
        staged_groups<DT, SUMS, 1>(acc, mine, operands, row_g, row_g8, col0,
                                   0, 0, lane, t);
      } else if constexpr (SUMS == kReg2) {
        // A step that hits both blocks walks its groups once for each.
        if (jlo <= 0 && jhi >= 0)
          staged_groups<DT, SUMS, 1>(acc, mine, operands, row_g, row_g8,
                                     col0, 0, 0, lane, t);
        if (jlo <= 1 && jhi >= 1)
          staged_groups<DT, SUMS, 2>(acc, mine, operands, row_g, row_g8,
                                     col0, 0, 0, lane, t);
      } else if (jlo <= jhi) {
        staged_groups<DT, SUMS, 0>(acc, mine, operands, row_g, row_g8, col0,
                                   jlo, jhi, lane, t);
      }
    } else {
      if (SUMS != kReg1) {
        int lo = INT_MAX, hi = INT_MIN;
        const long long e = e0 + 8 * lane;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int id = e + k < n ? __ldg(ids + e + k) : -1;
          lo = min(lo, id);
          hi = max(hi, id);
        }
        const int2 r = step_blocks(lo, hi, base, count);
        jlo = r.x;
        jhi = r.y;
      }
      for (int q = 0; q < kGroups && e0 + q * kM < n; ++q) {
        int4 id;
        uint4 raw;
        load_global<DT>(id, raw, ids, values, e0 + q * kM + 4 * t, n);
        Operands<DT> op;
        keys<DT>(op, packed_ids(id, base), row_g, row_g8);
        words<DT>(op, raw);
        if constexpr (SUMS == kShared) {
          add_shared<DT>(mine, op, col0, jlo, jhi, lane);
        } else {
          if (jlo <= 0 && jhi >= 0) add_registers<DT, 1>(acc, op, col0);
          if (SUMS == kReg2 && jlo <= 1 && jhi >= 1)
            add_registers<DT, 2>(acc, op, col0);
        }
      }
    }
    if (kRing) {
      // Every lane is done with this stage: it takes step i + nst.
      __syncwarp();
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load(i + nst, st);
      }
    }
    if (++st == nst) {
      st = 0;
      phase ^= 1;
    }
  }

  // The warps' sums, a float4 a lane and block, in warp order: register
  // sums go to the warp's own ring first (no copy is in flight).
  const float* sums = reinterpret_cast<const float*>(mine) -
                      warp * nblk * kBlockSegs;
  int between = nblk * kBlockSegs;
  if constexpr (SUMS != kShared) {
    float4* dst = reinterpret_cast<float4*>(ring);
#pragma unroll
    for (int j = 0; j < SUMS; ++j)
      if (j < nblk)
        dst[j * 32 + lane] = make_float4(acc[j][0], acc[j][1], acc[j][2],
                                         acc[j][3]);
    sums = reinterpret_cast<const float*>(smem);
    between = nst * kSB / 4;
  }
  __syncthreads();
  float* out = partials + static_cast<long long>(blockIdx.x) * num_segments
               + base;
  for (int s = threadIdx.x; s < count; s += blockDim.x) {
    // Segment 128 j + 16 c + r sits in lane 4 (r mod 8) + c / 2, register
    // (c mod 2) + 2 (r / 8) of block j.
    const int j = s / kBlockSegs, o = s % kBlockSegs, c = o >> 4, r = o & 15;
    const int idx = (j * 32 + 4 * (r & 7) + (c >> 1)) * 4 + (c & 1) +
                    2 * (r >> 3);
    float v = sums[idx];
    for (int w = 1; w < warps; ++w) v = __fadd_rn(v, sums[w * between + idx]);
    out[s] = v;
  }
}

// Launch 2: out[s] = the sum of column s of the (blocks, S) partials,
// one warp a column: lane l sums rows l, l + 32, ... in order, then a
// butterfly of shuffles; lane 0 writes.
__global__ void __launch_bounds__(kColumnThreads)
    columns_kernel(const float* partials, int blocks, int num_segments,
                   float* out) {
  const int lane = threadIdx.x & 31;
  const long long col = static_cast<long long>(blockIdx.x) *
                            (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (col >= num_segments) return;  // the whole warp together
  float v = 0.0f;
  for (int b = lane; b < blocks; b += 32)
    v = __fadd_rn(v, partials[static_cast<long long>(b) * num_segments + col]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) out[col] = v;
}

template <int DT, int SUMS>
cudaError_t launch_pass(const void* values, const int* ids, long long n,
                        int num_segments, int base, int count, int warps,
                        int blocks, float* partials, cudaStream_t s) {
  constexpr int kVB = value_bytes(DT);
  const int nst = stages(kVB, warps);
  const int nblk = (count + kBlockSegs - 1) / kBlockSegs;
  const size_t smem = static_cast<size_t>(ring_bytes(kVB, warps)) +
                      (SUMS == kShared ? static_cast<size_t>(warps) * nblk *
                                             kBlockSegs * sizeof(float)
                                       : 0);
  cudaError_t err = cudaFuncSetAttribute(
      partials_kernel<DT, SUMS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  partials_kernel<DT, SUMS><<<blocks, warps * 32, smem, s>>>(
      values, ids, n, num_segments, base, count, nst, partials);
  return cudaGetLastError();
}

// One pass, its sums where its blocks fit.
template <int DT>
cudaError_t pass(const void* values, const int* ids, long long n,
                 int num_segments, int base, int count, int warps, int blocks,
                 float* partials, cudaStream_t s) {
  const int nblk = (count + kBlockSegs - 1) / kBlockSegs;
  if (nblk == 1)
    return launch_pass<DT, kReg1>(values, ids, n, num_segments, base, count,
                                  warps, blocks, partials, s);
  if (nblk <= kRegBlocks)
    return launch_pass<DT, kReg2>(values, ids, n, num_segments, base, count,
                                  warps, blocks, partials, s);
  return launch_pass<DT, kShared>(values, ids, n, num_segments, base, count,
                                  warps, blocks, partials, s);
}

template <int DT>
cudaError_t launch(const void* values, const int* ids, long long n,
                   int num_segments, int block_rows, int blocks,
                   float* partials, float* out, cudaStream_t s) {
  const int warps = block_rows / kM;
  const int per_pass = pass_segments(value_bytes(DT), warps);
  for (int base = 0; base < num_segments; base += per_pass) {
    const int count = num_segments - base < per_pass ? num_segments - base
                                                     : per_pass;
    const cudaError_t err = pass<DT>(values, ids, n, num_segments, base,
                                     count, warps, blocks, partials, s);
    if (err != cudaSuccess) return err;
  }
  const int per_block = kColumnThreads / 32;
  const long long grid = (static_cast<long long>(num_segments) + per_block - 1)
                         / per_block;
  columns_kernel<<<static_cast<unsigned>(grid), kColumnThreads, 0, s>>>(
      partials, blocks, num_segments, out);
  return cudaGetLastError();
}

bool bad_geometry(int block_rows, int blocks, int num_segments) {
  return block_rows < kM || block_rows % kM != 0 ||
         2 * block_rows > kMaxThreads || blocks < 1 || num_segments < 1;
}

int dtype_bytes(int dtype) {
  if (dtype == kF32) return 4;
  if (dtype == kBF16 || dtype == kF16) return 2;
  return 0;
}

}  // namespace

extern "C" {

const char* mma_segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Segments one pass of launch 1 takes for this dtype and block_rows
// (0 for an unknown dtype or a bad block_rows).
int b7_pass_segments(int dtype, int block_rows) {
  if (block_rows < kM || block_rows % kM != 0 || 2 * block_rows > kMaxThreads
      || dtype_bytes(dtype) == 0)
    return 0;
  return pass_segments(dtype_bytes(dtype), block_rows / kM);
}

// Shared-memory bytes of a block's rings and their mbarriers (0 for an
// unknown dtype or a bad block_rows).
int b7_ring_bytes(int dtype, int block_rows) {
  if (block_rows < kM || block_rows % kM != 0 || 2 * block_rows > kMaxThreads
      || dtype_bytes(dtype) == 0)
    return 0;
  return ring_bytes(dtype_bytes(dtype), block_rows / kM);
}

// B7: out[0..S) = the f32 segmented sum of values[0..n) by ids[0..n)
// (int32; an id outside [0, S) adds nothing).  partials holds blocks *
// S floats; blocks is the grid of launch 1.  values and ids are 16-byte
// aligned.
int b7_segment_sum(const void* values, const int* ids, long long n,
                   int dtype, int num_segments, int block_rows, int blocks,
                   float* partials, float* out, void* stream) {
  if (bad_geometry(block_rows, blocks, num_segments) || n < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<kF32>(values, ids, n, num_segments, block_rows, blocks,
                        partials, out, s);
  if (dtype == kBF16)
    return launch<kBF16>(values, ids, n, num_segments, block_rows, blocks,
                         partials, out, s);
  if (dtype == kF16)
    return launch<kF16>(values, ids, n, num_segments, block_rows, blocks,
                        partials, out, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
