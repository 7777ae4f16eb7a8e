// Kernel B7 as it stood before its factored one-hot form (commit
// 47a5340, one MMA per group and 16-segment tile, no ring): kept
// unchanged below so that probes/b7_forms.py can build it and time it
// beside the current form on the same card.  It shares the current
// form's C interface (b7_segment_sum, b7_pass_segments).
//
// Segmented sum against an in-register one-hot for Hopper (sm_90a):
// kernel B7 of the port, with a plain C interface bound from Python
// through ctypes (repro_torch/kernels/_build.py,
// repro_torch/kernels/mma_segment.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mma_scan.py
// mma_segment_sum_kernel (launched by segment_sum_call): out[s] = the
// f32 sum of the values whose id is s, for s in [0, S); an id outside
// [0, S), -1 included, adds nothing.
//
// Encoding (the paper's ones-MMA with the one-hot segment matrix in
// place of the ones matrix).  A group is 16 consecutive elements.  For
// each tile of 16 segments s0..s0+15, one mma.sync.m16n8k16 forms
//
//   D (16 x 8, f32) = A (16 x 16) x B (16 x 8)
//   A[s][k] = (ids[k] == s0 + s)     the transposed one-hot, built in
//                                    registers straight into the A
//                                    fragment (one packed 16-bit
//                                    compare per register, below);
//                                    exact in bf16 and fp16
//   B[k][c] = word c of value k      bf16 / fp16 input: one column, the
//                                    value itself; f32: three bf16
//                                    words (hi, mid, lo, the port's
//                                    split_f32_words), which rebuild a
//                                    normal-range f32 exactly
//
// so D[s][c] is word c's sum over the group's elements of segment
// s0 + s.  Each MMA starts from a zero accumulator and its D is added
// on the CUDA cores with _rn intrinsics (the tensor cores' adders may
// truncate a running sum, as B4's design notes).
//
// Layout of the work.  A block has block_rows / 16 warps.  Warps take
// slabs of 16 groups (256 elements) grid-stride: global warp gw takes
// slabs gw, gw + W_total, ...  Per slab a warp loads 4 groups' ids and
// values at a time, finds the range of 16-segment tiles their ids hit
// (a warp-wide min / max; for sorted ids one or two tiles, for random
// ids all of them), and per tile runs one MMA per group, adds the 4 Ds
// in registers and folds them into the warp's own f32 accumulator in
// shared memory, one slot per (word, segment).  No slot is written by
// two lanes or two warps, so no atomics: the block then sums its warps'
// slots in warp order, ((hi + mid) + lo) per warp, into one partial per
// (block, segment).  A second launch sums each column of the (G, S)
// partials in a fixed order (one warp per column: a strided run per
// lane, then a shuffle tree).  Every sum runs in a fixed order, so the
// result has the same bits on every run; nothing uses float atomics.
//
// The per-block accumulator is what the TPU's mask budget becomes.  It
// holds warps * words * S f32 slots, and a block has at most 232,448
// bytes of shared memory (227 KB): S <= 232448 / (4 * warps * words),
// rounded down to whole 16-segment tiles, and at most 256 tiles (the
// one-hot keys below are 16-bit floats): 2416 segments at 8 warps in
// f32, 4096 in 16 bits, 592 at 32 warps in f32.  A larger S runs in
// passes of that many segments, each re-reading the whole input (each
// pass costs a full read of values and ids).
//
// The ragged tail is masked in the kernel: an element at or past n
// reads as id -1, value 0; no padded copy of values or ids is made.
//
// Bound on the H100.  The function reads 4 bytes of id and 2-4 bytes
// of value per element (8 per f32 element, 6 per 16-bit one) and
// writes S floats.  The one-hot costs S / 16 MMAs per 16 elements, 16 *
// S tensor-core flops per element (5.5e14 at n = 2^28, S = 128: 0.56 ms
// at 989 TFLOP/s, against a 0.64 ms bytes bound in f32), so above S of
// about 128 (f32) the tensor cores, not the bytes, bound it.  In
// practice this simple form is bound by the instructions it issues:
// per group of 16 elements the loads, the f32 word split (three packed
// cvts per pair of elements) and the one-hot keys (integer operations
// only), and per tile four packed compares, the MMA and four adds.
// Random ids at S = 128 take about ten times the bound.  Skipping tiles
// that no id of a batch of groups hits makes sorted ids cheaper at any
// S; their cost is then the per-group work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kM = 16;                  // elements per group (the MMA's k)
constexpr int kSlabGroups = 16;         // groups per warp step
constexpr int kSlab = kM * kSlabGroups; // elements per warp step
constexpr int kBatch = 4;               // groups loaded together
constexpr int kMaxThreads = 1024;       // block_rows <= 512
constexpr int kSmemPerBlock = 232448;   // 227 KB, opt-in dynamic
constexpr int kColumnThreads = 256;     // launch 2: 8 columns a block

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int DT>
struct Traits {
  static constexpr int kWords = DT == kF32 ? 3 : 1;
};

// Segments one pass takes: whole 16-segment tiles whose per-warp f32
// slots fit the block's shared memory, and at most kMaxTiles tiles (the
// one-hot keys are 16-bit floats, exact up to 256).
constexpr int kMaxTiles = 256;

int pass_segments(int words, int warps) {
  const int tiles = kSmemPerBlock / (4 * warps * words) / kM;
  return (tiles < kMaxTiles ? tiles : kMaxTiles) * kM;
}

// Two floats as a bf16 pair rounded to nearest, the lower in the low
// half (one cvt.rn.bf16x2.f32).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Word w of the round-to-nearest split of two f32 values into three
// bf16 words each (split_f32_words: hi = rn(x), mid = rn(x - hi), lo =
// rn of the rest), as a pair: one B-fragment register.
__device__ __forceinline__ uint32_t f32_word_pair(float x0, float x1, int w) {
  const uint32_t hi = bf16_pair(x0, x1);
  const float r0 = __fsub_rn(x0, __uint_as_float(hi << 16));
  const float r1 = __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u));
  const uint32_t mid = bf16_pair(r0, r1);
  const float q0 = __fsub_rn(r0, __uint_as_float(mid << 16));
  const float q1 = __fsub_rn(r1, __uint_as_float(mid & 0xffff0000u));
  const uint32_t lo = bf16_pair(q0, q1);
  return w == 0 ? hi : (w == 1 ? mid : lo);
}

// One lane's share of a group: the ids of elements 2t, 2t + 1, 2t + 8,
// 2t + 9 (the columns of its A fragment) and its B fragment, column g
// of B: b0 = words of elements 2t, 2t + 1, b1 = of 2t + 8, 2t + 9, the
// lower element in the low half.
struct Group {
  int id[4];
  uint32_t b[2];
};

template <int DT>
__device__ __forceinline__ void load_group(Group& grp, const void* values,
                                           const int* ids, long long n,
                                           long long e0, int g, int t) {
  const long long a = e0 + 2 * t, c = a + 8;
  const bool whole = e0 + kM <= n;
  if (whole) {
    const int2 p = __ldg(reinterpret_cast<const int2*>(ids + a));
    const int2 q = __ldg(reinterpret_cast<const int2*>(ids + c));
    grp.id[0] = p.x; grp.id[1] = p.y; grp.id[2] = q.x; grp.id[3] = q.y;
  } else {
    grp.id[0] = a < n ? __ldg(ids + a) : -1;
    grp.id[1] = a + 1 < n ? __ldg(ids + a + 1) : -1;
    grp.id[2] = c < n ? __ldg(ids + c) : -1;
    grp.id[3] = c + 1 < n ? __ldg(ids + c + 1) : -1;
  }
  grp.b[0] = grp.b[1] = 0u;
  if (g >= Traits<DT>::kWords) return;
  if (DT == kF32) {
    const float* v = static_cast<const float*>(values);
    float x[4];
    if (whole) {
      const float2 p = __ldg(reinterpret_cast<const float2*>(v + a));
      const float2 q = __ldg(reinterpret_cast<const float2*>(v + c));
      x[0] = p.x; x[1] = p.y; x[2] = q.x; x[3] = q.y;
    } else {
      x[0] = a < n ? __ldg(v + a) : 0.0f;
      x[1] = a + 1 < n ? __ldg(v + a + 1) : 0.0f;
      x[2] = c < n ? __ldg(v + c) : 0.0f;
      x[3] = c + 1 < n ? __ldg(v + c + 1) : 0.0f;
    }
    grp.b[0] = f32_word_pair(x[0], x[1], g);
    grp.b[1] = f32_word_pair(x[2], x[3], g);
  } else {
    const uint16_t* v = static_cast<const uint16_t*>(values);
    if (whole) {
      grp.b[0] = __ldg(reinterpret_cast<const unsigned int*>(v + a));
      grp.b[1] = __ldg(reinterpret_cast<const unsigned int*>(v + c));
    } else {
      const uint32_t x0 = a < n ? __ldg(v + a) : 0u;
      const uint32_t x1 = a + 1 < n ? __ldg(v + a + 1) : 0u;
      const uint32_t x2 = c < n ? __ldg(v + c) : 0u;
      const uint32_t x3 = c + 1 < n ? __ldg(v + c + 1) : 0u;
      grp.b[0] = x0 | (x1 << 16);
      grp.b[1] = x2 | (x3 << 16);
    }
  }
}

template <int DT>
__device__ __forceinline__ void mma_16bit(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if (DT == kF16) {
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

// A lane's one-hot keys.  Each A register holds two entries of one row
// (g or g + 8) for two of the lane's elements; the key of an entry is
// kKeyBias + the tile of the element's segment when the element falls
// in that row, else 0.  Read as 16-bit floats, the keys kKeyBias +
// 0..255 are distinct finite numbers (1.0 upwards) and none is +-0, so
// against tile T one packed compare gives both entries as 1.0 or 0.0:
// A's register k is heq2(key[k], {kKeyBias + T, kKeyBias + T}).  The
// keys are built with integer operations only.
template <int DT>
struct Key {
  static constexpr uint32_t kBias = DT == kF16 ? 0x3c00u : 0x3f80u;
};

template <int DT>
__device__ __forceinline__ uint32_t eq2(uint32_t key, uint32_t tile2) {
  uint32_t r;
  if (DT == kF16) {
    const __half2 e = __heq2(*reinterpret_cast<const __half2*>(&key),
                             *reinterpret_cast<const __half2*>(&tile2));
    r = *reinterpret_cast<const uint32_t*>(&e);
  } else {
    const __nv_bfloat162 e =
        __heq2(*reinterpret_cast<const __nv_bfloat162*>(&key),
               *reinterpret_cast<const __nv_bfloat162*>(&tile2));
    r = *reinterpret_cast<const uint32_t*>(&e);
  }
  return r;
}

// Launch 1, one pass over segments [base, base + count): the (block,
// segment) partials.  Shared memory: per warp, words x cols f32 slots
// (cols = count rounded up to whole tiles).
template <int DT>
__global__ void __launch_bounds__(kMaxThreads)
    partials_kernel(const void* values, const int* ids, long long n,
                    int num_segments, int base, int count, int cols,
                    float* partials) {
  constexpr int kWords = Traits<DT>::kWords;
  extern __shared__ __align__(16) float acc[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slots = warps * kWords * cols;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  float* mine = acc + warp * kWords * cols;
  const long long total = static_cast<long long>(gridDim.x) * warps;
  for (long long slab = static_cast<long long>(blockIdx.x) * warps + warp;
       slab * kSlab < n; slab += total) {
    for (int b0 = 0; b0 < kSlabGroups; b0 += kBatch) {
      const long long e0 = slab * kSlab + b0 * kM;
      if (e0 >= n) break;
      Group grp[kBatch];
      // key[j][0] / [2]: row g, elements 2t, 2t + 1 / 2t + 8, 2t + 9;
      // key[j][1] / [3]: row g + 8, the same elements.
      uint32_t key[kBatch][4];
      int lo = INT_MAX, hi = -1;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        load_group<DT>(grp[j], values, ids, n, e0 + j * kM, g, t);
        uint32_t row_g[4], row_g8[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // Unsigned, so an id below base wraps past count: not in.
          const uint32_t u = static_cast<uint32_t>(grp[j].id[k]) -
                             static_cast<uint32_t>(base);
          const bool in = u < static_cast<uint32_t>(count);
          const uint32_t tile_key = Key<DT>::kBias + (u >> 4);
          const uint32_t row = (u - g) & 15u;   // 0: row g, 8: row g + 8
          row_g[k] = in && row == 0 ? tile_key : 0u;
          row_g8[k] = in && row == 8 ? tile_key : 0u;
          if (in) {
            lo = min(lo, static_cast<int>(u >> 4));
            hi = max(hi, static_cast<int>(u >> 4));
          }
        }
        key[j][0] = row_g[0] | (row_g[1] << 16);
        key[j][1] = row_g8[0] | (row_g8[1] << 16);
        key[j][2] = row_g[2] | (row_g[3] << 16);
        key[j][3] = row_g8[2] | (row_g8[3] << 16);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      for (int tile = lo; tile <= hi; ++tile) {
        const uint32_t tile2 = (Key<DT>::kBias + tile) * 0x00010001u;
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const uint32_t a[4] = {eq2<DT>(key[j][0], tile2),
                                 eq2<DT>(key[j][1], tile2),
                                 eq2<DT>(key[j][2], tile2),
                                 eq2<DT>(key[j][3], tile2)};
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_16bit<DT>(d, a, grp[j].b[0], grp[j].b[1]);
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[q] = __fadd_rn(sum[q], d[q]);
        }
        // d0 = D[g][2t], d1 = D[g][2t + 1], d2 = D[g + 8][2t],
        // d3 = D[g + 8][2t + 1]: column c is word c.
        const int s = 16 * tile + g;
        if (2 * t < kWords) {
          float* w0 = mine + (2 * t) * cols;
          w0[s] = __fadd_rn(w0[s], sum[0]);
          w0[s + 8] = __fadd_rn(w0[s + 8], sum[2]);
        }
        if (2 * t + 1 < kWords) {
          float* w1 = mine + (2 * t + 1) * cols;
          w1[s] = __fadd_rn(w1[s], sum[1]);
          w1[s + 8] = __fadd_rn(w1[s + 8], sum[3]);
        }
      }
    }
  }
  __syncthreads();
  float* out = partials + static_cast<long long>(blockIdx.x) * num_segments
               + base;
  for (int s = threadIdx.x; s < count; s += blockDim.x) {
    float block_sum = 0.0f;
    for (int w = 0; w < warps; ++w) {
      const float* slot = acc + w * kWords * cols + s;
      float v = slot[0];
#pragma unroll
      for (int word = 1; word < kWords; ++word)
        v = __fadd_rn(v, slot[word * cols]);
      block_sum = __fadd_rn(block_sum, v);
    }
    out[s] = block_sum;
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

template <int DT>
cudaError_t launch(const void* values, const int* ids, long long n,
                   int num_segments, int block_rows, int blocks,
                   float* partials, float* out, cudaStream_t s) {
  constexpr int kWords = Traits<DT>::kWords;
  const int warps = block_rows / kM;
  const int per_pass = pass_segments(kWords, warps);
  for (int base = 0; base < num_segments; base += per_pass) {
    const int count = num_segments - base < per_pass ? num_segments - base
                                                     : per_pass;
    const int cols = (count + kM - 1) / kM * kM;
    const size_t smem = static_cast<size_t>(warps) * kWords * cols *
                        sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        partials_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    partials_kernel<DT><<<blocks, warps * 32, smem, s>>>(
        values, ids, n, num_segments, base, count, cols, partials);
    err = cudaGetLastError();
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

}  // namespace

extern "C" {

const char* mma_segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Segments one pass of launch 1 takes for this dtype and block_rows
// (0 for an unknown dtype or a bad block_rows).
int b7_pass_segments(int dtype, int block_rows) {
  if (block_rows < kM || block_rows % kM != 0 || 2 * block_rows > kMaxThreads)
    return 0;
  if (dtype == kF32) return pass_segments(3, block_rows / kM);
  if (dtype == kBF16 || dtype == kF16) return pass_segments(1, block_rows / kM);
  return 0;
}

// B7: out[0..S) = the f32 segmented sum of values[0..n) by ids[0..n)
// (int32; an id outside [0, S) adds nothing).  partials holds blocks *
// S floats; blocks is the grid of launch 1.
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
