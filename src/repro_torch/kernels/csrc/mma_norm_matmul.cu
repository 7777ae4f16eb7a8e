// Fused RMSNorm -> matmul for Hopper (sm_90a): kernel B10 of the port,
// with a plain C interface bound from Python through ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/mma_norm_matmul.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mma_norm_matmul.py
// _nm_kernel (launched by _nm_call and mma_norm_matmul).  For x of shape
// (rows, d), scale (d,), w (d, dout) and optionally w_gate (d, dout) and
// bias (dout,):
//
//   ss[r]   = sum_k x[r][k]^2                 squares in f32, every dtype
//   s1      = 1 + scale                       f32, one rounding each
//   up      = (x s1) @ w,  g = (x s1) @ w_gate   f32 accumulators
//   rstd[r] = rsqrt(ss[r] / d + eps)
//   out     = up * rstd [+ bias]              without w_gate
//   out     = act(g * rstd) * (up * rstd [+ bias])    with it
//
// in that association, act = identity, silu or gelu (tanh form), rounded
// to nearest into x's dtype (f32 or bf16).  Because rstd is a per-row
// scalar, rmsnorm(x) @ w = rstd * ((x s1) @ w): the normalised rows never
// exist in device memory.
//
// Bound on the H100: operations at the models' widths (Gemma-2 2B's MLP
// at 4096 tokens: 2 x 4096 x 2304 x 18432 = 348 GFLOP against ~190 MB),
// bytes at a decode step (128 rows: the weights, 170 MB in f32).
//
// The tensor cores take bf16 words: each f32 operand is split into bf16
// words rounded to nearest, each the rest of the previous (Markidis et
// al.), and a product is the sum of the products of words (i, j) with
// i + j < levels.  The forms, a pure function of the dtypes (Form below,
// mirrored by kernels/mma_norm_matmul.py walk), never of rows:
//   f32 x, f32 w     A three words of x s1, B three of w, the six
//                    products with i + j < 3: about 22 bits a product
//                    (the dropped ones 2^-24 relative);
//   f32 x, bf16 w    A three words of x s1, B w itself (exact), three
//                    products: about 23 bits, so f32 x keeps the 21
//                    bits declared for it whatever the weights' dtype;
//   bf16 x, bf16 w   A two words of x s1 (a bf16 x times an f32 s1),
//                    B w itself: 16 bits, what a bf16 operand allows;
//   bf16 x, f32 w    A x itself, B two words of s1 w (w s1 in f32): 16
//                    bits.
// Every form walks k in steps of 64 columns: a step's products chain
// from zero in the tensor cores (4 MMAs of k 16 a product),
// and the step's sum is added to the running f32 accumulator with
// __fadd_rn on the CUDA cores, so a truncating tensor-core add touches
// only the last bits of one step's partial, never the running sum.
//
// Up to three launches, each operand's words made once:
//   row_kernel     each row's sum of squares, once, in B8's order
//                  (kernels/mma_rmsnorm.py walk: a row's 16-column tiles
//                  in runs of `chunks` 128-byte chunks, run q = c
//                  kStatWarps + w; each run summed from 0 in column
//                  order, the runs of rank c in warp order, rank c's sums
//                  into part[c][row]): the paper's encoding, each f32
//                  square as exact bf16 words (three for f32 x, two for
//                  bf16) against ones in m16n8k16, every MMA from zero,
//                  (hi + mid) + lo per tile.  From the same loads it
//                  writes A's words of x s1, one bf16 plane each, where
//                  the form splits x;
//   weight_kernel  B's words of w (or of s1 w), one bf16 plane each, for
//                  an f32 weight (a bf16 one goes in as it is);
//   nm_kernel      the projections: a block owns 128 rows and 128
//                  columns of the combined projection (128 output
//                  columns of up, or 64 of up beside the same 64 of the
//                  gate), walking k with its accumulators in registers,
//                  so no shared-memory size depends on d or dout.  Warp
//                  8 (one lane) keeps a ring of stages loading by TMA
//                  (3-d maps over the word planes, 128-byte swizzle, zero
//                  past rows, d and dout): A as 64-column slabs of 128
//                  rows, K-major, B as two 64-column slabs of the k step,
//                  MN-major.  A stage is one k step of every word, 16 KB
//                  a word a side, and the ring as many stages as fit 227
//                  KB, at most four: two for f32 x and f32 w (96 KB a
//                  stage), three for f32 x with bf16 w (64 KB), four for
//                  the 16-bit forms (48 KB); 193 KB in every form.
//                  Warps 0-7, two consumer warpgroups of 64
//                  rows, run wgmma.m64n128k16 (bf16 -> f32, both
//                  operands in shared memory, B through the transpose
//                  bit) on each stage; setmaxnreg gives them 232
//                  registers (40 to the loading warpgroup): two 64-float
//                  accumulators a thread.  The epilogue adds rank c's
//                  sums of a row in rank order, so every column tile of a
//                  row reads the same rstd bits, and they are B8's.
// Splitting inside nm_kernel, once a (row tile, k step), ran slower on
// the H100: the split, not the MMAs, set the pace, and its warps and the
// consumers did not fit one SM's registers without spilling.
// Nothing depends on the number of rows or on which block runs when: no
// atomics, no split of k, the same bits on every call, and a row's bits
// do not depend on the batch.
//
// The epilogue: ms = ss / (float)d as an IEEE division, rstd =
// rsqrtf(ms + eps) (2 ulp), then the association above with _rn
// intrinsics; silu is g / (1 + expf(-g)), gelu 0.5 g (1 + tanhf(
// sqrt(2/pi) (g + 0.044715 g^3))).  The build uses no --use_fast_math.
//
// TMA needs 16-byte aligned bases and row pitches: the word planes have
// them by construction (pitches rounded up to 8 columns); for an operand
// that goes in as it is, the C entry refuses others and the wrapper pads
// such an input into an aligned copy.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;             // rows a block, 64 a consumer warpgroup
constexpr int kBN = 128;             // combined projection columns a block
constexpr int kSlab = 64;            // bf16 columns of a 128-byte row
constexpr int kStep = 64;            // k columns a step
constexpr int kConsumerWarps = 8;    // warps 0-7: two consumer warpgroups
constexpr int kThreads = 384;        // and a warpgroup whose warp 8 loads
constexpr int kGroup = 16;           // row tiles per block group (L2 reuse)
constexpr int kSmemLimit = 232448;   // 227 KB a block on the H100
constexpr int kAlign = 1024;         // the 128-byte swizzle's period
constexpr int kStagesMax = 4;
constexpr int kBarBytes = 2 * kStagesMax * 8;
// Registers a thread after setmaxnreg: the consumer warpgroups and the
// loading one.  Their sum is the block's allocation at launch (168 a
// thread for 384 threads), which setmaxnreg only moves between
// warpgroups.
constexpr int kConsumerRegs = 232;
constexpr int kLoadRegs = 40;
constexpr int kBlockRegs = 128 * (2 * kConsumerRegs + kLoadRegs);
constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0
// The statistic's walk (B8's constants, kernels/mma_rmsnorm.py).
constexpr int kStatWarps = 8;
constexpr int kChunkBytes = 128;
constexpr int kChunkMin = 2;
constexpr int kClusterMax = 8;
// The weight pass: threads a block, 8 columns a thread.
constexpr int kWeightThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kNone = 0, kSilu = 1, kGelu = 2 };

// Word i of A and word j of B of product p, i + j < levels, the levels
// from the highest (smallest products) down.
__host__ __device__ constexpr int product_word(int p, int a_words,
                                               int b_words, int levels,
                                               bool of_a) {
  int n = 0;
  for (int lev = levels - 1; lev >= 0; --lev)
    for (int i = 0; i <= lev; ++i) {
      const int j = lev - i;
      if (i < a_words && j < b_words) {
        if (n == p) return of_a ? i : j;
        ++n;
      }
    }
  return -1;
}

__host__ __device__ constexpr int product_count(int a_words, int b_words,
                                                int levels) {
  int n = 0;
  for (int lev = levels - 1; lev >= 0; --lev)
    for (int i = 0; i <= lev; ++i)
      if (i < a_words && lev - i < b_words) ++n;
  return n;
}

// A form's words and shared memory.
template <int XDT, int WDT>
struct Form {
  // s1 multiplies w where a bf16 x meets an f32 w (x then goes in as it
  // is); everywhere else it multiplies x, whose words A then are.
  static constexpr bool kFoldW = XDT == kBF16 && WDT == kF32;
  static constexpr bool kFF = XDT == kF32 && WDT == kF32;
  static constexpr int kAWords = kFoldW ? 1 : (XDT == kF32 ? 3 : 2);
  static constexpr int kBWords = kFF ? 3 : (kFoldW ? 2 : 1);
  static constexpr int kLevels = XDT == kF32 ? 3 : 2;
  static constexpr int kProducts = product_count(kAWords, kBWords, kLevels);
  static constexpr bool kAPlanes = !kFoldW;     // A: the row pass's words
  static constexpr bool kBPlanes = WDT == kF32;  // B: the weight pass's
  // A stage: A's slabs (word i: 128 rows of 128 bytes), then B's (word
  // j's two 64-column slabs of kStep rows at 2 j, 2 j + 1).
  static constexpr int kASlab = kBM * 128;
  static constexpr int kBSlab = kStep * 128;
  static constexpr int kA = kAWords * kASlab;
  static constexpr int kStage = kA + kBWords * 2 * kBSlab;
  static constexpr int kFit = (kSmemLimit - kAlign - kBarBytes) / kStage;
  static constexpr int kStages = kFit < kStagesMax ? kFit : kStagesMax;
  static constexpr int kSmem = kAlign + kStages * kStage + kBarBytes;
  static_assert(kStages >= 2, "two stages at least");
};

// The statistic's walk of a row of d columns (B8's walk with its
// constants): `cluster` ranks of kStatWarps runs of `chunks` chunks.
struct StatWalk {
  int cluster;
  int chunks;
};

StatWalk stat_walk(int d, int dtype) {
  const long long cols = kChunkBytes / (dtype == kF32 ? 4 : 2);
  const long long row_chunks = (d + cols - 1) / cols;
  const long long per = static_cast<long long>(kStatWarps) * kClusterMax;
  long long chunks = (row_chunks + per - 1) / per;
  if (chunks < kChunkMin) chunks = kChunkMin;
  const long long block = kStatWarps * chunks;
  return {static_cast<int>((row_chunks + block - 1) / block),
          static_cast<int>(chunks)};
}

template <int DT>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (DT == kF32) return __ldg(static_cast<const float*>(p) + i);
  const uint16_t u = __ldg(static_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// D = A x ones (m16n8k16, bf16) from a zero accumulator; d[0] is row g's
// sum, d[2] row g + 8's.
__device__ __forceinline__ void mma_ones(float (&d)[4], const uint32_t (&a)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(kOnes), "r"(kOnes));
}

// One 16-column tile's sums of squares of rows g and g + 8 (lane (g, t)
// holds their columns 4t .. 4t + 3): exact bf16 words of the f32 squares
// against ones, (hi + mid) + lo.  B is all ones, so only an element's
// row matters.
template <int XDT>
__device__ __forceinline__ void tile_squares(const float (&va)[4],
                                             const float (&vb)[4],
                                             float& tile_a, float& tile_b) {
  constexpr int kWords = XDT == kF32 ? 3 : 2;
  float sa[4], sb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sa[e] = __fmul_rn(va[e], va[e]);
    sb[e] = __fmul_rn(vb[e], vb[e]);
  }
#pragma unroll
  for (int word = 0; word < kWords; ++word) {
    uint32_t a[4];
    a[0] = split(sa[0], sa[1]);
    a[2] = split(sa[2], sa[3]);
    a[1] = split(sb[0], sb[1]);
    a[3] = split(sb[2], sb[3]);
    float dd[4];
    mma_ones(dd, a);
    tile_a = word == 0 ? dd[0] : __fadd_rn(tile_a, dd[0]);
    tile_b = word == 0 ? dd[2] : __fadd_rn(tile_b, dd[2]);
  }
}

// The W words of 4 consecutive values, most significant first, 8 bytes
// each into planes `plane` elements apart from dst.
template <int W>
__device__ __forceinline__ void store_words4(float (&v)[4],
                                             __nv_bfloat16* dst,
                                             long long plane) {
#pragma unroll
  for (int wd = 0; wd < W; ++wd) {
    const uint32_t a = split(v[0], v[1]), b = split(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst + wd * plane) = make_uint2(a, b);
  }
}

// Block (16-row tile, rank c): the sums of squares of rank c's runs of
// the 16 rows, into part[c][row]; with AW > 0, A's AW words of x s1 of
// every element it reads, into planes of rows x ldw.
template <int XDT, int AW>
__global__ void __launch_bounds__(32 * kStatWarps)
    row_kernel(const void* __restrict__ x, const float* __restrict__ scale,
               long long rows, int d, long long ldx, int chunks,
               float* __restrict__ part, __nv_bfloat16* __restrict__ words,
               long long ldw) {
  constexpr int kTilesPerChunk = kChunkBytes / (16 * (XDT == kF32 ? 4 : 2));
  __shared__ float red[kStatWarps][16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long r0 = 16LL * blockIdx.x;
  const long long ra = r0 + g, rb = ra + 8;
  const int rank = blockIdx.y;
  const int ntiles = chunks * kTilesPerChunk;
  const long long tile0 =
      static_cast<long long>(rank * kStatWarps + warp) * ntiles;
  // Tiles past d add exact zeros: they are skipped.
  const long long tiles_left = (d + 15) / 16 - tile0;
  const int n = tiles_left < ntiles ? static_cast<int>(
                    tiles_left > 0 ? tiles_left : 0) : ntiles;
  float sa = 0.0f, sb = 0.0f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const long long c0 = (tile0 + i) * 16 + 4 * t;
    float va[4], vb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = c0 + e < d;
      va[e] = in && ra < rows ? load<XDT>(x, ra * ldx + c0 + e) : 0.0f;
      vb[e] = in && rb < rows ? load<XDT>(x, rb * ldx + c0 + e) : 0.0f;
    }
    if (AW > 0 && c0 < d) {
      // x s1's words; the plane's padding past d takes the zeros.
      float s1[4], xa[4], xb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1[e] = c0 + e < d ? __fadd_rn(1.0f, __ldg(scale + c0 + e)) : 0.0f;
        xa[e] = __fmul_rn(va[e], s1[e]);
        xb[e] = __fmul_rn(vb[e], s1[e]);
      }
      if (ra < rows) store_words4<AW>(xa, words + ra * ldw + c0, rows * ldw);
      if (rb < rows) store_words4<AW>(xb, words + rb * ldw + c0, rows * ldw);
    }
    float ta, tb;
    tile_squares<XDT>(va, vb, ta, tb);
    sa = __fadd_rn(sa, ta);
    sb = __fadd_rn(sb, tb);
  }
  if (t == 0) {
    red[warp][g] = sa;
    red[warp][g + 8] = sb;
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kStatWarps; ++w) s = __fadd_rn(s, red[w][threadIdx.x]);
    const long long r = r0 + threadIdx.x;
    if (r < rows) part[rank * rows + r] = s;
  }
}

// B's BW words of an f32 weight (of s1 w with FOLD), 8 columns a thread,
// for w and, when given, w_gate: planes of d x ldw each.
template <int BW, bool FOLD>
__global__ void __launch_bounds__(kWeightThreads)
    weight_kernel(const float* __restrict__ w, const float* __restrict__ wg,
                  const float* __restrict__ scale, int d, int dout,
                  __nv_bfloat16* __restrict__ words,
                  __nv_bfloat16* __restrict__ gwords, long long ldw) {
  const long long chunks = (dout + 7) / 8;
  const long long per = d * chunks;
  const long long total = wg != nullptr ? 2 * per : per;
  const long long plane = d * ldw;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool gate = i >= per;
    const long long j = gate ? i - per : i;
    const long long k = j / chunks;
    const int c0 = static_cast<int>(j - k * chunks) * 8;
    const float* src = (gate ? wg : w) + k * dout + c0;
    const float sk = FOLD ? __fadd_rn(1.0f, __ldg(scale + k)) : 1.0f;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = c0 + e < dout ? __ldg(src + e) : 0.0f;
      if (FOLD) v[e] = __fmul_rn(v[e], sk);
    }
    store_words8<BW>(v, (gate ? gwords : words) + k * ldw + c0, plane);
  }
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
  if (act == kGelu) {
    const float cube = __fmul_rn(__fmul_rn(g, g), g);
    const float inner = __fmul_rn(0.7978845608028654f,
                                  __fadd_rn(g, __fmul_rn(0.044715f, cube)));
    return __fmul_rn(__fmul_rn(0.5f, g), __fadd_rn(1.0f, tanhf(inner)));
  }
  return g;
}

#define B10_D64(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define B10_R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (+)= A B, m64n128k16 bf16 -> f32: A K-major, B MN-major (two 64-column
// slabs, the transpose bit), both in shared memory.
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " B10_R64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : B10_D64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef B10_D64
#undef B10_R64

// ta: A's words (or x), tb / tg: B's words of w / w_gate (or w, w_gate),
// 3-d maps whose third coordinate is the word.
template <int XDT, int WDT, bool GATE>
__global__ void __launch_bounds__(kThreads, 1)
    nm_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tg,
              const float* __restrict__ bias, const float* __restrict__ part,
              void* __restrict__ out, long long rows, int d, int dout,
              int row_tiles, int col_tiles, int ranks, int act, float eps) {
  using F = Form<XDT, WDT>;
  constexpr int kOut = GATE ? kSlab : kBN;  // output columns a block
  constexpr int kS = F::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * F::kStage);
  uint64_t* empty = full + kStagesMax;

  // Block -> (row tile, column tile), column-major inside groups of
  // kGroup row tiles.
  const int block = blockIdx.x;
  const int per_group = kGroup * col_tiles;
  const int group = block / per_group;
  const int first = group * kGroup;
  const int in_group = min(row_tiles - first, kGroup);
  const int local = block - group * per_group;
  const int row0 = (first + local % in_group) * kBM;
  const int n0 = (local / in_group) * kOut;
  const int steps = (d + kStep - 1) / kStep;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    // The loads: stage s of step i once the consumers are done with step
    // i - kS.
    if (warp == kConsumerWarps && lane == 0) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % kS;
        if (step >= kS) mbar_wait(&empty[s], (step / kS - 1) & 1);
        unsigned char* dst = smem + s * F::kStage;
        const int k0 = step * kStep;
        mbar_expect_tx(&full[s], F::kStage);
#pragma unroll
        for (int i = 0; i < F::kAWords; ++i)
          tma_load_3d(dst + i * F::kASlab, &ta, &full[s], k0, row0, i);
#pragma unroll
        for (int j = 0; j < F::kBWords; ++j) {
          unsigned char* b = dst + F::kA + 2 * j * F::kBSlab;
          tma_load_3d(b, &tb, &full[s], n0, k0, j);
          tma_load_3d(b + F::kBSlab, GATE ? &tg : &tb, &full[s],
                      GATE ? n0 : n0 + kSlab, k0, j);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wgi = warp >> 2;
    float acc[64], part_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const uint32_t smem_u = smem_u32(smem);
    for (int step = 0; step < steps; ++step) {
      const int s = step % kS;
      mbar_wait(&full[s], (step / kS) & 1);
      const uint32_t stage = smem_u + s * F::kStage;
      // Each MMA's descriptors are the step's two plus a constant in the
      // address field (16-byte units; shared addresses stay below 2^18).
      const uint64_t da = desc(stage + wgi * (64 * 128), 16, 1024, 1);
      const uint64_t db = desc(stage + F::kA, F::kBSlab, 1024, 1);
      // The step's products from zero, the smaller first (the first MMA
      // ignores part_acc's old values).  A second partial sum, so that
      // the next step's MMAs ran beside this one's adds, spilled and ran
      // at half the speed on the H100.
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < F::kProducts; ++p) {
        const int i = product_word(p, F::kAWords, F::kBWords, F::kLevels, true);
        const int j = product_word(p, F::kAWords, F::kBWords, F::kLevels, false);
#pragma unroll
        for (int kk = 0; kk < kStep / 16; ++kk)
          mma_n128(part_acc, da + ((i * F::kASlab + kk * 32) >> 4),
                   db + ((2 * j * F::kBSlab + kk * 16 * 128) >> 4),
                   p + kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(part_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part_acc[i]);
    }

    // The epilogue: element 4 jb + 2 half + e of the accumulator is row
    // 16 (warp % 4) + g + 8 half of the warpgroup's 64, column 8 jb + 2 t
    // + e; with a gate, columns 64.. are g of columns 0.. .
    const int g = lane >> 2, t = lane & 3;
    const long long ra = row0 + 64 * wgi + 16 * (warp & 3) + g;
    float rs[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = ra + 8 * half;
      rs[half] = 0.0f;
      if (r < rows) {
        float ss = part[r];
        for (int c = 1; c < ranks; ++c) ss = __fadd_rn(ss, part[c * rows + r]);
        const float ms = __fdiv_rn(ss, static_cast<float>(d));
        rs[half] = rsqrtf(__fadd_rn(ms, eps));
      }
    }
    const bool pairs = (dout & 1) == 0;
    constexpr int kUpBlocks = kOut / 8;
#pragma unroll
    for (int jb = 0; jb < kUpBlocks; ++jb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = ra + 8 * half;
        const int col = n0 + 8 * jb + 2 * t;
        if (r >= rows || col >= dout) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float u = __fmul_rn(acc[4 * jb + 2 * half + e], rs[half]);
          if (bias != nullptr && col + e < dout)
            u = __fadd_rn(u, __ldg(bias + col + e));
          if (GATE) {
            const float gv =
                __fmul_rn(acc[4 * (jb + kUpBlocks) + 2 * half + e], rs[half]);
            u = __fmul_rn(activate(gv, act), u);
          }
          v[e] = u;
        }
        const long long o = r * dout + col;
        if (XDT == kF32) {
          float* dst = static_cast<float*>(out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            dst[0] = v[0];
            if (col + 1 < dout) dst[1] = v[1];
          }
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            dst[0] = __float2bfloat16_rn(v[0]);
            if (col + 1 < dout) dst[1] = __float2bfloat16_rn(v[1]);
          }
        }
      }
  }
}

// A bf16 array TMA can read: a 16-byte aligned base and row pitch.
bool tma_ready(const void* p, long long pitch) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (pitch * 2) % 16 == 0;
}

// The launches of a form: the row pass, the weight pass (f32 weights),
// the projections.  xw, ww, wgw: the word planes (ldxw, ldww their row
// pitches), where the form makes them.
template <int XDT, int WDT, bool GATE>
int launch(const void* x, const float* scale, const void* w, const void* wg,
           const float* bias, float* part, __nv_bfloat16* xw,
           __nv_bfloat16* ww, __nv_bfloat16* wgw, void* out, long long rows,
           int d, int dout, long long ldx, long long ldw, long long ldxw,
           long long ldww, int act, float eps, cudaStream_t s) {
  using F = Form<XDT, WDT>;
  constexpr int kOut = GATE ? kSlab : kBN;
  const long long row_tiles = (rows + kBM - 1) / kBM;
  const long long col_tiles = (dout + kOut - 1) / kOut;
  // The block index and a group's block count are ints.
  if (row_tiles * col_tiles > INT_MAX || kGroup * col_tiles > INT_MAX)
    return cudaErrorInvalidValue;
  const bool a_ok = F::kAPlanes ? xw != nullptr && ldxw % 8 == 0
                                : tma_ready(x, ldx);
  const bool b_ok = F::kBPlanes ? ww != nullptr && ldww % 8 == 0 &&
                                      (!GATE || wgw != nullptr)
                                : tma_ready(w, ldw) &&
                                      (!GATE || tma_ready(wg, ldw));
  if (!a_ok || !b_ok) return cudaErrorMisalignedAddress;

  const StatWalk sw = stat_walk(d, XDT);
  const dim3 stat_grid(static_cast<unsigned>((rows + 15) / 16), sw.cluster);
  row_kernel<XDT, F::kAPlanes ? F::kAWords : 0>
      <<<stat_grid, 32 * kStatWarps, 0, s>>>(x, scale, rows, d, ldx,
                                             sw.chunks, part, xw, ldxw);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return ce;
  if (F::kBPlanes) {
    const long long items = (GATE ? 2LL : 1LL) * d * ((dout + 7) / 8);
    const long long blocks = (items + kWeightThreads - 1) / kWeightThreads;
    weight_kernel<F::kBWords, F::kFoldW>
        <<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536),
           kWeightThreads, 0, s>>>(static_cast<const float*>(w),
                                   static_cast<const float*>(wg), scale, d,
                                   dout, ww, wgw, ldww);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return ce;
  }

  CUtensorMap ta, tb, tg;
  int e = F::kAPlanes
              ? encode(&ta, xw, d, rows, ldxw, F::kAWords, rows * ldxw, kSlab,
                       kBM)
              : encode(&ta, x, d, rows, ldx, 1, rows * ldx, kSlab, kBM);
  if (e) return e;
  const void* b = F::kBPlanes ? static_cast<const void*>(ww) : w;
  const void* bg = F::kBPlanes ? static_cast<const void*>(wgw) : wg;
  const long long ldb = F::kBPlanes ? ldww : ldw;
  e = encode(&tb, b, dout, d, ldb, F::kBWords, d * ldb, kSlab, kStep);
  if (e) return e;
  if (GATE) {
    e = encode(&tg, bg, dout, d, ldb, F::kBWords, d * ldb, kSlab, kStep);
    if (e) return e;
  } else {
    tg = tb;
  }
  auto kernel = nm_kernel<XDT, WDT, GATE>;
  // The shared memory granted to this kernel on each card, asked for once
  // (a host call per launch otherwise).  A build whose block holds fewer
  // registers than setmaxnreg hands out would wait for them forever:
  // refused here.
  static int granted[64] = {};
  int dev = 0;
  ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return ce;
  if (dev >= 64 || granted[dev] < F::kSmem) {
    cudaFuncAttributes attr;
    ce = cudaFuncGetAttributes(&attr, kernel);
    if (ce != cudaSuccess) return ce;
    if (attr.numRegs * kThreads < kBlockRegs)
      return cudaErrorInvalidConfiguration;
    ce = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              F::kSmem);
    if (ce != cudaSuccess) return ce;
    if (dev < 64) granted[dev] = F::kSmem;
  }
  kernel<<<static_cast<unsigned>(row_tiles * col_tiles), kThreads, F::kSmem,
           s>>>(ta, tb, tg, bias, part, out, rows, d, dout,
                static_cast<int>(row_tiles), static_cast<int>(col_tiles),
                sw.cluster, act, eps);
  return cudaGetLastError();
}

template <int XDT, int WDT>
int launch_gate(const void* x, const float* scale, const void* w,
                const void* wg, const float* bias, float* part,
                __nv_bfloat16* xw, __nv_bfloat16* ww, __nv_bfloat16* wgw,
                void* out, long long rows, int d, int dout, long long ldx,
                long long ldw, long long ldxw, long long ldww, int act,
                float eps, cudaStream_t s) {
  if (wg != nullptr)
    return launch<XDT, WDT, true>(x, scale, w, wg, bias, part, xw, ww, wgw,
                                  out, rows, d, dout, ldx, ldw, ldxw, ldww,
                                  act, eps, s);
  return launch<XDT, WDT, false>(x, scale, w, wg, bias, part, xw, ww, wgw,
                                 out, rows, d, dout, ldx, ldw, ldxw, ldww,
                                 act, eps, s);
}

}  // namespace

extern "C" {

const char* mma_norm_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B10's walk for rows of d columns, x and the weights f32 (0) or bf16
// (1): the k step, A's and B's words, the product levels (i + j <
// levels), whether 1 + scale multiplies w, and the statistic's ranks and
// chunks a run (B8's walk).
int b10_norm_matmul_walk(int d, int x_dtype, int w_dtype, int* step,
                         int* a_words, int* b_words, int* levels,
                         int* fold_w, int* ranks, int* chunks) {
  if (d < 1 || x_dtype < kF32 || x_dtype > kBF16 || w_dtype < kF32 ||
      w_dtype > kBF16)
    return cudaErrorInvalidValue;
#define B10_WALK(X, W)                \
  {                                   \
    *a_words = Form<X, W>::kAWords;   \
    *b_words = Form<X, W>::kBWords;   \
    *levels = Form<X, W>::kLevels;    \
    *fold_w = Form<X, W>::kFoldW;     \
  }
  if (x_dtype == kF32 && w_dtype == kF32) B10_WALK(kF32, kF32)
  if (x_dtype == kF32 && w_dtype == kBF16) B10_WALK(kF32, kBF16)
  if (x_dtype == kBF16 && w_dtype == kF32) B10_WALK(kBF16, kF32)
  if (x_dtype == kBF16 && w_dtype == kBF16) B10_WALK(kBF16, kBF16)
#undef B10_WALK
  *step = kStep;
  const StatWalk sw = stat_walk(d, x_dtype);
  *ranks = sw.cluster;
  *chunks = sw.chunks;
  return 0;
}

// B10: out (rows, dout) in x's dtype from x (rows, d; row pitch ldx) f32
// (x_dtype 0) or bf16 (1), scale (d,) f32, w and, when wg is not null,
// wg (d, dout; row pitch ldw) f32 (w_dtype 0) or bf16 (1), bias (dout,)
// f32 or null; act 0 (none), 1 (silu) or 2 (gelu, tanh form), applied to
// the gate only.  Scratch: part, f32 ranks x rows (b10_norm_matmul_walk);
// xw, A's a_words planes of rows x ldxw bf16, where 1 + scale multiplies
// x; ww and wgw, B's b_words planes of d x ldww bf16 each, for f32
// weights (null otherwise); ldxw and ldww multiples of 8.  An operand
// that goes in as it is (bf16 x beside f32 w; bf16 weights) 16-byte
// aligned with 16-byte row pitches (TMA); out row-major and contiguous.
int b10_norm_matmul(const void* x, const float* scale, const void* w,
                    const void* wg, const float* bias, float* part, void* xw,
                    void* ww, void* wgw, void* out, long long rows, int d,
                    int dout, long long ldx, long long ldw, long long ldxw,
                    long long ldww, int x_dtype, int w_dtype, int act,
                    float eps, void* stream) {
  if (rows < 1 || rows > INT_MAX - kBM || d < 1 || dout < 1 || ldx < d ||
      ldw < dout || act < kNone || act > kGelu || x_dtype < kF32 ||
      x_dtype > kBF16 || w_dtype < kF32 || w_dtype > kBF16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* xwp = static_cast<__nv_bfloat16*>(xw);
  auto* wwp = static_cast<__nv_bfloat16*>(ww);
  auto* wgwp = static_cast<__nv_bfloat16*>(wgw);
#define B10_ARGS                                                             \
  x, scale, w, wg, bias, part, xwp, wwp, wgwp, out, rows, d, dout, ldx, ldw, \
      ldxw, ldww, act, eps, s
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_gate<kF32, kF32>(B10_ARGS);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch_gate<kF32, kBF16>(B10_ARGS);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_gate<kBF16, kF32>(B10_ARGS);
  return launch_gate<kBF16, kBF16>(B10_ARGS);
#undef B10_ARGS
}

}  // extern "C"
