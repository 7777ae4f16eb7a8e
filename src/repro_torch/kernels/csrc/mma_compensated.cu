// Compensated and double-double reductions for Hopper (sm_90a): kernels
// B4 and B5 of the port, with a plain C interface bound from Python
// through ctypes (repro_torch/kernels/_build.py,
// repro_torch/kernels/mma_compensated.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mma_compensated.py:
//   b4_ec  <- mma_ec_kernel (ec_call)
//   b5_dd  <- mma_dd_kernel (dd_call)
//
// Both kernels rest on error-free transforms, so every rounding is
// spelled out with an intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __fmaf_rn): nvcc never contracts those into an FMA, and the file is
// compiled without --use_fast_math.
//
// Two stages, no float atomics.  The TPU carried its accumulators over
// a sequential grid in VMEM; here the blocks run in any order, so each
// block writes its compensated partial to its own slot and one block
// then folds the partials in a fixed order.  (Float atomics would add
// one rounding per block in a varying order: 131072 of them cost the
// split variant of B3 1.2e-3 % at 2^28, twelve times the ec ceiling.)
//
// B4, b4_ec: the compensated split-bf16 sum.  The input is the flat f32
// view of the reference's (T, 16) tiles; a block owns a tile of
// chain * block_rows * 16 elements and its warps load 16 x 16 slabs per
// chain link exactly as B1 does (csrc/mma_reduce.cu: 8 floats a lane).
// Each value (squared first with square=1, f32, one rounding) splits
// into split_words round-to-nearest bf16 words (hi = rn_bf16(r),
// r -= hi: precision.split_f32_words), and each word's slab goes
// through one mma.sync.m16n8k16 against an all-ones B.  Every link's
// MMA starts from a zero accumulator, so the tensor cores only ever
// add 16 products of one slab row; the row sums are folded into
// per-word lane accumulators with TwoSum on the CUDA cores, whose
// residuals collect in a second f32 word.  The block's lanes collapse
// with a TwoSum tree that keeps every residual, one (sum, err) pair
// per word per block; the second stage runs the same tree over all
// pairs and writes sum + err.
//
// B5, b5_dd: the double-double sum, CUDA cores only (Hopper has no f32
// MMA, and a TF32 or truncating tensor-core add is not fl(a + b), so a
// TwoSum residual taken after it would not be exact).  Each thread
// reads 16-byte vectors of its block's tile and splits every element
// in registers into a dd pair: f64 x gives hi = rn_f32(x) and
// lo = rn_f32(x - hi) (precision.dd_from_any), f32 / bf16 / fp16 give
// lo = 0, so the input is read once.  square=1 squares the pair with
// TwoProd in its FMA form, p = a*a, e = fma(a, a, -p), plus
// 2*hi*lo + lo*lo.  Pairs merge with dd_add (TwoSum of the high words,
// both low words folded in, FastTwoSum) per thread, then in a warp
// tree and a block tree; the second stage merges the blocks' pairs the
// same way and writes [hi, lo].
//
// Bound on the H100: bytes for both.  B4 reads 4 bytes per element and
// spends per word two f32 ops on the split and 16 tensor-core flops;
// B5 reads 2-8 bytes per element and spends 3 f64 ops on the split and
// about 11 f32 ops per dd_add.  Both are far under the CUDA cores' and
// tensor cores' rates for the bytes they move, so the design spends
// nothing on staging: loads go straight to registers, the ragged tail
// is masked in the kernel (out-of-range elements read as 0) and no
// padded copy of the input is made.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kM = 16;                   // chain-link tile: 16 x 16
constexpr int kSlab = kM * kM;           // elements per warp per link
constexpr int kPerLane = kSlab / 32;     // 8 elements per lane
constexpr int kMaxThreads = 1024;        // block_rows <= 512
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kFinishThreads = 1024;     // the second stage's one block
constexpr unsigned kAll = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

// ------------------------------------------------ error-free transforms

// s = fl(a + b), e = a + b - s exactly (Knuth, branch-free).
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bv = __fsub_rn(s, a);
  const float av = __fsub_rn(s, bv);
  e = __fadd_rn(__fsub_rn(a, av), __fsub_rn(b, bv));
}

// Dekker FastTwoSum: exact when |a| >= |b| or a == 0.
__device__ __forceinline__ void fast_two_sum(float a, float b, float& s,
                                             float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// A compensated f32 value: s + e, e the sum of the TwoSum residuals.
struct Comp {
  float s, e;
};

__device__ __forceinline__ Comp comp_add(Comp a, Comp b) {
  Comp r;
  float t;
  two_sum(a.s, b.s, r.s, t);
  r.e = __fadd_rn(__fadd_rn(a.e, b.e), t);
  return r;
}

// A double-double value hi + lo.
struct DD {
  float hi, lo;
};

// precision.dd_add: TwoSum on the high words, fold both low words into
// the residual, renormalise.
__device__ __forceinline__ DD dd_add(DD a, DD b) {
  float s, e;
  two_sum(a.hi, b.hi, s, e);
  DD r;
  fast_two_sum(s, __fadd_rn(e, __fadd_rn(a.lo, b.lo)), r.hi, r.lo);
  return r;
}

// (hi + lo)^2 = TwoProd(hi, hi) + 2 hi lo + lo^2, in the reference's
// order; the FMA form of TwoProd is exact for products in the normal
// range, so it equals the reference's Dekker split there.
__device__ __forceinline__ DD dd_square(DD a) {
  const float p = __fmul_rn(a.hi, a.hi);
  const float e = __fmaf_rn(a.hi, a.hi, -p);
  const float t = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, a.hi), a.lo),
                            __fmul_rn(a.lo, a.lo));
  DD r;
  fast_two_sum(p, __fadd_rn(e, t), r.hi, r.lo);
  return r;
}

__device__ __forceinline__ Comp shfl_xor(Comp v, int o) {
  return {__shfl_xor_sync(kAll, v.s, o), __shfl_xor_sync(kAll, v.e, o)};
}

__device__ __forceinline__ DD shfl_xor(DD v, int o) {
  return {__shfl_xor_sync(kAll, v.hi, o), __shfl_xor_sync(kAll, v.lo, o)};
}

__device__ __forceinline__ Comp merge(Comp a, Comp b) { return comp_add(a, b); }
__device__ __forceinline__ DD merge(DD a, DD b) { return dd_add(a, b); }

// Butterfly over lane bits [first, 5): every lane ends with the merge
// of its group.  Both merges are symmetric, so all lanes agree.
template <typename T>
__device__ __forceinline__ T warp_tree(T v, int first = 0) {
#pragma unroll
  for (int o = 1 << first; o < 32; o <<= 1) v = merge(v, shfl_xor(v, o));
  return v;
}

// Fixed-order tree over the block's warp values (lane 0 of each warp
// holds one); the result is valid in thread 0.  Warps past the block's
// count contribute zeros, which every merge adds exactly.
template <typename T>
__device__ __forceinline__ T block_tree(T v, T* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : T{0.0f, 0.0f};
    v = warp_tree(v);
  }
  return v;
}

// ------------------------------------------------------------- B4: ec

__device__ __forceinline__ void load8(float (&f)[kPerLane], const float* x,
                                      long long n, long long i) {
  const float* p = x + i;
  if (i + kPerLane <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) f[j] = (i + j < n) ? p[j] : 0.0f;
  }
}

// The next bf16 word of 8 values: rn_bf16(r), packed in pairs as an
// m16n8k16 A fragment, and r minus that word (exact in f32).
__device__ __forceinline__ void next_word(float (&r)[kPerLane],
                                          uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < kPerLane; j += 2) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(r[j]);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(r[j + 1]);
    r[j] = __fsub_rn(r[j], __bfloat162float(h0));
    r[j + 1] = __fsub_rn(r[j + 1], __bfloat162float(h1));
    a[j / 2] = static_cast<uint32_t>(__bfloat16_as_ushort(h0)) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
  }
}

// D = A_slab x [1] from a zero accumulator: lane 4g+t gets the sum of
// slab row g in d[0] (== d[1]) and of row g+8 in d[2] (== d[3]).
__device__ __forceinline__ void mma_rows(float (&d)[4], const uint32_t (&a)[4]) {
  const uint32_t one2 = 0x3f803f80u;  // two bf16 ones
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(one2), "r"(one2));
}

template <int W, bool SQUARE>
__global__ void __launch_bounds__(kMaxThreads)
    ec_kernel(const float* x, long long n, int chain, int block_rows,
              float* partials) {
  const long long stride = static_cast<long long>(block_rows) * kM;
  const long long i0 = blockIdx.x * stride * chain +
                       (threadIdx.x >> 5) * kSlab +
                       (threadIdx.x & 31) * kPerLane;
  // Per word, the lane accumulators of slab rows g and g + 8.
  Comp acc[W][2];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w][0] = acc[w][1] = Comp{0.0f, 0.0f};
  for (int r = 0; r < chain; ++r) {
    float v[kPerLane];
    load8(v, x, n, i0 + r * stride);
    if (SQUARE) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = __fmul_rn(v[j], v[j]);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t a[4];
      float d[4];
      next_word(v, a);
      mma_rows(d, a);
      acc[w][0] = comp_add(acc[w][0], Comp{d[0], 0.0f});
      acc[w][1] = comp_add(acc[w][1], Comp{d[2], 0.0f});
    }
  }
  __shared__ Comp part[W][kMaxWarps];
  Comp out[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    // Rows g and g + 8, then the 8 row groups (lane bits 2..4; lanes
    // 4g+t with the same g hold the same rows).
    out[w] = warp_tree(comp_add(acc[w][0], acc[w][1]), 2);
    if ((threadIdx.x & 31) == 0) part[w][threadIdx.x >> 5] = out[w];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      Comp v = lane < static_cast<int>(blockDim.x >> 5) ? part[w][lane]
                                                        : Comp{0.0f, 0.0f};
      v = warp_tree(v);
      if (lane == 0) {
        float* o = partials + (static_cast<long long>(blockIdx.x) * W + w) * 2;
        o[0] = v.s;
        o[1] = v.e;
      }
    }
  }
}

// Second stage of B4: the TwoSum tree over `pairs` (sum, err) pairs in
// a fixed order; out[0] = sum + err.
__global__ void __launch_bounds__(kFinishThreads)
    ec_finish(const float* partials, long long pairs, float* out) {
  Comp v{0.0f, 0.0f};
  for (long long i = threadIdx.x; i < pairs; i += blockDim.x)
    v = comp_add(v, Comp{partials[2 * i], partials[2 * i + 1]});
  __shared__ Comp part[kMaxWarps];
  v = block_tree(warp_tree(v), part);
  if (threadIdx.x == 0) out[0] = __fadd_rn(v.s, v.e);
}

// ------------------------------------------------------------- B5: dd

template <int DT>
struct Elem;
template <>
struct Elem<kF64> {
  using T = double;
  __device__ static DD dd(double x) {
    const float hi = __double2float_rn(x);
    return {hi, __double2float_rn(__dsub_rn(x, static_cast<double>(hi)))};
  }
};
template <>
struct Elem<kF32> {
  using T = float;
  __device__ static DD dd(float x) { return {x, 0.0f}; }
};
template <>
struct Elem<kBF16> {
  using T = __nv_bfloat16;
  __device__ static DD dd(__nv_bfloat16 x) { return {__bfloat162float(x), 0.0f}; }
};
template <>
struct Elem<kF16> {
  using T = __half;
  __device__ static DD dd(__half x) { return {__half2float(x), 0.0f}; }
};

template <int DT, bool SQUARE>
__global__ void __launch_bounds__(kMaxThreads)
    dd_kernel(const void* xv, long long n, int chain, int block_rows,
              float* partials) {
  using T = typename Elem<DT>::T;
  constexpr int kVec = 16 / sizeof(T);           // elements per 16 bytes
  const T* x = static_cast<const T*>(xv);
  const long long tile = static_cast<long long>(chain) * block_rows * kM;
  const int vecs = static_cast<int>(tile / kVec / blockDim.x);
  const long long base = blockIdx.x * tile;
  DD acc{0.0f, 0.0f};
  for (int k = 0; k < vecs; ++k) {
    const long long i = base + (static_cast<long long>(k) * blockDim.x +
                                threadIdx.x) * kVec;
    T v[kVec];
    if (i + kVec <= n) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(x + i));
      memcpy(v, &q, 16);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[j] = (i + j < n) ? x[i + j] : T(0.0f);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      DD e = Elem<DT>::dd(v[j]);
      if (SQUARE) e = dd_square(e);
      acc = dd_add(acc, e);
    }
  }
  __shared__ DD part[kMaxWarps];
  acc = block_tree(warp_tree(acc), part);
  if (threadIdx.x == 0) {
    partials[2 * static_cast<long long>(blockIdx.x)] = acc.hi;
    partials[2 * static_cast<long long>(blockIdx.x) + 1] = acc.lo;
  }
}

// Second stage of B5: dd_add over the blocks' pairs in a fixed order;
// out = [hi, lo].
__global__ void __launch_bounds__(kFinishThreads)
    dd_finish(const float* partials, long long pairs, float* out) {
  DD v{0.0f, 0.0f};
  for (long long i = threadIdx.x; i < pairs; i += blockDim.x)
    v = dd_add(v, DD{partials[2 * i], partials[2 * i + 1]});
  __shared__ DD part[kMaxWarps];
  v = block_tree(warp_tree(v), part);
  if (threadIdx.x == 0) {
    out[0] = v.hi;
    out[1] = v.lo;
  }
}

bool bad_geometry(int chain, int block_rows) {
  return chain < 1 || block_rows < kM || block_rows % kM != 0 ||
         2 * block_rows > kMaxThreads;
}

// Blocks for n elements at `tile` elements a block; 0 when the grid
// would exceed the launch limit.
unsigned blocks_for(long long n, long long tile) {
  const long long g = n > 0 ? (n + tile - 1) / tile : 1;
  return g <= 0x7fffffffLL ? static_cast<unsigned>(g) : 0u;
}

template <int DT>
void launch_dd(unsigned grid, unsigned block, cudaStream_t s, int square,
               const void* x, long long n, int chain, int block_rows,
               float* partials) {
  if (square)
    dd_kernel<DT, true><<<grid, block, 0, s>>>(x, n, chain, block_rows, partials);
  else
    dd_kernel<DT, false><<<grid, block, 0, s>>>(x, n, chain, block_rows, partials);
}

}  // namespace

extern "C" {

const char* mma_compensated_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B4: out[0] = compensated sum of x (f32) or of x * x.  partials holds
// 2 * split_words floats per block of chain * block_rows * 16 elements.
int b4_ec(const float* x, long long n, int chain, int block_rows,
          int split_words, int square, float* partials, float* out,
          void* stream) {
  if (bad_geometry(chain, block_rows) || split_words < 2 || split_words > 3)
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n, static_cast<long long>(chain) * block_rows * kM));
  const dim3 block(2 * block_rows);
  if (grid.x == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split_words == 2 && !square)
    ec_kernel<2, false><<<grid, block, 0, s>>>(x, n, chain, block_rows, partials);
  else if (split_words == 2)
    ec_kernel<2, true><<<grid, block, 0, s>>>(x, n, chain, block_rows, partials);
  else if (!square)
    ec_kernel<3, false><<<grid, block, 0, s>>>(x, n, chain, block_rows, partials);
  else
    ec_kernel<3, true><<<grid, block, 0, s>>>(x, n, chain, block_rows, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ec_finish<<<1, kFinishThreads, 0, s>>>(
      partials, static_cast<long long>(grid.x) * split_words, out);
  return cudaGetLastError();
}

// B5: out[0..1] = [hi, lo] of the dd sum of x (f64, f32, bf16 or fp16)
// or of x * x.  partials holds 2 floats per block.
int b5_dd(const void* x, long long n, int dtype, int chain, int block_rows,
          int square, float* partials, float* out, void* stream) {
  if (bad_geometry(chain, block_rows)) return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n, static_cast<long long>(chain) * block_rows * kM));
  const dim3 block(2 * block_rows);
  if (grid.x == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF64)
    launch_dd<kF64>(grid.x, block.x, s, square, x, n, chain, block_rows, partials);
  else if (dtype == kF32)
    launch_dd<kF32>(grid.x, block.x, s, square, x, n, chain, block_rows, partials);
  else if (dtype == kBF16)
    launch_dd<kBF16>(grid.x, block.x, s, square, x, n, chain, block_rows, partials);
  else if (dtype == kF16)
    launch_dd<kF16>(grid.x, block.x, s, square, x, n, chain, block_rows, partials);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dd_finish<<<1, kFinishThreads, 0, s>>>(partials, grid.x, out);
  return cudaGetLastError();
}

}  // extern "C"
