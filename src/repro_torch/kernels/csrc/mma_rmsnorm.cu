// Fused RMSNorm whose row statistic is a ones-MMA, for Hopper (sm_90a):
// kernel B8 of the port, with a plain C interface bound from Python
// through ctypes (repro_torch/kernels/_build.py,
// repro_torch/kernels/mma_rmsnorm.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mma_rmsnorm.py
// mma_rmsnorm_kernel (launched by rmsnorm_call): for x of shape
// (rows, d),
//
//   ms[r]   = (sum_j x[r][j]^2) / d        squares in f32, every dtype
//   rstd[r] = rsqrt(ms[r] + eps)
//   out[r][j] = (x[r][j] * rstd[r]) * (w[j] + weight_offset)
//
// in that association, rounded to nearest into x's dtype (f32 or bf16).
//
// The statistic (the paper's encoding).  A block takes 16 rows, one
// m16n8k16 row tile.  Its warps walk d in tiles of 16 columns (warp w
// takes tiles w, w + W, ...).  Per tile, each f32 square s goes in as
// bf16 words that rebuild it exactly (three for an f32 input: hi =
// rn(s), mid = rn(s - hi), lo = rn of the rest; two for bf16, whose
// square has at most 16 significant bits), and per word one
//
//   D (16 x 8, f32) = A (16 x 16 words) x B (16 x 8 ones)
//
// gives in every column of D the 16 rows' sums of that word over the
// tile.  B is all ones, so only an element's row in A matters, not its
// column: lane (g, t) puts columns 4t .. 4t + 3 of rows g and g + 8 in
// its A registers.  Each MMA starts from a zero accumulator; its D is
// added on the CUDA cores with _rn intrinsics (the tensor cores' adders
// may truncate a running sum, as B4's notes say): per tile (hi + mid) +
// lo, then into the warp's running row sum.  The warps' row sums meet
// in shared memory and are added in warp order, so the statistic is the
// sum of the exact f32 squares up to the order of f32 adds, and the
// same bits on every call.  Columns past d and rows past `rows` load as
// 0; nothing is padded or copied.
//
// The epilogue: ms = sum / (float)d as an IEEE division (not a multiply
// by 1/d), rstd = rsqrtf(ms + eps) (2 ulp), then the scaling pass; the
// build uses no --use_fast_math.
//
// Bound on the H100: bytes.  The function reads x once and w once and
// writes out once: (2 * itemsize) bytes per element plus 4 d; the
// statistic costs 16 tensor-core flops per element and word, under 2 %
// of the byte time.  This simple form reads x twice: the statistic's
// pass and the scaling pass, which re-reads the block's 16 rows from
// global memory instead of staging them in shared memory (16 rows of
// d = 2304 f32 are 147 KB of the 227 KB, of d = 7168 459 KB, which would
// not fit).  A block's 16 rows (at most 459 KB) were read a moment
// before, so the second read should mostly hit the 50 MB L2; what it
// costs in HBM bytes is what chip_smoke.py's timings show.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kM = 16;          // rows per block: the MMA's m; columns per tile
constexpr int kWarps = 8;       // warps per block, splitting d's tiles
constexpr int kThreads = 32 * kWarps;
constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0

enum DType { kF32 = 0, kBF16 = 1 };

template <int DT>
__device__ __forceinline__ float load(const void* x, long long i) {
  if (DT == kF32) return __ldg(static_cast<const float*>(x) + i);
  const uint16_t u = __ldg(static_cast<const unsigned short*>(x) + i);
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

template <int DT>
__device__ __forceinline__ void store(void* out, long long i, float v) {
  if (DT == kF32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

// Two floats as a bf16 pair rounded to nearest, the first in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D = A x ones from a zero accumulator; d[0] is row g's sum, d[2] row
// g + 8's (every column of D is the same).
__device__ __forceinline__ void mma_ones(float (&d)[4], const uint32_t (&a)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(kOnes), "r"(kOnes));
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const void* x, const float* w, void* out, long long rows,
                   int d, float eps, float weight_offset) {
  constexpr int kWords = DT == kF32 ? 3 : 2;
  __shared__ float part[kWarps][kM];
  __shared__ float rstd[kM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * kM;
  const long long ra = row0 + g, rb = row0 + g + 8;
  const bool in_a = ra < rows, in_b = rb < rows;
  const int tiles = (d + kM - 1) / kM;

  float acc_a = 0.0f, acc_b = 0.0f;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int c0 = tile * kM + 4 * t;
    float sa[4], sb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      const float xa = in_a && c < d ? load<DT>(x, ra * d + c) : 0.0f;
      const float xb = in_b && c < d ? load<DT>(x, rb * d + c) : 0.0f;
      sa[j] = __fmul_rn(xa, xa);
      sb[j] = __fmul_rn(xb, xb);
    }
    float tile_a = 0.0f, tile_b = 0.0f;
#pragma unroll
    for (int word = 0; word < kWords; ++word) {
      // a0 / a2: row g, a1 / a3: row g + 8; each the word of two squares.
      uint32_t a[4];
      a[0] = bf16_pair(sa[0], sa[1]);
      a[2] = bf16_pair(sa[2], sa[3]);
      a[1] = bf16_pair(sb[0], sb[1]);
      a[3] = bf16_pair(sb[2], sb[3]);
      float dd[4];
      mma_ones(dd, a);
      tile_a = word == 0 ? dd[0] : __fadd_rn(tile_a, dd[0]);
      tile_b = word == 0 ? dd[2] : __fadd_rn(tile_b, dd[2]);
      if (word + 1 < kWords) {
        // The rest of each square after this word: exact in f32.
        sa[0] = __fsub_rn(sa[0], __uint_as_float(a[0] << 16));
        sa[1] = __fsub_rn(sa[1], __uint_as_float(a[0] & 0xffff0000u));
        sa[2] = __fsub_rn(sa[2], __uint_as_float(a[2] << 16));
        sa[3] = __fsub_rn(sa[3], __uint_as_float(a[2] & 0xffff0000u));
        sb[0] = __fsub_rn(sb[0], __uint_as_float(a[1] << 16));
        sb[1] = __fsub_rn(sb[1], __uint_as_float(a[1] & 0xffff0000u));
        sb[2] = __fsub_rn(sb[2], __uint_as_float(a[3] << 16));
        sb[3] = __fsub_rn(sb[3], __uint_as_float(a[3] & 0xffff0000u));
      }
    }
    acc_a = __fadd_rn(acc_a, tile_a);
    acc_b = __fadd_rn(acc_b, tile_b);
  }
  if (t == 0) {
    part[warp][g] = acc_a;
    part[warp][g + 8] = acc_b;
  }
  __syncthreads();
  if (threadIdx.x < kM) {
    float sum = part[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) sum = __fadd_rn(sum, part[k][threadIdx.x]);
    const float ms = __fdiv_rn(sum, static_cast<float>(d));
    rstd[threadIdx.x] = rsqrtf(__fadd_rn(ms, eps));
  }
  __syncthreads();

  // The scaling pass: the block's rows again, from global memory.
  for (int r = 0; r < kM; ++r) {
    const long long row = row0 + r;
    if (row >= rows) break;
    const float s = rstd[r];
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const long long i = row * d + c;
      const float y = __fmul_rn(load<DT>(x, i), s);
      store<DT>(out, i, __fmul_rn(y, __fadd_rn(__ldg(w + c), weight_offset)));
    }
  }
}

}  // namespace

extern "C" {

const char* mma_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B8: out = rmsnorm(x) over the last dim of x (rows, d), row-major and
// contiguous, f32 (dtype 0) or bf16 (dtype 1); w is d f32 values; out
// has x's dtype and shape.
int b8_rmsnorm(const void* x, const float* w, void* out, long long rows,
               int d, int dtype, float eps, float weight_offset,
               void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  const long long blocks = (rows + kM - 1) / kM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    rmsnorm_kernel<kF32><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, w, out, rows, d, eps, weight_offset);
  } else if (dtype == kBF16) {
    rmsnorm_kernel<kBF16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, w, out, rows, d, eps, weight_offset);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
