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
//   xs      = x * (1 + scale)                 f32, one rounding each
//   up      = xs @ w,  g = xs @ w_gate        f32 accumulators
//   rstd[r] = rsqrt(ss[r] / d + eps)
//   out     = up * rstd [+ bias]              without w_gate
//   out     = act(g * rstd) * (up * rstd [+ bias])    with it
//
// in that association, act = identity, silu or gelu (tanh form), rounded
// to nearest into x's dtype (f32 or bf16).  Because rstd is a per-row
// scalar, rmsnorm(x) @ w = rstd * ((x * (1 + scale)) @ w): one walk over
// k feeds the statistic and the projections, and the normalised rows
// never exist in device memory.
//
// Tiles.  A block owns 128 rows and 64 columns of the combined
// projection: 64 output columns of up, or 32 of up beside the same 32 of
// g when w_gate is given, so one thread holds up and g of an output
// element.  Its 8 warps are 4 (rows) x 2 (columns), each with a 32 x 32
// tile of m16n8k8 accumulators.  The block walks k in steps of 32
// columns inside its loop (the TPU's sequential grid axis and VMEM carry
// become this loop), keeping only its own tile's accumulator, so no
// shared-memory size depends on d or dout: any d >= 1 fits.  Each step's
// x tile (128 x 32) and weight tile (32 x 64) are read from global
// memory into registers while the previous step computes, then stored
// to shared memory already split: x * (1 + scale) as two TF32 words
// (hi = rna(xs), lo = rna(xs - hi)), the raw x as f32 for the statistic,
// and an f32 weight as two TF32 words (a bf16 weight is exact in one).
// Ragged rows, columns and k load as 0; nothing is padded or copied.
//
// Precision (3xTF32).  Hopper has no f32 MMA, and one TF32 word keeps 11
// bits (~2^-12 relative per product).  Each product is taken as
// lo(x)·hi(w) + hi(x)·lo(w) + hi(x)·hi(w) (the second dropped for a bf16
// w), which keeps ~21 bits; the lo·lo term is 2^-22 relative.  Every
// step's 8-12 MMAs per tile chain from a zero accumulator, and the
// step's sum is added to the running f32 accumulator with __fadd_rn on
// the CUDA cores, so a truncating tensor-core add touches only the last
// bits of one step's partial, never the running sum.
//
// The statistic (the paper's encoding, as in B8).  Warp w owns the
// block's rows 16w..16w+15 and, in every k step, both 16-column tiles of
// the raw x: each f32 square goes into a ones-MMA (m16n8k16) as exact
// bf16 words (three for f32 x, two for bf16), every MMA from zero, per
// tile (hi + mid) + lo, and the tiles are added in k order with
// __fadd_rn.  Every block over the same rows computes the same sums, so
// every column tile of a row uses the same rstd bits.  Nothing depends
// on the number of rows or on which block runs when: no atomics, no
// split-k, the same bits on every call, and a row's bits do not depend
// on the batch it came in.
//
// The epilogue: ms = ss / (float)d as an IEEE division, rstd =
// rsqrtf(ms + eps) (2 ulp), then the association above with _rn
// intrinsics; silu is g / (1 + expf(-g)), gelu 0.5 g (1 + tanhf(
// sqrt(2/pi) (g + 0.044715 g^3))).  The build uses no --use_fast_math.
//
// Bound on the H100: operations at the shapes of the models (Gemma-2
// 2B's MLP at 4096 tokens: 2 x 4096 x 2304 x 18432 = 348 GFLOP against
// ~190 MB), bytes at decode (128 rows: the weights, 170 MB in f32).
// This simple form reaches neither: the 3xTF32 products cost three
// (two for a bf16 w) mma.sync per useful product, fragments come from
// shared memory with 32-bit loads, and the x tile is re-read from L2 by
// every column tile (blocks are ordered in groups of 16 row tiles so
// that those rows stay in L2 while the weight streams).  wgmma, TMA and
// a bf16-word form for 16-bit operands are later work; chip_smoke.py
// times it against its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;              // rows per block
constexpr int kBN = 64;               // combined projection columns per block
constexpr int kBK = 32;               // k per step
constexpr int kWarps = 8;             // 4 (rows) x 2 (columns)
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                // m16 tiles per warp (32 rows)
constexpr int kNT = 4;                // n8 tiles per warp (32 columns)
constexpr int kAPad = kBK + 4;        // x-tile row stride: conflict-free
constexpr int kBPad = kBN + 8;        // weight-tile row stride: likewise
constexpr int kGroup = 16;            // row tiles per block group (L2 reuse)
constexpr int kALoads = kBM * kBK / kThreads;   // 16 x values per thread
constexpr int kBLoads = kBK * kBN / kThreads;   // 8 weights per thread
constexpr uint32_t kOnes = 0x3f803f80u;         // two bf16 1.0

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kNone = 0, kSilu = 1, kGelu = 2 };

template <int DT>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (DT == kF32) return __ldg(static_cast<const float*>(p) + i);
  const uint16_t u = __ldg(static_cast<const unsigned short*>(p) + i);
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

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the bits the MMA reads
}

// Two floats as a bf16 pair rounded to nearest, the first in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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

// D += A x B (m16n8k8, TF32).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// The k step's sum of squares of 16 rows over one 16-column tile of the
// raw x in shared memory: exact bf16 words of the f32 squares against
// ones, (hi + mid) + lo.  Lane (g, t) feeds columns 4t..4t+3 of rows g
// and g + 8; B is all ones, so only an element's row matters.
template <int XDT>
__device__ __forceinline__ void tile_squares(const float* xr_row_g,
                                             const float* xr_row_g8,
                                             float& tile_a, float& tile_b) {
  constexpr int kWords = XDT == kF32 ? 3 : 2;
  const float4 va = *reinterpret_cast<const float4*>(xr_row_g);
  const float4 vb = *reinterpret_cast<const float4*>(xr_row_g8);
  float sa[4] = {__fmul_rn(va.x, va.x), __fmul_rn(va.y, va.y),
                 __fmul_rn(va.z, va.z), __fmul_rn(va.w, va.w)};
  float sb[4] = {__fmul_rn(vb.x, vb.x), __fmul_rn(vb.y, vb.y),
                 __fmul_rn(vb.z, vb.z), __fmul_rn(vb.w, vb.w)};
#pragma unroll
  for (int word = 0; word < kWords; ++word) {
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
}

constexpr int smem_bytes(bool w16) {
  return 4 * (3 * kBM * kAPad + (w16 ? 1 : 2) * kBK * kBPad + kBM);
}

// Two blocks an SM (at most 128 registers a thread): on the H100 the
// second block's warps hide more latency than the few spilled registers
// cost (with one block the f32-weight forms take 176-202 registers and
// ran up to 1.4x slower).
template <int XDT, int WDT, bool GATE>
__global__ void __launch_bounds__(kThreads, 2)
    nm_kernel(const void* __restrict__ x, const float* __restrict__ scale,
              const void* __restrict__ w, const void* __restrict__ wg,
              const float* __restrict__ bias, void* __restrict__ out,
              long long rows, int d, int dout, int row_tiles, int col_tiles,
              int act, float eps) {
  constexpr bool kW16 = WDT == kBF16;
  constexpr int kOut = GATE ? kBN / 2 : kBN;  // output columns per block
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* a_hi = reinterpret_cast<uint32_t*>(smem);  // [kBM][kAPad]
  uint32_t* a_lo = a_hi + kBM * kAPad;
  float* xr = reinterpret_cast<float*>(a_lo + kBM * kAPad);
  uint32_t* b_hi = reinterpret_cast<uint32_t*>(xr + kBM * kAPad);  // [kBK][kBPad]
  uint32_t* b_lo = b_hi + kBK * kBPad;                // f32 weights only
  float* row_s = reinterpret_cast<float*>(b_lo + (kW16 ? 0 : kBK * kBPad));

  // Block -> (row tile, column tile), column-major inside groups of
  // kGroup row tiles.
  const int block = blockIdx.x;
  const int per_group = kGroup * col_tiles;
  const int group = block / per_group;
  const int first = group * kGroup;
  const int in_group = min(row_tiles - first, kGroup);
  const int local = block - group * per_group;
  const long long row0 = static_cast<long long>(first + local % in_group) * kBM;
  const int n0 = (local / in_group) * kOut;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;  // warp row (4), warp column (2)

  // The loaders: x column tid % 32 of rows tid / 32 + 8 j; weight
  // column tid % 64 of k rows tid / 64 + 4 j.
  const int xc = tid & 31, xr0 = tid >> 5;
  const int bc = tid & 63, bk0 = tid >> 6;
  const void* wsrc = w;
  int wcol = n0 + bc;
  if (GATE) {
    wsrc = (bc & 31) >= 16 ? wg : w;
    wcol = n0 + (bc >> 5) * 16 + (bc & 15);
  }
  float xv[kALoads], wv[kBLoads], sv;

  auto fetch = [&](int k0) {
    const int kc = k0 + xc;
    sv = kc < d ? __ldg(scale + kc) : 0.0f;
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      const long long row = row0 + xr0 + 8 * j;
      xv[j] = row < rows && kc < d ? load<XDT>(x, row * d + kc) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int k = k0 + bk0 + 4 * j;
      wv[j] = k < d && wcol < dout
                  ? load<WDT>(wsrc, static_cast<long long>(k) * dout + wcol)
                  : 0.0f;
    }
  };
  auto stash = [&]() {
    const float s1 = __fadd_rn(1.0f, sv);
#pragma unroll
    for (int j = 0; j < kALoads; ++j) {
      const int i = (xr0 + 8 * j) * kAPad + xc;
      const float xs = __fmul_rn(xv[j], s1);
      const uint32_t hi = tf32_bits(xs);
      xr[i] = xv[j];
      a_hi[i] = hi;
      a_lo[i] = tf32_bits(__fsub_rn(xs, __uint_as_float(hi)));
    }
#pragma unroll
    for (int j = 0; j < kBLoads; ++j) {
      const int i = (bk0 + 4 * j) * kBPad + bc;
      if (kW16) {
        b_hi[i] = __float_as_uint(wv[j]);  // a bf16 value is exact in TF32
      } else {
        const uint32_t hi = tf32_bits(wv[j]);
        b_hi[i] = hi;
        b_lo[i] = tf32_bits(__fsub_rn(wv[j], __uint_as_float(hi)));
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  float ss_a = 0.0f, ss_b = 0.0f;  // rows 16 warp + g, + 8

  const int steps = (d + kBK - 1) / kBK;
  fetch(0);
  stash();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) fetch((step + 1) * kBK);

    // The statistic: this warp's 16 rows over the step's two tiles.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tile_a, tile_b;
      tile_squares<XDT>(xr + (16 * warp + g) * kAPad + 16 * h + 4 * t,
                        xr + (16 * warp + g + 8) * kAPad + 16 * h + 4 * t,
                        tile_a, tile_b);
      ss_a = __fadd_rn(ss_a, tile_a);
      ss_b = __fadd_rn(ss_b, tile_b);
    }

    // The projections: this step's partial from zero, 3xTF32.
    float part[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = (32 * wr + 16 * mt + g) * kAPad + kk + t;
        ah[mt][0] = a_hi[r];
        ah[mt][1] = a_hi[r + 8 * kAPad];
        ah[mt][2] = a_hi[r + 4];
        ah[mt][3] = a_hi[r + 8 * kAPad + 4];
        al[mt][0] = a_lo[r];
        al[mt][1] = a_lo[r + 8 * kAPad];
        al[mt][2] = a_lo[r + 4];
        al[mt][3] = a_lo[r + 8 * kAPad + 4];
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int c = (kk + t) * kBPad + 32 * wc + 8 * nt + g;
        bh[nt][0] = b_hi[c];
        bh[nt][1] = b_hi[c + 4 * kBPad];
        if (!kW16) {
          bl[nt][0] = b_lo[c];
          bl[nt][1] = b_lo[c + 4 * kBPad];
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (!kW16) mma_tf32(part[mt][nt], ah[mt], bl[nt]);
          mma_tf32(part[mt][nt], al[mt], bh[nt]);
          mma_tf32(part[mt][nt], ah[mt], bh[nt]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[mt][nt][i]);

    __syncthreads();
    if (step + 1 < steps) {
      stash();
      __syncthreads();
    }
  }

  // rstd of the block's rows.
  if (t == 0) {
    row_s[16 * warp + g] = ss_a;
    row_s[16 * warp + g + 8] = ss_b;
  }
  __syncthreads();
  if (tid < kBM) {
    const float ms = __fdiv_rn(row_s[tid], static_cast<float>(d));
    row_s[tid] = rsqrtf(__fadd_rn(ms, eps));
  }
  __syncthreads();

  // The epilogue: element i of tile (mt, nt) is row g (+ 8 for i >= 2),
  // column 2t + (i & 1).  With a gate, tiles 0-1 are up and 2-3 are g of
  // the same output columns.
  constexpr int kUpTiles = GATE ? kNT / 2 : kNT;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kUpTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 32 * wr + 16 * mt + g + (i >= 2 ? 8 : 0);
        const long long row = row0 + r;
        const int col = n0 + (GATE ? 16 : 32) * wc + 8 * nt + 2 * t + (i & 1);
        if (row >= rows || col >= dout) continue;
        const float rs = row_s[r];
        float v = __fmul_rn(acc[mt][nt][i], rs);
        if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + col));
        if (GATE) {
          const float gv = __fmul_rn(acc[mt][nt + kNT / 2][i], rs);
          v = __fmul_rn(activate(gv, act), v);
        }
        store<XDT>(out, row * dout + col, v);
      }
}

template <int XDT, int WDT, bool GATE>
int launch(const void* x, const float* scale, const void* w, const void* wg,
           const float* bias, void* out, long long rows, int d, int dout,
           int act, float eps, cudaStream_t s) {
  constexpr int kOut = GATE ? kBN / 2 : kBN;
  const long long row_tiles = (rows + kBM - 1) / kBM;
  const long long col_tiles = (dout + kOut - 1) / kOut;
  // The block index and a group's block count are ints.
  if (row_tiles * col_tiles > INT_MAX || kGroup * col_tiles > INT_MAX)
    return cudaErrorInvalidValue;
  const int bytes = smem_bytes(WDT == kBF16);
  cudaError_t e = cudaFuncSetAttribute(
      nm_kernel<XDT, WDT, GATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  nm_kernel<XDT, WDT, GATE>
      <<<static_cast<unsigned>(row_tiles * col_tiles), kThreads, bytes, s>>>(
          x, scale, w, wg, bias, out, rows, d, dout,
          static_cast<int>(row_tiles), static_cast<int>(col_tiles), act, eps);
  return cudaGetLastError();
}

template <int XDT, int WDT>
int launch_gate(const void* x, const float* scale, const void* w,
                const void* wg, const float* bias, void* out, long long rows,
                int d, int dout, int act, float eps, cudaStream_t s) {
  if (wg != nullptr)
    return launch<XDT, WDT, true>(x, scale, w, wg, bias, out, rows, d, dout,
                                  act, eps, s);
  return launch<XDT, WDT, false>(x, scale, w, wg, bias, out, rows, d, dout,
                                 act, eps, s);
}

}  // namespace

extern "C" {

const char* mma_norm_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B10: out (rows, dout) in x's dtype from x (rows, d) f32 (x_dtype 0) or
// bf16 (1), scale (d,) f32, w and, when wg is not null, wg (d, dout) f32
// (w_dtype 0) or bf16 (1), bias (dout,) f32 or null; act 0 (none), 1
// (silu) or 2 (gelu, tanh form), applied to the gate only.  Every array
// row-major and contiguous.
int b10_norm_matmul(const void* x, const float* scale, const void* w,
                    const void* wg, const float* bias, void* out,
                    long long rows, int d, int dout, int x_dtype, int w_dtype,
                    int act, float eps, void* stream) {
  if (rows < 1 || d < 1 || dout < 1 || act < kNone || act > kGelu)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_gate<kF32, kF32>(x, scale, w, wg, bias, out, rows, d, dout,
                                   act, eps, s);
  if (x_dtype == kF32 && w_dtype == kBF16)
    return launch_gate<kF32, kBF16>(x, scale, w, wg, bias, out, rows, d, dout,
                                    act, eps, s);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_gate<kBF16, kF32>(x, scale, w, wg, bias, out, rows, d, dout,
                                    act, eps, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch_gate<kBF16, kBF16>(x, scale, w, wg, bias, out, rows, d,
                                     dout, act, eps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
