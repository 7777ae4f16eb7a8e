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
// column) slot.  Each warp therefore stages its slab in shared memory
// (a coalesced 16-byte load per lane, rows padded by 4 words so the
// fragment reads hit 32 distinct banks) and reads the mma.sync A
// fragment from there; each element of the D fragment is stored to its
// own row and column.
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
// --use_fast_math.
//
// No block waits for another, and nothing uses float atomics.  The
// TPU's sequential-grid carry becomes three launches on one stream:
//
//   1. b6 totals:  each block scans its tile's rows and slabs and
//                  writes the exclusive carry of every slab and the
//                  tile's total (the masked tail reads as 0; nothing
//                  past n is read);
//   2. b6 carries: one block takes the exclusive prefix of the G tile
//                  totals in place: each thread sums a contiguous run
//                  sequentially, the block scans the run totals (a
//                  tree, so the carry's rounding grows with log G, not
//                  G), and each thread writes its run's carries;
//   3. b6 write:   each block reads its tile again, recomputes P and
//                  the row carries exactly as launch 1 did, adds the
//                  slab carries launch 1 wrote and its tile carry, and
//                  writes f32 for the first n positions only.
//
// Deterministic: every sum runs in a fixed order, so the kernel gives
// the same bits on every run.
//
// Bound on the H100: bytes.  The function reads its input once and
// writes f32 once (8 bytes per f32 element, 6 per bf16 / fp16 one)
// and spends 32-48 tensor-core flops per element, far under the ~295
// flops per byte at which the tensor cores would become the limit.
// This design reads the input twice (launches 1 and 3), so it moves
// 12 bytes per f32 element where the bound counts 8, and 8 per 16-bit
// element where the bound counts 6: at best 67 % (f32) and 75 %
// (bf16 / fp16) of the bytes bound.  A single-pass decoupled look-back
// scan, one read and one write, is the later form.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kM = 16;                   // slab: 16 x 16
constexpr int kSlab = kM * kM;           // elements per warp per link
constexpr int kPerLane = kSlab / 32;     // 8 elements per lane
constexpr int kBatch = 4;                // links loaded before their MMAs
constexpr int kMaxThreads = 1024;        // block_rows <= 512
constexpr int kCarryThreads = 1024;      // launch 2

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// 32-bit words per slab row in shared memory: 16 f32 values or 16
// 16-bit values packed in pairs, plus 4 words of padding.
template <int DT>
struct Stage {
  static constexpr int kWords = DT == kF32 ? 16 : 8;
  static constexpr int kStride = kWords + 4;
  static constexpr int kSlabWords = kM * kStride;
};

// One lane's 8 consecutive elements of one slab, as 32-bit words: 8
// floats, or 8 16-bit values packed in pairs.
template <int DT>
struct Frag {
  uint32_t v[DT == kF32 ? kPerLane : kPerLane / 2];
};

__device__ __forceinline__ void load(Frag<kF32>& f, const void* x,
                                     long long n, long long i) {
  const float* p = static_cast<const float*>(x) + i;
  if (i + kPerLane <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    f.v[0] = a.x; f.v[1] = a.y; f.v[2] = a.z; f.v[3] = a.w;
    f.v[4] = b.x; f.v[5] = b.y; f.v[6] = b.z; f.v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      f.v[j] = (i + j < n) ? __float_as_uint(p[j]) : 0u;
  }
}

template <int DT>
__device__ __forceinline__ void load(Frag<DT>& f, const void* x,
                                     long long n, long long i) {
  const uint16_t* p = static_cast<const uint16_t*>(x) + i;
  if (i + kPerLane <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    f.v[0] = a.x; f.v[1] = a.y; f.v[2] = a.z; f.v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane / 2; ++j) {
      const uint32_t lo = (i + 2 * j < n) ? p[2 * j] : 0u;
      const uint32_t hi = (i + 2 * j + 1 < n) ? p[2 * j + 1] : 0u;
      f.v[j] = lo | (hi << 16);
    }
  }
}

// Lane l's 8 elements are row l / 2, columns 8 * (l % 2) .. + 7 of the
// slab; they go to that row of the warp's stage.
template <int DT>
__device__ __forceinline__ void stage_store(uint32_t* stage,
                                            const Frag<DT>& f, int lane) {
  constexpr int kHalf = Stage<DT>::kWords / 2;
  uint32_t* row = stage + (lane >> 1) * Stage<DT>::kStride +
                  (lane & 1) * kHalf;
#pragma unroll
  for (int j = 0; j < kHalf; j += 4)
    *reinterpret_cast<uint4*>(row + j) =
        make_uint4(f.v[j], f.v[j + 1], f.v[j + 2], f.v[j + 3]);
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
                                               const Frag<kF32>*) {
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
                                               const Frag<DT>*) {
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

// The inclusive scan of one warp's slab of link r: load, stage, MMA.
// Called by every lane of the warp.
template <int DT>
__device__ __forceinline__ void slab_prefix(uint32_t* stage, const Frag<DT>& f,
                                            int lane, float (&lo)[4],
                                            float (&hi)[4]) {
  stage_store<DT>(stage, f, lane);
  __syncwarp();
  triangular_mma(stage, lane, lo, hi, static_cast<const Frag<DT>*>(nullptr));
  __syncwarp();  // the stage is free for the next link
}

struct TileGeometry {
  long long base;   // flat index of the tile's first element
  long long link;   // elements per link
  int warp, lane, warps, slabs;
};

__device__ __forceinline__ TileGeometry geometry(int chain, int block_rows) {
  TileGeometry geo;
  geo.link = static_cast<long long>(block_rows) * kM;
  geo.base = blockIdx.x * geo.link * chain;
  geo.warp = threadIdx.x >> 5;
  geo.lane = threadIdx.x & 31;
  geo.warps = blockDim.x >> 5;
  geo.slabs = chain * geo.warps;
  return geo;
}

// Launch 1: slab[tile * slabs + r * warps + w] = the exclusive carry of
// slab (r, w) inside its tile; tiles[tile] = the tile's total.
template <int DT>
__global__ void __launch_bounds__(kMaxThreads)
    totals_kernel(const void* x, long long n, int chain, int block_rows,
                  float* slab, float* tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  const TileGeometry geo = geometry(chain, block_rows);
  uint32_t* stage = smem + geo.warp * Stage<DT>::kSlabWords;
  float* carries = slab + static_cast<long long>(blockIdx.x) * geo.slabs;
  const long long i0 = geo.base + geo.warp * kSlab + geo.lane * kPerLane;
  for (int r0 = 0; r0 < chain; r0 += kBatch) {
    Frag<DT> f[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (r0 + b < chain) load(f[b], x, n, i0 + (r0 + b) * geo.link);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (r0 + b >= chain) break;
      float lo[4], hi[4];
      slab_prefix<DT>(stage, f[b], geo.lane, lo, hi);
      const float total = __shfl_sync(0xffffffffu, row_scan(hi, geo.lane), 15);
      if (geo.lane == 0) carries[(r0 + b) * geo.warps + geo.warp] = total;
    }
  }
  __syncthreads();  // the slab totals are visible to warp 0
  if (geo.warp != 0) return;
  float running = 0.0f;
  for (int s0 = 0; s0 < geo.slabs; s0 += 32) {
    const int s = s0 + geo.lane;
    const float v = s < geo.slabs ? carries[s] : 0.0f;
    const float incl = warp_scan(v, geo.lane);
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (geo.lane == 0) excl = 0.0f;
    if (s < geo.slabs) carries[s] = __fadd_rn(running, excl);
    running = __fadd_rn(running, __shfl_sync(0xffffffffu, incl, 31));
  }
  if (geo.lane == 0) tiles[blockIdx.x] = running;
}

// Launch 2, one block: tiles[0..g) := its exclusive prefix, in place.
__global__ void __launch_bounds__(kCarryThreads)
    carries_kernel(float* tiles, long long g) {
  __shared__ float warp_totals[kCarryThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = (g + blockDim.x - 1) / blockDim.x;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < g ? lo + per : g;
  float run = 0.0f;
  for (long long j = lo; j < hi; ++j) run = __fadd_rn(run, tiles[j]);
  const float incl = warp_scan(run, lane);
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float v = lane < static_cast<int>(blockDim.x >> 5)
                        ? warp_totals[lane] : 0.0f;
    const float w_incl = warp_scan(v, lane);
    float w_excl = __shfl_up_sync(0xffffffffu, w_incl, 1);
    if (lane == 0) w_excl = 0.0f;
    warp_totals[lane] = w_excl;
  }
  __syncthreads();
  float lane_excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) lane_excl = 0.0f;
  float carry = __fadd_rn(warp_totals[warp], lane_excl);
  for (long long j = lo; j < hi; ++j) {
    const float total = tiles[j];
    tiles[j] = carry;
    carry = __fadd_rn(carry, total);
  }
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

// Launch 3: the outputs.
template <int DT>
__global__ void __launch_bounds__(kMaxThreads)
    write_kernel(const void* x, long long n, int chain, int block_rows,
                 const float* slab, const float* tiles, float* out,
                 int exclusive) {
  extern __shared__ __align__(16) uint32_t smem[];
  const TileGeometry geo = geometry(chain, block_rows);
  uint32_t* stage = smem + geo.warp * Stage<DT>::kSlabWords;
  const float* carries = slab + static_cast<long long>(blockIdx.x) * geo.slabs;
  const float tile_carry = tiles[blockIdx.x];
  const int g = geo.lane >> 2, t = geo.lane & 3;
  if (exclusive && blockIdx.x == 0 && threadIdx.x == 0 && n > 0) out[0] = 0.0f;
  const long long w0 = geo.base + geo.warp * kSlab;
  for (int r0 = 0; r0 < chain; r0 += kBatch) {
    Frag<DT> f[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (r0 + b < chain)
        load(f[b], x, n, w0 + (r0 + b) * geo.link + geo.lane * kPerLane);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + b;
      if (r >= chain) break;
      float lo[4], hi[4];
      slab_prefix<DT>(stage, f[b], geo.lane, lo, hi);
      const float incl = row_scan(hi, geo.lane);
      // Exclusive row carries of rows g and g + 8.
      float c_g = __shfl_sync(0xffffffffu, incl, (g + 31) & 31);
      const float c_g8 = __shfl_sync(0xffffffffu, incl, g + 7);
      if (g == 0) c_g = 0.0f;
      const float slab_carry = carries[r * geo.warps + geo.warp];
      const float row_g = __fadd_rn(slab_carry, c_g);
      const float row_g8 = __fadd_rn(slab_carry, c_g8);
      const long long s = w0 + r * geo.link;
      const long long i_g = s + g * kM + 2 * t, i_g8 = i_g + 8 * kM;
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
cudaError_t launch(const void* x, long long n, int chain, int block_rows,
                   int exclusive, float* slab, float* tiles, float* out,
                   cudaStream_t s) {
  const dim3 grid(blocks_for(n, static_cast<long long>(chain) * block_rows * kM));
  const dim3 block(2 * block_rows);
  if (grid.x == 0) return cudaErrorInvalidValue;
  const size_t smem = (block.x / 32) * Stage<DT>::kSlabWords * sizeof(uint32_t);
  totals_kernel<DT><<<grid, block, smem, s>>>(x, n, chain, block_rows, slab,
                                              tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carries_kernel<<<1, kCarryThreads, 0, s>>>(tiles, grid.x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  write_kernel<DT><<<grid, block, smem, s>>>(x, n, chain, block_rows, slab,
                                             tiles, out, exclusive);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mma_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B6: out[0..n) = the inclusive (exclusive != 0: exclusive) f32 prefix
// sum of x.  slab holds chain * block_rows / 16 floats per tile of
// chain * block_rows * 16 elements, tiles one float per tile.
int b6_scan(const void* x, long long n, int dtype, int chain,
            int block_rows, int exclusive, float* slab, float* tiles,
            float* out, void* stream) {
  if (bad_geometry(chain, block_rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<kF32>(x, n, chain, block_rows, exclusive, slab, tiles, out, s);
  if (dtype == kBF16)
    return launch<kBF16>(x, n, chain, block_rows, exclusive, slab, tiles, out, s);
  if (dtype == kF16)
    return launch<kF16>(x, n, chain, block_rows, exclusive, slab, tiles, out, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
