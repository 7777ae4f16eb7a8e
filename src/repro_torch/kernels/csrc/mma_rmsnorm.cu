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
// Bound on the H100: bytes.  The function reads x once and w once and
// writes out once: (2 * itemsize) bytes per element plus 4 d; the
// statistic costs 16 tensor-core flops per element and word, under 2 %
// of the byte time.  The TPU kernel held a whole row block in VMEM; here
// a row tile of 16 rows (the MMA's m) is split across the C blocks of a
// thread-block cluster, each block holds its slice of the 16 rows in
// shared memory from the statistic's pass to the scaling pass, and the
// blocks' row sums meet in distributed shared memory.  So x is read from
// HBM once, in 16-byte pieces, and several blocks share an SM.  One
// block a (row tile, rank), not a persistent ring of row tiles: with
// two tiles in shared memory a block, fewer blocks fit an SM, and the
// ring ran slower on the H100 than more blocks each holding one tile.
//
// The walk: a pure function of (d, dtype), never of rows or of the
// pointers, so a row's bits do not depend on the batch (walk() below,
// mirrored by kernels/mma_rmsnorm.py walk()).
//   - A chunk is 16 rows x 128 bytes of a row (one L2 line a row): 32
//     f32 or 64 bf16 columns, 2 or 4 tiles of 16 columns.  A row tile
//     has ceil(d / chunk columns) chunks.
//   - A warp takes `chunks` consecutive chunks (at least kChunkMin, more
//     where d needs them to keep C <= kClusterMax), a block kWarps
//     consecutive warps' worth, a cluster C = ceil(row chunks / (kWarps
//     chunks)) blocks: rank c takes chunks [c kWarps chunks, ...).
//   - Shared memory holds `resident` = min(chunks, kChunkResident)
//     chunks a warp.  Every d a model of this repo has (up to 12288)
//     fits; a wider one re-reads its rows for the scaling pass.
//
// The statistic (the paper's encoding).  Per tile, each f32 square s
// goes in as bf16 words that rebuild it exactly (three for an f32
// input: hi = rn(s), mid = rn(s - hi), lo = rn of the rest; two for
// bf16, whose square has at most 16 significant bits), and per word one
//
//   D (16 x 8, f32) = A (16 x 16 words) x B (16 x 8 ones)
//
// gives in every column of D the 16 rows' sums of that word over the
// tile.  B is all ones, so only an element's row in A matters: lane
// (g, t) reads columns 4t .. 4t + 3 of rows g and g + 8 of the tile from
// shared memory.  Each MMA starts from a zero accumulator; its D is
// added on the CUDA cores with _rn intrinsics: per tile (hi + mid) + lo,
// then into the warp's running row sum in column order; the warps' sums
// in warp order (shared memory), then the blocks' sums in cluster-rank
// order (distributed shared memory).  No atomics: the same bits on every
// call.  Columns past d and rows past `rows` load as 0.
//
// Loads: by 16-byte cp.async, zero-filled past the rows, one group per
// chunk, so a warp's statistic runs while its later chunks land; where
// x's base or its row pitch is not 16-byte aligned (d odd, a view that
// starts mid-row), element by element into the same layout, so the
// order of adds is the same.  Shared memory: a tile is 16 rows of 16
// columns with one padding row after it, so the fragment reads, the
// copies and the scaling pass's reads are free of bank conflicts.
//
// The epilogue: ms = sum / (float)d as an IEEE division (not a multiply
// by 1/d), rstd = rsqrtf(ms + eps) (2 ulp), then the scaling pass from
// shared memory to out in 16-byte stores, w read once a block in 16-byte
// loads; the build uses no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kM = 16;                // rows per row tile: the MMA's m
constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkBytes = 128;      // bytes of a row in one chunk
constexpr int kChunkMin = 2;          // chunks a warp takes at least
constexpr int kClusterMax = 8;        // blocks a cluster (portable size)
constexpr int kChunkResident = 12;    // chunks a warp holds at most
// A chunk in shared memory: its tiles of 16 x 16 columns, each followed
// by one padding row (17 rows of 16 itemsize bytes): 2 tiles of 1088 B
// in f32, 4 of 544 B in bf16.
constexpr int kChunkStride = 17 * kChunkBytes;
constexpr int kSmemMax = kWarps * kChunkResident * kChunkStride;
constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0

enum DType { kF32 = 0, kBF16 = 1 };

struct Walk {
  int cluster;   // blocks a row tile
  int chunks;    // chunks a warp
  int resident;  // chunks a warp holds in shared memory
};

// The walk of a row of d columns of the dtype (0 f32, 1 bf16).
Walk walk(int d, int dtype) {
  const long long cols = kChunkBytes / (dtype == kF32 ? 4 : 2);
  const long long row_chunks = (d + cols - 1) / cols;
  const long long per = static_cast<long long>(kWarps) * kClusterMax;
  long long chunks = (row_chunks + per - 1) / per;
  if (chunks < kChunkMin) chunks = kChunkMin;
  const long long block = kWarps * chunks;
  Walk w;
  w.cluster = static_cast<int>((row_chunks + block - 1) / block);
  w.chunks = static_cast<int>(chunks);
  w.resident = static_cast<int>(chunks < kChunkResident ? chunks
                                                        : kChunkResident);
  return w;
}

template <int DT>
struct Geo {
  static constexpr int kSize = DT == kF32 ? 4 : 2;
  static constexpr int kRowBytes = 16 * kSize;             // a tile's row
  static constexpr int kTileStride = 17 * kRowBytes;       // + padding row
  static constexpr int kTiles = kChunkBytes / kRowBytes;   // a chunk's
  static constexpr int kCols = kChunkBytes / kSize;        // a chunk's
  static constexpr int kPieceCols = 16 / kSize;            // 16 B of a row
};

// 16 bytes (`bytes` of them read, the rest zero) into shared memory,
// with L2 fetching the 256 bytes around them: a row's next line belongs
// to the next warp's chunk (a little faster than without the hint on the
// H100).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's copy groups are in flight (more
// than 7 waits for 7: a longer wait, never a shorter one).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at p in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float load_cluster(const float* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(r) : "memory");
  return v;
}

__device__ __forceinline__ float bf16_bits(uint32_t u16) {
  return __uint_as_float(u16 << 16);
}

// Two floats as a bf16 pair rounded to nearest, the first in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D = A x ones from a zero accumulator; d[0] is row g's sum, d[2] row
// g + 8's (every column of D is the same).
__device__ __forceinline__ void mma_ones(float (&d)[4],
                                         const uint32_t (&a)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(kOnes), "r"(kOnes));
}

// Where the 16-byte piece p of row r of a chunk lives in shared memory.
template <int DT>
__device__ __forceinline__ unsigned char* piece(unsigned char* chunk, int r,
                                                int p) {
  using G = Geo<DT>;
  return chunk + (p / G::kSize) * G::kTileStride + r * G::kRowBytes +
         (p % G::kSize) * 16;
}

// One chunk (16 rows x 128 bytes from column col0) into shared memory,
// the warp's 32 lanes 4 pieces each: piece j of a lane is row 4j + lane
// / 8, 16 bytes p = lane % 8 of the chunk's row.
template <int DT, bool VEC>
__device__ __forceinline__ void load_chunk(const void* x, unsigned char* chunk,
                                           long long row0, long long rows,
                                           int d, long long col0, int lane) {
  using G = Geo<DT>;
  const int p = lane & 7;
  const long long col = col0 + p * G::kPieceCols;
  const auto* xb = static_cast<const unsigned char*>(x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * j + (lane >> 3);
    const long long row = row0 + r;
    unsigned char* dst = piece<DT>(chunk, r, p);
    if (VEC) {
      // Aligned rows: a piece lies wholly inside d or wholly past it.
      const bool in = row < rows && col < d;
      cp_async16(dst, in ? xb + (row * d + col) * G::kSize : xb, in ? 16 : 0);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (DT == kF32) {
          const long long c = col + e;
          v[e] = row < rows && c < d
                     ? __float_as_uint(__ldg(static_cast<const float*>(x) +
                                             row * d + c))
                     : 0u;
        } else {
          const auto* xs = static_cast<const unsigned short*>(x);
          const long long c = col + 2 * e;
          const uint32_t a =
              row < rows && c < d ? __ldg(xs + row * d + c) : 0u;
          const uint32_t b =
              row < rows && c + 1 < d ? __ldg(xs + row * d + c + 1) : 0u;
          v[e] = a | (b << 16);
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One tile's word sums of rows g and g + 8: (hi + mid) + lo for f32,
// hi + lo for bf16, each word's MMA from zero.
template <int DT>
__device__ __forceinline__ void tile_sum(const unsigned char* tile, int g,
                                         int t, float& out_a, float& out_b) {
  constexpr int kWords = DT == kF32 ? 3 : 2;
  float sa[4], sb[4];
  if (DT == kF32) {
    const float4 a = *reinterpret_cast<const float4*>(tile + g * 64 + t * 16);
    const float4 b =
        *reinterpret_cast<const float4*>(tile + (g + 8) * 64 + t * 16);
    const float va[4] = {a.x, a.y, a.z, a.w}, vb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sa[j] = __fmul_rn(va[j], va[j]);
      sb[j] = __fmul_rn(vb[j], vb[j]);
    }
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(tile + g * 32 + t * 8);
    const uint2 b =
        *reinterpret_cast<const uint2*>(tile + (g + 8) * 32 + t * 8);
    const uint32_t ua[2] = {a.x, a.y}, ub[2] = {b.x, b.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float a0 = bf16_bits(ua[j] & 0xffffu), a1 = bf16_bits(ua[j] >> 16);
      const float b0 = bf16_bits(ub[j] & 0xffffu), b1 = bf16_bits(ub[j] >> 16);
      sa[2 * j] = __fmul_rn(a0, a0);
      sa[2 * j + 1] = __fmul_rn(a1, a1);
      sb[2 * j] = __fmul_rn(b0, b0);
      sb[2 * j + 1] = __fmul_rn(b1, b1);
    }
  }
  float ta = 0.0f, tb = 0.0f;
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
    ta = word == 0 ? dd[0] : __fadd_rn(ta, dd[0]);
    tb = word == 0 ? dd[2] : __fadd_rn(tb, dd[2]);
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
  out_a = ta;
  out_b = tb;
}

// out for one chunk from shared memory: the pieces load_chunk moved,
// each (x * rstd) * (w + offset) and stored as 16 bytes where aligned.
template <int DT, bool VEC>
__device__ __forceinline__ void scale_chunk(const unsigned char* chunk,
                                            const float* w, void* out,
                                            const float* rstd, long long row0,
                                            long long rows, int d,
                                            long long col0, float offset,
                                            int lane) {
  using G = Geo<DT>;
  constexpr int kN = G::kPieceCols;
  const int p = lane & 7;
  const long long col = col0 + p * kN;
  if (col >= d) return;
  float wv[kN];
  if (VEC) {
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w + col) + q);
      wv[4 * q] = v.x;
      wv[4 * q + 1] = v.y;
      wv[4 * q + 2] = v.z;
      wv[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kN; ++e)
      wv[e] = col + e < d ? __ldg(w + col + e) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) wv[e] = __fadd_rn(wv[e], offset);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * j + (lane >> 3);
    const long long row = row0 + r;
    if (row >= rows) break;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        piece<DT>(const_cast<unsigned char*>(chunk), r, p));
    const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
    const float s = rstd[r];
    uint32_t o[4];
    if (DT == kF32) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __float_as_uint(
            __fmul_rn(__fmul_rn(__uint_as_float(u[e]), s), wv[e]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = __fmul_rn(__fmul_rn(bf16_bits(u[e] & 0xffffu), s),
                                   wv[2 * e]);
        const float hi = __fmul_rn(__fmul_rn(bf16_bits(u[e] >> 16), s),
                                   wv[2 * e + 1]);
        o[e] = bf16_pair(lo, hi);
      }
    }
    unsigned char* dst =
        static_cast<unsigned char*>(out) + (row * d + col) * G::kSize;
    if (VEC) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else if (DT == kF32) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) reinterpret_cast<uint32_t*>(dst)[e] = o[e];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < d)
          reinterpret_cast<uint16_t*>(dst)[e] =
              static_cast<uint16_t>(o[e / 2] >> (16 * (e % 2)));
    }
  }
}

// Grid: cluster x row tiles blocks, clusters of `cluster` along x.  The
// 16-byte path is held to 48 registers, so five blocks of 35 KB share an
// SM; with the compiler's 64-78 registers only three or four did, and
// bf16 ran slower on the H100.  The element-by-element path spills at 48
// and keeps the compiler's count.
template <int DT, bool VEC>
__global__ void __launch_bounds__(kThreads, VEC ? 5 : 1)
    rmsnorm_kernel(const void* x, const float* w, void* out, long long rows,
                   int d, int cluster, int chunks, int resident, float eps,
                   float weight_offset) {
  using G = Geo<DT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float part[kWarps][kM];
  __shared__ float rank_sum[kM];
  __shared__ float rstd[kM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned rank = cluster_rank();
  const long long row0 = static_cast<long long>(blockIdx.x / cluster) * kM;
  unsigned char* strip = smem + warp * resident * kChunkStride;
  // The warp's chunks of the row tile: [first, first + live).
  const long long row_chunks = (d + G::kCols - 1) / G::kCols;
  const long long first =
      (static_cast<long long>(rank) * kWarps + warp) * chunks;
  const long long left = row_chunks - first;
  const int live = left <= 0 ? 0 : left < chunks ? static_cast<int>(left)
                                                 : chunks;
  const long long tiles = (d + 15) / 16;

  float acc_a = 0.0f, acc_b = 0.0f;
  for (int s0 = 0; s0 < live; s0 += resident) {
    const int n = live - s0 < resident ? live - s0 : resident;
    if (s0 > 0) __syncwarp();  // every lane is done with the last segment
    for (int k = 0; k < n; ++k) {
      load_chunk<DT, VEC>(x, strip + k * kChunkStride, row0, rows, d,
                          (first + s0 + k) * G::kCols, lane);
      cp_async_commit();
    }
    for (int k = 0; k < n; ++k) {
      cp_async_wait(n - 1 - k);
      __syncwarp();
      const long long tile0 = (first + s0 + k) * G::kTiles;
#pragma unroll
      for (int i = 0; i < G::kTiles; ++i) {
        if (tile0 + i >= tiles) break;
        float ta, tb;
        tile_sum<DT>(strip + k * kChunkStride + i * G::kTileStride, g, t, ta,
                     tb);
        acc_a = __fadd_rn(acc_a, ta);
        acc_b = __fadd_rn(acc_b, tb);
      }
    }
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
    rank_sum[threadIdx.x] = sum;
  }
  cluster_arrive();  // this block's row sums, to the cluster
  cluster_wait();
  if (threadIdx.x < kM) {
    float sum = load_cluster(&rank_sum[threadIdx.x], 0);
    for (int c = 1; c < cluster; ++c)
      sum = __fadd_rn(sum, load_cluster(&rank_sum[threadIdx.x], c));
    const float ms = __fdiv_rn(sum, static_cast<float>(d));
    rstd[threadIdx.x] = rsqrtf(__fadd_rn(ms, eps));
  }
  cluster_arrive();  // done reading the other blocks' sums
  __syncthreads();

  // The scaling pass, last segment first: it is still in shared memory
  // (the only one wherever the warp's chunks are resident).
  const int segments = (live + resident - 1) / resident;
  for (int sg = segments - 1; sg >= 0; --sg) {
    const int s0 = sg * resident;
    const int n = live - s0 < resident ? live - s0 : resident;
    if (sg != segments - 1) {
      __syncwarp();
      for (int k = 0; k < n; ++k)
        load_chunk<DT, VEC>(x, strip + k * kChunkStride, row0, rows, d,
                            (first + s0 + k) * G::kCols, lane);
      cp_async_commit();
      cp_async_wait(0);
      __syncwarp();
    }
    for (int k = 0; k < n; ++k)
      scale_chunk<DT, VEC>(strip + k * kChunkStride, w, out, rstd, row0, rows,
                           d, (first + s0 + k) * G::kCols, weight_offset,
                           lane);
  }
  cluster_wait();  // no block leaves while another may read its sums
}

template <int DT, bool VEC>
int launch(const void* x, const float* w, void* out, long long rows, int d,
           float eps, float weight_offset, cudaStream_t s) {
  const Walk wk = walk(d, DT);
  const long long blocks = (rows + kM - 1) / kM * wk.cluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = rmsnorm_kernel<DT, VEC>;
  // The shared memory granted to this kernel on each card, asked for once
  // (a host call per launch otherwise).
  static bool granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !granted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return e;
    if (dev < 64) granted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(kWarps) * wk.resident *
                         kChunkStride;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = wk.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, w, out, rows, d, wk.cluster,
                         wk.chunks, wk.resident, eps, weight_offset);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mma_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B8's walk for a row of d columns (dtype 0 f32, 1 bf16): the cluster
// size, the chunks a warp takes and those it holds in shared memory.
int b8_rmsnorm_walk(int d, int dtype, int* cluster, int* chunks,
                    int* resident) {
  if (d < 1 || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const Walk w = walk(d, dtype);
  *cluster = w.cluster;
  *chunks = w.chunks;
  *resident = w.resident;
  return 0;
}

// B8: out = rmsnorm(x) over the last dim of x (rows, d), row-major and
// contiguous, f32 (dtype 0) or bf16 (dtype 1); w is d f32 values; out
// has x's dtype and shape and a 16-byte-aligned base.
int b8_rmsnorm(const void* x, const float* w, void* out, long long rows,
               int d, int dtype, float eps, float weight_offset,
               void* stream) {
  if (rows < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const long long pitch = static_cast<long long>(d) * (dtype == kF32 ? 4 : 2);
  const bool vec = aligned(x) && aligned(w) && aligned(out) && pitch % 16 == 0;
  if (dtype == kF32)
    return vec ? launch<kF32, true>(x, w, out, rows, d, eps, weight_offset, s)
               : launch<kF32, false>(x, w, out, rows, d, eps, weight_offset, s);
  if (dtype == kBF16)
    return vec ? launch<kBF16, true>(x, w, out, rows, d, eps, weight_offset, s)
               : launch<kBF16, false>(x, w, out, rows, d, eps, weight_offset,
                                      s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
