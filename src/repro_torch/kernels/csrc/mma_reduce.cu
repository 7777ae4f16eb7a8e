// Chained ones-MMA arithmetic reductions for Hopper (sm_90a): kernels
// B1-B3 of the port, with a plain C interface bound from Python through
// ctypes (repro_torch/kernels/_build.py, repro_torch/kernels/mma_reduce.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/mma_reduce.py:
//   b1_single_pass  <- mma_reduce_kernel   (single_pass_call)
//   b2_partials     <- mma_partials_kernel (partials_call)
//   b3_split        <- mma_split_kernel    (split_call)
//
// Encoding (Navarro et al. 2020, m = 16).  The input is the flat
// row-major view of the reference's (T, 16) tile array.  A tile of
// chain * block_rows rows is taken by one thread block; link r of the
// chain is the tile's rows [r * block_rows, (r + 1) * block_rows), and
// warp w owns the 16 x 16 slab at rows 16w..16w+15 of every link.  A
// link is one ones-MMA per slab:  D = A_slab x [1] + D, with the slab
// as the A operand and an all-ones B operand, so D's rows are the
// slab's row sums in f32.  Because B is all ones, the sum does not
// depend on which slab element lands in which A-fragment slot: each
// lane loads 8 consecutive elements (16 bytes for bf16/fp16), a fully
// coalesced 512-byte warp load, and feeds them to the MMA as they are.
//
//   bf16 / fp16 input: one mma.sync.m16n8k16 per slab and link.
//   f32 input: Hopper has no f32 MMA, and a TF32 operand alone keeps
//     11 significand bits (a 2^-12..2^-11 bias on positive sums).  Each
//     value is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi),
//     22 bits together, and both go through mma.sync.m16n8k8 TF32 MMAs
//     into the same f32 accumulator (four MMAs per slab and link).
//
// Collapse (the reference's final transposed ones-MMA) stays in f32: a
// warp shuffle tree over the 16 row sums, then a fixed-order sum over
// the block's warps in shared memory.  No partial is ever rounded to a
// narrower type.  square=True squares each element in the input dtype
// first (__hmul2 / __fmul_rn: one rounding, no FMA contraction), so
// bf16 / fp16 rounding and overflow match the reference.
//
// Bound on the H100: bytes.  Every element is read once, and a ones-MMA
// does 16-32 flops per element, far below the ~295 flops per byte at
// which the tensor cores would become the limit.  The design therefore
// spends nothing on shared-memory staging: loads go straight from
// device memory into MMA fragments, 16 bytes per lane (B2: up to kBatch
// links of loads issued before their MMAs).  The ragged tail is masked
// here (out-of-range elements read as 0), so no padded copy of the
// input is ever made.
//
// B1 and B3 walk the tiles on a grid that walk_grid below computes from
// (n, chain, block_rows) alone: each block takes ceil(kWalkUnits /
// chain) tiles, so each lane walks kWalkUnits units (one 16-byte load,
// or 32 bytes in f32, of one link of one tile), and block b the tiles
// b, b + grid, b + 2 grid, ...  A lane loads its units in stages of
// kStageBytes, double-buffered in registers: the next stage's loads are
// issued before the current stage's MMAs, so in 16 bits all 128 bytes
// of a lane's walk are in flight before its first MMA.  Each tile's
// chain folds into a D that starts at zero, and D is added into a
// per-lane f32 carry fragment (__fadd_rn) when the tile's last link is
// in: a tile is still a chain of exactly `chain` links, as the
// reference adds each grid step's chain into its f32 VMEM accumulator.
// The block collapses its carries once and makes one cross-block add,
// where one block per tile made one per tile (B3's 131072 same-address
// atomics at 2^28, block_rows 128, held it at ~0.29 ms on the H100
// 80GB HBM3 at 700 W: probes/b3_turnover.py).  On that card long walks
// ran slower than short ones the hardware keeps refilling (64 units a
// lane 5-9 % in 16 bits), and 8 units a lane ran fastest
// (probes/mma_reduce_walk.py).
//
// B1 replaces the TPU's sequential-grid VMEM accumulator with the
// paper's §5.2 atomics: each block adds its f32 total to one zeroed
// scalar with atomicAdd.  The order of those adds varies between runs,
// so the last bits of B1 and B3 do too.  B2 keeps one block per tile
// (variant="recurrence" reads its one partial per tile) and is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kM = 16;                   // chain-link tile: 16 x 16
constexpr int kSlab = kM * kM;           // elements per warp per link
constexpr int kPerLane = kSlab / 32;     // 8 elements per lane
constexpr int kBatch = 4;                // B2: links loaded before their MMAs
constexpr int kMaxThreads = 1024;        // block_rows <= 512
// The walk of B1 and B3: the units a lane walks (whole tiles, at least
// one), the launch limit on the grid, and the bytes a lane loads a stage
// (at most 64 registers a thread under __launch_bounds__(kMaxThreads,
// 1)).
constexpr int kWalkUnits = 8;
constexpr long long kMaxGrid = 0x7fffffffLL;
constexpr int kStageBytes = 64;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// One lane's 8 elements of one slab: 8 floats, or 8 16-bit values
// packed in pairs into 4 registers (the m16n8k16 A fragment).
template <int DT>
struct Frag;

template <>
struct Frag<kF32> {
  float v[kPerLane];
};

template <int DT>
struct Frag {
  uint32_t v[kPerLane / 2];
};

__device__ __forceinline__ void load(Frag<kF32>& f, const void* x,
                                     long long n, long long i) {
  const float* p = static_cast<const float*>(x) + i;
  if (i + kPerLane <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f.v[0] = a.x; f.v[1] = a.y; f.v[2] = a.z; f.v[3] = a.w;
    f.v[4] = b.x; f.v[5] = b.y; f.v[6] = b.z; f.v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) f.v[j] = (i + j < n) ? p[j] : 0.0f;
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

// x * x in the input dtype, rounded once.
__device__ __forceinline__ void square(Frag<kF32>& f) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) f.v[j] = __fmul_rn(f.v[j], f.v[j]);
}

template <int DT>
__device__ __forceinline__ void square(Frag<DT>& f) {
#pragma unroll
  for (int j = 0; j < kPerLane / 2; ++j) {
    if (DT == kBF16) {
      __nv_bfloat162 h;
      memcpy(&h, &f.v[j], 4);
      h = __hmul2(h, h);
      memcpy(&f.v[j], &h, 4);
    } else {
      __half2 h;
      memcpy(&h, &f.v[j], 4);
      h = __hmul2(h, h);
      memcpy(&f.v[j], &h, 4);
    }
  }
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the bits the MMA reads
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3) {
  const uint32_t one = 0x3f800000u;  // 1.0 as TF32
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(one), "r"(one));
}

// One chain link of one slab: D += A_slab x [1].
__device__ __forceinline__ void mma_link(float (&d)[4], const Frag<kF32>& f) {
  uint32_t hi[kPerLane], lo[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    hi[j] = tf32_bits(f.v[j]);
    lo[j] = tf32_bits(__fsub_rn(f.v[j], __uint_as_float(hi[j])));
  }
  mma_tf32(d, hi[0], hi[1], hi[2], hi[3]);
  mma_tf32(d, hi[4], hi[5], hi[6], hi[7]);
  mma_tf32(d, lo[0], lo[1], lo[2], lo[3]);
  mma_tf32(d, lo[4], lo[5], lo[6], lo[7]);
}

template <int DT>
__device__ __forceinline__ void mma_link(float (&d)[4], const Frag<DT>& f) {
  if (DT == kBF16) {
    const uint32_t one2 = 0x3f803f80u;  // two bf16 ones
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(f.v[0]), "r"(f.v[1]), "r"(f.v[2]), "r"(f.v[3]), "r"(one2),
          "r"(one2));
  } else {
    const uint32_t one2 = 0x3c003c00u;  // two fp16 ones
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(f.v[0]), "r"(f.v[1]), "r"(f.v[2]), "r"(f.v[3]), "r"(one2),
          "r"(one2));
  }
}

// The chain: fold `chain` links, `stride` elements apart, starting at
// element i, into this warp's f32 accumulator fragment.
template <int DT>
__device__ __forceinline__ void fold_chain(float (&d)[4], const void* x,
                                           long long n, long long i,
                                           long long stride, int chain) {
  for (int r0 = 0; r0 < chain; r0 += kBatch) {
    Frag<DT> f[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (r0 + b < chain) load(f[b], x, n, i + (r0 + b) * stride);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (r0 + b < chain) mma_link(d, f[b]);
  }
}

// The 16 row sums of D, collapsed in f32.  Lane 4g+t holds row g in
// d[0] (== d[1]) and row g+8 in d[2] (== d[3]); the tree over lane bits
// 2..4 leaves the warp total in every lane.
__device__ __forceinline__ float collapse(const float (&d)[4]) {
  float v = d[0] + d[2];
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order f32 sum of the warp totals; valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += part[w];
  return s;
}

// Plain f32 sum of one lane's 8 elements into acc, in element order
// (the CUDA-core path of B3).
__device__ __forceinline__ float lane_add(float acc, const Frag<kF32>& f) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc = __fadd_rn(acc, f.v[j]);
  return acc;
}

template <int DT>
__device__ __forceinline__ float lane_add(float acc, const Frag<DT>& f) {
#pragma unroll
  for (int j = 0; j < kPerLane / 2; ++j) {
    float2 p;
    if (DT == kBF16) {
      __nv_bfloat162 h;
      memcpy(&h, &f.v[j], 4);
      p = __bfloat1622float2(h);
    } else {
      __half2 h;
      memcpy(&h, &f.v[j], 4);
      p = __half22float2(h);
    }
    acc = __fadd_rn(acc, p.x);
    acc = __fadd_rn(acc, p.y);
  }
  return acc;
}

__device__ __forceinline__ void add_into(float (&carry)[4],
                                         const float (&d)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) carry[j] = __fadd_rn(carry[j], d[j]);
}

// Units a lane loads a stage: 64 bytes, four 16-bit units or two f32.
template <int DT>
__host__ __device__ constexpr int stage_units() {
  return kStageBytes / (kPerLane * (DT == kF32 ? 4 : 2));
}

// The tiles this block walks: `count` of them, from tile `first`, `step`
// tiles apart.
struct Span {
  long long first;
  long long count;
  long long step;
};

__device__ __forceinline__ Span block_tiles(long long tiles) {
  const long long b = blockIdx.x, grid = gridDim.x;
  return Span{b, (tiles - b + grid - 1) / grid, grid};
}

// A lane's place in the walk: the first element of its next unit, that
// unit's link, and the units it has still to load.  Link r of tile t
// starts at t * tile + r * stride; after the last link the walk jumps
// to the span's next tile.
struct Cursor {
  long long i;
  long long left;
  int link;
};

template <int DT, int K>
__device__ __forceinline__ void load_stage(Frag<DT> (&f)[K], Cursor& c,
                                           const void* x, long long n,
                                           long long stride, long long jump,
                                           int chain) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (c.left > 0) {
      load(f[k], x, n, c.i);
      --c.left;
      if (++c.link == chain) {
        c.link = 0;
        c.i += jump;
      } else {
        c.i += stride;
      }
    }
  }
}

// The walk of one lane: every unit of tiles blockIdx.x, + gridDim.x, ...
// goes to use(unit) in order, `chain` units a tile, while the next
// stage's loads are in flight.  The unit count is the same for every
// lane of a block, so every branch here is uniform across a warp (as
// mma.sync needs).
template <int DT, typename Use>
__device__ __forceinline__ void walk_units(const void* x, long long n,
                                           long long tiles, int chain,
                                           int block_rows, Use use) {
  constexpr int K = stage_units<DT>();
  const long long stride = static_cast<long long>(block_rows) * kM;
  const long long tile = stride * chain;
  const Span span = block_tiles(tiles);
  Cursor c{span.first * tile + (threadIdx.x >> 5) * kSlab +
               (threadIdx.x & 31) * kPerLane,
           span.count * chain, 0};
  const long long jump = span.step * tile - (chain - 1) * stride;
  long long left = c.left;
  Frag<DT> a[K], b[K];
  load_stage(a, c, x, n, stride, jump, chain);
  while (left > 0) {
    load_stage(b, c, x, n, stride, jump, chain);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (left - k > 0) use(a[k]);
    left -= K;
    if (left <= 0) break;
    load_stage(a, c, x, n, stride, jump, chain);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (left - k > 0) use(b[k]);
    left -= K;
  }
}

template <int DT, bool SQUARE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    single_pass_kernel(const void* x, long long n, int chain,
                       int block_rows, long long tiles, float* out) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int link = 0;
  walk_units<DT>(x, n, tiles, chain, block_rows, [&](Frag<DT>& f) {
    if (SQUARE) square(f);
    mma_link(d, f);
    if (++link == chain) {  // the tile's chain is in: carry it, restart
      link = 0;
      add_into(carry, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = 0.0f;
    }
  });
  const float s = block_sum(collapse(carry));
  if (threadIdx.x == 0) atomicAdd(out, s);
}

template <int DT>
__global__ void __launch_bounds__(kMaxThreads)
    partials_kernel(const void* x, long long n, int chain, int block_rows,
                    float* out) {
  const long long stride = static_cast<long long>(block_rows) * kM;
  const long long i = blockIdx.x * stride * chain +
                      (threadIdx.x >> 5) * kSlab +
                      (threadIdx.x & 31) * kPerLane;
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  fold_chain<DT>(d, x, n, i, stride, chain);
  const float s = block_sum(collapse(d));
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// Warps below mma_warps reduce their slab of every tile they walk with a
// ones-MMA, the others with plain f32 adds on the CUDA cores, side by
// side in one block.
template <int DT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    split_kernel(const void* x, long long n, int block_rows, int mma_warps,
                 long long tiles, float* out) {
  float v;
  if ((threadIdx.x >> 5) < mma_warps) {
    float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    walk_units<DT>(x, n, tiles, 1, block_rows, [&](Frag<DT>& f) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_link(d, f);
      add_into(carry, d);
    });
    v = collapse(carry);
  } else {
    float acc = 0.0f;
    walk_units<DT>(x, n, tiles, 1, block_rows,
                   [&](Frag<DT>& f) { acc = lane_add(acc, f); });
    v = warp_sum(acc);
  }
  const float s = block_sum(v);
  if (threadIdx.x == 0) atomicAdd(out, s);
}

bool bad_geometry(int chain, int block_rows) {
  return chain < 1 || block_rows < kM || block_rows % kM != 0 ||
         2 * block_rows > kMaxThreads;
}

// Tiles of `tile` elements that cover n (one when n = 0).
long long tiles_for(long long n, long long tile) {
  return n > 0 ? (n + tile - 1) / tile : 1;
}

// B2: one block per tile; 0 when the grid would exceed the launch limit.
unsigned blocks_for(long long n, long long tile) {
  const long long g = tiles_for(n, tile);
  return g <= kMaxGrid ? static_cast<unsigned>(g) : 0u;
}

// B1's and B3's walk: blocks that each take ceil(kWalkUnits / chain)
// tiles, and no more than the launch limit (past it the blocks walk
// more).  Mirrored by repro_torch.kernels.mma_reduce.walk.
long long walk_grid(long long n, int chain, int block_rows) {
  const long long tile = static_cast<long long>(chain) * block_rows * kM;
  const long long grid =
      tiles_for(tiles_for(n, tile), tiles_for(kWalkUnits, chain));
  return grid < kMaxGrid ? grid : kMaxGrid;
}

}  // namespace

extern "C" {

const char* mma_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The walk's grid for these arguments (the library's own walk_grid).
long long mma_reduce_walk(long long n, int chain, int block_rows) {
  if (bad_geometry(chain, block_rows)) return -1;
  return walk_grid(n, chain, block_rows);
}

// B1: out[0] = sum(x) (or sum(x * x)): zeroes out, then one launch.
int b1_single_pass(const void* x, long long n, int dtype, int chain,
                   int block_rows, int square, float* out, void* stream) {
  if (bad_geometry(chain, block_rows)) return cudaErrorInvalidValue;
  const long long tiles =
      tiles_for(n, static_cast<long long>(chain) * block_rows * kM);
  const dim3 grid(
      static_cast<unsigned>(walk_grid(n, chain, block_rows)));
  const dim3 block(2 * block_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (rc != cudaSuccess) return rc;
  if (dtype == kF32 && !square)
    single_pass_kernel<kF32, false><<<grid, block, 0, s>>>(x, n, chain, block_rows, tiles, out);
  else if (dtype == kF32)
    single_pass_kernel<kF32, true><<<grid, block, 0, s>>>(x, n, chain, block_rows, tiles, out);
  else if (dtype == kBF16 && !square)
    single_pass_kernel<kBF16, false><<<grid, block, 0, s>>>(x, n, chain, block_rows, tiles, out);
  else if (dtype == kBF16)
    single_pass_kernel<kBF16, true><<<grid, block, 0, s>>>(x, n, chain, block_rows, tiles, out);
  else if (dtype == kF16 && !square)
    single_pass_kernel<kF16, false><<<grid, block, 0, s>>>(x, n, chain, block_rows, tiles, out);
  else if (dtype == kF16)
    single_pass_kernel<kF16, true><<<grid, block, 0, s>>>(x, n, chain, block_rows, tiles, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// B2: out[g] = sum of tile g, for every tile of chain * block_rows * 16.
int b2_partials(const void* x, long long n, int dtype, int chain,
                int block_rows, float* out, void* stream) {
  if (bad_geometry(chain, block_rows)) return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(n, static_cast<long long>(chain) * block_rows * kM));
  const dim3 block(2 * block_rows);
  if (grid.x == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    partials_kernel<kF32><<<grid, block, 0, s>>>(x, n, chain, block_rows, out);
  else if (dtype == kBF16)
    partials_kernel<kBF16><<<grid, block, 0, s>>>(x, n, chain, block_rows, out);
  else if (dtype == kF16)
    partials_kernel<kF16><<<grid, block, 0, s>>>(x, n, chain, block_rows, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// B3: out[0] = sum(x), the first mma_rows rows of every block_rows-row
// tile through ones-MMAs and the rest through CUDA-core adds: zeroes
// out, then one launch.
int b3_split(const void* x, long long n, int dtype, int block_rows,
             int mma_rows, float* out, void* stream) {
  if (bad_geometry(1, block_rows) || mma_rows < 0 || mma_rows % kM != 0 ||
      mma_rows > block_rows)
    return cudaErrorInvalidValue;
  const long long tiles = tiles_for(n, static_cast<long long>(block_rows) * kM);
  const dim3 grid(static_cast<unsigned>(walk_grid(n, 1, block_rows)));
  const dim3 block(2 * block_rows);
  const int mma_warps = mma_rows / kM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (rc != cudaSuccess) return rc;
  if (dtype == kF32)
    split_kernel<kF32><<<grid, block, 0, s>>>(x, n, block_rows, mma_warps, tiles, out);
  else if (dtype == kBF16)
    split_kernel<kBF16><<<grid, block, 0, s>>>(x, n, block_rows, mma_warps, tiles, out);
  else if (dtype == kF16)
    split_kernel<kF16><<<grid, block, 0, s>>>(x, n, block_rows, mma_warps, tiles, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
