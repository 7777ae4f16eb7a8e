// Fused attention for Hopper (sm_90a): kernel B9 of the port, with a
// plain C interface bound from Python through ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/mma_attention.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mma_attention.py
// _attn_kernel (launched by _attn_call and mma_attention).  For qg of
// shape (B, Sq, KV, G, hd), k (B, Sk, KV, hd) and v (B, Sk, KV, hd_v):
//
//   s_ij = scale q_i.k_j, then cap tanh(s_ij / cap) with a softcap
//   valid: lo_i <= j < hi_i, hi_i = min(Sk, kv_len[b], qpos_i + 1 if
//          causal), lo_i = qpos_i - window + 1 with a window, else 0
//   o_i  = sum_j exp(s_ij - m_i) v_j / l_i over the valid keys
//
// written to (B, Sq, KV, G, hd_v) in v's dtype; a row with no valid key
// gives exactly 0.
//
// The TPU walked the KV blocks as the sequential last grid axis and
// carried m, l, the Kahan carry and the accumulator in VMEM from one grid
// step to the next.  Here one block owns 64 query rows of one (batch, KV
// head), one 16-row group per warp, and walks the key blocks in a loop
// inside it, keeping that state in registers: blocks run in no order and
// share nothing, so each output row is written by one block in a fixed
// order (no atomics, no split of the keys): the same bits on every call,
// and a row's bits do not depend on the batch it came in.  The rows pack
// the (Sq, G) pairs, row r = i G + g, so the G heads of a group share
// each K/V load and a decode step (Sq = 1, G = 2) fills two rows of 16,
// not one per head.  A problem of at most 16 rows a head (decode) takes
// blocks of 16 rows whose four warps split each score's hd chains and the
// value columns between them, so all four work on the few rows.
//
// The walk, per row, over key blocks of kBK = 32 from 0 in order.  A
// block that holds no valid key of the row leaves its state as it was
// (so a block skipped by the whole tile changes no bits); otherwise
//
//   m_new = max(m, max_j s_ij)      (masked scores are -2e38)
//   corr  = exp(m - m_new),  p_ij = exp(s_ij - m_new)
//   l_blk = p x ones                 (the ones-MMA: p's two TF32 words)
//   y = l_blk - c corr;  t = l corr + y;  c = (t - l corr) - y;  l = t
//   acc   = acc corr + p x v;  m = m_new
//
// from m = -1e30, l = c = acc = 0; at the end o = acc / (l - c) where
// l - c > 0, else 0.  The Kahan steps use _rn intrinsics, so nvcc neither
// contracts nor reassociates them; exp and tanh are expf / tanhf (the
// build uses no --use_fast_math).
//
// Products (3xTF32).  Hopper has no f32 MMA, and one TF32 word keeps 11
// bits, ~2^-12 a product.  An f32 operand goes in as two TF32 words (hi =
// rna(x), lo = rna(x - hi)) and each product as lo.hi + hi.lo + hi.hi,
// ~21 bits; a bf16 operand is exact in one word (f32 q beside a bf16
// cache: q's two words against k's one); these run on m16n8k8 TF32
// MMAs.  Where both operands are bf16 (bf16 q and k; p rounded to bf16
// against a bf16 v) the products are exact in f32 and run on m16n8k16
// bf16 MMAs, two elements a register.  q.k runs in chains of 32 hd
// columns from a zero accumulator, each chain's sum added to the score
// with __fadd_rn on the CUDA cores; p x v and the ones-MMA run per key
// block from zero and are added to the running state on the CUDA cores,
// so a truncating tensor-core add touches one chain's partial, never a
// running sum.  p goes into p x v as two TF32 words when v is f32, and
// rounded to bf16 when v is bf16 (as the model layer's _direct_attn
// rounds it to v's dtype); l always sums p's two TF32 words.
//
// Fragments (mma.sync, lane = 4 g + t).  m16n8k8 .tf32: A (row g / g + 8,
// column t / t + 4), B (row t / t + 4, column g); m16n8k16 .bf16: A (row
// g / g + 8, columns 2t, 2t + 1 / 2t + 8, 2t + 9), B (rows 2t, 2t + 1 /
// 2t + 8, 2t + 9, column g); C (row g / g + 8, columns 2t, 2t + 1) for
// both.  For q.k the B operand is a block of K stored row-major (key,
// hd): B[kk][n] = K[n][kk], read at row 8 nt + g (a bf16 pair is one
// 32-bit load).  The score tile comes out in the C layout and goes into
// p x v as the A operand without a trip through shared memory: for k16
// two 8-key tiles' C fragments are the A fragment of their 16 keys; for
// k8 the key index is permuted, A column t standing for key 2t and t + 4
// for key 2t + 1 of each 8-key tile, and V's rows are read in the same
// order (B row t from key 2t, t + 4 from key 2t + 1).
//
// Loads.  The query rows and, in two stages, each block of keys and of
// values go to shared memory in their own dtype by cp.async in 16-byte
// chunks (zero past hd, hd_v and Sk); the next block's copies are in
// flight while this block's MMAs run.  Rows not 16-byte aligned load
// element by element.  Shared rows are padded (f32 to a multiple of 32
// words plus 4, bf16 to 64 elements plus 8) so that every fragment load
// is free of bank conflicts and every row starts 16-byte aligned.
//
// Bound on the H100: operations at prefill (Gemma-2 2B's global layer at
// 4096 tokens: 2 (256 + 256) flops on each of ~67M live scores a head
// pair), bytes at decode (128 slots over a 32768-slot bf16 cache: 8.6 GB
// each for k and v, read as far as each row's kv_len).  This simple form
// reaches neither: it splits words at every fragment load, runs 2-3
// mma.sync per useful f32 product, and at decode a block's MMAs fill 2 of
// their 16 rows.  wgmma, TMA, warp specialisation and a split of the keys
// for decode with a fixed-order second stage are later work;
// chip_smoke.py times it against its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;             // WM (16-row groups) x WN (columns)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 64;          // query rows of the tallest tile
constexpr int kBK = 32;               // keys per block step
constexpr int kKT = kBK / 8;          // 8-key tiles of a step
constexpr int kStep = 32;             // hd columns per chain of q.k MMAs
constexpr int kVT = 4;                // 8-column value tiles per p x v chain
constexpr int kXS = kBK + 8;          // exchanged score row: float2 loads
                                      // of a half-warp hit 32 banks
constexpr float kNegInf = -2.0e38f;
constexpr float kMInit = -1.0e30f;
constexpr uint32_t kOne = 0x3f800000u;  // 1.0f, exact in TF32
constexpr int kSmemLimit = 232448;      // 227 KB a block on the H100

enum DType { kF32 = 0, kBF16 = 1 };

// A shared row of dim elements: f32 rows padded to a multiple of 32 words
// plus 4, bf16 rows to a multiple of 64 elements plus 8 (both 128 k + 16
// bytes), so every fragment load is free of bank conflicts and every row
// starts 16-byte aligned for cp.async.
template <bool F32>
__host__ __device__ constexpr int stride_of(int dim) {
  return F32 ? (dim + 31) / 32 * 32 + 4 : (dim + 63) / 64 * 64 + 8;
}

template <bool F32>
__host__ __device__ constexpr int row_bytes(int dim) {
  return stride_of<F32>(dim) * (F32 ? 4 : 2);
}

// Shared memory of a block: its 16 WM query rows, two stages of a key
// block and a value block, the rows' bounds, and with WN > 1 the score
// chains' partials that the warps of a row group exchange.
template <bool QF32, bool KVF32, int NV, int WM, int WN>
constexpr long long smem_bytes(int hd) {
  return 16LL * WM * row_bytes<QF32>(hd) +
         2LL * kBK * (row_bytes<KVF32>(hd) + row_bytes<KVF32>(8 * NV)) +
         2 * 16 * WM * 4 +
         (WN > 1 ? 4LL * (16 * kXS * ((hd + kStep - 1) / kStep + 1) +
                          16 * WN)
                 : 0);
}

template <bool F32>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (F32) return __ldg(static_cast<const float*>(p) + i);
  const uint16_t u = __ldg(static_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// Element i of a shared tile, as f32 (a bf16 value widens exactly).
template <bool F32>
__device__ __forceinline__ float lds(const unsigned char* tile, int i) {
  if (F32) return reinterpret_cast<const float*>(tile)[i];
  const uint16_t u = reinterpret_cast<const uint16_t*>(tile)[i];
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

template <bool F32>
__device__ __forceinline__ void store(void* out, long long i, float v) {
  if (F32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One row of a tile into shared memory: columns [0, width) of which the
// first n come from src[off ..] when the row is in range, the rest zero.
// With vec (rows 16-byte aligned) by cp.async in 16-byte chunks, else
// element by element.
template <bool F32>
__device__ __forceinline__ void copy_row(unsigned char* dst, const void* src,
                                         long long off, int n, int width,
                                         bool in, bool vec, int lane) {
  constexpr int kItem = F32 ? 4 : 2;
  constexpr int kChunk = 16 / kItem;
  if (vec) {
    for (int col = kChunk * lane; col < width; col += 32 * kChunk) {
      const bool ok = in && col < n;
      cp_async16(dst + col * kItem,
                 static_cast<const unsigned char*>(src) + (ok ? (off + col) * kItem : 0),
                 ok);
    }
  } else {
    for (int col = lane; col < width; col += 32) {
      const float x = in && col < n ? load<F32>(src, off + col) : 0.0f;
      if (F32) {
        reinterpret_cast<float*>(dst)[col] = x;
      } else {
        reinterpret_cast<uint16_t*>(dst)[col] =
            static_cast<uint16_t>(__float_as_uint(x) >> 16);
      }
    }
  }
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the bits the MMA reads
}

// The MMA words of x: hi and lo when TWO (an f32 value), else x itself
// (a value exact in TF32: bf16 data, or p rounded to bf16).
template <bool TWO>
__device__ __forceinline__ void words(float x, uint32_t& hi, uint32_t& lo) {
  if (TWO) {
    hi = tf32_bits(x);
    lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// D += A x B (m16n8k8, TF32).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A score of key j in a row with valid keys [lo, hi): scale s, then
// cap tanh(s / cap) with a softcap; -2e38 when masked.
__device__ __forceinline__ float score(float s, int j, int lo, int hi,
                                       float scale, int has_cap, float cap) {
  float x = __fmul_rn(s, scale);
  if (has_cap) x = __fmul_rn(cap, tanhf(__fdiv_rn(x, cap)));
  return j >= lo && j < hi ? x : kNegInf;
}

// Two rows' maxima over the four lanes of a quad (the row's keys).
__device__ __forceinline__ void quad_max(float& a, float& b) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
}

// D += A x B (m16n8k16, bf16): each register two bf16, the lower column
// (A) or row (B) in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Elements i and i + 1 of a bf16 shared tile as one register (i even).
__device__ __forceinline__ uint32_t lds_pair(const unsigned char* tile,
                                             int i) {
  return reinterpret_cast<const uint32_t*>(tile)[i >> 1];
}

// Elements i and j of a bf16 shared tile as one register, i low.
__device__ __forceinline__ uint32_t lds_two(const unsigned char* tile, int i,
                                            int j) {
  const uint16_t* e = reinterpret_cast<const uint16_t*>(tile);
  return static_cast<uint32_t>(e[i]) | (static_cast<uint32_t>(e[j]) << 16);
}

// Two floats as a bf16 pair rounded to nearest, the first in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The Kahan step of one row over a block it touches.
__device__ __forceinline__ void kahan(float& l, float& c, float corr,
                                      float l_blk) {
  const float l_old = __fmul_rn(l, corr);
  const float c_old = __fmul_rn(c, corr);
  const float y = __fsub_rn(l_blk, c_old);
  const float t = __fadd_rn(l_old, y);
  c = __fsub_rn(__fsub_rn(t, l_old), y);
  l = t;
}

// QF32 / KVF32: qg / k and v are f32 (else bf16); NV: 8-column tiles of
// the value head (hd_v padded to 8 NV).  The four warps are WM groups of
// 16 query rows by WN: with WN = 1 each warp owns its rows' whole
// scores and accumulator (prefill: 64 rows a block); with WN = 4 (a
// decode step's few rows: 16 a block) the warps of the row group split
// each score's hd chains (exchanged through shared memory and added in
// chain order, so the bits are those of one warp's walk) and the value
// columns, and each keeps the rows' softmax state itself.  vec: every
// row of q, k and v starts 16-byte aligned (cp.async), else the tiles
// load element by element.
template <bool QF32, bool KVF32, int NV, int WM, int WN>
__global__ void __launch_bounds__(kThreads, 1)
    attn_kernel(const void* __restrict__ q, const void* __restrict__ k,
                const void* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kvlen, void* __restrict__ out,
                int Sq, int Sk, int KV, int G, int hd, int hd_v, int causal,
                int has_window, long long window, float scale, int has_cap,
                float cap, int vec) {
  static_assert(WM * WN == kWarps, "four warps a block");
  static_assert(WN == 1 || WN == kKT, "with WN > 1 a warp per key tile");
  constexpr int kRows = 16 * WM;
  constexpr int NW = NV / WN;                   // this warp's value tiles
  constexpr int kVC = NW < kVT ? NW : kVT;      // value tiles per chain
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int range_s[2];
  const int qs = stride_of<QF32>(hd), ks = stride_of<KVF32>(hd);
  constexpr int vs = stride_of<KVF32>(8 * NV);
  const int k_bytes = kBK * row_bytes<KVF32>(hd);
  constexpr int v_bytes = kBK * row_bytes<KVF32>(8 * NV);
  unsigned char* q_s = smem;                           // [kRows][qs]
  unsigned char* kv_s = q_s + kRows * row_bytes<QF32>(hd);
  // stage st: keys at kv_s + st (k_bytes + v_bytes), values after them
  int* lo_s = reinterpret_cast<int*>(kv_s + 2 * (k_bytes + v_bytes));
  int* hi_s = lo_s + kRows;
  // With WN > 1: the score chains [chain][16][kXS], the key tiles' row
  // maxes [WN][16] and the block's p [16][kXS].
  float* xs = reinterpret_cast<float*>(hi_s + kRows);
  const int chains = (hd + kStep - 1) / kStep;
  float* mx_s = xs + chains * 16 * kXS;
  float* ps = mx_s + 16 * WN;

  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int nrows = Sq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int hd8 = (hd + 7) / 8 * 8;
  const int hd16 = (hd + 15) / 16 * 16;   // tiles are zero up to here

  // Each row's valid keys [lo, hi), clamped to [0, Sk]; rows past the
  // end hold none.
  if (tid < kRows) {
    const int r = r0 + tid;
    long long lo = 0, hi = 0;
    if (r < nrows) {
      const long long qp = qpos[static_cast<long long>(b) * Sq + r / G];
      hi = Sk;
      if (kvlen != nullptr) hi = min(hi, static_cast<long long>(kvlen[b]));
      if (causal) hi = min(hi, qp + 1);
      if (has_window) lo = qp - window + 1;
      lo = max(0LL, min(lo, static_cast<long long>(Sk)));
      hi = max(0LL, hi);
    }
    lo_s[tid] = static_cast<int>(lo);
    hi_s[tid] = static_cast<int>(hi);
  }
  __syncthreads();
  // The tile's key range: from the block holding the first valid key of
  // any row to the last valid key of any row.
  if (tid == 0) {
    int first = INT_MAX, last = 0;
    for (int i = 0; i < kRows; ++i) {
      if (lo_s[i] < hi_s[i]) {
        first = min(first, lo_s[i]);
        last = max(last, hi_s[i]);
      }
    }
    range_s[0] = first == INT_MAX ? 0 : first / kBK * kBK;
    range_s[1] = last;
  }
  __syncthreads();
  const int kbeg = range_s[0], kend = range_s[1];
  const int ra = 16 * wm + g, rb = ra + 8;  // this lane's two rows
  const int lo_a = lo_s[ra], hi_a = hi_s[ra];
  const int lo_b = lo_s[rb], hi_b = hi_s[rb];

  // The key block at j0 into stage st: keys past Sk and columns past
  // hd / hd_v are zero.
  auto issue = [&](int j0, int st) {
    unsigned char* kd = kv_s + st * (k_bytes + v_bytes);
    unsigned char* vd = kd + k_bytes;
    for (int kr = warp; kr < kBK; kr += kWarps) {
      const int j = j0 + kr;
      const long long row =
          j < Sk ? (static_cast<long long>(b) * Sk + j) * KV + h : 0;
      copy_row<KVF32>(kd + kr * row_bytes<KVF32>(hd), k, row * hd, hd, hd16,
                      j < Sk, vec, lane);
      copy_row<KVF32>(vd + kr * row_bytes<KVF32>(8 * NV), v, row * hd_v,
                      hd_v, 8 * NV, j < Sk, vec, lane);
    }
  };

  // The query rows (zero past hd and past the last row) and the first
  // key block, as one group of copies.
  for (int rr = warp; rr < kRows; rr += kWarps) {
    const int r = r0 + rr;
    const long long row =
        r < nrows
            ? ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G
            : 0;
    copy_row<QF32>(q_s + rr * row_bytes<QF32>(hd), q, row * hd, hd, hd16,
                   r < nrows, vec, lane);
  }
  if (kbeg < kend) issue(kbeg, 0);
  cp_async_commit();

  float acc[NW][4];
#pragma unroll
  for (int nt = 0; nt < NW; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
  float m_a = kMInit, m_b = kMInit, l_a = 0.0f, l_b = 0.0f, c_a = 0.0f,
        c_b = 0.0f;

  int st = 0;
  for (int j0 = kbeg; j0 < kend; j0 += kBK, st ^= 1) {
    // The next block's copies go out before this one's MMAs.
    if (j0 + kBK < kend) issue(j0 + kBK, st ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const unsigned char* k_t = kv_s + st * (k_bytes + v_bytes);
    const unsigned char* v_t = k_t + k_bytes;
    const bool touch_a = lo_a < hi_a && j0 < hi_a && j0 + kBK > lo_a;
    const bool touch_b = lo_b < hi_b && j0 < hi_b && j0 + kBK > lo_b;
    // With WN > 1 every warp holds the same rows, so this is the same in
    // all of them, and the barrier inside is reached by all or none.
    if (__any_sync(0xffffffffu, touch_a || touch_b)) {
      // Scores: chains of kStep hd columns from zero (chain ci on warp
      // ci % WN of the row group), added in chain order.
      float s[kKT][4];
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
      for (int ci = wn; ci < chains; ci += WN) {
        const int c0 = ci * kStep;
        float part[kKT][4];
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[nt][i] = 0.0f;
        if (!QF32 && !KVF32) {
          // bf16 q and k: m16n8k16, two columns a register.
#pragma unroll
          for (int kq = 0; kq < kStep / 16; ++kq) {
            const int kk = c0 + 16 * kq;
            if (kk >= hd16) break;
            const int qa = ra * qs + kk + 2 * t;
            const uint32_t a[4] = {lds_pair(q_s, qa),
                                   lds_pair(q_s, qa + 8 * qs),
                                   lds_pair(q_s, qa + 8),
                                   lds_pair(q_s, qa + 8 * qs + 8)};
#pragma unroll
            for (int nt = 0; nt < kKT; ++nt) {
              const int kb = (8 * nt + g) * ks + kk + 2 * t;
              const uint32_t bb[2] = {lds_pair(k_t, kb),
                                      lds_pair(k_t, kb + 8)};
              mma_bf16(part[nt], a, bb);
            }
          }
        } else {
#pragma unroll
          for (int kq = 0; kq < kStep / 8; ++kq) {
            const int kk = c0 + 8 * kq;
            if (kk >= hd8) break;
            const int qa = ra * qs + kk + t;
            uint32_t ah[4], al[4];
            words<QF32>(lds<QF32>(q_s, qa), ah[0], al[0]);
            words<QF32>(lds<QF32>(q_s, qa + 8 * qs), ah[1], al[1]);
            words<QF32>(lds<QF32>(q_s, qa + 4), ah[2], al[2]);
            words<QF32>(lds<QF32>(q_s, qa + 8 * qs + 4), ah[3], al[3]);
#pragma unroll
            for (int nt = 0; nt < kKT; ++nt) {
              const int kb = (8 * nt + g) * ks + kk + t;
              uint32_t bh[2], bl[2];
              words<KVF32>(lds<KVF32>(k_t, kb), bh[0], bl[0]);
              words<KVF32>(lds<KVF32>(k_t, kb + 4), bh[1], bl[1]);
              if (KVF32) mma_tf32(part[nt], ah, bl);
              if (QF32) mma_tf32(part[nt], al, bh);
              mma_tf32(part[nt], ah, bh);
            }
          }
        }
        if (WN == 1) {
#pragma unroll
          for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              s[nt][i] = __fadd_rn(s[nt][i], part[nt][i]);
        } else {
          float* x = xs + (ci * 16 + g) * kXS + 2 * t;
#pragma unroll
          for (int nt = 0; nt < kKT; ++nt) {
            *reinterpret_cast<float2*>(x + 8 * nt) =
                make_float2(part[nt][0], part[nt][1]);
            *reinterpret_cast<float2*>(x + 8 * kXS + 8 * nt) =
                make_float2(part[nt][2], part[nt][3]);
          }
        }
      }
      float mn_a, mn_b, corr_a, corr_b;
      if (WN == 1) {
        // Scale, softcap, mask; the block's row max over the quad.
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = j0 + 8 * nt + 2 * t + (i & 1);
            s[nt][i] = i < 2 ? score(s[nt][i], j, lo_a, hi_a, scale, has_cap, cap)
                             : score(s[nt][i], j, lo_b, hi_b, scale, has_cap, cap);
            if (i < 2) {
              mx_a = fmaxf(mx_a, s[nt][i]);
            } else {
              mx_b = fmaxf(mx_b, s[nt][i]);
            }
          }
        quad_max(mx_a, mx_b);
        mn_a = fmaxf(m_a, mx_a);
        mn_b = fmaxf(m_b, mx_b);
        corr_a = expf(__fsub_rn(m_a, mn_a));
        corr_b = expf(__fsub_rn(m_b, mn_b));
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[nt][i] = expf(__fsub_rn(s[nt][i], i < 2 ? mn_a : mn_b));
      } else {
        // Warp wn takes key tile wn: its scores (every chain, in order),
        // their scale, cap and mask, and its row max; the row maxes and
        // then the tiles' p go through shared memory to every warp.
        __syncthreads();  // every warp's chains are in xs
        float sw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int ci = 0; ci < chains; ++ci) {
          const float* x = xs + (ci * 16 + g) * kXS + 8 * wn + 2 * t;
          const float2 u = *reinterpret_cast<const float2*>(x);
          const float2 w = *reinterpret_cast<const float2*>(x + 8 * kXS);
          sw[0] = __fadd_rn(sw[0], u.x);
          sw[1] = __fadd_rn(sw[1], u.y);
          sw[2] = __fadd_rn(sw[2], w.x);
          sw[3] = __fadd_rn(sw[3], w.y);
        }
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + 8 * wn + 2 * t + (i & 1);
          sw[i] = i < 2 ? score(sw[i], j, lo_a, hi_a, scale, has_cap, cap)
                        : score(sw[i], j, lo_b, hi_b, scale, has_cap, cap);
        }
        mx_a = fmaxf(sw[0], sw[1]);
        mx_b = fmaxf(sw[2], sw[3]);
        quad_max(mx_a, mx_b);
        if (t == 0) {
          mx_s[wn * 16 + g] = mx_a;
          mx_s[wn * 16 + g + 8] = mx_b;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < WN; ++w) {
          mx_a = fmaxf(mx_a, mx_s[w * 16 + g]);
          mx_b = fmaxf(mx_b, mx_s[w * 16 + g + 8]);
        }
        mn_a = fmaxf(m_a, mx_a);
        mn_b = fmaxf(m_b, mx_b);
        corr_a = expf(__fsub_rn(m_a, mn_a));
        corr_b = expf(__fsub_rn(m_b, mn_b));
        float* pw = ps + g * kXS + 8 * wn + 2 * t;
        *reinterpret_cast<float2*>(pw) =
            make_float2(expf(__fsub_rn(sw[0], mn_a)),
                        expf(__fsub_rn(sw[1], mn_a)));
        *reinterpret_cast<float2*>(pw + 8 * kXS) =
            make_float2(expf(__fsub_rn(sw[2], mn_b)),
                        expf(__fsub_rn(sw[3], mn_b)));
        __syncthreads();
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt) {
          const float* x = ps + g * kXS + 8 * nt + 2 * t;
          const float2 u = *reinterpret_cast<const float2*>(x);
          const float2 w = *reinterpret_cast<const float2*>(x + 8 * kXS);
          s[nt][0] = u.x;
          s[nt][1] = u.y;
          s[nt][2] = w.x;
          s[nt][3] = w.y;
        }
      }
      m_a = mn_a;
      m_b = mn_b;

      // p's A fragments: column t is key 2t, column t + 4 key 2t + 1.
      uint32_t ph[kKT][4], pl[kKT][4];
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        words<true>(s[kt][0], ph[kt][0], pl[kt][0]);
        words<true>(s[kt][2], ph[kt][1], pl[kt][1]);
        words<true>(s[kt][1], ph[kt][2], pl[kt][2]);
        words<true>(s[kt][3], ph[kt][3], pl[kt][3]);
      }

      // The row sum of exponentials: p's words against ones, from zero.
      float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint32_t ones[2] = {kOne, kOne};
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        mma_tf32(dl, pl[kt], ones);
        mma_tf32(dl, ph[kt], ones);
      }
      if (touch_a) kahan(l_a, c_a, corr_a, dl[0]);
      if (touch_b) kahan(l_b, c_b, corr_b, dl[2]);

      // p rounded to bf16 for a bf16 v, as m16n8k16 A fragments of 16
      // keys (the C layout of two 8-key tiles, keys in order).
      uint32_t pb[kKT / 2][4];
      if (!KVF32) {
#pragma unroll
        for (int u = 0; u < kKT / 2; ++u) {
          pb[u][0] = bf16_pair(s[2 * u][0], s[2 * u][1]);
          pb[u][1] = bf16_pair(s[2 * u][2], s[2 * u][3]);
          pb[u][2] = bf16_pair(s[2 * u + 1][0], s[2 * u + 1][1]);
          pb[u][3] = bf16_pair(s[2 * u + 1][2], s[2 * u + 1][3]);
        }
      }

      // acc = acc corr + p x v over this warp's value tiles, per chain of
      // kVC tiles from zero.
#pragma unroll
      for (int n0 = 0; n0 < NW; n0 += kVC) {
        float part[kVC][4];
#pragma unroll
        for (int nt = 0; nt < kVC; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[nt][i] = 0.0f;
#pragma unroll
        for (int nt = 0; nt < kVC; ++nt) {
          const int col = 8 * (wn * NW + n0 + nt) + g;
          if (KVF32) {
#pragma unroll
            for (int kt = 0; kt < kKT; ++kt) {
              const int vb = (8 * kt + 2 * t) * vs + col;
              uint32_t bh[2], bl[2];
              words<true>(lds<true>(v_t, vb), bh[0], bl[0]);
              words<true>(lds<true>(v_t, vb + vs), bh[1], bl[1]);
              mma_tf32(part[nt], ph[kt], bl);
              mma_tf32(part[nt], pl[kt], bh);
              mma_tf32(part[nt], ph[kt], bh);
            }
          } else {
#pragma unroll
            for (int u = 0; u < kKT / 2; ++u) {
              const int vb = (16 * u + 2 * t) * vs + col;
              const uint32_t bb[2] = {
                  lds_two(v_t, vb, vb + vs),
                  lds_two(v_t, vb + 8 * vs, vb + 9 * vs)};
              mma_bf16(part[nt], pb[u], bb);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kVC; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[n0 + nt][i] = __fadd_rn(
                __fmul_rn(acc[n0 + nt][i], i < 2 ? corr_a : corr_b),
                part[nt][i]);
      }
    }
    __syncthreads();  // every warp is done with this stage (and xs)
  }

  // o = acc / (l - c) where l - c > 0, else 0, in v's dtype.
  const float lf_a = __fsub_rn(l_a, c_a), lf_b = __fsub_rn(l_b, c_b);
#pragma unroll
  for (int nt = 0; nt < NW; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + (i < 2 ? ra : rb);
      const int col = 8 * (wn * NW + nt) + 2 * t + (i & 1);
      if (r >= nrows || col >= hd_v) continue;
      const float lf = i < 2 ? lf_a : lf_b;
      const float o = lf > 0.0f ? __fdiv_rn(acc[nt][i], lf) : 0.0f;
      const long long row =
          ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G;
      store<KVF32>(out, row * hd_v + col, o);
    }
}

template <bool QF32, bool KVF32, int NV, int WM, int WN>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kvlen, void* out, int B, int Sq, int Sk, int KV, int G,
           int hd, int hd_v, int causal, int has_window, long long window,
           float scale, int has_cap, float cap, cudaStream_t s) {
  const long long bytes = smem_bytes<QF32, KVF32, NV, WM, WN>(hd);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  // cp.async needs every row 16-byte aligned: the bases and the rows'
  // lengths in bytes.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = aligned(q) && aligned(k) && aligned(v) &&
                  hd * (QF32 ? 4 : 2) % 16 == 0 &&
                  hd * (KVF32 ? 4 : 2) % 16 == 0 &&
                  hd_v * (KVF32 ? 4 : 2) % 16 == 0;
  auto kernel = attn_kernel<QF32, KVF32, NV, WM, WN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq * G + 16 * WM - 1) / (16 * WM), KV, B);
  kernel<<<grid, kThreads, static_cast<int>(bytes), s>>>(
      q, k, v, qpos, kvlen, out, Sq, Sk, KV, G, hd, hd_v, causal, has_window,
      window, scale, has_cap, cap, vec);
  return cudaGetLastError();
}

// A decode step's few rows (Sq G <= 16) take one 16-row group whose four
// warps split the columns; more rows take four groups of one warp each.
template <bool QF32, bool KVF32, int NV>
int launch_rows(const void* q, const void* k, const void* v, const int* qpos,
                const int* kvlen, void* out, int B, int Sq, int Sk, int KV,
                int G, int hd, int hd_v, int causal, int has_window,
                long long window, float scale, int has_cap, float cap,
                cudaStream_t s) {
  if (static_cast<long long>(Sq) * G <= 16)
    return launch<QF32, KVF32, NV, 1, 4>(q, k, v, qpos, kvlen, out, B, Sq, Sk,
                                         KV, G, hd, hd_v, causal, has_window,
                                         window, scale, has_cap, cap, s);
  return launch<QF32, KVF32, NV, 4, 1>(q, k, v, qpos, kvlen, out, B, Sq, Sk,
                                       KV, G, hd, hd_v, causal, has_window,
                                       window, scale, has_cap, cap, s);
}

template <bool QF32, bool KVF32>
int launch_width(const void* q, const void* k, const void* v, const int* qpos,
                 const int* kvlen, void* out, int B, int Sq, int Sk, int KV,
                 int G, int hd, int hd_v, int causal, int has_window,
                 long long window, float scale, int has_cap, float cap,
                 cudaStream_t s) {
#define B9_LAUNCH(NV)                                                     \
  return launch_rows<QF32, KVF32, NV>(q, k, v, qpos, kvlen, out, B, Sq, Sk, \
                                      KV, G, hd, hd_v, causal, has_window,  \
                                      window, scale, has_cap, cap, s)
  if (hd_v <= 32) B9_LAUNCH(4);
  if (hd_v <= 64) B9_LAUNCH(8);
  if (hd_v <= 128) B9_LAUNCH(16);
  if (hd_v <= 256) B9_LAUNCH(32);
#undef B9_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* mma_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B9: out (B, Sq, KV, G, hd_v) in v's dtype from qg (B, Sq, KV, G, hd)
// f32 (q_dtype 0) or bf16 (1), k (B, Sk, KV, hd) and v (B, Sk, KV, hd_v)
// f32 (kv_dtype 0) or bf16 (1), qpos (B, Sq) int32, kvlen (B,) int32 or
// null; causal, has_window with window, has_cap with cap as flags.
// Every array row-major and contiguous; hd_v <= 256.
int b9_attention(const void* q, const void* k, const void* v, const int* qpos,
                 const int* kvlen, void* out, int B, int Sq, int Sk, int KV,
                 int G, int hd, int hd_v, int q_dtype, int kv_dtype,
                 int causal, int has_window, long long window, float scale,
                 int has_cap, float cap, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || G < 1 || hd < 1 || hd_v < 1 ||
      hd_v > 256 || B > 65535 || KV > 65535 ||
      static_cast<long long>(Sq) * G > INT_MAX - kMaxRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B9_ARGS                                                             \
  q, k, v, qpos, kvlen, out, B, Sq, Sk, KV, G, hd, hd_v, causal, has_window, \
      window, scale, has_cap, cap, s
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_width<true, true>(B9_ARGS);
  if (q_dtype == kF32 && kv_dtype == kBF16) return launch_width<true, false>(B9_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kF32) return launch_width<false, true>(B9_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kBF16) return launch_width<false, false>(B9_ARGS);
#undef B9_ARGS
  return cudaErrorInvalidValue;
}

}  // extern "C"
