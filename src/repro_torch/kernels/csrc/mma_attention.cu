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
// Four forms.  b9_attention picks one by form (at the end), a pure function
// of the dtypes and the shape, before launch (kernels/mma_attention.py walk
// is its mirror; the wrapper counts each form's launches apart):
//
//   * the bf16 prefill form (namespace wg below): qg, k and v bf16, more
//     than 16 rows a head, hd and hd_v multiples of 16 up to 256.  It
//     replaces, for those problems, the mma.sync walk they ran on before
//     (kBK = 32, 64-row blocks of four warps, q.k in chains of 32
//     columns, 32-bit fragment loads): two warpgroups of 64 rows, TMA
//     into a two-stage ring, wgmma for q.k, p x v and the row sums, 64-key
//     blocks.  Its walk differs (64-key blocks, one q.k chain, l from three
//     bf16 words of p, p x v accumulated in the wgmma accumulator), so a
//     16-bit prefill row's bits differ from a decode call's;
//   * the f32 prefill form (namespace wf): qg, k and v f32 under the same
//     conditions of rows and head dims;
//   * the decode form (namespace dc): at most 16 rows a head, a bf16
//     cache (q f32 or bf16), hd and hd_v multiples of 16 up to 256.  Each
//     row's keys are cut into chunks of dc::kChunk that blocks walk side
//     by side, and a second launch folds the chunks' states in key order;
//   * the mma.sync form (attn_kernel below) for the rest: f32 q, k and v
//     at a decode step, f32 q beside a bf16 cache with more than 16 rows,
//     odd head dims.
//
// Bound on the H100: operations at prefill (Gemma-2 2B's global layer at
// 4096 tokens: 2 (256 + 256) flops on each of ~67M live scores a head
// pair, 0.0695 ms at 989 bf16 TFLOP/s), bytes at decode (128 slots over a
// 32768-slot bf16 cache: 8.8 GB of k and v read as far as each row's
// kv_len, 2.64 ms).  The bf16 prefill form spends its time in the tensor
// cores and in the softmax between them (ex2 and, with a softcap, a
// second ex2 and a reciprocal per score on the SFU, and three bf16 words
// of p for the row sums); its two warpgroups overlap only as they fall,
// and there is no producer warp or setmaxnreg.
// The mma.sync form reaches neither bound: it splits words at every
// fragment load, runs 2-3 mma.sync per useful f32 product, and at decode
// a block's MMAs fill 2 of their 16 rows while one block walks a row's
// keys alone.  The decode form is its redesign for a decode step;
// chip_smoke.py times every form against its bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The bf16 prefill form: two consumer warpgroups, wgmma fed by TMA.
//
// Taken by wg::form (below) when qg, k and v are all bf16, a head has more
// than 16 rows, and hd and hd_v are multiples of 16 up to 256; the rest
// keeps attn_kernel above.  A block owns 128 query rows of one (batch, KV
// head), 64 a warpgroup, and walks keys in blocks of kBK = 64.  Its walk
// per row, from the same m, l, c, acc as above:
//
//   s      = q.k: one wgmma chain over the whole hd from zero, bf16
//            products exact in f32
//   m_new, corr, p as above, in log2 units (x = s scale log2 e, so corr
//            and p take one ex2.approx each; tanh from an ex2 and a
//            reciprocal: their error, a few 2^-22 of p, sits far inside
//            the bf16 tolerance)
//   l_blk  = words(p) x ones: p split into three bf16 words (hi, mid,
//            lo: ~24 bits), one m64n8k16 wgmma per word and 16 keys with
//            A from registers, from zero; the Kahan step as above
//   acc    = acc corr (CUDA cores), then acc += bf16(p) x v in the wgmma
//            accumulator itself, with no zeroed partial
//
// Shared memory: Q (128 rows) and two stages of a key block and a value
// block, each tile in slabs of 64 columns whose 128-byte rows carry the
// 128-byte swizzle that wgmma's descriptors expect: 64 + 2 x 64 KB at hd
// 256.  K and V arrive by TMA (cp.async.bulk.tensor, 4-d maps over (d, KV,
// Sk, B), keys past Sk and columns past hd / hd_v zero-filled); an mbarrier
// per stage and operand says it landed.  Each warp counts itself off a
// stage's keys once its S is done and off its values once its p x v is;
// the last of the eight loads the block two on into the stage, so no
// thread waits for a stage to free.  Q is loaded once a block by cp.async
// into the same swizzled layout by hand (its (Sq, G) rows are not one
// box).  S = Q K^T is wgmma.m64n64k16 with both operands in shared memory,
// K-major; p goes from the S accumulator layout to the A fragment layout
// in registers; P V takes V as an MN-major B operand (the transpose bit),
// one m64n64k16 per 64 value columns.
//
// Each warpgroup walks the blocks its rows touch in order: S (wait), the
// softmax and p's words on the CUDA cores, then the row sums and p x v
// (wait), the Kahan step; the other warpgroup runs on beside it, tied only
// by the ring, so one's MMAs overlap the other's softmax as they fall.
// ptxas serializes wgmma whose register operands are written on a branch
// or ahead of a wait, or that sit in a loop with a remainder: so acc is
// rescaled on every block, no mbarrier wait sits between writing the
// operands and the MMA, the mask is a select, the softcap a template
// flag, and the S chain runs whole 64-column slabs.  Masks count only on
// blocks that straddle some row's [lo, hi) in the warpgroup.  Under the
// causal mask the row tiles launch heaviest first (blockIdx.z reversed).
namespace wg {

using namespace hopper;

constexpr int kRows = 128;           // query rows a block, 64 a warpgroup
constexpr int kBK = 64;              // keys a block of the walk
constexpr int kThreads = 256;
constexpr int kSlab = 64;            // bf16 columns of a 128-byte row
constexpr int kOnesBytes = 512;      // the ones-MMA's B operand
constexpr int kMaxTiles = 65535;     // gridDim.z
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round64(int d) { return (d + 63) / 64 * 64; }

// Shared memory of a block: the 1024-byte alignment slack, Q, two stages
// of keys and values, the ones, four mbarriers and four release counts,
// the rows' bounds and the warps' bound reductions
// (kernels/mma_attention.py smem_bytes mirrors it).
__host__ __device__ constexpr long long smem_bytes(int hd, int hd_v) {
  return 1024LL + 2LL * kRows * round64(hd) +
         2LL * 2 * kBK * (round64(hd) + round64(hd_v)) + kOnesBytes + 4 * 8 +
         4 * 4 + 2 * kRows * 4 + 4 * 5 * 4;
}

// The form chooser, a pure function of dtypes and shape (mirrored by
// kernels/mma_attention.py walk): 1 for this form, 0 for attn_kernel.
__host__ __device__ inline int form(int q_dtype, int kv_dtype, long long rows,
                                    int hd, int hd_v) {
  return q_dtype == kBF16 && kv_dtype == kBF16 && rows > 16 && hd % 16 == 0 &&
         hd_v % 16 == 0 && hd >= 16 && hd <= 256 && hd_v >= 16 &&
         hd_v <= 256 && (rows + kRows - 1) / kRows <= kMaxTiles &&
         smem_bytes(hd, hd_v) <= kSmemLimit;
}

#define B9_D32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define B9_R32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D (+)= A B, m64n64k16 bf16 -> f32, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " B9_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : B9_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, m64n64k16 bf16 -> f32, A from registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void mma_rs64t(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " B9_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : B9_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (+)= A B, m64n8k16 bf16 -> f32, A from registers, B (the ones)
// K-major in shared memory.
__device__ __forceinline__ void mma_rs8(float (&d)[4], const uint32_t (&a)[4],
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
#undef B9_D32
#undef B9_R32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as bf16 words, the first in the low half: hi = bf16(x), and
// the rest x - hi (exact in f32) for the next word.
__device__ __forceinline__ uint32_t split(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  x = __fsub_rn(x, f.x);
  y = __fsub_rn(y, f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// NV: the value columns, hd_v rounded up to 64; CAP: a softcap is given.
template <int NV, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    attn_wgmma_kernel(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __nv_bfloat16* __restrict__ q,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kvlen,
                      __nv_bfloat16* __restrict__ out, int Sq, int Sk, int KV,
                      int G, int hd, int hd_v, int causal, int has_window,
                      long long window, float scale, float cap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int hdp = round64(hd);
  const int q_bytes = kRows * hdp * 2;
  const int k_bytes = kBK * hdp * 2;
  const int stage_bytes = k_bytes + kBK * NV * 2;
  unsigned char* q_s = smem;  // slab s of Q at s kRows 128 bytes
  unsigned char* stages = smem + q_bytes;
  unsigned char* extra = stages + 2 * stage_bytes;
  uint16_t* ones = reinterpret_cast<uint16_t*>(extra);
  // full[st] / full[2 + st]: stage st's keys / values have landed
  uint64_t* full = reinterpret_cast<uint64_t*>(extra + kOnesBytes);
  // released[st] / released[2 + st]: warps done with stage st's keys /
  // values since their last load
  int* released = reinterpret_cast<int*>(full + 4);
  int* lo_s = released + 4;
  int* hi_s = lo_s + kRows;
  int* red = hi_s + kRows;  // per warp of rows: first, last, max lo, min hi, all live

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int r0 = tile * kRows;
  const int nrows = Sq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wgi = tid >> 7;
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Each row's valid keys [lo, hi), as attn_kernel; and per warp of rows
  // the bounds its warpgroup decides by.
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
    const bool live = lo < hi;
    int first = live ? static_cast<int>(lo) : INT_MAX;
    int last = live ? static_cast<int>(hi) : 0;
    int mlo = static_cast<int>(lo), mhi = static_cast<int>(hi);
    int all = live;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
      mlo = max(mlo, __shfl_xor_sync(0xffffffffu, mlo, off));
      mhi = min(mhi, __shfl_xor_sync(0xffffffffu, mhi, off));
      all &= __shfl_xor_sync(0xffffffffu, all, off);
    }
    if (lane == 0) {
      red[5 * warp] = first;
      red[5 * warp + 1] = last;
      red[5 * warp + 2] = mlo;
      red[5 * warp + 3] = mhi;
      red[5 * warp + 4] = all;
    }
  }
  // Q into its swizzled slabs (16-byte chunk c of row rr at chunk c ^ (rr
  // mod 8) of the row), zero past hd and past the last row; the ones.
  const int chunks = hdp / 8;
  for (int idx = tid; idx < kRows * chunks; idx += kThreads) {
    const int rr = idx / chunks, c = idx % chunks;
    const int r = r0 + rr;
    const bool ok = r < nrows && c * 8 < hd;
    const long long row =
        ok ? ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G
           : 0;
    cp_async16(q_s + (c >> 3) * (kRows * 128) + rr * 128 +
                   (((c & 7) ^ (rr & 7)) << 4),
               q + (ok ? row * hd + c * 8 : 0), ok);
  }
  cp_async_commit();
  for (int i = tid; i < kOnesBytes / 2; i += kThreads) ones[i] = 0x3f80;
  __syncthreads();

  // The tile's key range (every row), and this warpgroup's: the blocks it
  // computes and the ones it need not mask.
  int first = INT_MAX, last = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    first = min(first, red[5 * w]);
    last = max(last, red[5 * w + 1]);
  }
  const int kbeg = first == INT_MAX ? 0 : first / kBK * kBK;
  const int nblk = kbeg < last ? (last - kbeg + kBK - 1) / kBK : 0;
  const int* rw = red + 10 * wgi;
  const int w_first = min(rw[0], rw[5]), w_last = max(rw[1], rw[6]);
  const int w_maxlo = max(rw[2], rw[7]), w_minhi = min(rw[3], rw[8]);
  const bool w_all = rw[4] && rw[9];

  // Block it's keys (v = 0) or values (v = 1) into stage it & 1.
  auto load = [&](int it, int v) {
    const int st = it & 1;
    unsigned char* d = stages + st * stage_bytes + v * k_bytes;
    const int slabs = v ? NV / kSlab : hdp / kSlab;
    mbar_expect_tx(&full[2 * v + st],
                   static_cast<uint32_t>(slabs * kBK * 128));
    for (int sl = 0; sl < slabs; ++sl)
      tma_load_4d(d + sl * (kBK * 128), v ? &tmv : &tmk, &full[2 * v + st],
               sl * kSlab, h, kbeg + it * kBK, b);
  };
  if (tid == 0) {
    for (int it = 0; it < 2 && it < nblk; ++it) {
      load(it, 0);
      load(it, 1);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int ra = 64 * wgi + 16 * (warp & 3) + g, rb = ra + 8;
  const int lo_a = lo_s[ra], hi_a = hi_s[ra];
  const int lo_b = lo_s[rb], hi_b = hi_s[rb];
  const uint32_t q_base = smem_u32(q_s) + wgi * 64 * 128;
  const uint64_t ones_desc = desc(smem_u32(ones), 128, 256, 0);

  // This warp is done with block it's keys (v = 0) or values (v = 1):
  // the last of the block's eight warps to say so loads block it + 2
  // into the stage (no thread waits for a stage to free).
  auto release = [&](int it, int v) {
    __syncwarp();
    if (lane == 0) {
      int* count = &released[2 * v + (it & 1)];
      __threadfence_block();
      if (atomicAdd(count, 1) == kThreads / 32 - 1) {
        *count = 0;
        __threadfence_block();
        if (it + 2 < nblk) load(it + 2, v);
      }
    }
    __syncwarp();
  };

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.0f;
  float m_a = kMInit, m_b = kMInit, l_a = 0.0f, l_b = 0.0f, c_a = 0.0f,
        c_b = 0.0f;
  // Scores go through the softmax in log2 units (x = s scale log2 e; m,
  // and the masked -2e38 and the seed -1e30, in the same units), so that
  // corr = 2^(m - m_new) and p = 2^(x - m_new) take one ex2 each; with a
  // softcap x = cap log2 e (1 - 2 / (1 + 2^(2 s scale log2 e / cap))),
  // tanh from an ex2 and a reciprocal, the constants folded.
  const float x_mul = CAP ? 2.0f * kLog2e * scale / cap : kLog2e * scale;
  const float cap2 = CAP ? cap * kLog2e : 0.0f;

  for (int it = 0; it < nblk; ++it) {
    const int j0 = kbeg + it * kBK, st = it & 1, ph = (it >> 1) & 1;
    if (j0 < w_last && j0 + kBK > w_first) {
      // S = Q K^T over the whole hd, from zero.
      mbar_wait(&full[st], ph);
      const uint32_t kb = smem_u32(stages + st * stage_bytes);
      // (the first MMA ignores s's old values: no write to s precedes it;
      // the chain runs over whole 64-column slabs, 4 MMAs unrolled a slab,
      // hd's zero padding adding zero products: a loop of MMAs with a
      // remainder makes ptxas serialize them)
      float s[32];
      wgmma_fence();
      for (int k4 = 0; k4 < hdp / 16; k4 += 4)
#pragma unroll
      for (int kk = k4; kk < k4 + 4; ++kk)
        mma_ss64(s,
                 desc(q_base + (kk >> 2) * (kRows * 128) + (kk & 3) * 32, 16,
                      1024, 1),
                 desc(kb + (kk >> 2) * (kBK * 128) + (kk & 3) * 32, 16, 1024,
                      1),
                 kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      release(it, 0);
      // The values too (they came with the keys): no wait may sit between
      // writing the MMA's register operands and the MMA, or ptxas
      // serializes the MMAs.
      mbar_wait(&full[2 + st], ph);

      // Scale, softcap, mask (blocks that straddle a row's bounds only);
      // the block's row max over the quad.  s[4i + e]: key j0 + 8i + 2t +
      // (e & 1), row ra (e < 2) or rb.
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * x_mul;
        if (CAP) x = fmaf(-2.0f * cap2, rcp(1.0f + ex2(x)), cap2);
        s[i] = x;
      }
      // (a select, not a branch: s written on a branch would make ptxas
      // serialize the MMAs that write it)
      const bool inner = w_all && j0 >= w_maxlo && j0 + kBK <= w_minhi;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = (i & 2) == 0 ? j >= lo_a && j < hi_a
                                     : j >= lo_b && j < hi_b;
        s[i] = inner || ok ? s[i] : kNegInf;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if ((i & 2) == 0) {
          mx_a = fmaxf(mx_a, s[i]);
        } else {
          mx_b = fmaxf(mx_b, s[i]);
        }
      }
      quad_max(mx_a, mx_b);
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = ex2(__fsub_rn(m_a, mn_a));
      const float corr_b = ex2(__fsub_rn(m_b, mn_b));
      m_a = mn_a;
      m_b = mn_b;

      // p's bf16 words as A fragments of 16 keys (register 0 row g, keys
      // 2t, 2t + 1; 1 row g + 8; 2, 3 the same 8 keys on): the first word
      // is p rounded to bf16, the operand of p x v.
      uint32_t w0[4][4], w1[4][4], w2[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = ex2(__fsub_rn(s[8 * u + 2 * r], r & 1 ? mn_b : mn_a));
          float y = ex2(__fsub_rn(s[8 * u + 2 * r + 1], r & 1 ? mn_b : mn_a));
          w0[u][r] = split(x, y);
          w1[u][r] = split(x, y);
          w2[u][r] = split(x, y);
        }

      // acc *= corr (unconditionally: acc written on a branch would make
      // ptxas serialize the MMAs that read it), then the row sums and acc
      // += p v on the tensor cores.
#pragma unroll
      for (int i = 0; i < NV / 2; ++i)
        acc[i] = __fmul_rn(acc[i], (i & 2) == 0 ? corr_a : corr_b);
      const uint32_t vb = kb + k_bytes;
      float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      fence_regs(acc);
      fence_regs(dl);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma_rs8(dl, w0[u], ones_desc, u > 0);
        mma_rs8(dl, w1[u], ones_desc, 1);
        mma_rs8(dl, w2[u], ones_desc, 1);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NV / kSlab; ++c)
          mma_rs64t(*reinterpret_cast<float(*)[32]>(&acc[32 * c]), w0[u],
                    desc(vb + c * (kBK * 128) + u * 16 * 128, 1024, 1024, 1));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(dl);
      release(it, 1);

      const bool touch_a = lo_a < hi_a && j0 < hi_a && j0 + kBK > lo_a;
      const bool touch_b = lo_b < hi_b && j0 < hi_b && j0 + kBK > lo_b;
      if (touch_a) kahan(l_a, c_a, corr_a, dl[0]);
      if (touch_b) kahan(l_b, c_b, corr_b, dl[2]);
    } else {
      // A block no row of this warpgroup touches: counted off once landed.
      mbar_wait(&full[st], ph);
      release(it, 0);
      mbar_wait(&full[2 + st], ph);
      release(it, 1);
    }
  }

  // o = acc / (l - c) where l - c > 0, else 0, in bf16.
  const float lf_a = __fsub_rn(l_a, c_a), lf_b = __fsub_rn(l_b, c_b);
#pragma unroll
  for (int i = 0; i < NV / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (col >= hd_v) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + (half ? rb : ra);
      if (r >= nrows) continue;
      const float lf = half ? lf_b : lf_a;
      const float x = lf > 0.0f ? __fdiv_rn(acc[4 * i + 2 * half], lf) : 0.0f;
      const float y =
          lf > 0.0f ? __fdiv_rn(acc[4 * i + 2 * half + 1], lf) : 0.0f;
      const long long row =
          ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G;
      *reinterpret_cast<uint32_t*>(out + row * hd_v + col) = bf16_pair(x, y);
    }
  }
}

// The 4-d map of a bf16 (B, Sk, KV, d) array: boxes of 64 columns x 1 head
// x box_keys keys x 1 batch row, 128-byte swizzled, zero past each extent
// (the decode form's boxes hold fewer keys).
int encode(CUtensorMap* map, const void* base, int B, int Sk, int KV, int d,
           int box_keys) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(Sk),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(KV) * d * 2,
                                 static_cast<cuuint64_t>(Sk) * KV * d * 2};
  const cuuint32_t box[4] = {kSlab, 1, static_cast<cuuint32_t>(box_keys),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <int NV, bool CAP>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kvlen, void* out, int B, int Sq, int Sk, int KV, int G,
           int hd, int hd_v, int causal, int has_window, long long window,
           float scale, float cap, cudaStream_t s) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(q) || !aligned(k) || !aligned(v)) return cudaErrorMisalignedAddress;
  CUtensorMap tmk, tmv;
  int e = encode(&tmk, k, B, Sk, KV, hd, kBK);
  if (e) return e;
  e = encode(&tmv, v, B, Sk, KV, hd_v, kBK);
  if (e) return e;
  const int bytes = static_cast<int>(smem_bytes(hd, hd_v));
  auto kernel = attn_wgmma_kernel<NV, CAP>;
  // The shared memory granted to this kernel on each card, asked for once
  // (a host call per launch otherwise).
  static int granted[64] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return ce;
  if (dev >= 64 || granted[dev] < bytes) {
    ce = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
    if (ce != cudaSuccess) return ce;
    if (dev < 64) granted[dev] = bytes;
  }
  const int tiles = static_cast<int>(
      (static_cast<long long>(Sq) * G + kRows - 1) / kRows);
  const dim3 grid(KV, B, tiles);
  kernel<<<grid, kThreads, bytes, s>>>(
      tmk, tmv, static_cast<const __nv_bfloat16*>(q), qpos, kvlen,
      static_cast<__nv_bfloat16*>(out), Sq, Sk, KV, G, hd, hd_v, causal,
      has_window, window, scale, cap);
  return cudaGetLastError();
}

int launch_width(const void* q, const void* k, const void* v, const int* qpos,
                 const int* kvlen, void* out, int B, int Sq, int Sk, int KV,
                 int G, int hd, int hd_v, int causal, int has_window,
                 long long window, float scale, int has_cap, float cap,
                 cudaStream_t s) {
#define B9_WG_LAUNCH(NV)                                                     \
  return has_cap ? launch<NV, true>(q, k, v, qpos, kvlen, out, B, Sq, Sk, KV,  \
                                    G, hd, hd_v, causal, has_window, window,   \
                                    scale, cap, s)                             \
                 : launch<NV, false>(q, k, v, qpos, kvlen, out, B, Sq, Sk, KV, \
                                     G, hd, hd_v, causal, has_window, window,  \
                                     scale, cap, s)
  if (hd_v <= 64) B9_WG_LAUNCH(64);
  if (hd_v <= 128) B9_WG_LAUNCH(128);
  if (hd_v <= 192) B9_WG_LAUNCH(192);
  B9_WG_LAUNCH(256);
#undef B9_WG_LAUNCH
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The f32 prefill form: one consumer warpgroup on wgmma fed by TMA, the
// operands' MMA words made once by a word pass.
//
// Taken by wf::form (below) when qg, k and v are all f32, a head has more
// than 16 rows, and hd and hd_v are multiples of 16 up to 256; it replaces
// attn_kernel for those problems (which split each f32 value into TF32
// words at every fragment load, on every key block, in every warp).
//
// Words.  The tensor cores take bf16 words: each f32 value x is split into
// three, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
// rounded to nearest (the rests are exact in f32), and a product is the
// six word products (i, j) with i + j < 3, the smaller first: (0, 2) (1,
// 1) (2, 0) (0, 1) (1, 0) (0, 0) (B10's f32 form; about 22 bits a product,
// the dropped ones 2^-24 relative).  Three bf16 words on bf16 wgmma cost
// the tensor cores what 3xTF32 does on TF32 wgmma (probes/b10_tf32.py),
// take 6 bytes a value against TF32's 8, and keep wgmma's transpose bit
// for V (TF32 has none: V would have to be transposed).
//
// Two launches a call:
//   words_kernel    one pass over qg, k and v (f32, 32 bytes a thread),
//                   writing their three words as bf16 planes laid out for
//                   TMA: q's rows packed per (batch, KV head) in the
//                   walk's order r = i G + g, planes [word][b KV + h][r]
//                   [hd]; k's and v's [word][b KV + h][key][hd or hd_v];
//   attn_f32_kernel the walk.  A block owns 64 query rows of one (batch,
//                   KV head) and walks keys in blocks of kBK = 64, in
//                   order.  Its walk per row, from m = -1e30, l = c = acc
//                   = 0:
//     s     = q.k: per 64-column step of hd, the six word products chained
//             from zero on the tensor cores (24 wgmma.m64n64k16, both
//             operands in shared memory), the steps added in order with
//             __fadd_rn on the CUDA cores;
//     the softcap, the mask, m_new, corr and p as attn_kernel: f32,
//             __fmul_rn / __fdiv_rn, tanhf and expf;
//     l_blk = words(p) x ones: p's three bf16 words (the operands of p x
//             v, in shared memory) against ones, m64n8k16, from zero;
//             the Kahan step as above;
//     acc   = acc corr + p x v, per 64-column chunk of hd_v: p's three
//             words against v's three, the six products from zero (24
//             wgmma.m64n64k16, both in shared memory, V MN-major through
//             the transpose bit), the chunk's partial added to acc corr
//             with __fmul_rn / __fadd_rn.  A truncating tensor-core add
//             touches one step's or one chunk's partial, never a running
//             sum.
//
// Shared memory and registers, at hd = hd_v = 256 (the widest; 227 KB a
// block, 255 registers a thread):
//   Q       three words of the block's 64 rows, resident for the walk:
//           4 slabs x 3 words x (64 rows x 128 bytes) = 96 KB, by TMA
//           once (a slab of 64 columns laid out as a ring stage is);
//   ring    wf::stages(hd) stages of 24 KB, each one 64 x 64 tile of each
//           word (8 KB a word, 128-byte rows in the 128-byte swizzle):
//           a key block's hd / 64 steps of K, then its hd_v / 64 chunks
//           of V, in that order.  4 stages at hd 256 (96 KB), 5 at 192,
//           7 at 64 and below;
//   P       p's three words of the block, 24 KB in a stage's layout: the
//           A operand of the row sums and of p x v.  Held in registers
//           (48 a thread) beside acc (128), a chunk's partial (32) and the
//           MMAs' descriptors, they made ptxas spill ~540 bytes at hd_v
//           256, so they go through shared memory, one store of 4 bytes a
//           word and key pair, free of bank conflicts in the swizzle;
//   the rest the ones-MMA's 512-byte operand, a Q mbarrier and a full and
//           an empty mbarrier a stage, the rows' bounds, the warps' bound
//           reductions: 223,448 bytes in all at hd 256;
//   a consumer thread holds acc (hd_v / 2 floats: 128 at 256), the
//           scores (32) and one 32-float partial (a step's or a chunk's);
//           a 128-row block (two warpgroups, as the bf16 form) would need
//           Q's words of 128 rows, 192 KB, so a block keeps 64 rows and
//           one block runs an SM.
// Warp 4 (one lane) loads: Q once, then the ring in the consumers' order,
// each stage once the four consumer warps have released it.  It takes no
// setmaxnreg: at 160 threads and one block an SM every thread may hold the
// 255-register ceiling already, so there is nothing to move (the launch
// checks it).  The bf16 form's known fixes stand: blocks past the tile's
// causal / window band are not walked, masks count only on blocks that
// straddle some row's [lo, hi), the row tiles launch heaviest first under
// a causal mask, and no accumulator is written on a branch or touched
// between a chain's first MMA and its wait (every operand but the
// accumulators is in shared memory).
// Nothing depends on which block runs when: the same bits on every call,
// and a row's bits do not depend on the batch.
namespace wf {

using namespace hopper;

constexpr int kRows = 64;               // query rows a block
constexpr int kBK = 64;                 // keys a block of the walk
constexpr int kStep = 64;               // hd columns a step, hd_v a chunk
constexpr int kWords = 3;               // bf16 words of an f32 value
constexpr int kProducts = 6;            // word pairs (i, j), i + j < 3
constexpr int kConsumerWarps = 4;       // one consumer warpgroup
constexpr int kThreads = 160;           // and warp 4, which loads
constexpr int kPlane = 64 * 128;        // a word's 64 x 64 bf16 tile
constexpr int kStage = kWords * kPlane;  // 24 KB
constexpr int kStagesMax = 8;
constexpr int kOnesBytes = 512;
constexpr int kMaxTiles = 65535;        // gridDim.z
// The ones, the Q mbarrier, a full and an empty mbarrier a stage, the
// rows' lo and hi, and five bound reductions for each of two warps of
// rows (kernels/mma_attention.py WF_EXTRA_BYTES).
constexpr int kExtra = kOnesBytes + 8 * (1 + 2 * kStagesMax) + 2 * kRows * 4 +
                       4 * 5 * 4;
constexpr int kPassThreads = 256;

__host__ __device__ constexpr int round64(int d) { return (d + 63) / 64 * 64; }

// The ring's stages at head dim hd: as many as fit beside Q and p's
// words, at most kStagesMax (kernels/mma_attention.py wf_stages).
__host__ __device__ constexpr int stages(int hd) {
  const int fit = (kSmemLimit - 1024 - kWords * kRows * round64(hd) * 2 -
                   kStage - kExtra) /
                  kStage;
  return fit < kStagesMax ? fit : kStagesMax;
}

// Shared memory of a block: the 1024-byte alignment slack, Q's words, the
// ring, p's words (a stage's size) and the rest (kernels/mma_attention.py
// smem_bytes mirrors it).
__host__ __device__ constexpr long long smem_bytes(int hd) {
  return 1024LL + kWords * kRows * round64(hd) * 2LL +
         static_cast<long long>(stages(hd) + 1) * kStage + kExtra;
}

// The form chooser, a pure function of dtypes and shape (mirrored by
// kernels/mma_attention.py walk): 1 for this form.
__host__ __device__ inline int form(int q_dtype, int kv_dtype, long long rows,
                                    int hd, int hd_v) {
  return q_dtype == kF32 && kv_dtype == kF32 && rows > 16 && hd % 16 == 0 &&
         hd_v % 16 == 0 && hd >= 16 && hd <= 256 && hd_v >= 16 &&
         hd_v <= 256 && (rows + kRows - 1) / kRows <= kMaxTiles &&
         stages(hd) >= 2 && smem_bytes(hd) <= kSmemLimit;
}

// Word i of the p (or Q) side and word j of the v (or K) side of product
// p: (0, 2) (1, 1) (2, 0) (0, 1) (1, 0) (0, 0), the smaller first.
__host__ __device__ constexpr int word_a(int p) {
  return p < 3 ? p : (p < 5 ? p - 3 : 0);
}
__host__ __device__ constexpr int word_b(int p) {
  return p < 3 ? 2 - p : (p < 5 ? 4 - p : 0);
}

// D (+)= A B, m64n64k16 bf16 -> f32, A K-major and B MN-major (the
// transpose bit) in shared memory; from zero unless accumulate.
#define B9F_D32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
__device__ __forceinline__ void mma_ss64t(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : B9F_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B, m64n8k16 bf16 -> f32, A and B (the ones) K-major in shared
// memory.
__device__ __forceinline__ void mma_ss8(float (&d)[4], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef B9F_D32

// One operand of the word pass: src (B, S, KV, G, cols) f32 into dst's
// three planes [word][b KV + h][i G + g][cols], `plane` elements each.
struct Pack {
  const float* src;
  __nv_bfloat16* dst;
  int rows;   // B S KV G
  int S, KV, G, cols;
  long long plane;
};

// Block row blockIdx.y takes operand q, k or v; 8 columns a thread.
__global__ void __launch_bounds__(kPassThreads)
    words_kernel(const __grid_constant__ Pack q,
                 const __grid_constant__ Pack k,
                 const __grid_constant__ Pack v) {
  const Pack& p = blockIdx.y == 0 ? q : (blockIdx.y == 1 ? k : v);
  const int per_row = p.cols / 8;
  const long long n = static_cast<long long>(p.rows) * per_row;
  for (long long e = blockIdx.x * static_cast<long long>(kPassThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kPassThreads) {
    const int row = static_cast<int>(e / per_row);
    const int c8 = static_cast<int>(e - static_cast<long long>(row) * per_row) * 8;
    // row = ((b S + i) KV + h) G + g
    const int g = row % p.G;
    int rest = row / p.G;
    const int h = rest % p.KV;
    rest /= p.KV;
    const int i = rest % p.S;
    const int b = rest / p.S;
    const float* src = p.src + static_cast<long long>(row) * p.cols + c8;
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(src));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(src) + 1);
    float val[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const long long dst_row =
        (static_cast<long long>(b) * p.KV + h) * (static_cast<long long>(p.S) * p.G) +
        static_cast<long long>(i) * p.G + g;
    store_words8<kWords>(val, p.dst + dst_row * p.cols + c8, p.plane);
  }
}

// NV: the value columns, hd_v rounded up to 64; CAP: a softcap is given.
// tmq, tmk, tmv: 3-d maps over the word planes (columns, rows, word x (b
// KV + h)).
template <int NV, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    attn_f32_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kvlen, float* __restrict__ out,
                    int B, int Sq, int Sk, int KV, int G, int hd, int hd_v,
                    int causal, int has_window, long long window,
                    float scale, float cap, int nst) {
  constexpr int kChunks = NV / kStep;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nslab = round64(hd) / kStep;  // K steps a key block
  unsigned char* q_s = smem;  // slab sl, word w at (sl kWords + w) kPlane
  unsigned char* ring = q_s + kWords * nslab * kPlane;
  unsigned char* p_s = ring + nst * kStage;  // p's words, a stage's layout
  unsigned char* extra = p_s + kStage;
  uint16_t* ones = reinterpret_cast<uint16_t*>(extra);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(extra + kOnesBytes);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + kStagesMax;
  int* lo_s = reinterpret_cast<int*>(empty + kStagesMax);
  int* hi_s = lo_s + kRows;
  int* red = hi_s + kRows;  // per warp of rows: first, last, max lo, min hi, all live

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int r0 = tile * kRows;
  const int nrows = Sq * G;
  const int bh = b * KV + h, planes = B * KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Each row's valid keys [lo, hi), as attn_kernel; and per warp of rows
  // the bounds the tile decides by.
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
    const bool live = lo < hi;
    int first = live ? static_cast<int>(lo) : INT_MAX;
    int last = live ? static_cast<int>(hi) : 0;
    int mlo = static_cast<int>(lo), mhi = static_cast<int>(hi);
    int all = live;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
      last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
      mlo = max(mlo, __shfl_xor_sync(0xffffffffu, mlo, off));
      mhi = min(mhi, __shfl_xor_sync(0xffffffffu, mhi, off));
      all &= __shfl_xor_sync(0xffffffffu, all, off);
    }
    if (lane == 0) {
      red[5 * warp] = first;
      red[5 * warp + 1] = last;
      red[5 * warp + 2] = mlo;
      red[5 * warp + 3] = mhi;
      red[5 * warp + 4] = all;
    }
  }
  for (int i = tid; i < kOnesBytes / 2; i += kThreads) ones[i] = 0x3f80;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // The tile's key range (every row) and the bounds inside which no mask
  // is needed.
  const int first = min(red[0], red[5]), last = max(red[1], red[6]);
  const int kbeg = first == INT_MAX ? 0 : first / kBK * kBK;
  const int nblk = kbeg < last ? (last - kbeg + kBK - 1) / kBK : 0;
  const int t_maxlo = max(red[2], red[7]), t_minhi = min(red[3], red[8]);
  const bool t_all = red[4] && red[9];

  if (warp == kConsumerWarps) {
    // The loads: Q's words once, then for each key block its K steps and
    // its V chunks, item n into stage n mod nst once the consumers have
    // released item n - nst.
    if (lane == 0) {
      mbar_expect_tx(qfull, static_cast<uint32_t>(kWords * nslab * kPlane));
      for (int sl = 0; sl < nslab; ++sl)
        for (int w = 0; w < kWords; ++w)
          tma_load_3d(q_s + (sl * kWords + w) * kPlane, &tmq, qfull,
                      sl * kStep, r0, w * planes + bh);
      int n = 0;
      for (int it = 0; it < nblk; ++it) {
        const int j0 = kbeg + it * kBK;
        for (int item = 0; item < nslab + kChunks; ++item, ++n) {
          const int st = n % nst;
          if (n >= nst) mbar_wait(&empty[st], (n / nst - 1) & 1);
          const bool is_v = item >= nslab;
          const int c0 = (is_v ? item - nslab : item) * kStep;
          unsigned char* dst = ring + st * kStage;
          mbar_expect_tx(&full[st], kStage);
          for (int w = 0; w < kWords; ++w)
            tma_load_3d(dst + w * kPlane, is_v ? &tmv : &tmk, &full[st], c0,
                        j0, w * planes + bh);
        }
      }
    }
    return;
  }

  const int ra = 16 * warp + g, rb = ra + 8;  // this lane's two rows
  const int lo_a = lo_s[ra], hi_a = hi_s[ra];
  const int lo_b = lo_s[rb], hi_b = hi_s[rb];
  const uint32_t q_u = smem_u32(q_s), ring_u = smem_u32(ring);
  const uint64_t ones_desc = desc(smem_u32(ones), 128, 256, 0);
  const uint64_t dp = desc(smem_u32(p_s), 16, 1024, 1);
  // This warp is done with the stage: the fourth to say so frees it.
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.0f;
  float m_a = kMInit, m_b = kMInit, l_a = 0.0f, l_b = 0.0f, c_a = 0.0f,
        c_b = 0.0f;
  mbar_wait(qfull, 0);

  int n = 0;
  for (int it = 0; it < nblk; ++it) {
    const int j0 = kbeg + it * kBK;
    // S = Q K^T: per 64-column step of hd the six word products chained
    // from zero (the first MMA ignores part's old values), the steps
    // added in order.
    float s[32];
    for (int sl = 0; sl < nslab; ++sl, ++n) {
      const int st = n % nst;
      mbar_wait(&full[st], (n / nst) & 1);
      // Each MMA's descriptors are the step's two plus a constant in the
      // address field (16-byte units; shared addresses stay below 2^18),
      // so that no descriptor is held in registers across the chain.
      const uint64_t dq = desc(q_u + sl * kStage, 16, 1024, 1);
      const uint64_t dk = desc(ring_u + st * kStage, 16, 1024, 1);
      float part[32];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kProducts; ++p)
#pragma unroll
        for (int kk = 0; kk < kStep / 16; ++kk)
          wg::mma_ss64(part, dq + ((word_a(p) * kPlane + kk * 32) >> 4),
                       dk + ((word_b(p) * kPlane + kk * 32) >> 4),
                       p + kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
      release(st);
      if (sl == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = part[i];
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = __fadd_rn(s[i], part[i]);
      }
    }

    // Scale, softcap, mask (blocks that straddle a row's bounds only);
    // the block's row max over the quad.  s[4i + e]: key j0 + 8i + 2t +
    // (e & 1), row ra (e < 2) or rb.
    const bool inner = t_all && j0 >= t_maxlo && j0 + kBK <= t_minhi;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = __fmul_rn(s[i], scale);
      if (CAP) x = __fmul_rn(cap, tanhf(__fdiv_rn(x, cap)));
      const int j = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool ok = (i & 2) == 0 ? j >= lo_a && j < hi_a
                                   : j >= lo_b && j < hi_b;
      s[i] = inner || ok ? x : kNegInf;
    }
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i & 2) == 0) {
        mx_a = fmaxf(mx_a, s[i]);
      } else {
        mx_b = fmaxf(mx_b, s[i]);
      }
    }
    quad_max(mx_a, mx_b);
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(__fsub_rn(m_a, mn_a));
    const float corr_b = expf(__fsub_rn(m_b, mn_b));
    m_a = mn_a;
    m_b = mn_b;

    // p's three bf16 words into shared memory, the A operand (K-major, in
    // the 128-byte swizzle) of the row sums and of p x v: this lane's key
    // pair 16u + 2t (+ 8 for r >= 2) of row ra (r even) or rb lies in
    // 16-byte chunk 2u + r / 2 of its 128-byte row, at chunk (2u + r / 2)
    // ^ g (ra and rb are g mod 8).
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = expf(__fsub_rn(s[8 * u + 2 * r], r & 1 ? mn_b : mn_a));
        float y = expf(__fsub_rn(s[8 * u + 2 * r + 1], r & 1 ? mn_b : mn_a));
        unsigned char* at = p_s + (r & 1 ? rb : ra) * 128 +
                            (((2 * u + (r >> 1)) ^ g) << 4) + 4 * t;
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          *reinterpret_cast<uint32_t*>(at + w * kPlane) = split(x, y);
      }
    // (every consumer warp's words are in before the MMAs read them; the
    // last block's MMAs, which all four warps issue together, are done)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");

    // The row sums with the first chunk, then acc = acc corr + p x v per
    // 64-column chunk of the values, each chunk's products from zero.
    float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch, ++n) {
      const int st = n % nst;
      mbar_wait(&full[st], (n / nst) & 1);
      const uint64_t dv = desc(ring_u + st * kStage, 1024, 1024, 1);
      float part[32];
      wgmma_fence();
      if (ch == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            mma_ss8(dl, dp + ((w * kPlane + u * 32) >> 4), ones_desc,
                    u + w > 0);
      }
#pragma unroll
      for (int p = 0; p < kProducts; ++p)
#pragma unroll
        for (int u = 0; u < kBK / 16; ++u)
          mma_ss64t(part, dp + ((word_a(p) * kPlane + u * 32) >> 4),
                    dv + ((word_b(p) * kPlane + u * 16 * 128) >> 4),
                    p + u > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(part);
      fence_regs(dl);
      release(st);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[32 * ch + i] = __fadd_rn(
            __fmul_rn(acc[32 * ch + i], (i & 2) == 0 ? corr_a : corr_b),
            part[i]);
    }
    const bool touch_a = lo_a < hi_a && j0 < hi_a && j0 + kBK > lo_a;
    const bool touch_b = lo_b < hi_b && j0 < hi_b && j0 + kBK > lo_b;
    if (touch_a) kahan(l_a, c_a, corr_a, dl[0]);
    if (touch_b) kahan(l_b, c_b, corr_b, dl[2]);
  }

  // o = acc / (l - c) where l - c > 0, else 0, in f32.
  const float lf_a = __fsub_rn(l_a, c_a), lf_b = __fsub_rn(l_b, c_b);
#pragma unroll
  for (int i = 0; i < NV / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (col >= hd_v) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + (half ? rb : ra);
      if (r >= nrows) continue;
      const float lf = half ? lf_b : lf_a;
      const float x = lf > 0.0f ? __fdiv_rn(acc[4 * i + 2 * half], lf) : 0.0f;
      const float y =
          lf > 0.0f ? __fdiv_rn(acc[4 * i + 2 * half + 1], lf) : 0.0f;
      const long long row =
          ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G;
      *reinterpret_cast<float2*>(out + row * hd_v + col) = make_float2(x, y);
    }
  }
}

// The word pass, then the walk.  words: the scratch of q's, k's and v's
// planes, in that order.
template <int NV, bool CAP>
int launch(const float* q, const float* k, const float* v, const int* qpos,
           const int* kvlen, float* out, __nv_bfloat16* words, int B, int Sq,
           int Sk, int KV, int G, int hd, int hd_v, int causal,
           int has_window, long long window, float scale, float cap,
           cudaStream_t s) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(words))
    return cudaErrorMisalignedAddress;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long planes = static_cast<long long>(B) * KV;
  if (planes * rows >= INT_MAX || planes * Sk >= INT_MAX)
    return cudaErrorInvalidValue;
  const long long q_plane = planes * rows * hd, k_plane = planes * Sk * hd;
  const long long v_plane = planes * Sk * hd_v;
  __nv_bfloat16* qw = words;
  __nv_bfloat16* kw = qw + kWords * q_plane;
  __nv_bfloat16* vw = kw + kWords * k_plane;
  const Pack pq{q, qw, static_cast<int>(planes * rows), Sq, KV, G, hd, q_plane};
  const Pack pk{k, kw, static_cast<int>(planes * Sk), Sk, KV, 1, hd, k_plane};
  const Pack pv{v, vw, static_cast<int>(planes * Sk), Sk, KV, 1, hd_v,
                v_plane};
  const long long most = (q_plane > k_plane ? (q_plane > v_plane ? q_plane : v_plane)
                                            : (k_plane > v_plane ? k_plane : v_plane)) / 8;
  const long long blocks = (most + kPassThreads - 1) / kPassThreads;
  words_kernel<<<dim3(static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 3),
                 kPassThreads, 0, s>>>(pq, pk, pv);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return ce;

  CUtensorMap tmq, tmk, tmv;
  int e = encode(&tmq, qw, hd, rows, hd, kWords * planes, rows * hd, kStep,
                 kRows);
  if (e) return e;
  e = encode(&tmk, kw, hd, Sk, hd, kWords * planes, Sk * hd, kStep, kBK);
  if (e) return e;
  e = encode(&tmv, vw, hd_v, Sk, hd_v, kWords * planes, Sk * hd_v, kStep,
             kBK);
  if (e) return e;
  const int nst = stages(hd);
  const int bytes = static_cast<int>(smem_bytes(hd));
  auto kernel = attn_f32_kernel<NV, CAP>;
  // The shared memory granted to this kernel on each card, asked for once
  // (a host call per launch otherwise); a build whose block would hold
  // more registers than an SM has is refused there.
  static int granted[64] = {};
  int dev = 0;
  ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return ce;
  if (dev >= 64 || granted[dev] < bytes) {
    cudaFuncAttributes attr;
    ce = cudaFuncGetAttributes(&attr, kernel);
    if (ce != cudaSuccess) return ce;
    if (attr.numRegs * kThreads > 65536) return cudaErrorInvalidConfiguration;
    ce = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
    if (ce != cudaSuccess) return ce;
    if (dev < 64) granted[dev] = bytes;
  }
  const int tiles = static_cast<int>((rows + kRows - 1) / kRows);
  kernel<<<dim3(KV, B, tiles), kThreads, bytes, s>>>(
      tmq, tmk, tmv, qpos, kvlen, out, B, Sq, Sk, KV, G, hd, hd_v, causal,
      has_window, window, scale, cap, nst);
  return cudaGetLastError();
}

int launch_width(const float* q, const float* k, const float* v,
                 const int* qpos, const int* kvlen, float* out,
                 __nv_bfloat16* words, int B, int Sq, int Sk, int KV, int G,
                 int hd, int hd_v, int causal, int has_window,
                 long long window, float scale, int has_cap, float cap,
                 cudaStream_t s) {
#define B9F_LAUNCH(NV)                                                        \
  return has_cap ? launch<NV, true>(q, k, v, qpos, kvlen, out, words, B, Sq,  \
                                    Sk, KV, G, hd, hd_v, causal, has_window,  \
                                    window, scale, cap, s)                    \
                 : launch<NV, false>(q, k, v, qpos, kvlen, out, words, B, Sq, \
                                     Sk, KV, G, hd, hd_v, causal, has_window, \
                                     window, scale, cap, s)
  if (hd_v <= 64) B9F_LAUNCH(64);
  if (hd_v <= 128) B9F_LAUNCH(128);
  if (hd_v <= 192) B9F_LAUNCH(192);
  B9F_LAUNCH(256);
#undef B9F_LAUNCH
}

}  // namespace wf

// ---------------------------------------------------------------------------
// The decode form: a row's keys cut into chunks that blocks walk side by
// side, then a merge that folds the chunks' states in key order.
//
// Taken by dc::form (below) when a head has at most 16 rows (a decode
// step: Sq G rows, 2 at Gemma-2 2B), the cache (k and v) is bf16, q is f32
// or bf16, and hd and hd_v are multiples of 16 up to 256.  It replaces
// attn_kernel for those problems, where one block walked each row's keys
// alone (up to 1024 blocks of 32 at the 32768-slot ring), its MMAs filled
// 2 of their 16 rows, and f32 q was split into TF32 words at every
// fragment load of every key block.
//
// The walk per row.  Keys are cut at absolute multiples of kChunk.  A
// chunk that holds a valid key of the row is walked from the fresh state
// (m = -1e30, l = c = acc = 0) in blocks of kBK = 16 keys, each block
// that holds a valid key of the row updating it as attn_kernel's walk
// does; the chunk ends with its state (m_c, l_c - c_c, acc_c) in f32.
// The merge folds the chunks' states in chunk order, from M = -1e30, L = C
// = A = 0:
//
//   M' = max(M, m_c);  a = exp(M - M');  b = exp(m_c - M')
//   y = (l_c - c_c) b - C a;  t = L a + y;  C = (t - L a) - y;  L = t
//   A = A a + acc_c b;  M = M'
//
// and o = A / (L - C) where L - C > 0, else 0, all with _rn intrinsics.
// For a row whose keys lie in one chunk, a = exp(-1e30 - m_c) is 0 and b
// is 1, so o is exactly that chunk's acc_c / (l_c - c_c): a short row
// has the bits of an unsplit walk.  A row's bits depend on its own q,
// positions and keys alone, never on the rows or slots beside it.
//
// Products.  Sᵀ = K qᵀ on m16n8k16 bf16 mma.sync: the A operand is 16
// keys by 16 hd columns of K (ldmatrix from the 128-byte swizzled TMA
// tile), the B operand q's words as 8 columns: each row is four columns,
// hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid) and a zero
// (a bf16 q is its hi word, the others 0), so two rows an n-tile.  Each
// word product is exact in f32; each column is one chain over the whole
// hd from zero, and a score is (hi + mid) + lo, added on the CUDA cores:
// ~24 bits of an f32 q, whose words are made once a block.  Oᵀ = Vᵀ pᵀ the
// same way: A is 16 value columns by 16 keys of V (ldmatrix.trans), B is
// p rounded to bf16 for eight rows (p's words pass through a few hundred
// bytes of shared memory), from zero per block and added to acc corr with
// __fmul_rn / __fadd_rn.  l_blk is a ones-MMA over p's three bf16 words,
// from zero per block; the Kahan step as above.  So a truncating
// tensor-core add touches one block's partial, never a running sum.
//
// Two launches a call:
//   attn_decode_kernel  one warp a block, one block per (chunk, KV head,
//                       batch row) (gridDim.x chunk KV + head, the heads
//                       of a key range side by side), built for 2, 8 or
//                       16 rows; a block whose chunk holds no valid key of
//                       any of its rows exits at once.  K and V come by TMA (the 4-d maps of
//                       the bf16 prefill form, boxes of 16 keys) through
//                       a ring of stages(hd, hd_v, rt) stages: at 2 rows
//                       3 of 16 KB at hd = hd_v = 256, so that four
//                       blocks, 192 KB of loads, fit an SM; at 8 or 16
//                       rows a smaller ring beside q's words (2 stages of
//                       8 KB at hd 128, six 16-row blocks an SM).  It writes its rows' chunk
//                       states to an f32 scratch the wrapper allocates
//                       (not zeroed): [b][h][chunk][row][m, l - c, acc];
//   merge_kernel        one block per (KV head, batch row), a thread per
//                       (row, value column), folding the row's live
//                       chunks in order and writing o in bf16.
// Bound: bytes (the keys and values each row reads).  At the global
// decode step the grid holds ~4200 live blocks of at most 2 MB each,
// against 512 blocks of up to 16 MB for attn_kernel, so the waves balance
// however the rows' kv_len fall (probes/b9_decode_limits.py chose 2048
// keys a chunk over 512 and 1024).
namespace dc {

using namespace hopper;

constexpr int kChunk = 2048;        // keys a chunk (DECODE_CHUNK)
constexpr int kBK = 16;             // keys a block of the walk
constexpr int kMaxRows = 16;        // rows a head
constexpr int kSlab = 64;           // bf16 columns of a 128-byte row
constexpr int kSlabBytes = kBK * 128;
// The ring's budget: at 2 rows a block 3 stages at hd 256; at 8 or 16,
// where q's words take much room and the warp's work a key grows with
// the rows, 2 stages at hd 128, so that twice the blocks fit an SM (1.77x
// faster at GLM-4 9B's 16 rows, probes/b9_decode_limits.py).
constexpr int kRingBytes = 49152;
constexpr int kRingBytesRows = 16384;
constexpr int kStagesMin = 2;
constexpr int kStagesMax = 8;
constexpr int kPS = 24;             // a row of p's words: 16 keys + 8
constexpr int kMergeThreads = 256;
constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 ones

__host__ __device__ constexpr int round32(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int slabs(int d) { return (d + kSlab - 1) / kSlab; }
// One ring stage: a block's keys and values, each in slabs of 64 columns.
__host__ __device__ constexpr int stage_bytes(int hd, int hd_v) {
  return (slabs(hd) + slabs(hd_v)) * kSlabBytes;
}
__host__ __device__ constexpr int stages(int hd, int hd_v, int rt) {
  const int fit = (rt > 2 ? kRingBytesRows : kRingBytes) / stage_bytes(hd, hd_v);
  return fit < kStagesMin ? kStagesMin : fit < kStagesMax ? fit : kStagesMax;
}

// Shared memory of a block of rt rows (2, 8 or 16; kernels/mma_attention.py
// smem_bytes mirrors it): the 1024-byte alignment slack, the ring, q's four
// word columns a row (rows round32(hd) + 8 elements: conflict-free
// ldmatrix), p's three words of the rows' n-tiles (8 rows each), the rows'
// corr and bounds, and the ring's mbarriers.
__host__ __device__ constexpr long long smem_bytes(int hd, int hd_v, int rt) {
  return 1024LL + static_cast<long long>(stages(hd, hd_v, rt)) * stage_bytes(hd, hd_v) +
         4LL * rt * (round32(hd) + 8) * 2 + 3LL * ((rt + 7) / 8 * 8) * kPS * 2 +
         kMaxRows * 12 + kStagesMax * 8;
}

// The form chooser, a pure function of dtypes and shape (mirrored by
// kernels/mma_attention.py walk): 1 for this form.  q may be f32 or bf16.
__host__ __device__ inline int form(int q_dtype, int kv_dtype, long long rows,
                                    int hd, int hd_v) {
  return (q_dtype == kF32 || q_dtype == kBF16) && kv_dtype == kBF16 &&
         rows <= 16 && hd % 16 == 0 && hd_v % 16 == 0 && hd >= 16 &&
         hd <= 256 && hd_v >= 16 && hd_v <= 256;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// The byte offset of the 16-byte chunk holding column col of row key in a
// TMA tile: slabs of 64 columns x kBK rows of 128 bytes, 128-byte swizzled
// (chunk c of row key at chunk c ^ (key mod 8)).
__device__ __forceinline__ uint32_t tile_off(int key, int col) {
  return (col >> 6) * kSlabBytes + key * 128 +
         ((((col & 63) >> 3) ^ (key & 7)) << 4);
}

// Row r's valid keys [lo, hi) as attn_kernel's; a row past the last holds
// none.
__device__ __forceinline__ int2 row_range(int r, int R, int b, int Sq, int G,
                                          int Sk, const int* qpos,
                                          const int* kvlen, int causal,
                                          int has_window, long long window) {
  long long lo = 0, hi = 0;
  if (r < R) {
    const long long qp = qpos[static_cast<long long>(b) * Sq + r / G];
    hi = Sk;
    if (kvlen != nullptr) hi = min(hi, static_cast<long long>(kvlen[b]));
    if (causal) hi = min(hi, qp + 1);
    if (has_window) lo = qp - window + 1;
    lo = max(0LL, min(lo, static_cast<long long>(Sk)));
    hi = max(0LL, hi);
  }
  return make_int2(static_cast<int>(lo), static_cast<int>(hi));
}

// x as three bf16 words, hi first (the rests are exact in f32).
__device__ __forceinline__ void words3(float x, __nv_bfloat16 (&w)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = __float2bfloat16_rn(x);
    x = __fsub_rn(x, __bfloat162float(w[i]));
  }
}

// RT: the rows a block holds (2, 8 or 16; q's words take RT / 2 n-tiles of
// 8 columns, p's rows (RT + 7) / 8); NV: 16-column tiles of the value head
// it can hold (hd_v / 16 of them run).
template <int RT, int NV>
__global__ void __launch_bounds__(32)
    attn_decode_kernel(const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const void* __restrict__ q, int q_f32,
                       const int* __restrict__ qpos,
                       const int* __restrict__ kvlen,
                       float* __restrict__ state, int Sq, int Sk, int KV, int G,
                       int hd, int hd_v, int nch, int causal, int has_window,
                       long long window, float scale, int has_cap, float cap) {
  constexpr int NQ = RT / 2;
  constexpr int NQH = NQ < 4 ? NQ : 4;
  constexpr int NP = (RT + 7) / 8;
  constexpr int NR = 8 * NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;  // an ldmatrix address's matrix, row
  const int h = blockIdx.x % KV, chunk = blockIdx.x / KV, b = blockIdx.y;
  const int R = Sq * G;
  const int c0 = chunk * kChunk;
  const int c1 = Sk - c0 < kChunk ? Sk : c0 + kChunk;

  // The block's keys: from the first valid key of any row in the chunk to
  // the last; none, and the block exits.
  int first = INT_MAX, last = 0;
  for (int r = 0; r < R; ++r) {
    const int2 rg = row_range(r, R, b, Sq, G, Sk, qpos, kvlen, causal,
                              has_window, window);
    const int lo = max(rg.x, c0), hi = min(rg.y, c1);
    if (lo < hi) {
      first = min(first, lo);
      last = max(last, hi);
    }
  }
  if (first == INT_MAX) return;
  const int kb0 = first / kBK * kBK;
  const int nblk = (last - kb0 + kBK - 1) / kBK;

  const int nst = stages(hd, hd_v, RT), sb = stage_bytes(hd, hd_v);
  const int k_bytes = slabs(hd) * kSlabBytes;
  const int qstride = round32(hd) + 8;
  unsigned char* ring = smem;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(ring + nst * sb);
  __nv_bfloat16* ps = qs + 4 * RT * qstride;  // [word][row][key]
  float* corr_s = reinterpret_cast<float*>(ps + 3 * NR * kPS);
  int2* rb_s = reinterpret_cast<int2*>(corr_s + kMaxRows);  // rows' [lo, hi)
  uint64_t* full = reinterpret_cast<uint64_t*>(rb_s + kMaxRows);

  if (lane == 0) {
    for (int i = 0; i < nst; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // Block it's keys and values into stage it mod nst (keys past Sk and
  // columns past hd / hd_v zero).
  auto load = [&](int it) {
    const int st = it % nst;
    unsigned char* d = ring + st * sb;
    mbar_expect_tx(&full[st], static_cast<uint32_t>(sb));
    const int j = kb0 + it * kBK;
    for (int s = 0; s < slabs(hd); ++s)
      tma_load_4d(d + s * kSlabBytes, &tmk, &full[st], s * kSlab, h, j, b);
    for (int s = 0; s < slabs(hd_v); ++s)
      tma_load_4d(d + k_bytes + s * kSlabBytes, &tmv, &full[st], s * kSlab, h,
                  j, b);
  };
  if (lane == 0)
    for (int it = 0; it < nst && it < nblk; ++it) load(it);

  // q's words once a block: column 4 r + w of row r (zero past hd, past
  // the last row and in the fourth word).
  for (int i = lane; i < RT * qstride; i += 32) {
    const int r = i / qstride, col = i % qstride;
    float x = 0.0f;
    if (r < R && col < hd) {
      const long long row =
          ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G;
      x = q_f32 ? __ldg(static_cast<const float*>(q) + row * hd + col)
                : __bfloat162float(
                      static_cast<const __nv_bfloat16*>(q)[row * hd + col]);
    }
    __nv_bfloat16 w[3];
    words3(x, w);
#pragma unroll
    for (int wd = 0; wd < 3; ++wd) qs[(4 * r + wd) * qstride + col] = w[wd];
    qs[(4 * r + 3) * qstride + col] = __float2bfloat16_rn(0.0f);
  }
  for (int i = lane; i < 3 * NR * kPS; i += 32)
    ps[i] = __float2bfloat16_rn(0.0f);
  // The rows' bounds (in shared memory, not in registers, beside a
  // 16-row block's accumulators).
  for (int i = lane; i < kMaxRows; i += 32) {
    corr_s[i] = 1.0f;
    rb_s[i] = row_range(i, R, b, Sq, G, Sk, qpos, kvlen, causal, has_window,
                        window);
  }
  __syncwarp();

  float m[NQ];
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) m[nt] = kMInit;
  float l[NP][2], c[NP][2], acc[NV][NP][4];
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    l[np][0] = l[np][1] = c[np][0] = c[np][1] = 0.0f;
#pragma unroll
    for (int mt = 0; mt < NV; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][np][i] = 0.0f;
  }
  const uint32_t ring_u = smem_u32(ring), qs_u = smem_u32(qs),
                 ps_u = smem_u32(ps);
  const int nk = round32(hd) / 16;  // the S chain's k steps (zero past hd)
  const int nmt = hd_v / 16;
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};

  for (int it = 0; it < nblk; ++it) {
    const int st = it % nst, j0 = kb0 + it * kBK;
    mbar_wait(&full[st], (it / nst) & 1);
    const uint32_t kt = ring_u + st * sb, vt = kt + k_bytes;

    // Sᵀ = K qᵀ: each word column one chain over hd from zero, NQH n-tiles
    // at a time (two passes over the keys at 16 rows: 16 rows' scores
    // beside their accumulators spilled).  Then, per n-tile, the scores
    // (hi + mid) + lo of keys g and g + 8, scaled, capped and masked; the
    // block's row max; corr and p; p's words to shared memory (key g from
    // even lanes, g + 8 from odd) and corr beside them.  This lane's rows
    // of the block: in this score layout row 2 nt + t / 2 (t even: words
    // hi and mid; odd: lo and the zero column), in the value layout below
    // rows 8 np + 2 t + e.
#pragma unroll
    for (int q0 = 0; q0 < NQ; q0 += NQH) {
      float s[NQH][4];
#pragma unroll
      for (int nh = 0; nh < NQH; ++nh)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nh][i] = 0.0f;
      for (int kk = 0; kk < nk; kk += 2) {
        uint32_t a0[4], a1[4];
        const int key = mr + 8 * (mat & 1);
        ldsm_x4(a0, kt + tile_off(key, 16 * kk + 8 * (mat >> 1)));
        ldsm_x4(a1, kt + tile_off(key, 16 * kk + 16 + 8 * (mat >> 1)));
#pragma unroll
        for (int nh = 0; nh < NQH; ++nh) {
          uint32_t bq[4];
          ldsm_x4(bq, qs_u + ((8 * (q0 + nh) + mr) * qstride + 16 * kk +
                              8 * mat) * 2);
          const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
          mma_bf16(s[nh], a0, b0);
          mma_bf16(s[nh], a1, b1);
        }
      }
#pragma unroll
      for (int nh = 0; nh < NQH; ++nh) {
        const int nt = q0 + nh, r = 2 * nt + (t >> 1);
        const int2 rg = rb_s[r];
        const float x0 = (t & 1) ? s[nh][0] : __fadd_rn(s[nh][0], s[nh][1]);
        const float x1 = (t & 1) ? s[nh][2] : __fadd_rn(s[nh][2], s[nh][3]);
        const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
        const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
        const float v0 = score((t & 1) ? __fadd_rn(y0, x0) : __fadd_rn(x0, y0),
                               j0 + g, rg.x, rg.y, scale, has_cap, cap);
        const float v1 = score((t & 1) ? __fadd_rn(y1, x1) : __fadd_rn(x1, y1),
                               j0 + g + 8, rg.x, rg.y, scale, has_cap, cap);
        float mx = fmaxf(v0, v1);
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[nt], mx);
        const float corr = expf(__fsub_rn(m[nt], mn));
        m[nt] = mn;
        if (g == 0 && (t & 1) == 0) corr_s[r] = corr;
        __nv_bfloat16 w[3];
        words3(expf(__fsub_rn((t & 1) ? v1 : v0, mn)), w);
        const int key = g + 8 * (t & 1);
#pragma unroll
        for (int wd = 0; wd < 3; ++wd) ps[(wd * NR + r) * kPS + key] = w[wd];
      }
    }
    __syncwarp();

    // The row sums (p's three words against ones, from zero) and their
    // Kahan steps; p's hi word is p x v's B operand.
    uint32_t bh[NP][2];
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bw[4], bl[2];
      ldsm_x4(bw, ps_u + (((mat >> 1) * NR + 8 * np + mr) * kPS + 8 * (mat & 1)) * 2);
      ldsm_x2(bl, ps_u + ((2 * NR + 8 * np + mr) * kPS + 8 * (mat & 1)) * 2);
      bh[np][0] = bw[0];
      bh[np][1] = bw[1];
      const uint32_t bm[2] = {bw[2], bw[3]};
      float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(dl, ones, bh[np]);
      mma_bf16(dl, ones, bm);
      mma_bf16(dl, ones, bl);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int2 rg = rb_s[8 * np + 2 * t + e];
        if (rg.x < rg.y && j0 < rg.y && j0 + kBK > rg.x)
          kahan(l[np][e], c[np][e], corr_s[8 * np + 2 * t + e], dl[e]);
      }
    }
    // acc = acc corr + p x v per 16 value columns, each from zero.
    float ca[NP], cb[NP];
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      ca[np] = corr_s[8 * np + 2 * t];
      cb[np] = corr_s[8 * np + 2 * t + 1];
    }
#pragma unroll
    for (int mt = 0; mt < NV; ++mt) {
      if (mt >= nmt) break;
      uint32_t av[4];
      ldsm_x4_t(av, vt + tile_off(mr + 8 * (mat >> 1), 16 * mt + 8 * (mat & 1)));
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(part, av, bh[np]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][np][i] = __fadd_rn(
              __fmul_rn(acc[mt][np][i], (i & 1) ? cb[np] : ca[np]), part[i]);
      }
    }
    // Every lane is done with this stage, p's words and corr: the stage
    // takes block it + nst.
    __syncwarp();
    if (lane == 0 && it + nst < nblk) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(it + nst);
    }
  }

  // The chunk's state of each row: m (score layout), l - c and acc (value
  // layout).
  const long long base =
      ((static_cast<long long>(b) * KV + h) * nch + chunk) * R;
  const int width = hd_v + 2;
  if (g == 0 && (t & 1) == 0) {
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int r = 2 * nt + (t >> 1);
      if (r < R) state[(base + r) * width] = m[nt];
    }
  }
#pragma unroll
  for (int np = 0; np < NP; ++np)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * np + 2 * t + e;
      if (r >= R) continue;
      float* row = state + (base + r) * width;
      if (g == 0) row[1] = __fsub_rn(l[np][e], c[np][e]);
#pragma unroll
      for (int mt = 0; mt < NV; ++mt) {
        if (mt >= nmt) break;
        row[2 + 16 * mt + g] = acc[mt][np][e];
        row[2 + 16 * mt + g + 8] = acc[mt][np][2 + e];
      }
    }
}

// The merge: block (h, b), a thread per (row, value column) in turn; each
// folds its row's live chunks (those holding a valid key of it) in chunk
// order and writes o in bf16.
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const float* __restrict__ state, const int* __restrict__ qpos,
                 const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ out,
                 int Sq, int Sk, int KV, int G, int hd_v, int nch, int causal,
                 int has_window, long long window) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int R = Sq * G, width = hd_v + 2;
  for (int idx = threadIdx.x; idx < R * hd_v; idx += kMergeThreads) {
    const int r = idx / hd_v, col = idx % hd_v;
    const int2 rg = row_range(r, R, b, Sq, G, Sk, qpos, kvlen, causal,
                              has_window, window);
    float M = kMInit, L = 0.0f, C = 0.0f, A = 0.0f;
    if (rg.x < rg.y) {
      for (long long ch = rg.x / kChunk; ch * kChunk < rg.y; ++ch) {
        const float* st =
            state + ((((static_cast<long long>(b) * KV + h) * nch + ch) * R) + r) *
                        width;
        const float mc = st[0], lf = st[1], ac = st[2 + col];
        const float mn = fmaxf(M, mc);
        const float a = expf(__fsub_rn(M, mn)), bb = expf(__fsub_rn(mc, mn));
        const float y = __fsub_rn(__fmul_rn(lf, bb), __fmul_rn(C, a));
        const float la = __fmul_rn(L, a);
        const float tt = __fadd_rn(la, y);
        C = __fsub_rn(__fsub_rn(tt, la), y);
        L = tt;
        A = __fadd_rn(__fmul_rn(A, a), __fmul_rn(ac, bb));
        M = mn;
      }
    }
    const float lf = __fsub_rn(L, C);
    const float o = lf > 0.0f ? __fdiv_rn(A, lf) : 0.0f;
    const long long row =
        ((static_cast<long long>(b) * Sq + r / G) * KV + h) * G + r % G;
    out[row * hd_v + col] = __float2bfloat16_rn(o);
  }
}

template <int RT, int NV>
int launch(const void* q, int q_f32, const void* k, const void* v,
           const int* qpos, const int* kvlen, void* out, float* state, int B,
           int Sq, int Sk, int KV, int G, int hd, int hd_v, int causal,
           int has_window, long long window, float scale, int has_cap,
           float cap, cudaStream_t s) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(k) || !aligned(v) || state == nullptr)
    return cudaErrorInvalidValue;
  const long long nch = (static_cast<long long>(Sk) + kChunk - 1) / kChunk;
  if (nch * KV >= INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tmk, tmv;
  int e = wg::encode(&tmk, k, B, Sk, KV, hd, kBK);
  if (e) return e;
  e = wg::encode(&tmv, v, B, Sk, KV, hd_v, kBK);
  if (e) return e;
  const int bytes = static_cast<int>(smem_bytes(hd, hd_v, RT));
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = attn_decode_kernel<RT, NV>;
  // The shared memory granted to this kernel on each card, asked for once.
  static int granted[64] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return ce;
  if (dev >= 64 || granted[dev] < bytes) {
    ce = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
    if (ce != cudaSuccess) return ce;
    if (dev < 64) granted[dev] = bytes;
  }
  kernel<<<dim3(static_cast<unsigned>(nch * KV), B), 32, bytes, s>>>(
      tmk, tmv, q, q_f32, qpos, kvlen, state, Sq, Sk, KV, G, hd, hd_v,
      static_cast<int>(nch), causal, has_window, window, scale, has_cap, cap);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return ce;
  merge_kernel<<<dim3(KV, B), kMergeThreads, 0, s>>>(
      state, qpos, kvlen, static_cast<__nv_bfloat16*>(out), Sq, Sk, KV, G,
      hd_v, static_cast<int>(nch), causal, has_window, window);
  return cudaGetLastError();
}

// Blocks of 2 rows (a decode step of two heads a group), 8 or 16; value
// heads up to 128 or 256 columns.
int launch_rows(const void* q, int q_f32, const void* k, const void* v,
                const int* qpos, const int* kvlen, void* out, float* state,
                int B, int Sq, int Sk, int KV, int G, int hd, int hd_v,
                int causal, int has_window, long long window, float scale,
                int has_cap, float cap, cudaStream_t s) {
#define B9_DC_LAUNCH(RT, NV)                                                  \
  return launch<RT, NV>(q, q_f32, k, v, qpos, kvlen, out, state, B, Sq, Sk,  \
                        KV, G, hd, hd_v, causal, has_window, window, scale,  \
                        has_cap, cap, s)
  const int rows = Sq * G;
  if (rows <= 2) {
    if (hd_v <= 128) B9_DC_LAUNCH(2, 8);
    B9_DC_LAUNCH(2, 16);
  }
  if (rows <= 8) {
    if (hd_v <= 128) B9_DC_LAUNCH(8, 8);
    B9_DC_LAUNCH(8, 16);
  }
  if (hd_v <= 128) B9_DC_LAUNCH(16, 8);
  B9_DC_LAUNCH(16, 16);
#undef B9_DC_LAUNCH
}

}  // namespace dc

// The form b9_attention launches (kernels/mma_attention.py walk mirrors
// it): 1 the bf16 prefill form, 2 the f32 prefill form, 3 the decode form,
// 0 attn_kernel.
int form(int q_dtype, int kv_dtype, long long rows, int hd, int hd_v) {
  if (wg::form(q_dtype, kv_dtype, rows, hd, hd_v)) return 1;
  if (wf::form(q_dtype, kv_dtype, rows, hd, hd_v)) return 2;
  if (dc::form(q_dtype, kv_dtype, rows, hd, hd_v)) return 3;
  return 0;
}

template <bool QF32, bool KVF32>
int launch_width(const void* q, const void* k, const void* v, const int* qpos,
                 const int* kvlen, void* out, void* words, int B, int Sq,
                 int Sk, int KV, int G, int hd, int hd_v, int causal,
                 int has_window, long long window, float scale, int has_cap,
                 float cap, cudaStream_t s) {
  if (QF32 && KVF32 &&
      wf::form(kF32, kF32, static_cast<long long>(Sq) * G, hd, hd_v)) {
    if (words == nullptr) return cudaErrorInvalidValue;
    return wf::launch_width(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qpos, kvlen, static_cast<float*>(out),
        static_cast<__nv_bfloat16*>(words), B, Sq, Sk, KV, G, hd, hd_v,
        causal, has_window, window, scale, has_cap, cap, s);
  }
  if (wg::form(QF32 ? kF32 : kBF16, KVF32 ? kF32 : kBF16,
               static_cast<long long>(Sq) * G, hd, hd_v))
    return wg::launch_width(q, k, v, qpos, kvlen, out, B, Sq, Sk, KV, G, hd,
                            hd_v, causal, has_window, window, scale, has_cap,
                            cap, s);
  if (!KVF32 && dc::form(QF32 ? kF32 : kBF16, kBF16,
                         static_cast<long long>(Sq) * G, hd, hd_v))
    return dc::launch_rows(q, QF32, k, v, qpos, kvlen, out,
                           static_cast<float*>(words), B, Sq, Sk, KV, G, hd,
                           hd_v, causal, has_window, window, scale, has_cap,
                           cap, s);
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

// The form b9_attention launches for these dtypes (0 f32, 1 bf16) and
// shape: 1 the bf16 prefill form (wgmma and TMA), 2 the f32 prefill form
// (its word pass, then wgmma and TMA), 3 the decode form (chunks walked
// side by side, then their merge), 0 the mma.sync form.
int b9_attention_form(int q_dtype, int kv_dtype, long long rows, int hd,
                      int hd_v) {
  return form(q_dtype, kv_dtype, rows, hd, hd_v);
}

// B9: out (B, Sq, KV, G, hd_v) in v's dtype from qg (B, Sq, KV, G, hd)
// f32 (q_dtype 0) or bf16 (1), k (B, Sk, KV, hd) and v (B, Sk, KV, hd_v)
// f32 (kv_dtype 0) or bf16 (1), qpos (B, Sq) int32, kvlen (B,) int32 or
// null; causal, has_window with window, has_cap with cap as flags.
// words: for the f32 prefill form (b9_attention_form 2) a bf16 scratch of
// 3 B KV (Sq G hd + Sk (hd + hd_v)) elements, 16-byte aligned, for the
// operands' word planes; for the decode form (3) an f32 scratch of B KV
// ceil(Sk / dc::kChunk) Sq G (hd_v + 2) elements for the chunks' states; null
// otherwise.  Every array row-major and
// contiguous; hd_v <= 256.
int b9_attention(const void* q, const void* k, const void* v, const int* qpos,
                 const int* kvlen, void* out, void* words, int B, int Sq,
                 int Sk, int KV, int G, int hd, int hd_v, int q_dtype,
                 int kv_dtype, int causal, int has_window, long long window,
                 float scale, int has_cap, float cap, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || G < 1 || hd < 1 || hd_v < 1 ||
      hd_v > 256 || B > 65535 || KV > 65535 ||
      static_cast<long long>(Sq) * G > INT_MAX - kMaxRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define B9_ARGS                                                              \
  q, k, v, qpos, kvlen, out, words, B, Sq, Sk, KV, G, hd, hd_v, causal,       \
      has_window, window, scale, has_cap, cap, s
  if (q_dtype == kF32 && kv_dtype == kF32) return launch_width<true, true>(B9_ARGS);
  if (q_dtype == kF32 && kv_dtype == kBF16) return launch_width<true, false>(B9_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kF32) return launch_width<false, true>(B9_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kBF16) return launch_width<false, false>(B9_ARGS);
#undef B9_ARGS
  return cudaErrorInvalidValue;
}

}  // extern "C"
