// Flash attention for Hopper (sm_90a): forward and backward at head width 64,
// with the numerics of the JAX library's TPU flash-attention kernels.
//
// Replaces (jax/experimental/pallas/ops/tpu/flash_attention.py, reached from
// sceneverse_tpu/ops/pallas/attention.py:105):
//   sv_flash_fwd  <- _flash_attention_kernel     (pallas_call :758)
//   sv_flash_bwd  <- _flash_attention_dq_kernel  (pallas_call :1456), launch 1,
//                    with di = sum(o * do) (:273) folded in
//                    _flash_attention_dkv_kernel (pallas_call :1121), launch 2
//
// Operands are (B*H, L, 64) bf16 rows (q pre-scaled by the wrapper); the
// optional bias ab is (B*H, Lq, Lk) f32 and the optional key-pad mask (B, Lk)
// bytes (1 = pad key, which gets s + MASK_VALUE as the library's segment
// mask adds). Keys past Lk take no part (the library pads to 128-multiples
// and masks its padding the same way). Every product has bf16 operands and
// f32 accumulation on tensor cores; the softmax and its derivative run in
// f32 with each operation rounded on its own (no FMA contraction), in the
// order of the plain twins in ops/attention.py. A block holds 64 rows of its
// own (query rows in the forward and dq passes, keys in the dk/dv pass) and
// walks tiles of 64 of the other; each of its 4 warps owns 16 of those rows,
// so every sum over the walked dimension stays in one warp: no float
// atomics, and two runs agree bit for bit.
//
// Design (all three kernels). What bounds them on this card at the GPS
// lengths (L <= 300, B*H = 384): bytes (q, the valid keys' k, v, and in the
// backward o, do, at 3.35 TB/s) over the products, and in practice latency:
// a block walks at most 5 tiles. So no (rows x tile) matrix of scores,
// probabilities, dp or ds leaves registers: mma.sync m16n8k16 bf16
// fragments (documented layouts, common.cuh), accumulators repacked in
// registers as the A operand of the next product; the block's own rows are
// loaded once into A fragments; the walked tiles are double-buffered by
// cp.async, the next tile's load overlapping the current products; results
// leave as bf16 rows through the warp's own staged rows, 16 bytes a store.
// A key whose pad term is MASK_VALUE gets p = exp(s + MASK_VALUE - m) = 0
// in any row with a valid key, so every tile past the one that holds the
// batch row's last valid key is skipped exactly (a row with no valid key
// walks every tile: its p is 1/Lk).
//   forward: warp = 16 query rows; s = q k^T, online softmax (row max and
//     sum two quad shuffles per row), p.v. Shared memory 46,592 B.
//   backward launch 1 (dq, d ab, di): warp = 16 query rows; di = sum(o do)
//     of its rows first (written for launch 2), then per key tile s = q k^T
//     and dp = do v^T, p and ds = (dp - di) p in place, d ab stored from the
//     accumulators (8-byte pairs), dq += bf16(ds) k with k through
//     ldmatrix.trans; the walk stops after the last valid key's tile and
//     d ab is zero past it.
//   backward launch 2 (dk, dv): warp = 16 keys; per query tile the
//     transposes s^T = k q^T and dp^T = v do^T, so that p^T and ds^T come
//     out with keys as rows and repack as the A operands of dv += p^T do and
//     dk += ds^T q; the tile's m, 1/l and di are staged in shared memory and
//     read per column pair. A block whose 64 keys all lie past the last
//     valid key writes zero dk, dv and returns.
// Registers, spills, times and bounds: chip_smoke.py's build and flash
// phases, PERF.md rows 11a-c.
#include "common.cuh"

typedef __nv_bfloat16 bf16;

constexpr int FA_D = 64;        // head width
constexpr int FA_T = 64;        // rows per tile
constexpr int FA_LD = FA_D + 8;  // bf16 row stride of a staged tile
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_SUB = 32;      // walked rows per product step of the backward
constexpr float FA_MASK = -0.7f * 3.4028234663852886e38f;

// rows [r0, r0 + 64) of one head's (L, 64) bf16 matrix -> shared [64][FA_LD]
// by cp.async, zero past L
__device__ __forceinline__ void fa_cp_tile(bf16* dst, const bf16* src, int r0, int L) {
  for (int i = threadIdx.x; i < FA_T * (FA_D / 8); i += FA_THREADS) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    const bool ok = r0 + r < L;
    sv_cp16(dst + r * FA_LD + c8, src + (size_t)(ok ? r0 + r : 0) * FA_D + c8, ok ? 16 : 0);
  }
}

// key tile j0.. of K and V by cp.async, and the keys' additive terms: 0,
// the pad mask, or -inf past Lk
__device__ __forceinline__ void fa_stage(bf16* kb, bf16* vb, float* kadd, int j0,
                                         const bf16* kh, const bf16* vh,
                                         const unsigned char* padb, int Lk) {
  fa_cp_tile(kb, kh, j0, Lk);
  fa_cp_tile(vb, vh, j0, Lk);
  if (threadIdx.x < FA_T) {
    const int key = j0 + threadIdx.x;
    kadd[threadIdx.x] = key >= Lk ? -INFINITY : (padb != nullptr && padb[key]) ? FA_MASK : 0.f;
  }
}

// One past the batch row's last valid key, for every thread of the block:
// Lk without a mask, and for a row whose keys are all pads (it takes every
// key). red: FA_WARPS ints of shared memory. Holds a __syncthreads.
__device__ __forceinline__ int fa_kv_end(const unsigned char* padb, int Lk, int* red) {
  if (padb == nullptr) return Lk;
  int last = -1;
  for (int j = threadIdx.x; j < Lk; j += FA_THREADS)
    if (!padb[j]) last = j;
  last = __reduce_max_sync(SV_FULL_MASK, last);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = last;
  __syncthreads();
  for (int w = 0; w < FA_WARPS; ++w) last = max(last, red[w]);
  return last >= 0 ? last + 1 : Lk;
}

// A fragments of the 16 staged rows at `rows` (row-major, ld FA_LD), all
// four 16-column chunks
__device__ __forceinline__ void fa_lda(uint32_t (&a)[FA_D / 16][4], const bf16* rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < FA_D / 16; ++kk)
    sv_ldsm4(a[kk], rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * FA_LD + kk * 16 +
                        (lane >> 4) * 8);
}

// acc (16 x 8 NB) += a (16 x 64) t^T, t = 8 NB staged rows of 64 (the n
// index by row, k along the row)
template <int NB>
__device__ __forceinline__ void fa_mma_abt(float (&acc)[NB][4], const uint32_t (&a)[FA_D / 16][4],
                                           const bf16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < FA_D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      sv_ldsm4(b, t + (np * 16 + (lane & 7) + (lane >> 4) * 8) * FA_LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      sv_mma(acc[2 * np], a[kk], b[0], b[1]);
      sv_mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x 64) += a (16 x 16 KC) t, t = 16 KC staged rows of 64 (the k
// index by row, n along the row; ldmatrix.trans)
template <int KC>
__device__ __forceinline__ void fa_mma_ab(float (&acc)[FA_D / 8][4], const uint32_t (&a)[KC][4],
                                          const bf16* t) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
#pragma unroll
    for (int dp = 0; dp < FA_D / 16; ++dp) {
      uint32_t b[4];
      sv_ldsm4_t(b, t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * FA_LD + dp * 16 +
                        (lane >> 4) * 8);
      sv_mma(acc[2 * dp], a[kk], b[0], b[1]);
      sv_mma(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
}

template <int NB>
__device__ __forceinline__ void fa_zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// a warp's 16 x 64 f32 accumulators -> bf16 rows r0.. (< L) of dst
// (L x 64), through the warp's 16 staged rows w, as 16-byte stores
__device__ __forceinline__ void fa_store_rows(const float (&acc)[FA_D / 8][4], bf16* w,
                                              bf16* __restrict__ dst, int r0, int L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < FA_D / 8; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(w + (g + r * 8) * FA_LD + d * 8 + t4 * 2) =
          sv_pack_bf16(acc[d][2 * r], acc[d][2 * r + 1]);
  __syncwarp();
  for (int i = lane; i < 16 * (FA_D / 8); i += 32) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * FA_D + c8) =
          *reinterpret_cast<const uint4*>(w + r * FA_LD + c8);
  }
}

// ab at (row, key) and (row, key + 1) of one head's (Lq, Lk) bias, each 0
// where it lies past Lq or Lk; one 8-byte load when Lk is even (key is even)
__device__ __forceinline__ float2 fa_ab2(const float* __restrict__ abh, int row, int key, int Lq,
                                         int Lk) {
  float2 r = make_float2(0.f, 0.f);
  if (row >= Lq || key >= Lk) return r;
  const float* p = abh + (size_t)row * Lk + key;
  if ((Lk & 1) == 0) return *reinterpret_cast<const float2*>(p);
  r.x = p[0];
  if (key + 1 < Lk) r.y = p[1];
  return r;
}

// ---------------------------------------------------------------------------
// Forward. Grid (ceil(Lq / 64), B*H), 4 warps; warp w owns query rows
// 16w..16w+15 and keeps their scores, probabilities, running max and sum and
// output in registers (mma.sync m16n8k16 fragments): lane (g, t) holds rows
// g and g + 8 and, of each 8-key or 8-column block, columns 2t and 2t + 1.
// ---------------------------------------------------------------------------
constexpr int FA_FWD_MIN_BLOCKS = 4;  // blocks per SM asked of ptxas

struct FaFwdSmem {
  bf16 q[FA_T * FA_LD];                  // the query tile, then the bf16 output
  bf16 k[2][FA_T * FA_LD], v[2][FA_T * FA_LD];  // double-buffered key tiles
  float kadd[2][FA_T];                   // per key: 0, the pad mask, or -inf past Lk
  int last[FA_WARPS];                    // the batch row's last valid key, per warp
};

__global__ void __launch_bounds__(FA_THREADS, FA_FWD_MIN_BLOCKS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const unsigned char* __restrict__ pad,
              const float* __restrict__ ab, bf16* __restrict__ o, float* __restrict__ lout,
              float* __restrict__ mout, int H, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  FaFwdSmem& S = *reinterpret_cast<FaFwdSmem*>(fa_smem);
  const int bh = blockIdx.y, q0 = blockIdx.x * FA_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qh = q + (size_t)bh * Lq * FA_D;
  const bf16* kh = k + (size_t)bh * Lk * FA_D;
  const bf16* vh = v + (size_t)bh * Lk * FA_D;
  const unsigned char* padb = pad ? pad + (size_t)(bh / H) * Lk : nullptr;
  const float* abh = ab ? ab + (size_t)bh * Lq * Lk : nullptr;

  // queries (once) and the first key tile in flight while the pad row is read
  fa_cp_tile(S.q, qh, q0, Lq);
  fa_stage(S.k[0], S.v[0], S.kadd[0], 0, kh, vh, padb, Lk);
  sv_cp_commit();
  // The walk stops after the tile that holds the batch row's last valid key:
  // a later tile is all pads, so alpha = exp(0) = 1 and every p = exp(MASK -
  // m) = 0 for a row with a valid key, and skipping it changes no bit.
  const int ntiles = (fa_kv_end(padb, Lk, S.last) + FA_T - 1) / FA_T;

  uint32_t qa[FA_D / 16][4];  // A fragments of the warp's 16 query rows
  float oacc[FA_D / 8][4];    // running output, 8 column blocks
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  fa_zero(oacc);

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, j0 = t * FA_T;
    if (t + 1 < ntiles) {  // the next tile loads while this one is used
      fa_stage(S.k[buf ^ 1], S.v[buf ^ 1], S.kadd[buf ^ 1], j0 + FA_T, kh, vh, padb, Lk);
      sv_cp_commit();
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    if (t == 0) fa_lda(qa, S.q + warp * 16 * FA_LD);
    // scores s = q k^T of 16 rows x 64 keys
    float s[FA_T / 8][4];
    fa_zero(s);
    fa_mma_abt(s, qa, S.k[buf]);
    // logits s [+ ab] + the key's term, and the rows' tile maxima
    const float* kadd = S.kadd[buf];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < FA_T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t4 * 2 + (e & 1);
        float x = s[n][e];
        if (abh != nullptr) {
          const int row = q0 + warp * 16 + g + (e >> 1) * 8;
          if (row < Lq && j0 + c < Lk) x = __fadd_rn(x, abh[(size_t)row * Lk + j0 + c]);
        }
        x = __fadd_rn(x, kadd[c]);
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mnew[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the quad holds the row: two shuffles
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(SV_FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(SV_FULL_MASK, mx[r], 2));
      mnew[r] = fmaxf(mrow[r], mx[r]);
      alpha[r] = expf(__fsub_rn(mrow[r], mnew[r]));
    }
    // p = exp(x - m_new); its bf16 pairs are the A fragments of p.v
    uint32_t pa[FA_T / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < FA_T / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(__fsub_rn(s[n][e], mnew[e >> 1]));
      sum[0] = __fadd_rn(__fadd_rn(sum[0], p[0]), p[1]);
      sum[1] = __fadd_rn(__fadd_rn(sum[1], p[2]), p[3]);
      pa[n >> 1][(n & 1) * 2] = sv_pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = sv_pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tot = __fadd_rn(sum[r], __shfl_xor_sync(SV_FULL_MASK, sum[r], 1));
      tot = __fadd_rn(tot, __shfl_xor_sync(SV_FULL_MASK, tot, 2));
      lrow[r] = __fadd_rn(__fmul_rn(alpha[r], lrow[r]), tot);
      mrow[r] = mnew[r];
    }
    // the tile's bf16(p) v in f32, then o = o * alpha + it
    float pv[FA_D / 8][4];
    fa_zero(pv);
    fa_mma_ab(pv, pa, S.v[buf]);
#pragma unroll
    for (int d = 0; d < FA_D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[d][e] = __fadd_rn(__fmul_rn(oacc[d][e], alpha[e >> 1]), pv[d][e]);
    __syncthreads();  // buffer buf is free for the load of tile t + 2
  }
  // o / l in bf16 through the warp's own rows of the query tile
  const int row0 = q0 + warp * 16;
#pragma unroll
  for (int d = 0; d < FA_D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = __fdiv_rn(oacc[d][e], lrow[e >> 1]);
  fa_store_rows(oacc, S.q + warp * 16 * FA_LD, o + (size_t)bh * Lq * FA_D, row0, Lq);
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + r * 8;
      if (row < Lq) {
        lout[(size_t)bh * Lq + row] = lrow[r];
        mout[(size_t)bh * Lq + row] = mrow[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, launch 1 (di, dq, d ab). Grid (ceil(Lq / 64), B*H); warp w owns
// query rows 16w..16w+15 (lane (g, t): rows g and g + 8) and walks the key
// tiles up to the one that holds the batch row's last valid key, FA_SUB
// keys per product step.
// ---------------------------------------------------------------------------
constexpr int FA_BWD_MIN_BLOCKS = 3;  // blocks per SM asked of ptxas (4 spill)

struct FaDqSmem {
  bf16 q[FA_T * FA_LD], dout[FA_T * FA_LD];     // the block's rows; q's then holds dq
  bf16 k[2][FA_T * FA_LD], v[2][FA_T * FA_LD];  // double-buffered key tiles
  float kadd[2][FA_T];
  int last[FA_WARPS];
};

__global__ void __launch_bounds__(FA_THREADS, FA_BWD_MIN_BLOCKS)
fa_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const unsigned char* __restrict__ pad,
             const float* __restrict__ ab, const float* __restrict__ lin,
             const float* __restrict__ min_, const bf16* __restrict__ o,
             const bf16* __restrict__ dout, float* __restrict__ diout, bf16* __restrict__ dq,
             float* __restrict__ dab, int H, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  FaDqSmem& S = *reinterpret_cast<FaDqSmem*>(fa_smem);
  const int bh = blockIdx.y, q0 = blockIdx.x * FA_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kh = k + (size_t)bh * Lk * FA_D;
  const bf16* vh = v + (size_t)bh * Lk * FA_D;
  const unsigned char* padb = pad ? pad + (size_t)(bh / H) * Lk : nullptr;
  const float* abh = ab ? ab + (size_t)bh * Lq * Lk : nullptr;
  float* dabh = dab ? dab + (size_t)bh * Lq * Lk : nullptr;

  fa_cp_tile(S.q, q + (size_t)bh * Lq * FA_D, q0, Lq);
  fa_cp_tile(S.dout, dout + (size_t)bh * Lq * FA_D, q0, Lq);
  fa_stage(S.k[0], S.v[0], S.kadd[0], 0, kh, vh, padb, Lk);
  sv_cp_commit();
  // while they load: lane l's half row of o for di (row l / 2, columns
  // 32 (l % 2)..), and rows g, g + 8's m and 1/l (0 past Lq: p = 0 there)
  const int row0 = q0 + warp * 16, orow = row0 + (lane >> 1);
  uint4 ov[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    ov[c] = orow < Lq ? *reinterpret_cast<const uint4*>(
                            o + ((size_t)bh * Lq + orow) * FA_D + (lane & 1) * 32 + c * 8)
                      : make_uint4(0u, 0u, 0u, 0u);
  float mr[2], linv[2], dir[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    const bool ok = row < Lq;
    mr[r] = ok ? min_[(size_t)bh * Lq + row] : 0.f;
    linv[r] = ok ? __fdiv_rn(1.f, lin[(size_t)bh * Lq + row]) : 0.f;
  }
  // later tiles hold only pads: p = 0, so ds, d ab and their dq terms are 0
  const int ntiles = (fa_kv_end(padb, Lk, S.last) + FA_T - 1) / FA_T;

  uint32_t qa[FA_D / 16][4], da[FA_D / 16][4];  // A fragments of q and do rows
  float dqa[FA_D / 8][4];
  fa_zero(dqa);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, j0 = t * FA_T;
    if (t + 1 < ntiles) {
      fa_stage(S.k[buf ^ 1], S.v[buf ^ 1], S.kadd[buf ^ 1], j0 + FA_T, kh, vh, padb, Lk);
      sv_cp_commit();
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      fa_lda(qa, S.q + warp * 16 * FA_LD);
      fa_lda(da, S.dout + warp * 16 * FA_LD);
      // di = sum(o do) in f32: a half row per lane, the pair's sum, then
      // rows g and g + 8 from their lanes
      const bf16* dr = S.dout + (warp * 16 + (lane >> 1)) * FA_LD + (lane & 1) * 32;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 dv4 = *reinterpret_cast<const uint4*>(dr + c * 8);
        const bf16* ob = reinterpret_cast<const bf16*>(&ov[c]);
        const bf16* db = reinterpret_cast<const bf16*>(&dv4);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part = __fadd_rn(part, __fmul_rn(__bfloat162float(ob[e]), __bfloat162float(db[e])));
      }
      const float tot = __fadd_rn(part, __shfl_xor_sync(SV_FULL_MASK, part, 1));
      dir[0] = __shfl_sync(SV_FULL_MASK, tot, 2 * g);
      dir[1] = __shfl_sync(SV_FULL_MASK, tot, 2 * g + 16);
      if ((lane & 1) == 0 && orow < Lq) diout[(size_t)bh * Lq + orow] = tot;
    }
#pragma unroll
    for (int h = 0; h < FA_T / FA_SUB; ++h) {
      const bf16* ks = S.k[buf] + h * FA_SUB * FA_LD;
      // s = q k^T and dp = do v^T of 16 rows x FA_SUB keys
      float s[FA_SUB / 8][4], dp[FA_SUB / 8][4];
      fa_zero(s);
      fa_zero(dp);
      fa_mma_abt(s, qa, ks);
      fa_mma_abt(dp, da, S.v[buf] + h * FA_SUB * FA_LD);
      // p = exp(s [+ ab] + the key's term - m) (1/l), ds = (dp - di) p;
      // d ab from the accumulators; ds's bf16 pairs are the A fragments
      // of ds.k
      uint32_t dsa[FA_SUB / 16][4];
#pragma unroll
      for (int n = 0; n < FA_SUB / 8; ++n) {
        const int c = h * FA_SUB + n * 8 + t4 * 2;  // key in the tile
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + g + r * 8;
          float x0 = s[n][2 * r], x1 = s[n][2 * r + 1];
          if (abh != nullptr) {
            const float2 b = fa_ab2(abh, row, j0 + c, Lq, Lk);
            x0 = __fadd_rn(x0, b.x);
            x1 = __fadd_rn(x1, b.y);
          }
          x0 = __fadd_rn(x0, S.kadd[buf][c]);
          x1 = __fadd_rn(x1, S.kadd[buf][c + 1]);
          const float p0 = __fmul_rn(expf(__fsub_rn(x0, mr[r])), linv[r]);
          const float p1 = __fmul_rn(expf(__fsub_rn(x1, mr[r])), linv[r]);
          const float d0 = __fmul_rn(__fsub_rn(dp[n][2 * r], dir[r]), p0);
          const float d1 = __fmul_rn(__fsub_rn(dp[n][2 * r + 1], dir[r]), p1);
          if (dabh != nullptr && row < Lq && j0 + c < Lk) {
            float* dst = dabh + (size_t)row * Lk + j0 + c;
            if ((Lk & 1) == 0) {
              *reinterpret_cast<float2*>(dst) = make_float2(d0, d1);
            } else {
              dst[0] = d0;
              if (j0 + c + 1 < Lk) dst[1] = d1;
            }
          }
          dsa[n >> 1][(n & 1) * 2 + r] = sv_pack_bf16(d0, d1);
        }
      }
      fa_mma_ab(dqa, dsa, ks);
    }
    __syncthreads();  // buffer buf is free for the load of tile t + 2
  }
  if (dabh != nullptr)  // d ab of the skipped pad keys
    for (int r = 0; r < 16 && row0 + r < Lq; ++r)
      for (int key = ntiles * FA_T + lane; key < Lk; key += 32)
        dabh[(size_t)(row0 + r) * Lk + key] = 0.f;
  fa_store_rows(dqa, S.q + warp * 16 * FA_LD, dq + (size_t)bh * Lq * FA_D, row0, Lq);
}

// ---------------------------------------------------------------------------
// Backward, launch 2 (dk, dv). Grid (ceil(Lk / 64), B*H); warp w owns keys
// 16w..16w+15 of the block's tile (lane (g, t): keys g and g + 8) and walks
// every query tile, FA_SUB query rows per product step.
// ---------------------------------------------------------------------------
struct FaDkvSmem {
  bf16 k[FA_T * FA_LD], v[FA_T * FA_LD];        // the block's keys; then dk, dv
  bf16 q[2][FA_T * FA_LD], dout[2][FA_T * FA_LD];  // double-buffered query tiles
  float m[2][FA_T], linv[2][FA_T], di[2][FA_T];  // per query row, 0 past Lq
  int last[FA_WARPS];
};

__global__ void __launch_bounds__(FA_THREADS, FA_BWD_MIN_BLOCKS)
fa_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const unsigned char* __restrict__ pad,
              const float* __restrict__ ab, const float* __restrict__ lin,
              const float* __restrict__ min_, const bf16* __restrict__ dout,
              const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int H, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  FaDkvSmem& S = *reinterpret_cast<FaDkvSmem*>(fa_smem);
  const int bh = blockIdx.y, k0 = blockIdx.x * FA_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qh = q + (size_t)bh * Lq * FA_D;
  const bf16* doh = dout + (size_t)bh * Lq * FA_D;
  const unsigned char* padb = pad ? pad + (size_t)(bh / H) * Lk : nullptr;
  const float* abh = ab ? ab + (size_t)bh * Lq * Lk : nullptr;
  bf16* dkh = dk + (size_t)bh * Lk * FA_D;
  bf16* dvh = dv + (size_t)bh * Lk * FA_D;

  // keys past the batch row's last valid key have p = 0 in every query
  // row: a block holding only such keys writes zeros
  if (k0 >= fa_kv_end(padb, Lk, S.last)) {
    for (int i = tid; i < FA_T * (FA_D / 8); i += FA_THREADS) {
      const int r = i >> 3, c8 = (i & 7) * 8;
      if (k0 + r < Lk) {
        *reinterpret_cast<uint4*>(dkh + (size_t)(k0 + r) * FA_D + c8) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dvh + (size_t)(k0 + r) * FA_D + c8) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  fa_cp_tile(S.k, k + (size_t)bh * Lk * FA_D, k0, Lk);
  fa_cp_tile(S.v, v + (size_t)bh * Lk * FA_D, k0, Lk);
  fa_cp_tile(S.q[0], qh, 0, Lq);
  fa_cp_tile(S.dout[0], doh, 0, Lq);
  sv_cp_commit();
  if (tid < FA_T) {  // the first query tile's row terms
    const bool ok = tid < Lq;
    S.m[0][tid] = ok ? min_[(size_t)bh * Lq + tid] : 0.f;
    S.linv[0][tid] = ok ? __fdiv_rn(1.f, lin[(size_t)bh * Lq + tid]) : 0.f;
    S.di[0][tid] = ok ? di[(size_t)bh * Lq + tid] : 0.f;
  }
  // keys g, g + 8 of the warp: 0, the pad mask, or -inf past Lk (p = 0)
  const int key0 = k0 + warp * 16;
  float kadd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + r * 8;
    kadd[r] = key >= Lk ? -INFINITY : (padb != nullptr && padb[key]) ? FA_MASK : 0.f;
  }
  const int ntiles = (Lq + FA_T - 1) / FA_T;

  uint32_t ka[FA_D / 16][4], va[FA_D / 16][4];  // A fragments of the warp's k, v
  float dka[FA_D / 8][4], dva[FA_D / 8][4];
  fa_zero(dka);
  fa_zero(dva);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, i0 = t * FA_T;
    // the next tile's rows load during this tile's products; its row terms
    // are read now and staged after them
    const int nrow = i0 + FA_T + tid;
    const bool nok = t + 1 < ntiles && tid < FA_T && nrow < Lq;
    float nm = 0.f, nl = 0.f, nd = 0.f;
    if (t + 1 < ntiles) {
      fa_cp_tile(S.q[buf ^ 1], qh, i0 + FA_T, Lq);
      fa_cp_tile(S.dout[buf ^ 1], doh, i0 + FA_T, Lq);
      sv_cp_commit();
      if (nok) {
        nm = min_[(size_t)bh * Lq + nrow];
        nl = lin[(size_t)bh * Lq + nrow];
        nd = di[(size_t)bh * Lq + nrow];
      }
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      fa_lda(ka, S.k + warp * 16 * FA_LD);
      fa_lda(va, S.v + warp * 16 * FA_LD);
    }
#pragma unroll
    for (int h = 0; h < FA_T / FA_SUB; ++h) {
      const bf16* qs = S.q[buf] + h * FA_SUB * FA_LD;
      const bf16* dos = S.dout[buf] + h * FA_SUB * FA_LD;
      // s^T = k q^T and dp^T = v do^T of 16 keys x FA_SUB queries
      float st[FA_SUB / 8][4], dpt[FA_SUB / 8][4];
      fa_zero(st);
      fa_zero(dpt);
      fa_mma_abt(st, ka, qs);
      fa_mma_abt(dpt, va, dos);
      // p^T and ds^T in place, the query's m, 1/l and di per column pair;
      // their bf16 pairs are the A fragments of p^T do and ds^T q
      uint32_t pa[FA_SUB / 16][4], dsa[FA_SUB / 16][4];
#pragma unroll
      for (int n = 0; n < FA_SUB / 8; ++n) {
        const int c = h * FA_SUB + n * 8 + t4 * 2;  // query in the tile
        const float2 mm = *reinterpret_cast<const float2*>(&S.m[buf][c]);
        const float2 li = *reinterpret_cast<const float2*>(&S.linv[buf][c]);
        const float2 dd = *reinterpret_cast<const float2*>(&S.di[buf][c]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = key0 + g + r * 8;
          float x0 = st[n][2 * r], x1 = st[n][2 * r + 1];
          if (abh != nullptr) {
            const int row = i0 + c;
            if (key < Lk) {
              if (row < Lq) x0 = __fadd_rn(x0, abh[(size_t)row * Lk + key]);
              if (row + 1 < Lq) x1 = __fadd_rn(x1, abh[(size_t)(row + 1) * Lk + key]);
            }
          }
          x0 = __fadd_rn(x0, kadd[r]);
          x1 = __fadd_rn(x1, kadd[r]);
          const float p0 = __fmul_rn(expf(__fsub_rn(x0, mm.x)), li.x);
          const float p1 = __fmul_rn(expf(__fsub_rn(x1, mm.y)), li.y);
          const float d0 = __fmul_rn(__fsub_rn(dpt[n][2 * r], dd.x), p0);
          const float d1 = __fmul_rn(__fsub_rn(dpt[n][2 * r + 1], dd.y), p1);
          pa[n >> 1][(n & 1) * 2 + r] = sv_pack_bf16(p0, p1);
          dsa[n >> 1][(n & 1) * 2 + r] = sv_pack_bf16(d0, d1);
        }
      }
      fa_mma_ab(dva, pa, dos);
      fa_mma_ab(dka, dsa, qs);
    }
    if (t + 1 < ntiles && tid < FA_T) {  // buf ^ 1 was last read before the previous barrier
      S.m[buf ^ 1][tid] = nm;
      S.linv[buf ^ 1][tid] = nok ? __fdiv_rn(1.f, nl) : 0.f;
      S.di[buf ^ 1][tid] = nd;
    }
    __syncthreads();  // buffer buf is free for the load of tile t + 2
  }
  fa_store_rows(dka, S.k + warp * 16 * FA_LD, dkh, key0, Lk);
  fa_store_rows(dva, S.v + warp * 16 * FA_LD, dvh, key0, Lk);
}

template <typename K>
static cudaError_t fa_smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int sv_flash_fwd(const void* q, const void* k, const void* v, const void* pad,
                            const float* ab, void* o, float* l, float* m, int BH, int H,
                            int Lq, int Lk, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(FaFwdSmem);
  cudaError_t e = fa_smem_attr(fa_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + FA_T - 1) / FA_T, BH);
  fa_fwd_kernel<<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(pad), ab, static_cast<bf16*>(o), l, m, H, Lq, Lk);
  return (int)cudaGetLastError();
}

// di (B*H*Lq floats) is written by launch 1 and read by launch 2
extern "C" int sv_flash_bwd(const void* q, const void* k, const void* v, const void* pad,
                            const float* ab, const float* l, const float* m, const void* o,
                            const void* dout, float* di, void* dq, void* dk, void* dv,
                            float* dab, int BH, int H, int Lq, int Lk, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  const auto* Q = static_cast<const bf16*>(q);
  const auto* Kp = static_cast<const bf16*>(k);
  const auto* V = static_cast<const bf16*>(v);
  const auto* P = static_cast<const unsigned char*>(pad);
  const auto* DO = static_cast<const bf16*>(dout);
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem = sizeof(FaDqSmem);
  cudaError_t e = fa_smem_attr(fa_dq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fa_dq_kernel<<<dim3((Lq + FA_T - 1) / FA_T, BH), FA_THREADS, smem, s>>>(
      Q, Kp, V, P, ab, l, m, static_cast<const bf16*>(o), DO, di, static_cast<bf16*>(dq), dab,
      H, Lq, Lk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  smem = sizeof(FaDkvSmem);
  e = fa_smem_attr(fa_dkv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fa_dkv_kernel<<<dim3((Lk + FA_T - 1) / FA_T, BH), FA_THREADS, smem, s>>>(
      Q, Kp, V, P, ab, l, m, DO, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq,
      Lk);
  return (int)cudaGetLastError();
}
