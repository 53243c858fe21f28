// Flash attention for Hopper (sm_90a): forward and backward at head width 64,
// with the numerics of the JAX library's TPU flash-attention kernels.
//
// Replaces (jax/experimental/pallas/ops/tpu/flash_attention.py, reached from
// sceneverse_tpu/ops/pallas/attention.py:105):
//   sv_flash_fwd  <- _flash_attention_kernel     (pallas_call :758)
//   sv_flash_bwd  <- _flash_attention_dkv_kernel (pallas_call :1121), launch 1
//                    _flash_attention_dq_kernel  (pallas_call :1456), launch 2
//
// Operands are (B*H, L, 64) bf16 rows (q pre-scaled by the wrapper); the
// optional bias ab is (B*H, Lq, Lk) f32 and the optional key-pad mask (B, Lk)
// bytes (1 = pad key, which gets s + MASK_VALUE as the library's segment
// mask adds). Keys past Lk take no part (the library pads to 128-multiples
// and masks its padding the same way). Every product has bf16 operands and
// f32 accumulation on tensor cores (nvcuda::wmma 16x16x16 fragments); the
// softmax and its derivative run in f32 with each operation rounded on its
// own (no FMA contraction), in the order of the plain twins in
// ops/attention.py. A block holds 64 rows of its own (query rows in the
// forward and dq passes, keys in the dk/dv pass) and walks tiles of 64 of
// the other; each of its 4 warps owns 16 of those rows, so every sum over
// the walked dimension stays in one warp's registers or shared memory: no
// float atomics, and two runs agree bit for bit.
// Bound at the GPS lengths (L <= 300): the q.k and p.v products; the design
// keeps every score, probability and ds tile out of device memory.
#include "common.cuh"
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int FA_D = 64;        // head width
constexpr int FA_T = 64;        // rows per tile
constexpr int FA_LD = FA_D + 8;  // bf16 row stride of a staged tile
constexpr int FA_WARPS = 4;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_WLD = 16 + 8;  // bf16 row stride of a warp's 64 x 16 slab
constexpr float FA_MASK = -0.7f * 3.4028234663852886e38f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FaA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FaAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FaB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FaBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FaC;

// rows [r0, r0 + 64) of one head's (L, 64) bf16 matrix -> shared [64][FA_LD],
// zero past L (16-byte loads)
__device__ __forceinline__ void fa_load_tile(const bf16* __restrict__ src, int r0, int L,
                                             bf16* dst) {
  for (int i = threadIdx.x; i < FA_T * (FA_D / 8); i += FA_THREADS) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * FA_D + c8);
    *reinterpret_cast<uint4*>(dst + r * FA_LD + c8) = v;
  }
}

// s [+ ab] + the pad mask, as the library forms the logits
__device__ __forceinline__ float fa_logit(float s, const float* __restrict__ ab,
                                          const unsigned char* __restrict__ pad, int row,
                                          int key, int Lk) {
  if (ab != nullptr) s = __fadd_rn(s, ab[(size_t)row * Lk + key]);
  if (pad != nullptr) s = __fadd_rn(s, pad[key] ? FA_MASK : 0.f);
  return s;
}

// acc (16 x 16) += a[16 x 64] (row-major, ld FA_LD) @ b^T, b rows n.. (ld FA_LD)
__device__ __forceinline__ void fa_mm_abt(FaC& acc, const bf16* a, const bf16* b) {
  FaA fa;
  FaBT fb;
#pragma unroll
  for (int k = 0; k < FA_D; k += 16) {
    wmma::load_matrix_sync(fa, a + k, FA_LD);
    wmma::load_matrix_sync(fb, b + k, FA_LD);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// ---------------------------------------------------------------------------
// Forward. Grid (ceil(Lq / 64), B*H); warp w owns query rows 16w..16w+15.
// ---------------------------------------------------------------------------
struct FaFwdSmem {
  bf16 q[FA_T * FA_LD], k[FA_T * FA_LD], v[FA_T * FA_LD];
  float s[FA_WARPS][16 * FA_T];  // scores, then the tile's p.v
  float o[FA_WARPS][16 * FA_D];  // running output
  bf16 p[FA_WARPS][16 * FA_LD];  // bf16 probabilities
};

__global__ void __launch_bounds__(FA_THREADS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const unsigned char* __restrict__ pad,
              const float* __restrict__ ab, bf16* __restrict__ o, float* __restrict__ lout,
              float* __restrict__ mout, int H, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  FaFwdSmem& S = *reinterpret_cast<FaFwdSmem*>(fa_smem);
  const int bh = blockIdx.y, q0 = blockIdx.x * FA_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qh = q + (size_t)bh * Lq * FA_D;
  const bf16* kh = k + (size_t)bh * Lk * FA_D;
  const bf16* vh = v + (size_t)bh * Lk * FA_D;
  const unsigned char* padb = pad ? pad + (size_t)(bh / H) * Lk : nullptr;
  const float* abh = ab ? ab + (size_t)bh * Lq * Lk : nullptr;

  fa_load_tile(qh, q0, Lq, S.q);
  float* sw = S.s[warp];
  float* ow = S.o[warp];
  bf16* pw = S.p[warp];
  for (int i = lane; i < 16 * FA_D; i += 32) ow[i] = 0.f;
  // the warp walks its 16 rows; lane owns columns lane and lane + 32, so
  // shared memory is read without bank conflicts and ab rows coalesce.
  // Each lane keeps every row's running max and sum (the same in all lanes)
  const int row0 = q0 + warp * 16;
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int j0 = 0; j0 < Lk; j0 += FA_T) {
    __syncthreads();  // the previous tile's K, V are no longer read
    fa_load_tile(kh, j0, Lk, S.k);
    fa_load_tile(vh, j0, Lk, S.v);
    __syncthreads();
#pragma unroll
    for (int ct = 0; ct < FA_T / 16; ++ct) {
      FaC acc;
      wmma::fill_fragment(acc, 0.f);
      fa_mm_abt(acc, S.q + warp * 16 * FA_LD, S.k + ct * 16 * FA_LD);
      wmma::store_matrix_sync(sw + ct * 16, acc, FA_T, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const float* abr = row < Lq ? abh : nullptr;
      float x[2], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, key = j0 + c;
        x[j] = key < Lk ? fa_logit(sw[r * FA_T + c], abr, padb, row, key, Lk) : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m[r], sv_warp_max(mx));
      const float alpha = expf(__fsub_rn(m[r], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const float p = j0 + c < Lk ? expf(__fsub_rn(x[j], m_new)) : 0.f;
        sum = __fadd_rn(sum, p);
        pw[r * FA_LD + c] = __float2bfloat16_rn(p);
        ow[r * FA_D + c] = __fmul_rn(ow[r * FA_D + c], alpha);
      }
      l[r] = __fadd_rn(__fmul_rn(alpha, l[r]), sv_warp_sum(sum));
      m[r] = m_new;
    }
    __syncwarp();
    // the tile's bf16(p) @ v into the score scratch, then o += it
#pragma unroll
    for (int dt = 0; dt < FA_D / 16; ++dt) {
      FaC acc;
      wmma::fill_fragment(acc, 0.f);
      FaA fa;
      FaB fb;
#pragma unroll
      for (int kk = 0; kk < FA_T; kk += 16) {
        wmma::load_matrix_sync(fa, pw + kk, FA_LD);
        wmma::load_matrix_sync(fb, S.v + kk * FA_LD + dt * 16, FA_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sw + dt * 16, acc, FA_D, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * FA_D; e += 32) ow[e] = __fadd_rn(ow[e], sw[e]);
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    if (row >= Lq) break;
    bf16* orow = o + ((size_t)bh * Lq + row) * FA_D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      orow[c] = __float2bfloat16_rn(__fdiv_rn(ow[r * FA_D + c], l[r]));
    }
    if (lane == 0) {
      lout[(size_t)bh * Lq + row] = l[r];
      mout[(size_t)bh * Lq + row] = m[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, launch 1 (dk, dv). Grid (ceil(Lk / 64), B*H); warp w owns keys
// 16w..16w+15 of the block's tile and walks every query tile.
// ---------------------------------------------------------------------------
// a warp's 16 x 64 f32 result (4 fragments) -> rows key0.. of dst in bf16,
// through the warp's scratch (1024 floats)
__device__ __forceinline__ void fa_store_keys(const FaC (&acc)[FA_D / 16], float* scr,
                                              bf16* __restrict__ dst, int key0, int Lk,
                                              int lane) {
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < FA_D / 16; ++dt)
    wmma::store_matrix_sync(scr + dt * 16, acc[dt], FA_D, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * FA_D; e += 32) {
    const int key = key0 + (e >> 6);
    if (key < Lk) dst[(size_t)key * FA_D + (e & 63)] = __float2bfloat16_rn(scr[e]);
  }
}

struct FaDkvSmem {
  bf16 k[FA_T * FA_LD], v[FA_T * FA_LD], q[FA_T * FA_LD], dout[FA_T * FA_LD];
  float m[FA_T], linv[FA_T], di[FA_T];
  float s[FA_WARPS][FA_T * 16];   // scores of (query rows, the warp's keys)
  float dp[FA_WARPS][FA_T * 16];  // do . v^T
  bf16 p[FA_WARPS][FA_T * FA_WLD], ds[FA_WARPS][FA_T * FA_WLD];
};

__global__ void __launch_bounds__(FA_THREADS)
fa_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const unsigned char* __restrict__ pad,
              const float* __restrict__ ab, const float* __restrict__ lin,
              const float* __restrict__ min_, const bf16* __restrict__ dout,
              const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int H, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  FaDkvSmem& S = *reinterpret_cast<FaDkvSmem*>(fa_smem);
  const int bh = blockIdx.y, k0 = blockIdx.x * FA_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qh = q + (size_t)bh * Lq * FA_D;
  const bf16* doh = dout + (size_t)bh * Lq * FA_D;
  const unsigned char* padb = pad ? pad + (size_t)(bh / H) * Lk : nullptr;
  const float* abh = ab ? ab + (size_t)bh * Lq * Lk : nullptr;
  fa_load_tile(k + (size_t)bh * Lk * FA_D, k0, Lk, S.k);
  fa_load_tile(v + (size_t)bh * Lk * FA_D, k0, Lk, S.v);
  float* sw = S.s[warp];
  float* dpw = S.dp[warp];
  bf16* pw = S.p[warp];
  bf16* dsw = S.ds[warp];
  FaC dk_acc[FA_D / 16], dv_acc[FA_D / 16];
#pragma unroll
  for (int t = 0; t < FA_D / 16; ++t) {
    wmma::fill_fragment(dk_acc[t], 0.f);
    wmma::fill_fragment(dv_acc[t], 0.f);
  }
  for (int q0 = 0; q0 < Lq; q0 += FA_T) {
    __syncthreads();
    fa_load_tile(qh, q0, Lq, S.q);
    fa_load_tile(doh, q0, Lq, S.dout);
    for (int i = threadIdx.x; i < FA_T; i += FA_THREADS) {
      const int row = q0 + i;
      const bool ok = row < Lq;
      S.m[i] = ok ? min_[(size_t)bh * Lq + row] : 0.f;
      S.linv[i] = ok ? __fdiv_rn(1.f, lin[(size_t)bh * Lq + row]) : 0.f;
      S.di[i] = ok ? di[(size_t)bh * Lq + row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rt = 0; rt < FA_T / 16; ++rt) {
      FaC acc;
      wmma::fill_fragment(acc, 0.f);
      fa_mm_abt(acc, S.q + rt * 16 * FA_LD, S.k + warp * 16 * FA_LD);
      wmma::store_matrix_sync(sw + rt * 16 * 16, acc, 16, wmma::mem_row_major);
      wmma::fill_fragment(acc, 0.f);
      fa_mm_abt(acc, S.dout + rt * 16 * FA_LD, S.v + warp * 16 * FA_LD);
      wmma::store_matrix_sync(dpw + rt * 16 * 16, acc, 16, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < FA_T * 16; e += 32) {
      const int rr = e >> 4, c = e & 15, row = q0 + rr, key = k0 + warp * 16 + c;
      float p = 0.f, ds = 0.f;
      if (row < Lq && key < Lk) {
        const float s = fa_logit(sw[e], abh, padb, row, key, Lk);
        p = __fmul_rn(expf(__fsub_rn(s, S.m[rr])), S.linv[rr]);
        ds = __fmul_rn(__fsub_rn(dpw[e], S.di[rr]), p);
      }
      pw[rr * FA_WLD + c] = __float2bfloat16_rn(p);
      dsw[rr * FA_WLD + c] = __float2bfloat16_rn(ds);
    }
    __syncwarp();
    // dv += bf16(p)^T do, dk += bf16(ds)^T q over the tile's 64 query rows
#pragma unroll
    for (int kk = 0; kk < FA_T; kk += 16) {
      FaAT fp, fds;
      wmma::load_matrix_sync(fp, pw + kk * FA_WLD, FA_WLD);
      wmma::load_matrix_sync(fds, dsw + kk * FA_WLD, FA_WLD);
#pragma unroll
      for (int dt = 0; dt < FA_D / 16; ++dt) {
        FaB fb;
        wmma::load_matrix_sync(fb, S.dout + kk * FA_LD + dt * 16, FA_LD);
        wmma::mma_sync(dv_acc[dt], fp, fb, dv_acc[dt]);
        wmma::load_matrix_sync(fb, S.q + kk * FA_LD + dt * 16, FA_LD);
        wmma::mma_sync(dk_acc[dt], fds, fb, dk_acc[dt]);
      }
    }
  }
  // the warp's 16 keys: dk, dv through the score scratch, rounded to bf16
  const int key0 = k0 + warp * 16;
  fa_store_keys(dk_acc, sw, dk + (size_t)bh * Lk * FA_D, key0, Lk, lane);
  fa_store_keys(dv_acc, sw, dv + (size_t)bh * Lk * FA_D, key0, Lk, lane);
}

// ---------------------------------------------------------------------------
// Backward, launch 2 (dq, d ab). Grid (ceil(Lq / 64), B*H); warp w owns query
// rows 16w..16w+15 and walks every key tile.
// ---------------------------------------------------------------------------
struct FaDqSmem {
  bf16 q[FA_T * FA_LD], dout[FA_T * FA_LD], k[FA_T * FA_LD], v[FA_T * FA_LD];
  float s[FA_WARPS][16 * FA_T], dp[FA_WARPS][16 * FA_T];
  bf16 ds[FA_WARPS][16 * FA_LD];
};

__global__ void __launch_bounds__(FA_THREADS)
fa_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const unsigned char* __restrict__ pad,
             const float* __restrict__ ab, const float* __restrict__ lin,
             const float* __restrict__ min_, const bf16* __restrict__ dout,
             const float* __restrict__ di, bf16* __restrict__ dq, float* __restrict__ dab,
             int H, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  FaDqSmem& S = *reinterpret_cast<FaDqSmem*>(fa_smem);
  const int bh = blockIdx.y, q0 = blockIdx.x * FA_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kh = k + (size_t)bh * Lk * FA_D;
  const bf16* vh = v + (size_t)bh * Lk * FA_D;
  const unsigned char* padb = pad ? pad + (size_t)(bh / H) * Lk : nullptr;
  const float* abh = ab ? ab + (size_t)bh * Lq * Lk : nullptr;
  float* dabh = dab ? dab + (size_t)bh * Lq * Lk : nullptr;
  fa_load_tile(q + (size_t)bh * Lq * FA_D, q0, Lq, S.q);
  fa_load_tile(dout + (size_t)bh * Lq * FA_D, q0, Lq, S.dout);
  float* sw = S.s[warp];
  float* dpw = S.dp[warp];
  bf16* dsw = S.ds[warp];
  // the warp walks its 16 rows, lane owning keys lane and lane + 32 of a
  // tile; every lane keeps the 16 rows' m, 1/l and di
  const int row0 = q0 + warp * 16;
  float mr[16], linv[16], dir[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const bool ok = row0 + r < Lq;
    const size_t i = (size_t)bh * Lq + row0 + r;
    mr[r] = ok ? min_[i] : 0.f;
    linv[r] = ok ? __fdiv_rn(1.f, lin[i]) : 0.f;
    dir[r] = ok ? di[i] : 0.f;
  }
  FaC dq_acc[FA_D / 16];
#pragma unroll
  for (int t = 0; t < FA_D / 16; ++t) wmma::fill_fragment(dq_acc[t], 0.f);
  for (int j0 = 0; j0 < Lk; j0 += FA_T) {
    __syncthreads();
    fa_load_tile(kh, j0, Lk, S.k);
    fa_load_tile(vh, j0, Lk, S.v);
    __syncthreads();
#pragma unroll
    for (int ct = 0; ct < FA_T / 16; ++ct) {
      FaC acc;
      wmma::fill_fragment(acc, 0.f);
      fa_mm_abt(acc, S.q + warp * 16 * FA_LD, S.k + ct * 16 * FA_LD);
      wmma::store_matrix_sync(sw + ct * 16, acc, FA_T, wmma::mem_row_major);
      wmma::fill_fragment(acc, 0.f);
      fa_mm_abt(acc, S.dout + warp * 16 * FA_LD, S.v + ct * 16 * FA_LD);
      wmma::store_matrix_sync(dpw + ct * 16, acc, FA_T, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, key = j0 + c;
        float ds = 0.f;
        if (row < Lq && key < Lk) {
          const float s = fa_logit(sw[r * FA_T + c], abh, padb, row, key, Lk);
          const float p = __fmul_rn(expf(__fsub_rn(s, mr[r])), linv[r]);
          ds = __fmul_rn(__fsub_rn(dpw[r * FA_T + c], dir[r]), p);
          if (dabh != nullptr) dabh[(size_t)row * Lk + key] = ds;
        }
        dsw[r * FA_LD + c] = __float2bfloat16_rn(ds);
      }
    }
    __syncwarp();
    // dq += bf16(ds) k over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < FA_T; kk += 16) {
      FaA fa;
      wmma::load_matrix_sync(fa, dsw + kk, FA_LD);
#pragma unroll
      for (int dt = 0; dt < FA_D / 16; ++dt) {
        FaB fb;
        wmma::load_matrix_sync(fb, S.k + kk * FA_LD + dt * 16, FA_LD);
        wmma::mma_sync(dq_acc[dt], fa, fb, dq_acc[dt]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < FA_D / 16; ++dt)
    wmma::store_matrix_sync(sw + dt * 16, dq_acc[dt], FA_D, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * FA_D; e += 32) {
    const int row = row0 + (e >> 6);
    if (row < Lq) dq[((size_t)bh * Lq + row) * FA_D + (e & 63)] = __float2bfloat16_rn(sw[e]);
  }
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

extern "C" int sv_flash_bwd(const void* q, const void* k, const void* v, const void* pad,
                            const float* ab, const float* l, const float* m, const void* dout,
                            const float* di, void* dq, void* dk, void* dv, float* dab, int BH,
                            int H, int Lq, int Lk, void* stream) {
  if (BH < 1 || Lq < 1 || Lk < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
  const auto* Q = static_cast<const bf16*>(q);
  const auto* Kp = static_cast<const bf16*>(k);
  const auto* V = static_cast<const bf16*>(v);
  const auto* P = static_cast<const unsigned char*>(pad);
  const auto* DO = static_cast<const bf16*>(dout);
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem = sizeof(FaDkvSmem);
  cudaError_t e = fa_smem_attr(fa_dkv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fa_dkv_kernel<<<dim3((Lk + FA_T - 1) / FA_T, BH), FA_THREADS, smem, s>>>(
      Q, Kp, V, P, ab, l, m, DO, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq,
      Lk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  smem = sizeof(FaDqSmem);
  e = fa_smem_attr(fa_dq_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fa_dq_kernel<<<dim3((Lq + FA_T - 1) / FA_T, BH), FA_THREADS, smem, s>>>(
      Q, Kp, V, P, ab, l, m, DO, di, static_cast<bf16*>(dq), dab, H, Lq, Lk);
  return (int)cudaGetLastError();
}
