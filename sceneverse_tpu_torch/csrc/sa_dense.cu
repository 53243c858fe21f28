// Dense SA2 stage for Hopper (sm_90a): every (center, point) pair of an
// object through the 3-layer folded MLP, then a masked max over the points.
//
// Replaces the TPU kernel _kernel_dense_batched of
// sceneverse_tpu/ops/pallas/sa_forward.py (:98, pallas_call :662), the
// SCENEVERSE_SA2_BATCHED route of the frozen SA2 level. One block per
// object, 8 warps:
//   1. the object's points go to shared memory; the per-point projection
//      pw = bf16(bf16(p) @ w1) and the centering term cw = bf16(c) @ w1[:3]
//      (f32 accumulation, CUDA cores), the in-ball mask (strict d2 < r^2)
//      and each center's in-ball count;
//   2. the m*N pair rows (r = c*N + p, no compaction) run in tiles of TM
//      rows: h1 = bf16(relu(a1 * (pw - cw) + b1)) to shared memory, then
//      layers 2 and 3 on tensor cores (nvcuda::wmma bf16 16x16x16
//      fragments, f32 accumulation, weights read as fragments from device
//      memory, where they stay in L2) with h2 rounded to bf16 between them;
//   3. the pool: the max of the post-ReLU f32 h3 over the in-ball points
//      (atomicMax on the bits of non-negative floats in shared memory: the
//      max does not depend on the order), an empty ball takes pair (c, 0).
// Every affine is u * a + b without FMA contraction, as in the plain twin.
// Bound: the bf16 products (1.3e11 operations at SA2 of the GPS slice).
#include "common.cuh"
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int SD_WARPS = 8;
constexpr int SD_THREADS = SD_WARPS * 32;
constexpr int SD_TM = 64;  // pair rows per tile
constexpr int SD_PAD = 8;  // bf16 padding per shared-memory row

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> SdFragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> SdFragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> SdFragC;

struct SdPlan {
  int pts, pw, cw, win, cnt, pool, h1, h2, scr, total;
};

__host__ __device__ inline int sd_align(int b) { return (b + 127) & ~127; }

// Shared-memory plan (byte offsets), the same on host and device.
__host__ __device__ inline SdPlan sd_plan(int N, int C, int m, int H1, int H2, int H3) {
  SdPlan s;
  int off = 0;
  s.pts = off;  off += sd_align(N * C * 4);
  s.pw = off;   off += sd_align(N * H1 * 4);
  s.cw = off;   off += sd_align(m * H1 * 4);
  s.win = off;  off += sd_align(m * N * 4);
  s.cnt = off;  off += sd_align(m * 4);
  s.pool = off; off += sd_align(m * H3 * 4);
  s.h1 = off;   off += sd_align(SD_TM * (H1 + SD_PAD) * 2);
  s.h2 = off;   off += sd_align(SD_TM * (H2 + SD_PAD) * 2);
  s.scr = off;  off += sd_align(SD_WARPS * 256 * 4);
  s.total = off;
  return s;
}

__device__ __forceinline__ float sd_affine(float u, float a, float b) {
  return __fadd_rn(__fmul_rn(u, a), b);
}

__global__ void __launch_bounds__(SD_THREADS)
sv_sa_dense_kernel(const float* __restrict__ pts, const float* __restrict__ centers,
                   const bf16* __restrict__ w1, const float* __restrict__ a1,
                   const float* __restrict__ b1,
                   const bf16* __restrict__ w2, const float* __restrict__ a2,
                   const float* __restrict__ b2,
                   const bf16* __restrict__ w3, const float* __restrict__ a3,
                   const float* __restrict__ b3,
                   float* __restrict__ pooled, int N, int C, int m, int H1, int H2,
                   int H3, float r2) {
  extern __shared__ __align__(128) unsigned char sd_smem[];
  const SdPlan P = sd_plan(N, C, m, H1, H2, H3);
  float* ptsS = reinterpret_cast<float*>(sd_smem + P.pts);
  float* pwS = reinterpret_cast<float*>(sd_smem + P.pw);
  float* cwS = reinterpret_cast<float*>(sd_smem + P.cw);
  int* winS = reinterpret_cast<int*>(sd_smem + P.win);
  int* cntS = reinterpret_cast<int*>(sd_smem + P.cnt);
  unsigned* poolS = reinterpret_cast<unsigned*>(sd_smem + P.pool);
  bf16* h1S = reinterpret_cast<bf16*>(sd_smem + P.h1);
  bf16* h2S = reinterpret_cast<bf16*>(sd_smem + P.h2);
  float* scr = reinterpret_cast<float*>(sd_smem + P.scr);

  const int g = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* Pg = pts + (size_t)g * N * C;
  const float* Cg = centers + (size_t)g * m * 3;
  const int ld1 = H1 + SD_PAD, ld2 = H2 + SD_PAD;

  for (int i = tid; i < N * C; i += SD_THREADS) ptsS[i] = Pg[i];
  for (int i = tid; i < m * H3; i += SD_THREADS) poolS[i] = 0u;
  // centering term of layer 1: bf16(center) @ w1[:3], f32
  for (int i = tid; i < m * H1; i += SD_THREADS) {
    const int c = i / H1, j = i - c * H1;
    float acc = __fmul_rn(sv_bf16r(Cg[c * 3 + 0]), __bfloat162float(w1[0 * H1 + j]));
    acc = __fadd_rn(acc, __fmul_rn(sv_bf16r(Cg[c * 3 + 1]), __bfloat162float(w1[1 * H1 + j])));
    acc = __fadd_rn(acc, __fmul_rn(sv_bf16r(Cg[c * 3 + 2]), __bfloat162float(w1[2 * H1 + j])));
    cwS[i] = acc;
  }
  __syncthreads();
  // per-point projection bf16(bf16(p) @ w1) and the in-ball mask
  for (int i = tid; i < N * H1; i += SD_THREADS) {
    const int p = i / H1, j = i - p * H1;
    const float* row = ptsS + p * C;
    float acc = 0.f;
    for (int k = 0; k < C; ++k)
      acc = fmaf(sv_bf16r(row[k]), __bfloat162float(w1[k * H1 + j]), acc);
    pwS[i] = sv_bf16r(acc);
  }
  for (int i = tid; i < m * N; i += SD_THREADS) {
    const int c = i / N, p = i - c * N;
    const float* q = ptsS + p * C;
    winS[i] = sv_sq3(q[0] - Cg[c * 3], q[1] - Cg[c * 3 + 1], q[2] - Cg[c * 3 + 2]) < r2;
  }
  __syncthreads();
  for (int c = tid; c < m; c += SD_THREADS) {
    int n = 0;
    for (int p = 0; p < N; ++p) n += winS[c * N + p];
    cntS[c] = n;
  }
  __syncthreads();

  const int R = m * N;
  float* ws = scr + warp * 256;
  for (int r0 = 0; r0 < R; r0 += SD_TM) {
    // layer 1 (w1-fold): h1 = bf16(relu(a1 * (pw - cw) + b1)), rows past R zero
    for (int i = tid; i < SD_TM * H1; i += SD_THREADS) {
      const int rr = i / H1, j = i - rr * H1, r = r0 + rr;
      float v = 0.f;
      if (r < R) {
        const int c = r / N, p = r - c * N;
        v = sd_affine(__fsub_rn(pwS[p * H1 + j], cwS[c * H1 + j]), a1[j], b1[j]);
        v = fmaxf(v, 0.f);
      }
      h1S[rr * ld1 + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    // layer 2: h2 = bf16(relu(h1 @ w2 * a2 + b2))
    {
      const int nc = H2 / 16, nt = (SD_TM / 16) * nc;
      for (int t = warp; t < nt; t += SD_WARPS) {
        const int rt = t / nc, ct = t - rt * nc;
        SdFragC acc;
        wmma::fill_fragment(acc, 0.f);
        SdFragA fa;
        SdFragB fb;
        for (int k = 0; k < H1; k += 16) {
          wmma::load_matrix_sync(fa, h1S + rt * 16 * ld1 + k, ld1);
          wmma::load_matrix_sync(fb, w2 + (size_t)k * H2 + ct * 16, H2);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(ws, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = rt * 16 + (e >> 4), col = ct * 16 + (e & 15);
          const float h = fmaxf(sd_affine(ws[e], a2[col], b2[col]), 0.f);
          h2S[rr * ld2 + col] = __float2bfloat16_rn(h);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // layer 3: h3 = relu(h2 @ w3 * a3 + b3) (f32), pooled over in-ball points
    {
      const int nc = H3 / 16, nt = (SD_TM / 16) * nc;
      for (int t = warp; t < nt; t += SD_WARPS) {
        const int rt = t / nc, ct = t - rt * nc;
        SdFragC acc;
        wmma::fill_fragment(acc, 0.f);
        SdFragA fa;
        SdFragB fb;
        for (int k = 0; k < H2; k += 16) {
          wmma::load_matrix_sync(fa, h2S + rt * 16 * ld2 + k, ld2);
          wmma::load_matrix_sync(fb, w3 + (size_t)k * H3 + ct * 16, H3);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(ws, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = r0 + rt * 16 + (e >> 4), col = ct * 16 + (e & 15);
          if (r >= R) continue;
          const int c = r / N, p = r - c * N;
          const float h = fmaxf(sd_affine(ws[e], a3[col], b3[col]), 0.f) + 0.f;
          if (winS[c * N + p])
            atomicMax(&poolS[c * H3 + col], __float_as_uint(h));
          else if (p == 0 && cntS[c] == 0)
            poolS[c * H3 + col] = __float_as_uint(h);  // empty ball: pair (c, 0)
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  float* out = pooled + (size_t)g * m * H3;
  for (int i = tid; i < m * H3; i += SD_THREADS) out[i] = __uint_as_float(poolS[i]);
}

extern "C" int sv_sa_dense_smem(int N, int C, int m, int h1, int h2, int h3) {
  return sd_plan(N, C, m, h1, h2, h3).total;
}

extern "C" int sv_sa_dense_pool(const float* pts, const float* centers, const void* w1,
                                const float* a1, const float* b1, const void* w2,
                                const float* a2, const float* b2, const void* w3,
                                const float* a3, const float* b3, float* pooled, int G,
                                int N, int C, int m, int h1, int h2, int h3, float r2,
                                void* stream) {
  if (h1 % 16 || h2 % 16 || h3 % 16 || G < 1) return (int)cudaErrorInvalidValue;
  const int smem = sd_plan(N, C, m, h1, h2, h3).total;
  cudaError_t e = cudaFuncSetAttribute(sv_sa_dense_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sv_sa_dense_kernel<<<G, SD_THREADS, smem, (cudaStream_t)stream>>>(
      pts, centers, static_cast<const bf16*>(w1), a1, b1, static_cast<const bf16*>(w2), a2,
      b2, static_cast<const bf16*>(w3), a3, b3, pooled, N, C, m, h1, h2, h3, r2);
  return (int)cudaGetLastError();
}
