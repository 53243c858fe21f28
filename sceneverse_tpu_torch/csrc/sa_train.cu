// Trainable fused set abstraction for Hopper (sm_90a): 3 x (1x1 conv ->
// train-mode BatchNorm folded to u * a + b -> ReLU) + max-pool over grouped
// rows, forward and backward, with the activations kept on chip.
//
// Replaces the four Pallas kernels of sceneverse_tpu/ops/pallas/sa_train.py:
//   mode 0 sa_stats      _stats_kernel      (:103): sum and Gram of bf16(h_upto)
//   mode 1 sa_pool       _pool_kernel       (:210): max / first argmax of f32 h3
//   mode 2 sa_stats_bwd  _stats_bwd_kernel  (:184): dh = dS + h (dG + dG^T), back
//   mode 3 sa_pool_bwd   _pool_bwd_kernel   (:232): d_pooled to the argmax slot, back
//
// Every product has bf16 operands and f32 accumulation (nvcuda::wmma
// 16x16x16 tensor-core fragments); h = relu(u * a + b) in f32 without FMA
// contraction, rounded to bf16 for the next layer and the moments, as the
// TPU kernels and the plain twins in ops/sa_train.py do. A block walks row
// tiles of TM rows (whole centers for the pool): the tile's rows go to
// shared memory as bf16, the chain is recomputed there, the weights are read
// from device memory (L2). Sums, Gram, dW, da and db go to a partial slot
// owned by the block; st_reduce_kernel, launched next from this file, sums
// the slots in a fixed order. No float atomics, so two runs are
// bit-identical. Bound: the bf16 products (tensor cores) at the GPS widths;
// wgmma / TMA and register-resident weight-gradient sums are later work.
#include "common.cuh"
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int ST_WARPS = 8;
constexpr int ST_THREADS = ST_WARPS * 32;
constexpr int ST_PAD = 8;  // bf16 elements of padding per shared-memory row

enum { M_STATS = 0, M_POOL = 1, M_STATS_BWD = 2, M_POOL_BWD = 3 };

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// one layer: W (k, h) row-major bf16, k the (padded) input width
struct StLayer {
  const bf16* w;
  const float* a;
  const float* b;
  int k, h;
};

struct StArgs {
  const float* x;  // grouped rows, (R, C) row-major f32
  int mode, R, C, K1, upto, ns, need_dx, TM, nl;  // nl: layers of the chain
  StLayer L[3];
  float* psum;            // stats: [P][TM/16][H] row-group sums
  float* pgram;           // stats: [P][H][H]
  float* pooled;          // pool: [R/ns][H3]
  int* arg;               // pool: [R/ns][H3] slot
  const bf16* dsym;       // stats bwd: bf16(dG + dG^T) [H][H]
  const float* dS;        // stats bwd: [H]
  const float* dpool;     // pool bwd: [R/ns][H3]
  const int* argin;       // pool bwd: [R/ns][H3]
  float* dx;              // bwd: [R][C] or null
  float* pdw;             // bwd: [P][dwlen] (dW1 | dW2 | dW3)
  float* pds;             // bwd: [P][TM/16][dslen] (da1 db1 | da2 db2 | ...)
  int dwlen, dslen;
};

struct StSmem {
  int x, h[3], du[2], scr, pmax, parg, total;
};

__host__ __device__ inline int st_align(int b) { return (b + 127) & ~127; }

// Shared-memory plan, the same on host and device (byte offsets).
__host__ __device__ inline StSmem st_smem(int mode, int K1, int upto, const int* H, int TM) {
  const bool pool = mode == M_POOL || mode == M_POOL_BWD;
  const int nl = pool ? 3 : upto;
  const int nh = pool ? 2 : upto;  // layers whose bf16 h stays in shared memory
  StSmem s;
  int off = 0;
  s.x = off;
  off += st_align(TM * (K1 + ST_PAD) * 2);
  for (int j = 0; j < 3; ++j) {
    s.h[j] = off;
    if (j < nh) off += st_align(TM * (H[j] + ST_PAD) * 2);
  }
  int hmax = 0;
  for (int j = 0; j < nl; ++j) hmax = H[j] > hmax ? H[j] : hmax;
  for (int i = 0; i < 2; ++i) {
    s.du[i] = off;
    if (mode >= M_STATS_BWD) off += st_align(TM * (hmax + ST_PAD) * 2);
  }
  s.scr = off;
  off += st_align(ST_WARPS * 512 * 4);
  s.pmax = s.parg = off;
  if (mode == M_POOL) {
    off += st_align((TM / 16) * H[2] * 4);
    s.parg = off;
    off += st_align((TM / 16) * H[2] * 4);
  }
  s.total = off;
  return s;
}

// acc += a[16 x K] (shared, row-major) @ b[K x 16] (row-major, ld ldb)
__device__ __forceinline__ void st_mm(FragC& acc, const bf16* a, int lda, const bf16* b,
                                      int ldb, int K) {
  FragA fa;
  FragB fb;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, b + (size_t)k * ldb, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// acc += a[16 x K] @ W^T, W row-major with rows n..n+15 at wt (ld ldw)
__device__ __forceinline__ void st_mm_t(FragC& acc, const bf16* a, int lda, const bf16* wt,
                                        int ldw, int K) {
  FragA fa;
  FragBT fb;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, wt + k, ldw);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// dst[16 x 16] (global f32, ld) = (first ? 0 : dst) + p^T q over TM rows
__device__ __forceinline__ void st_acc_tile(float* dst, int ld, bool first, const bf16* p,
                                            int ldp, const bf16* q, int ldq, int TM) {
  FragC acc;
  if (first)
    wmma::fill_fragment(acc, 0.f);
  else
    wmma::load_matrix_sync(acc, dst, ld, wmma::mem_row_major);
  FragAT fa;
  FragB fb;
  for (int k = 0; k < TM; k += 16) {
    wmma::load_matrix_sync(fa, p + (size_t)k * ldp, ldp);
    wmma::load_matrix_sync(fb, q + (size_t)k * ldq, ldq);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(dst, acc, ld, wmma::mem_row_major);
}

__device__ __forceinline__ float st_affine(float u, float a, float b) {
  return __fadd_rn(__fmul_rn(u, a), b);
}

// rows r0.. of x (f32, R x C) -> bf16 shared [TM][K1 + PAD], zero padded
__device__ void st_load_x(const StArgs& A, int r0, bf16* xs) {
  const int ld = A.K1 + ST_PAD;
  for (int i = threadIdx.x; i < A.TM * A.K1; i += ST_THREADS) {
    const int r = i / A.K1, c = i - r * A.K1;
    float v = 0.f;
    if (c < A.C && r0 + r < A.R) v = A.x[(size_t)(r0 + r) * A.C + c];
    xs[r * ld + c] = __float2bfloat16_rn(v);
  }
}

enum { EPI_STORE = 0, EPI_STATS = 1, EPI_POOL = 2 };

// One forward layer over the row tile: h = relu(in @ W * a + b).
//   EPI_STORE  bf16 h to out;
//   EPI_STATS  bf16 h to out (rows past R zeroed) and each 16-row group's
//              column sums into psum_blk (the block's slot);
//   EPI_POOL   each 16-row group's max of the f32 h and its first row.
__device__ void st_fwd_layer(const StArgs& A, const StLayer& L, const bf16* in, int ldin,
                             bf16* out, int ldout, float* scr, int epi, int r0,
                             float* psum_blk, bool first, float* pmax, int* parg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = L.h / 16, ntile = (A.TM / 16) * nc;
  float* ws = scr + warp * 512;
  for (int t = warp; t < ntile; t += ST_WARPS) {
    const int r = t / nc, c = t - r * nc;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    st_mm(acc, in + r * 16 * ldin, ldin, L.w + c * 16, L.h, L.k);
    wmma::store_matrix_sync(ws, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e >> 4, col = c * 16 + (e & 15);
      float h = fmaxf(st_affine(ws[e], L.a[col], L.b[col]), 0.f);
      if (epi == EPI_POOL) {
        ws[e] = h;
        continue;
      }
      if (epi == EPI_STATS && r0 + r * 16 + rr >= A.R) h = 0.f;
      out[(r * 16 + rr) * ldout + col] = __float2bfloat16_rn(h);
    }
    __syncwarp();
    if (lane < 16) {
      const int col = c * 16 + lane;
      if (epi == EPI_STATS) {
        float s = 0.f;
        for (int i = 0; i < 16; ++i) s += __bfloat162float(out[(r * 16 + i) * ldout + col]);
        float* d = psum_blk + r * L.h + col;
        *d = first ? s : *d + s;
      } else if (epi == EPI_POOL) {
        float best = ws[lane];
        int bi = 0;
        for (int i = 1; i < 16; ++i) {
          const float v = ws[i * 16 + lane];
          if (v > best) {
            best = v;
            bi = i;
          }
        }
        pmax[r * L.h + col] = best;
        parg[r * L.h + col] = r * 16 + bi;
      }
    }
    __syncwarp();
  }
}

// modes 0 and 1
__global__ void __launch_bounds__(ST_THREADS) st_fwd_kernel(StArgs A) {
  extern __shared__ __align__(128) unsigned char st_sm[];
  const int H[3] = {A.L[0].h, A.L[1].h, A.L[2].h};
  const StSmem S = st_smem(A.mode, A.K1, A.upto, H, A.TM);
  bf16* xs = reinterpret_cast<bf16*>(st_sm + S.x);
  float* scr = reinterpret_cast<float*>(st_sm + S.scr);
  float* pmax = reinterpret_cast<float*>(st_sm + S.pmax);
  int* parg = reinterpret_cast<int*>(st_sm + S.parg);
  const int warp = threadIdx.x >> 5;
  const int ntiles = (A.R + A.TM - 1) / A.TM, g16 = A.TM / 16;
  const bool stats = A.mode == M_STATS;
  const int Hl = A.L[A.nl - 1].h;
  float* psum_blk = stats ? A.psum + (size_t)blockIdx.x * g16 * Hl : nullptr;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    const int r0 = t * A.TM;
    __syncthreads();  // the previous tile's readers are done
    st_load_x(A, r0, xs);
    __syncthreads();
    const bf16* in = xs;
    int ldin = A.K1 + ST_PAD;
    for (int j = 0; j < A.nl; ++j) {
      const int epi = j < A.nl - 1 ? EPI_STORE : (stats ? EPI_STATS : EPI_POOL);
      bf16* out = reinterpret_cast<bf16*>(st_sm + S.h[j]);
      const int ldo = H[j] + ST_PAD;
      st_fwd_layer(A, A.L[j], in, ldin, out, ldo, scr, epi, r0, psum_blk, first, pmax, parg);
      __syncthreads();
      in = out;
      ldin = ldo;
    }
    if (stats) {  // Gram of the tile's bf16 h_upto into the block's slot
      const int nc = Hl / 16;
      float* g = A.pgram + (size_t)blockIdx.x * Hl * Hl;
      for (int tt = warp; tt < nc * nc; tt += ST_WARPS) {
        const int i = tt / nc, jj = tt - i * nc;
        st_acc_tile(g + i * 16 * Hl + jj * 16, Hl, first, in + i * 16, ldin, in + jj * 16,
                    ldin, A.TM);
      }
    } else {  // 16-row maxima -> each center's max and first argmax
      const int H3 = H[2], cpt = A.TM / A.ns, sub = A.ns / 16;
      for (int i = threadIdx.x; i < cpt * H3; i += ST_THREADS) {
        const int q = i / H3, col = i - q * H3;
        const int center = t * cpt + q;
        if ((size_t)center * A.ns >= (size_t)A.R) continue;
        const int s0 = q * sub;
        float best = pmax[s0 * H3 + col];
        int bi = parg[s0 * H3 + col];
        for (int s = 1; s < sub; ++s) {
          const float v = pmax[(s0 + s) * H3 + col];
          if (v > best) {
            best = v;
            bi = parg[(s0 + s) * H3 + col];
          }
        }
        A.pooled[(size_t)center * H3 + col] = best;
        A.arg[(size_t)center * H3 + col] = bi - q * A.ns;
      }
    }
  }
}

// modes 2 and 3: recompute the chain, then back through layers nl..1
__global__ void __launch_bounds__(ST_THREADS) st_bwd_kernel(StArgs A) {
  extern __shared__ __align__(128) unsigned char st_sm[];
  const int H[3] = {A.L[0].h, A.L[1].h, A.L[2].h};
  const StSmem S = st_smem(A.mode, A.K1, A.upto, H, A.TM);
  bf16* xs = reinterpret_cast<bf16*>(st_sm + S.x);
  bf16* du[2] = {reinterpret_cast<bf16*>(st_sm + S.du[0]),
                 reinterpret_cast<bf16*>(st_sm + S.du[1])};
  float* scr = reinterpret_cast<float*>(st_sm + S.scr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stats = A.mode == M_STATS_BWD;
  const int nl = A.nl, nh = stats ? nl : 2;
  int hmax = 0;
  for (int j = 0; j < nl; ++j) hmax = max(hmax, H[j]);
  const int ldd = hmax + ST_PAD;
  const int ntiles = (A.R + A.TM - 1) / A.TM, g16 = A.TM / 16;
  float* ws0 = scr + warp * 512;
  float* ws1 = ws0 + 256;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    const int r0 = t * A.TM;
    __syncthreads();
    st_load_x(A, r0, xs);
    __syncthreads();
    const bf16* in = xs;
    int ldin = A.K1 + ST_PAD;
    for (int j = 0; j < nh; ++j) {
      bf16* out = reinterpret_cast<bf16*>(st_sm + S.h[j]);
      st_fwd_layer(A, A.L[j], in, ldin, out, H[j] + ST_PAD, scr, EPI_STORE, r0, nullptr,
                   first, nullptr, nullptr);
      __syncthreads();
      in = out;
      ldin = H[j] + ST_PAD;
    }
    int cur = 0;
    for (int j = nl - 1; j >= 0; --j) {
      const StLayer& L = A.L[j];
      const bf16* src = j ? reinterpret_cast<const bf16*>(st_sm + S.h[j - 1]) : xs;
      const int lds = j ? H[j - 1] + ST_PAD : A.K1 + ST_PAD;
      bf16* dout = du[cur];
      const bf16* dnext = du[cur ^ 1];
      int dwoff = 0, dsoff = 0;
      for (int i = 0; i < j; ++i) {
        dwoff += A.L[i].k * A.L[i].h;
        dsoff += 2 * A.L[i].h;
      }
      float* dsb = A.pds + (size_t)blockIdx.x * g16 * A.dslen + dsoff;
      const int nc = L.h / 16;
      for (int tile = warp; tile < g16 * nc; tile += ST_WARPS) {
        const int r = tile / nc, c = tile - r * nc;
        FragC acc_u, acc_d;
        wmma::fill_fragment(acc_u, 0.f);
        wmma::fill_fragment(acc_d, 0.f);
        st_mm(acc_u, src + r * 16 * lds, lds, L.w + c * 16, L.h, L.k);
        if (j < nl - 1) {  // d = du_{j+1} @ W_{j+1}^T
          const StLayer& N = A.L[j + 1];
          st_mm_t(acc_d, dnext + r * 16 * ldd, ldd, N.w + (size_t)c * 16 * N.h, N.h, N.h);
        } else if (stats) {  // the bf16(h) @ bf16(dG + dG^T) term
          const bf16* hl = reinterpret_cast<const bf16*>(st_sm + S.h[j]);
          st_mm(acc_d, hl + r * 16 * (L.h + ST_PAD), L.h + ST_PAD, A.dsym + c * 16, L.h, L.h);
        }
        wmma::store_matrix_sync(ws0, acc_u, 16, wmma::mem_row_major);
        wmma::store_matrix_sync(ws1, acc_d, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4, col = c * 16 + (e & 15), row = r0 + r * 16 + rr;
          float d = ws1[e];
          if (j == nl - 1) {
            if (stats) {
              d = A.dS[col] + d;
            } else if (row < A.R) {
              const int center = row / A.ns;
              const size_t o = (size_t)center * L.h + col;
              d = A.argin[o] == row - center * A.ns ? A.dpool[o] : 0.f;
            }
          }
          if (row >= A.R) d = 0.f;
          const float u = ws0[e];
          const float dz = st_affine(u, L.a[col], L.b[col]) > 0.f ? d : 0.f;
          dout[(r * 16 + rr) * ldd + col] = __float2bfloat16_rn(__fmul_rn(dz, L.a[col]));
          ws0[e] = __fmul_rn(dz, u);
          ws1[e] = dz;
        }
        __syncwarp();
        {  // lanes 0-15: da of column lane; 16-31: db of column lane - 16
          const float* v = lane < 16 ? ws0 : ws1;
          const int cl = lane & 15;
          float s = 0.f;
          for (int i = 0; i < 16; ++i) s += v[i * 16 + cl];
          float* d = dsb + (size_t)r * A.dslen + (lane < 16 ? 0 : L.h) + c * 16 + cl;
          *d = first ? s : *d + s;
        }
        __syncwarp();
      }
      __syncthreads();
      // dW_j += bf16(in_j)^T bf16(du_j) over the tile's rows
      float* dwb = A.pdw + (size_t)blockIdx.x * A.dwlen + dwoff;
      const int ni = L.k / 16;
      for (int tt = warp; tt < ni * nc; tt += ST_WARPS) {
        const int i = tt / nc, jj = tt - i * nc;
        st_acc_tile(dwb + i * 16 * L.h + jj * 16, L.h, first, src + i * 16, lds, dout + jj * 16,
                    ldd, A.TM);
      }
      __syncthreads();
      cur ^= 1;
    }
    if (A.need_dx) {  // dx = bf16(du_1) @ bf16(W_1)^T, the first C columns
      const bf16* d1 = du[cur ^ 1];
      const StLayer& L = A.L[0];
      const int nc = A.K1 / 16;
      for (int tile = warp; tile < g16 * nc; tile += ST_WARPS) {
        const int r = tile / nc, c = tile - r * nc;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        st_mm_t(acc, d1 + r * 16 * ldd, ldd, L.w + (size_t)c * 16 * L.h, L.h, L.h);
        wmma::store_matrix_sync(ws0, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = r0 + r * 16 + (e >> 4), col = c * 16 + (e & 15);
          if (row < A.R && col < A.C) A.dx[(size_t)row * A.C + col] = ws0[e];
        }
        __syncwarp();
      }
    }
  }
}

// out[k] = sum over q of part[q][k], q in a fixed order: thread row ty sums
// q = ty, ty + 8, ...; the 8 row sums are added in order.
__global__ void __launch_bounds__(256) st_reduce_kernel(const float* __restrict__ part, int Q,
                                                         int L, float* __restrict__ out) {
  __shared__ float acc[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (k < L)
    for (int q = ty; q < Q; q += 8) s += part[(size_t)q * L + k];
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && k < L) {
    float v = acc[0][tx];
    for (int i = 1; i < 8; ++i) v += acc[i][tx];
    out[k] = v;
  }
}

static int st_reduce(const float* part, int Q, int L, float* out, cudaStream_t st) {
  st_reduce_kernel<<<(L + 31) / 32, dim3(32, 8), 0, st>>>(part, Q, L, out);
  return (int)cudaGetLastError();
}

extern "C" int sv_sa_train_smem(int mode, int C, int upto, int H1, int H2, int H3, int TM) {
  const int H[3] = {H1, H2, H3};
  return st_smem(mode, (C + 15) / 16 * 16, upto, H, TM).total;
}

extern "C" int sv_sa_train(int mode, const float* x, int R, int C, int upto, int ns,
                           int need_dx, const bf16* w1, const float* a1, const float* b1,
                           const bf16* w2, const float* a2, const float* b2, const bf16* w3,
                           const float* a3, const float* b3, int H1, int H2, int H3, int TM,
                           int P, int smem, float* sum, float* gram, float* pooled, int* arg,
                           const bf16* dsym, const float* dS, const float* dpool,
                           const int* argin, float* dx, float* dw, float* ds, float* part_a,
                           float* part_b, void* stream) {
  StArgs A = {};
  A.mode = mode;
  A.x = x;
  A.R = R;
  A.C = C;
  A.K1 = (C + 15) / 16 * 16;
  A.upto = upto;
  A.ns = ns;
  A.need_dx = need_dx;
  A.TM = TM;
  A.nl = (mode == M_POOL || mode == M_POOL_BWD) ? 3 : upto;
  const bf16* w[3] = {w1, w2, w3};
  const float* a[3] = {a1, a2, a3};
  const float* b[3] = {b1, b2, b3};
  const int H[3] = {H1, H2, H3};
  int kin = A.K1;
  for (int j = 0; j < 3; ++j) {
    A.L[j] = StLayer{w[j], a[j], b[j], kin, H[j]};
    kin = H[j];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int g16 = TM / 16;
  int e;
  if (mode == M_STATS || mode == M_POOL) {
    A.psum = part_a;
    A.pgram = part_b;
    A.pooled = pooled;
    A.arg = arg;
    e = (int)cudaFuncSetAttribute(st_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    if (e) return e;
    st_fwd_kernel<<<P, ST_THREADS, smem, st>>>(A);
    if ((e = (int)cudaGetLastError())) return e;
    if (mode == M_STATS) {
      const int Hl = H[upto - 1];
      if ((e = st_reduce(part_a, P * g16, Hl, sum, st))) return e;
      return st_reduce(part_b, P, Hl * Hl, gram, st);
    }
    return 0;
  }
  A.dsym = dsym;
  A.dS = dS;
  A.dpool = dpool;
  A.argin = argin;
  A.dx = dx;
  A.pdw = part_a;
  A.pds = part_b;
  for (int j = 0; j < A.nl; ++j) {
    A.dwlen += A.L[j].k * A.L[j].h;
    A.dslen += 2 * A.L[j].h;
  }
  e = (int)cudaFuncSetAttribute(st_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  if (e) return e;
  st_bwd_kernel<<<P, ST_THREADS, smem, st>>>(A);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = st_reduce(part_a, P, A.dwlen, dw, st))) return e;
  return st_reduce(part_b, P * g16, A.dslen, ds, st);
}
