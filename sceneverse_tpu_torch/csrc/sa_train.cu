// Trainable fused set abstraction for Hopper (sm_90a): 3 x (1x1 conv ->
// train-mode BatchNorm folded to u * a + b -> ReLU) + max-pool over grouped
// rows, forward and backward.
//
// Replaces the four Pallas kernels of sceneverse_tpu/ops/pallas/sa_train.py:
//   sv_sa_stats      sa_stats      _stats_kernel      (:103): sum and Gram of bf16(h_upto)
//   sv_sa_pool       sa_pool       _pool_kernel       (:210): max / first argmax of f32 h3
//   sv_sa_stats_bwd  sa_stats_bwd  _stats_bwd_kernel  (:184): dh = dS + h (dG + dG^T), back
//   sv_sa_pool_bwd   sa_pool_bwd   _pool_bwd_kernel   (:232): d_pooled to the argmax slot, back
//
// Every product has bf16 operands and f32 accumulation on the tensor cores
// (mma.sync m16n8k16); h = relu(u * a + b) in f32 without FMA contraction,
// rounded to bf16 for the next layer and the moments, as the TPU kernels and
// the plain twins in ops/sa_train.py do. No float atomics: partial sums are
// reduced in a fixed order (st_reduce_kernel), so two runs are bit-identical.
//
// All four entries are one chain of tiled passes over the rows (pb_*, the
// note at their section below) with the bf16 activations in a workspace the
// wrapper allocates; they differ in the top pass: the column sums of the
// bf16 h_upto and its Gram (sa_stats), the max and first argmax of the f32
// h3 over each center's rows (sa_pool), the argmax routing of d_pooled
// (sa_pool_bwd) or the head d = dS + h dsym (sa_stats_bwd). Bound: the bf16
// products at the GPS widths at 989 TFLOP/s, or the f32 rows read from
// device memory. Times and bounds: chip_smoke.py's sa_train phase, PERF.md
// rows 7-10.
#include "common.cuh"

#include <algorithm>

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int st_align(int b) { return (b + 127) & ~127; }

__device__ __forceinline__ float st_affine(float u, float a, float b) {
  return __fadd_rn(__fmul_rn(u, a), b);
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

// ===========================================================================
// The passes: a chain of tiled tensor-core GEMMs over the rows, behind all
// four entries (sv_sa_stats, sv_sa_pool, sv_sa_stats_bwd, sv_sa_pool_bwd).
//
// Split: one pass per layer, with the bf16 activations and row cotangents
// (exactly the values the twin rounds to bf16) kept in a device workspace.
// Every sum of dW, da and db (and of the moments) runs over all R rows, and
// du_j needs every column of du_{j+1}; a block that kept all three layers'
// dW in registers would need 264 KB (SA2) to 1.6 MB (SA3). So each pass is a
// plain tiled product whose block owns one output tile and keeps its sums in
// registers for every row it walks. For a chain of nl layers (top layer
// t = nl):
//   cvt    xb = bf16(x), zero-padded to K1 columns
//   FWD    h1 = bf16(relu(xb W1 * a1 + b1)), h2 likewise, up to h_{t-1}
//          (h_t too under the head)
//   top    STATS (sa_stats): h_t as FWD, and the column sums of bf16(h_t)
//          over the rows < R in registers; then the Gram h_t^T h_t as a DW
//          pass with in = du = h_t;
//          POOL (sa_pool): h_t = relu(u_t a_t + b_t) in f32, staged in shared
//          memory and scanned per (center, column) over the center's ns
//          rows in slot order, strictly greater wins (the first slot on a
//          tie); needs 64 % ns == 0, so that a 64-row tile holds whole
//          centers; h_t never leaves the block;
//          ROUTE (sa_pool_bwd): u_t = h_{t-1} W_t, d_t = d_pooled at the
//          saved argmax slot, else 0;
//          HEAD (sa_stats_bwd): u_t = h_{t-1} W_t and d_t = dS + h_t dsym
//          (dsym = bf16(dG + dG^T), symmetric) in one block, the dual pass
//          with dS added to the f32 d of rows < R;
//          then (ROUTE, HEAD) du_t = bf16(dz a_t), da_t += dz u_t, db_t += dz
//          (dz = d_t where u_t a_t + b_t > 0)
//   DUAL   u_j = in_j W_j and d_j = du_{j+1} W_{j+1}^T in one block; du_j,
//          da_j, db_j; for j = t - 1 .. 1
//   DX     dx = du1 W1^T, the first C columns (when need_dx)
//   DW     dW_j = in_j^T du_j, split over row chunks; each block walks its
//          chunk with the 64 x 64 tile's sums in registers and writes its
//          partial once
// then st_reduce sums the row-block partials of the column sums (da / db, or
// sum h) and the chunk partials of dW (or the Gram) in a fixed order (no
// float atomics: two runs agree bit for bit). Tiles: 64 x 64 outputs, 4
// warps of 32 x 32 (mma.sync m16n8k16 bf16, f32 sums), k slices of 32. Row
// passes (pb_rows_kernel) are persistent, one wave at their occupancy: a
// block loads the weight slices of its 64 columns into shared memory once
// (where they are at most 256 deep; deeper ones stream beside A), then walks
// its 64-row tiles as one stream of A slices through a 3-slot cp.async ring
// that runs across tile boundaries; a and b (and dS) of its columns and, for
// the routing, the tile's argmax slots and d_pooled (prefetched with the
// tile's first slice) sit in shared memory; the ReLU, the mask, the routing
// and the a / b scaling run on the accumulator registers; the output tile
// leaves through shared memory in 16-byte rows; column sums stay in
// registers until the block's one partial write. The dW pass (pb_dw_kernel)
// walks a row chunk per block through a 2-slot ring (20 KB static). Shared
// memory per row pass at SA2: 52-88 KB (2-4 blocks per SM). ptxas (PERF.md
// has the current counts): pb_rows_kernel 100-128 registers at
// __launch_bounds__(128, 4), the dual passes spilling 140 B; pb_dw_kernel
// 105. The workspace traffic (about 2.4 GB written at SA2 in sa_pool_bwd,
// 1.05 GB in sa_pool) costs less than recomputing the chain once per column
// slice.
// ===========================================================================
constexpr int PB_BM = 64, PB_BN = 64, PB_BK = 32, PB_THREADS = 128;
constexpr int PB_LDK = PB_BK + 8;        // bf16 stride of a [64][32] tile
constexpr int PB_LDW = PB_BM + 8;        // bf16 stride of a [32][64] tile
constexpr int PB_TILE = PB_BM * PB_LDK;  // bf16 per staged tile (>= 32 * 72)
constexpr int PB_MIN_BLOCKS = 4;         // blocks per SM asked of ptxas

enum {
  PB_FWD = 0, PB_ROUTE = 1, PB_DUAL = 2, PB_DX = 3, PB_HEAD = 4, PB_STATS = 5, PB_POOL = 6
};

// the passes with a second product, d = a2 @ w2^T
__host__ __device__ constexpr bool pb_dual(int mode) {
  return mode == PB_DUAL || mode == PB_HEAD;
}

// an [NR][NC] tile at (r0, c0) of a row-major bf16 matrix (ld) into shared
// memory (stride NC + 8); zero outside rows < rlim, cols < clim
template <int NR, int NC>
__device__ __forceinline__ void pb_load(bf16* dst, const bf16* src, int ld, int r0, int c0,
                                        int rlim, int clim) {
  constexpr int CH = NC / 8;
  for (int i = threadIdx.x; i < NR * CH; i += PB_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    sv_cp16(dst + r * (NC + 8) + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok ? 16 : 0);
  }
}

// acc[32 x 32 per warp] += the staged 32-deep k slice: A staged [64][32]
// (AK false) or [32][64] (AK true), B staged [32][64] (BNM false) or
// [64][32] (BNM true)
template <bool AK, bool BNM>
__device__ __forceinline__ void pb_mma_step(float (&acc)[2][4][4], const bf16* sa,
                                            const bf16* sb, int ldb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int kk = 0; kk < PB_BK; kk += 16) {
    uint32_t af[2][4], bfr[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mb = wm * 32 + mi * 16;
      if (AK)
        sv_ldsm4_t(af[mi], sa + (kk + (lane >> 4) * 8 + (lane & 7)) * PB_LDW + mb +
                               ((lane >> 3) & 1) * 8);
      else
        sv_ldsm4(af[mi], sa + (mb + (lane & 7) + ((lane >> 3) & 1) * 8) * PB_LDK + kk +
                             (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int nb = wn * 32 + np * 16;
      if (BNM)
        sv_ldsm4(bfr[np], sb + (nb + (lane & 7) + (lane >> 4) * 8) * ldb + kk +
                              ((lane >> 3) & 1) * 8);
      else
        sv_ldsm4_t(bfr[np], sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + nb +
                                (lane >> 4) * 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        sv_mma(acc[mi][2 * np], af[mi], bfr[np][0], bfr[np][1]);
        sv_mma(acc[mi][2 * np + 1], af[mi], bfr[np][2], bfr[np][3]);
      }
  }
}

// acc += A[m0.., k0..k1) B[k0..k1), n0..]: A stored [M][K] (AK false) or
// [K][M] (AK true); B stored [K][N] (BNM false) or [N][K] (BNM true); a
// two-stage cp.async ring in sm. Ends with a block barrier.
template <bool AK, bool BNM>
__device__ __forceinline__ void pb_mainloop(float (&acc)[2][4][4], const bf16* A, int lda,
                                            const bf16* B, int ldb, int M, int N, int m0,
                                            int n0, int k0, int k1, bf16* sm) {
  auto stage = [&](int buf, int k) {
    bf16* sa = sm + buf * PB_TILE;
    bf16* sb = sm + (2 + buf) * PB_TILE;
    if (AK)
      pb_load<PB_BK, PB_BM>(sa, A, lda, k, m0, k1, M);
    else
      pb_load<PB_BM, PB_BK>(sa, A, lda, m0, k, M, k1);
    if (BNM)
      pb_load<PB_BN, PB_BK>(sb, B, ldb, n0, k, N, k1);
    else
      pb_load<PB_BK, PB_BN>(sb, B, ldb, k, n0, k1, N);
  };
  const int nk = (k1 - k0 + PB_BK - 1) / PB_BK;
  stage(0, k0);
  sv_cp_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      stage(buf ^ 1, k0 + (kt + 1) * PB_BK);
      sv_cp_commit();
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    pb_mma_step<AK, BNM>(acc, sm + buf * PB_TILE, sm + (2 + buf) * PB_TILE,
                         BNM ? PB_LDK : PB_LDW);
    __syncthreads();
  }
}

struct PbRows {
  const bf16* a1;  // u = a1 @ w1: a1 [M][K1], w1 [K1][N] ([N][K1] in PB_DX)
  const bf16* w1;
  int lda1, ldw1, K1;
  const bf16* a2;  // PB_DUAL, PB_HEAD: d = a2 @ w2^T, a2 [M][K2], w2 [N][K2]
  const bf16* w2;
  int lda2, ldw2, K2;
  const float* sa;  // scale and shift (N)
  const float* sb;
  const float* dS;  // PB_HEAD: added to d (N)
  const float* dpool;  // PB_ROUTE: [M / ns][N]
  const int* argin;
  int ns;  // PB_ROUTE, PB_POOL: rows per center
  bf16* out;  // h (PB_FWD, PB_STATS) or du, [M][N]
  float* outf;  // PB_DX: [M][Nreal]
  int Nreal;
  float* pooled;  // PB_POOL: max and its first slot, [M / ns][N]
  int* argout;
  float* pds;  // da | db partials, [gridDim.y][2N]; PB_STATS: sum h, [gridDim.y][N]
  int M, N;
};

constexpr int PB_NS = 3;                    // stages of the row passes' A ring
constexpr int PB_CENTERS = PB_BM / 16 + 1;  // centers a 64-row tile touches (ns >= 16)
constexpr int PB_LDO = PB_BN + 8;           // stride of the staged bf16 output tile
constexpr int PB_LDF = PB_BN + 4;           // stride of the staged f32 output tile
constexpr int PB_ATILE = PB_BM * PB_LDK;    // bf16 of one staged [64][32] A slice

// Dynamic shared memory of a row pass (bytes, 128-aligned pieces): the
// block's weight slices, resident for the whole pass where their depth is
// at most PB_KRES (w1: [K1][64] k-major, or [64][K1] in PB_DX; w2:
// [64][K2] in the dual passes) and otherwise streamed beside A; the ring
// of PB_NS slots (an A slice, and a weight slice where one is streamed);
// the staged output tile; in PB_ROUTE three tiles' argmax slots and
// d_pooled.
constexpr int PB_KRES = 256;
struct PbRowsSmem {
  int w1, w2, ring, slot, out, route, total;
  bool res1, res2;
};
__host__ __device__ inline int pb_kpad(int K) { return (K + PB_BK - 1) / PB_BK * PB_BK; }

__host__ __device__ inline PbRowsSmem pb_rows_smem(int mode, int K1, int K2) {
  PbRowsSmem s;
  int off = 0;
  K1 = pb_kpad(K1);  // whole 32-deep slices, zero past K
  K2 = pb_kpad(K2);
  s.res1 = K1 <= PB_KRES;
  s.res2 = pb_dual(mode) && K2 <= PB_KRES;
  s.w1 = off;
  if (s.res1) off += st_align((mode == PB_DX ? PB_BN * (K1 + 8) : K1 * (PB_BN + 8)) * 2);
  s.w2 = off;
  if (s.res2) off += st_align(PB_BN * (K2 + 8) * 2);
  s.ring = off;
  s.slot = PB_ATILE + (!s.res1 || (pb_dual(mode) && !s.res2) ? PB_TILE : 0);
  off += PB_NS * s.slot * 2;
  s.out = off;
  off += st_align(PB_BM * PB_LDF * 4);
  s.route = off;
  if (mode == PB_ROUTE) off += 3 * 2 * PB_CENTERS * PB_BN * 4;
  s.total = off;
  return s;
}

// an [nr][nc] tile (nc a multiple of 8) at (r0, c0) of a row-major bf16
// matrix into shared memory (stride nc + 8), zero outside rlim x clim
__device__ __forceinline__ void pb_load_rt(bf16* dst, const bf16* src, int ld, int r0, int c0,
                                           int nr, int nc, int rlim, int clim) {
  const int ch = nc / 8;
  for (int i = threadIdx.x; i < nr * ch; i += PB_THREADS) {
    const int r = i / ch, c = (i - r * ch) * 8;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    sv_cp16(dst + r * (nc + 8) + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src,
            ok ? 16 : 0);
  }
}

// The row passes. The block's weight slices go to shared memory once; the
// block then walks the 64-row tiles blockIdx.y, + gridDim.y, ... of its 64
// output columns as one stream of 32-deep A slices (both products' slices
// in the dual passes), PB_NS - 1 slices in flight ahead of the one
// multiplied, across tile boundaries, so a tile's epilogue overlaps the
// next tile's loads.
template <int MODE>
__global__ void __launch_bounds__(PB_THREADS, PB_MIN_BLOCKS) pb_rows_kernel(PbRows P) {
  extern __shared__ __align__(128) unsigned char pb_dyn[];
  __shared__ float s_a[PB_BN], s_b[PB_BN], red[2][2][PB_BN];
  __shared__ float s_ds[MODE == PB_HEAD ? PB_BN : 1];
  const PbRowsSmem L = pb_rows_smem(MODE, P.K1, P.K2);
  bf16* w1s = reinterpret_cast<bf16*>(pb_dyn + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(pb_dyn + L.w2);
  bf16* ring = reinterpret_cast<bf16*>(pb_dyn + L.ring);
  bf16* stage_h = reinterpret_cast<bf16*>(pb_dyn + L.out);
  float* stage_f = reinterpret_cast<float*>(pb_dyn + L.out);
  int* s_arg = reinterpret_cast<int*>(pb_dyn + L.route);  // [3][PB_CENTERS][64]
  float* s_dp = reinterpret_cast<float*>(s_arg + 3 * PB_CENTERS * PB_BN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * PB_BN, M = P.M, N = P.N;
  const int K1p = pb_kpad(P.K1), K2p = pb_kpad(P.K2);
  const int ldw1 = MODE == PB_DX ? K1p + 8 : PB_BN + 8, ldw2 = K2p + 8;
  constexpr bool DUAL = pb_dual(MODE);
  constexpr bool BWD = MODE == PB_ROUTE || DUAL;
  constexpr bool FWD = MODE == PB_FWD || MODE == PB_STATS || MODE == PB_POOL;
  constexpr bool STAGE_F = MODE == PB_DX || MODE == PB_POOL;  // the tile staged in f32
  if (MODE != PB_DX)
    for (int i = threadIdx.x; i < PB_BN; i += PB_THREADS) {
      const int c = n0 + i;
      s_a[i] = c < N ? P.sa[c] : 0.f;
      s_b[i] = c < N ? P.sb[c] : 0.f;
      if (MODE == PB_HEAD) s_ds[i] = c < N ? P.dS[c] : 0.f;
    }  // read after the stream's first barrier
  // the weight slices, in the first commit group
  if (L.res1) {
    if (MODE == PB_DX)
      pb_load_rt(w1s, P.w1, P.ldw1, n0, 0, PB_BN, K1p, N, P.K1);
    else
      pb_load_rt(w1s, P.w1, P.ldw1, 0, n0, K1p, PB_BN, P.K1, N);
  }
  if (L.res2) pb_load_rt(w2s, P.w2, P.ldw2, n0, 0, PB_BN, K2p, N, P.K2);
  float cda[4][2], cdb[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) cda[ni][e] = cdb[ni][e] = 0.f;
  float acc[2][4][4], accd[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = accd[mi][ni][e] = 0.f;

  const int nM = (M + PB_BM - 1) / PB_BM;
  const int ntile = (int)blockIdx.y < nM ? (nM - 1 - (int)blockIdx.y) / (int)gridDim.y + 1 : 0;
  const int n1 = (P.K1 + PB_BK - 1) / PB_BK;
  const int spt = n1 + (DUAL ? (P.K2 + PB_BK - 1) / PB_BK : 0);
  const int total = ntile * spt;
  auto fetch = [&](int s) {  // A slice s of the stream into its ring slot
    const int i = s / spt, j = s - i * spt;
    const int m0 = (blockIdx.y + i * gridDim.y) * PB_BM;
    bf16* sa = ring + (s % PB_NS) * L.slot;
    bf16* sb = sa + PB_ATILE;
    if (j < n1) {
      const int k = j * PB_BK;
      pb_load<PB_BM, PB_BK>(sa, P.a1, P.lda1, m0, k, M, P.K1);
      if (!L.res1) {
        if (MODE == PB_DX)
          pb_load<PB_BN, PB_BK>(sb, P.w1, P.ldw1, n0, k, N, P.K1);
        else
          pb_load<PB_BK, PB_BN>(sb, P.w1, P.ldw1, k, n0, P.K1, N);
      }
    } else {
      const int k = (j - n1) * PB_BK;
      pb_load<PB_BM, PB_BK>(sa, P.a2, P.lda2, m0, k, M, P.K2);
      if (!L.res2) pb_load<PB_BN, PB_BK>(sb, P.w2, P.ldw2, n0, k, N, P.K2);
    }
    if (MODE == PB_ROUTE && j == 0) {  // the tile's centers' slots and d_pooled
      const int c_lo = m0 / P.ns, nctr = M / P.ns;
      int* ga = s_arg + (i % 3) * PB_CENTERS * PB_BN;
      float* gd = s_dp + (i % 3) * PB_CENTERS * PB_BN;
      for (int t = threadIdx.x; t < PB_CENTERS * (PB_BN / 4); t += PB_THREADS) {
        const int lc = t / (PB_BN / 4), c4 = (t - lc * (PB_BN / 4)) * 4;
        const bool ok = c_lo + lc < nctr && n0 + c4 < N;
        const size_t o = ok ? (size_t)(c_lo + lc) * N + n0 + c4 : 0;
        sv_cp16(ga + lc * PB_BN + c4, P.argin + o, ok ? 16 : 0);
        sv_cp16(gd + lc * PB_BN + c4, P.dpool + o, ok ? 16 : 0);
      }
    }
  };
  for (int s = 0; s < PB_NS - 1; ++s) {
    if (s < total) fetch(s);
    sv_cp_commit();
  }
  for (int s = 0; s < total; ++s) {
    sv_cp_wait<PB_NS - 2>();
    __syncthreads();  // slice s landed; slot (s - 1) % PB_NS is free
    if (s + PB_NS - 1 < total) fetch(s + PB_NS - 1);
    sv_cp_commit();
    const int i = s / spt, j = s - i * spt;
    const bf16* sa = ring + (s % PB_NS) * L.slot;
    const bf16* sb = sa + PB_ATILE;  // a streamed weight slice
    if (j < n1) {
      if (MODE == PB_DX)
        pb_mma_step<false, true>(acc, sa, L.res1 ? w1s + j * PB_BK : sb,
                                 L.res1 ? ldw1 : PB_LDK);
      else
        pb_mma_step<false, false>(acc, sa, L.res1 ? w1s + j * PB_BK * ldw1 : sb,
                                  L.res1 ? ldw1 : PB_LDW);
    } else {
      pb_mma_step<false, true>(accd, sa, L.res2 ? w2s + (j - n1) * PB_BK : sb,
                               L.res2 ? ldw2 : PB_LDK);
    }
    if (j != spt - 1) continue;
    // ---- epilogue of tile i
    const int m0 = (blockIdx.y + i * gridDim.y) * PB_BM;
    const int c_lo = m0 / P.ns;
    const int* ga = s_arg + (i % 3) * PB_CENTERS * PB_BN;
    const float* gd = s_dp + (i % 3) * PB_CENTERS * PB_BN;
    int qoff[2][2], slot[2][2];  // the thread's 4 rows: center offset, slot
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 32 + mi * 16 + g + r * 8;
        const int center = MODE == PB_ROUTE ? row / P.ns : 0;
        qoff[mi][r] = (center - c_lo) * PB_BN;
        slot[mi][r] = row - center * P.ns;
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = wm * 32 + mi * 16 + g + r * 8, row = m0 + rl;
          const int cl = wn * 32 + ni * 8 + t4 * 2;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u = acc[mi][ni][r * 2 + e];
            if (FWD) {
              y[e] = fmaxf(st_affine(u, s_a[cl + e], s_b[cl + e]), 0.f);
              if (MODE == PB_STATS && row < M)  // the moments read bf16(h)
                cda[ni][e] += __bfloat162float(__float2bfloat16_rn(y[e]));
            } else if (MODE == PB_DX) {
              y[e] = u;
            } else {
              float d = 0.f;
              if (row < M) {
                if (MODE == PB_ROUTE) {
                  const int q = qoff[mi][r] + cl + e;
                  d = ga[q] == slot[mi][r] ? gd[q] : 0.f;
                } else {
                  d = accd[mi][ni][r * 2 + e];
                  if (MODE == PB_HEAD) d = __fadd_rn(s_ds[cl + e], d);
                }
              }
              const float dz = st_affine(u, s_a[cl + e], s_b[cl + e]) > 0.f ? d : 0.f;
              y[e] = __fmul_rn(dz, s_a[cl + e]);
              cda[ni][e] += __fmul_rn(dz, u);
              cdb[ni][e] += dz;
            }
            acc[mi][ni][r * 2 + e] = 0.f;
            accd[mi][ni][r * 2 + e] = 0.f;
          }
          if (STAGE_F) {
            stage_f[rl * PB_LDF + cl] = y[0];
            stage_f[rl * PB_LDF + cl + 1] = y[1];
          } else {
            *reinterpret_cast<uint32_t*>(stage_h + rl * PB_LDO + cl) = sv_pack_bf16(y[0], y[1]);
          }
        }
    __syncthreads();
    if (MODE == PB_DX) {  // f32 rows of the first Nreal columns
      for (int t = threadIdx.x; t < PB_BM * PB_BN; t += PB_THREADS) {
        const int rl = t / PB_BN, cl = t - rl * PB_BN, c = n0 + cl;
        if (m0 + rl < M && c < P.Nreal)
          P.outf[(size_t)(m0 + rl) * P.Nreal + c] = stage_f[rl * PB_LDF + cl];
      }
    } else if (MODE == PB_POOL) {  // each (center, column) of the tile over its ns rows
      const int cpt = PB_BM / P.ns, nctr = M / P.ns;
      for (int t = threadIdx.x; t < cpt * PB_BN; t += PB_THREADS) {
        const int q = t / PB_BN, cl = t - q * PB_BN, c = n0 + cl;
        if (c_lo + q >= nctr || c >= N) continue;
        const float* col = stage_f + q * P.ns * PB_LDF + cl;
        float best = col[0];
        int bi = 0;
        for (int s2 = 1; s2 < P.ns; ++s2) {
          const float v = col[s2 * PB_LDF];
          if (v > best) {
            best = v;
            bi = s2;
          }
        }
        P.pooled[(size_t)(c_lo + q) * N + c] = best;
        P.argout[(size_t)(c_lo + q) * N + c] = bi;
      }
    } else {  // 16-byte pieces of bf16 rows
      for (int t = threadIdx.x; t < PB_BM * (PB_BN / 8); t += PB_THREADS) {
        const int rl = t / (PB_BN / 8), c8 = (t % (PB_BN / 8)) * 8;
        if (m0 + rl < M && n0 + c8 < N)
          *reinterpret_cast<uint4*>(P.out + (size_t)(m0 + rl) * N + n0 + c8) =
              *reinterpret_cast<const uint4*>(stage_h + rl * PB_LDO + c8);
      }
    }
    // the staging tile is written again only after the next tile's first
    // stream barrier
  }
  sv_cp_wait<0>();
  if (BWD || MODE == PB_STATS) {
    // the block's column sums (da | db, or sum h): over the quad rows, then
    // the 2 warp rows
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float va = cda[ni][e], vb = cdb[ni][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          va += __shfl_xor_sync(SV_FULL_MASK, va, off);
          if (BWD) vb += __shfl_xor_sync(SV_FULL_MASK, vb, off);
        }
        if (g == 0) {
          const int cl = wn * 32 + ni * 8 + t4 * 2 + e;
          red[0][wm][cl] = va;
          if (BWD) red[1][wm][cl] = vb;
        }
      }
    __syncthreads();
    for (int t = threadIdx.x; t < PB_BN; t += PB_THREADS) {
      const int c = n0 + t;
      if (c < N) {
        float* dst = P.pds + (size_t)blockIdx.y * (BWD ? 2 : 1) * N;
        dst[c] = red[0][0][t] + red[0][1][t];
        if (BWD) dst[N + c] = red[1][0][t] + red[1][1][t];
      }
    }
  }
}

// dW = in^T du over the rows [z * chunk, (z + 1) * chunk): in [R][M],
// du [R][N]; the tile's partial to part[z][M][N]
__global__ void __launch_bounds__(PB_THREADS, PB_MIN_BLOCKS)
pb_dw_kernel(const bf16* __restrict__ in, int ldi, const bf16* __restrict__ du, int ldd, int M,
             int N, int R, int chunk, float* __restrict__ part) {
  __shared__ __align__(128) bf16 sm[4 * PB_TILE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * PB_BM, n0 = blockIdx.x * PB_BN;
  const int k0 = blockIdx.z * chunk, k1 = min(R, k0 + chunk);
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  pb_mainloop<true, false>(acc, in, ldi, du, ldd, M, N, m0, n0, k0, k1, sm);
  float* dst = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 32 + mi * 16 + g + r * 8;
        const int c = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (row < M && c < N)
          *reinterpret_cast<float2*>(dst + (size_t)row * N + c) =
              make_float2(acc[mi][ni][r * 2], acc[mi][ni][r * 2 + 1]);
      }
}

// xb[R][K1] = bf16(x[R][C]), zero in the padding columns; a warp per row
__global__ void pb_cvt_kernel(const float* __restrict__ x, int R, int C, int K1,
                              bf16* __restrict__ xb) {
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  for (int r = w0; r < R; r += nw)
    for (int c = lane; c < K1; c += 32)
      xb[(size_t)r * K1 + c] = __float2bfloat16_rn(c < C ? x[(size_t)r * C + c] : 0.f);
}

// blocks along the rows: one wave of persistent blocks at the pass's
// occupancy (shared memory bound, at most PB_MIN_BLOCKS per SM)
static int pb_rows_p(int mode, int M, int N, int K1, int K2, int sms) {
  const int nM = (M + PB_BM - 1) / PB_BM, nN = (N + PB_BN - 1) / PB_BN;
  const int per_block = pb_rows_smem(mode, K1, K2).total + 8 * 1024;  // + static, reserved
  const int occ = std::max(1, std::min(PB_MIN_BLOCKS, 232448 / per_block));
  return std::max(1, std::min(nM, (occ * sms + nN - 1) / nN));
}

// Row chunks of a DW pass over R rows (a multiple of 32 rows each): about
// two waves of its M x N output tiles
static void pb_split(int M, int N, int R, int sms, int& chunk, int& S) {
  const int tiles = ((M + PB_BM - 1) / PB_BM) * ((N + PB_BN - 1) / PB_BN);
  const int want = std::max(1, (2 * PB_MIN_BLOCKS * sms + tiles - 1) / tiles);
  chunk = (R + want - 1) / want;
  chunk = (chunk + PB_BK - 1) / PB_BK * PB_BK;
  S = (R + chunk - 1) / chunk;
}

// Launch plan of a chain of nl layers (1-3) and its top pass, the same for
// the workspace query and the launch: PB_STATS (sa_stats, nl = upto) or
// PB_POOL (sa_pool, nl = 3) after the forward passes; PB_ROUTE (sa_pool_bwd)
// or PB_HEAD (sa_stats_bwd) between the forward and the backward passes.
// The workspace holds xb and the nh activations that later passes read:
// h_nl too under the stats and the head, which read it, nl - 1 under the
// pool and the route. The stats add the Gram's chunk partials and the
// column-sum partials of h_nl; the backwards add per layer a du slab and
// the partials of dW and of da / db.
struct PbPlan {
  int top, nl, nh, K1, H[3], kin[3], P[3], S[3], chunk[3];
  size_t off_x, off_h[3], off_du[3], off_pdw[3], off_pds[3], total;
};

static PbPlan pb_plan(int top, int nl, int R, int C, const int* H, int sms) {
  PbPlan p = {};
  p.top = top, p.nl = nl, p.nh = top == PB_HEAD || top == PB_STATS ? nl : nl - 1;
  p.K1 = (C + 15) / 16 * 16;
  for (int j = 0; j < nl; ++j) {
    p.H[j] = H[j];
    p.kin[j] = j ? H[j - 1] : p.K1;
  }
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 255) / 256 * 256;
    return o;
  };
  p.off_x = take((size_t)R * p.K1 * 2);
  for (int j = 0; j < p.nh; ++j) p.off_h[j] = take((size_t)R * H[j] * 2);
  const int t = nl - 1;
  if (top == PB_POOL) {
    p.P[t] = pb_rows_p(PB_POOL, R, H[t], p.kin[t], 0, sms);
  } else if (top == PB_STATS) {
    pb_split(H[t], H[t], R, sms, p.chunk[t], p.S[t]);
    p.off_pdw[t] = take((size_t)p.S[t] * H[t] * H[t] * 4);
    p.P[t] = pb_rows_p(PB_STATS, R, H[t], p.kin[t], 0, sms);
    p.off_pds[t] = take((size_t)p.P[t] * H[t] * 4);
  } else {
    for (int j = 0; j < nl; ++j) p.off_du[j] = take((size_t)R * H[j] * 2);
    for (int j = 0; j < nl; ++j) {
      const int M = p.kin[j], N = H[j];
      pb_split(M, N, R, sms, p.chunk[j], p.S[j]);
      p.off_pdw[j] = take((size_t)p.S[j] * M * N * 4);
      p.P[j] = j < nl - 1 ? pb_rows_p(PB_DUAL, R, N, M, H[j + 1], sms)
                          : pb_rows_p(top, R, N, M, top == PB_HEAD ? N : 0, sms);
      p.off_pds[j] = take((size_t)p.P[j] * 2 * N * 4);
    }
  }
  p.total = off;
  return p;
}

template <int MODE>
static int pb_rows(const PbRows& a, int P, cudaStream_t st) {
  const int smem = pb_rows_smem(MODE, a.K1, a.K2).total;
  const cudaError_t e = cudaFuncSetAttribute(
      pb_rows_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  pb_rows_kernel<MODE><<<dim3((a.N + PB_BN - 1) / PB_BN, P), PB_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The operands and outputs of the top pass: d_pooled and the argmax slots
// with their ns (PB_ROUTE), dsym [H][H] and dS [H] (PB_HEAD); the sums and
// Gram of h_nl (PB_STATS), or pooled and arg with their ns (PB_POOL)
struct PbTop {
  const float* dpool;
  const int* argin;
  int ns;
  const bf16* dsym;
  const float* dS;
  float* sum;
  float* gram;
  float* pooled;
  int* arg;
};

static bool pb_shapes_ok(int R, int C, int nl, const int* H, int sms) {
  if (R < 1 || C < 1 || sms < 1 || nl < 1 || nl > 3) return false;
  for (int j = 0; j < nl; ++j)
    if (H[j] < 16 || H[j] % 16) return false;
  return true;
}

// a chain's layer operands, as the entries take them
struct PbLayers {
  const bf16* w[3];
  const float* a[3];
  const float* b[3];
};

// The row pass of layer j (0-based) with its operands: in_j W_j, a_j, b_j
static PbRows pb_layer(const PbPlan& p, const PbLayers& l, const bf16* in, int j, int R) {
  PbRows r = {};
  r.a1 = in, r.lda1 = p.kin[j], r.K1 = p.kin[j];
  r.w1 = l.w[j], r.ldw1 = p.H[j];
  r.sa = l.a[j], r.sb = l.b[j], r.M = R, r.N = p.H[j];
  return r;
}

// Every pass of a plan on one stream, in order: cvt and FWD; then the top
// pass and, for the stats, the Gram and the fixed-order reductions; for the
// backwards the top pass, the dual passes down to layer 1, DX, then DW and
// the fixed-order reductions per layer.
static int pb_run(const PbPlan& p, const PbTop& top, const float* x, int R, int C, int need_dx,
                  const PbLayers& l, int sms, float* dx, float* dw, float* ds, void* ws,
                  cudaStream_t st) {
  const int nl = p.nl, t = nl - 1;
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* xb = reinterpret_cast<bf16*>(base + p.off_x);
  bf16 *h[3] = {}, *du[3] = {};
  const bf16* in[3] = {};
  for (int j = 0; j < nl; ++j) {
    if (j < p.nh) h[j] = reinterpret_cast<bf16*>(base + p.off_h[j]);
    if (p.top == PB_ROUTE || p.top == PB_HEAD)
      du[j] = reinterpret_cast<bf16*>(base + p.off_du[j]);
    in[j] = j ? h[j - 1] : xb;
  }
  int e;
  pb_cvt_kernel<<<8 * sms, 256, 0, st>>>(x, R, C, p.K1, xb);
  if ((e = (int)cudaGetLastError())) return e;
  const int nfwd = p.top == PB_HEAD ? nl : nl - 1;
  for (int j = 0; j < nfwd; ++j) {  // forward: h1, h2, ...
    PbRows r = pb_layer(p, l, in[j], j, R);
    r.out = h[j];
    if ((e = pb_rows<PB_FWD>(r, pb_rows_p(PB_FWD, R, p.H[j], p.kin[j], 0, sms), st))) return e;
  }
  if (p.top == PB_POOL) {
    PbRows r = pb_layer(p, l, in[t], t, R);
    r.ns = top.ns, r.pooled = top.pooled, r.argout = top.arg;
    return pb_rows<PB_POOL>(r, p.P[t], st);
  }
  if (p.top == PB_STATS) {
    const int H = p.H[t];
    float* pds = reinterpret_cast<float*>(base + p.off_pds[t]);
    float* pdw = reinterpret_cast<float*>(base + p.off_pdw[t]);
    PbRows r = pb_layer(p, l, in[t], t, R);
    r.out = h[t], r.pds = pds;
    if ((e = pb_rows<PB_STATS>(r, p.P[t], st))) return e;
    pb_dw_kernel<<<dim3((H + PB_BN - 1) / PB_BN, (H + PB_BM - 1) / PB_BM, p.S[t]), PB_THREADS, 0,
                   st>>>(h[t], H, h[t], H, H, H, R, p.chunk[t], pdw);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = st_reduce(pds, p.P[t], H, top.sum, st))) return e;
    return st_reduce(pdw, p.S[t], H * H, top.gram, st);
  }
  for (int j = t; j >= 0; --j) {  // du_nl .. du_1 with da / db partials
    PbRows r = pb_layer(p, l, in[j], j, R);
    r.out = du[j];
    r.pds = reinterpret_cast<float*>(base + p.off_pds[j]);
    if (j < t) {
      r.a2 = du[j + 1], r.lda2 = p.H[j + 1], r.K2 = p.H[j + 1];
      r.w2 = l.w[j + 1], r.ldw2 = p.H[j + 1];
      e = pb_rows<PB_DUAL>(r, p.P[j], st);
    } else if (p.top == PB_ROUTE) {
      r.dpool = top.dpool, r.argin = top.argin, r.ns = top.ns;
      e = pb_rows<PB_ROUTE>(r, p.P[j], st);
    } else {
      r.a2 = h[j], r.lda2 = p.H[j], r.K2 = p.H[j];
      r.w2 = top.dsym, r.ldw2 = p.H[j], r.dS = top.dS;
      e = pb_rows<PB_HEAD>(r, p.P[j], st);
    }
    if (e) return e;
  }
  if (need_dx) {
    PbRows r = {};
    r.a1 = du[0], r.lda1 = p.H[0], r.K1 = p.H[0];
    r.w1 = l.w[0], r.ldw1 = p.H[0];
    r.outf = dx, r.Nreal = C, r.M = R, r.N = p.K1;
    if ((e = pb_rows<PB_DX>(r, pb_rows_p(PB_DX, R, p.K1, p.H[0], 0, sms), st))) return e;
  }
  size_t dwoff = 0, dsoff = 0;
  for (int j = 0; j < nl; ++j) {
    const int M = p.kin[j], N = p.H[j];
    float* pdw = reinterpret_cast<float*>(base + p.off_pdw[j]);
    pb_dw_kernel<<<dim3((N + PB_BN - 1) / PB_BN, (M + PB_BM - 1) / PB_BM, p.S[j]), PB_THREADS,
                   0, st>>>(in[j], M, du[j], N, M, N, R, p.chunk[j], pdw);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = st_reduce(pdw, p.S[j], M * N, dw + dwoff, st))) return e;
    if ((e = st_reduce(reinterpret_cast<float*>(base + p.off_pds[j]), p.P[j], 2 * N,
                       ds + dsoff, st)))
      return e;
    dwoff += (size_t)M * N;
    dsoff += 2 * (size_t)N;
  }
  return 0;
}

extern "C" long long sv_sa_stats_ws(int R, int C, int upto, int H1, int H2, int H3, int sms) {
  if (upto < 1 || upto > 3) return -1;
  const int H[3] = {H1, H2, H3};
  return (long long)pb_plan(PB_STATS, upto, R, C, H, sms).total;
}

// sum [H] and Gram [H][H] of bf16(h_upto), H = H_upto
extern "C" int sv_sa_stats(const float* x, int R, int C, int upto, const bf16* w1, const float* a1,
                           const float* b1, const bf16* w2, const float* a2, const float* b2,
                           const bf16* w3, const float* a3, const float* b3, int H1, int H2,
                           int H3, int sms, float* sum, float* gram, void* ws, void* stream) {
  const int H[3] = {H1, H2, H3};
  const PbLayers l = {{w1, w2, w3}, {a1, a2, a3}, {b1, b2, b3}};
  if (!pb_shapes_ok(R, C, upto, H, sms)) return (int)cudaErrorInvalidValue;
  PbTop top = {};
  top.sum = sum, top.gram = gram;
  return pb_run(pb_plan(PB_STATS, upto, R, C, H, sms), top, x, R, C, 0, l, sms, nullptr,
                nullptr, nullptr, ws, (cudaStream_t)stream);
}

extern "C" long long sv_sa_pool_ws(int R, int C, int H1, int H2, int H3, int sms) {
  const int H[3] = {H1, H2, H3};
  return (long long)pb_plan(PB_POOL, 3, R, C, H, sms).total;
}

// pooled and arg [R / ns][H3]; ns divides the 64-row tile, so that no
// center spans two tiles
extern "C" int sv_sa_pool(const float* x, int R, int C, int ns, const bf16* w1, const float* a1,
                          const float* b1, const bf16* w2, const float* a2, const float* b2,
                          const bf16* w3, const float* a3, const float* b3, int H1, int H2,
                          int H3, int sms, float* pooled, int* arg, void* ws, void* stream) {
  const int H[3] = {H1, H2, H3};
  const PbLayers l = {{w1, w2, w3}, {a1, a2, a3}, {b1, b2, b3}};
  if (!pb_shapes_ok(R, C, 3, H, sms) || ns < 1 || PB_BM % ns || R % ns)
    return (int)cudaErrorInvalidValue;
  PbTop top = {};
  top.ns = ns, top.pooled = pooled, top.arg = arg;
  return pb_run(pb_plan(PB_POOL, 3, R, C, H, sms), top, x, R, C, 0, l, sms, nullptr,
                nullptr, nullptr, ws, (cudaStream_t)stream);
}

extern "C" long long sv_sa_pool_bwd_ws(int R, int C, int H1, int H2, int H3, int sms) {
  const int H[3] = {H1, H2, H3};
  return (long long)pb_plan(PB_ROUTE, 3, R, C, H, sms).total;
}

extern "C" int sv_sa_pool_bwd(const float* x, int R, int C, int ns, int need_dx,
                              const bf16* w1, const float* a1, const float* b1, const bf16* w2,
                              const float* a2, const float* b2, const bf16* w3,
                              const float* a3, const float* b3, int H1, int H2, int H3,
                              int sms, const float* dpool, const int* argin, float* dx,
                              float* dw, float* ds, void* ws, void* stream) {
  const int H[3] = {H1, H2, H3};
  const PbLayers l = {{w1, w2, w3}, {a1, a2, a3}, {b1, b2, b3}};
  if (!pb_shapes_ok(R, C, 3, H, sms) || ns < 1 || R % ns) return (int)cudaErrorInvalidValue;
  PbTop top = {};
  top.dpool = dpool, top.argin = argin, top.ns = ns;
  return pb_run(pb_plan(PB_ROUTE, 3, R, C, H, sms), top, x, R, C, need_dx, l, sms, dx,
                dw, ds, ws, (cudaStream_t)stream);
}

extern "C" long long sv_sa_stats_bwd_ws(int R, int C, int upto, int H1, int H2, int H3,
                                        int sms) {
  if (upto < 1 || upto > 3) return -1;
  const int H[3] = {H1, H2, H3};
  return (long long)pb_plan(PB_HEAD, upto, R, C, H, sms).total;
}

// dsym = bf16(dG + dG^T) [H][H] and dS [H], H = H_upto
extern "C" int sv_sa_stats_bwd(const float* x, int R, int C, int upto, int need_dx,
                               const bf16* w1, const float* a1, const float* b1,
                               const bf16* w2, const float* a2, const float* b2,
                               const bf16* w3, const float* a3, const float* b3, int H1, int H2,
                               int H3, int sms, const bf16* dsym, const float* dS, float* dx,
                               float* dw, float* ds, void* ws, void* stream) {
  const int H[3] = {H1, H2, H3};
  const PbLayers l = {{w1, w2, w3}, {a1, a2, a3}, {b1, b2, b3}};
  if (!pb_shapes_ok(R, C, upto, H, sms)) return (int)cudaErrorInvalidValue;
  PbTop top = {};
  top.dsym = dsym, top.dS = dS;
  return pb_run(pb_plan(PB_HEAD, upto, R, C, H, sms), top, x, R, C, need_dx, l, sms, dx,
                dw, ds, ws, (cudaStream_t)stream);
}
