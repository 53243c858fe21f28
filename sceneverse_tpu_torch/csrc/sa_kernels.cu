// Frozen set-abstraction kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of sceneverse_tpu/ops/pallas/sa_forward.py:
//   sv_fps               <- _fps_inline (:229) / _fps_kernel_t (:294)
//   sv_sa_fwd            <- _kernel (:353) body and _kernel_dense_batched (:98):
//                           ball query, compaction of the in-ball pairs, the
//                           3-layer folded MLP (layers 2-3 on mma.sync) and
//                           the max-pool
// Design notes live in sceneverse_tpu_torch/ops/sa_forward.py.
#include "common.cuh"

// ---------------------------------------------------------------------------
// FPS: one warp per object, no block barrier. The warp stages its object's
// xyz once into its own shared-memory copy (16-byte loads where aligned);
// lane l owns points l + 32 k. With PPL > 0 (N <= 32 PPL) their coordinates
// and running min-distances live in registers (every index static); with
// PPL == 0 (large N) the min-distances stay in the warp's shared memory.
// Each step: the lane's distances and its best (value, index), an xor
// butterfly over (value, index) with the lowest index winning a tie, so that
// every lane holds the winner, whose coordinates come from the warp's copy.
// The step's index goes to a list (shared memory, or the output itself when
// PPL == 0); the centers and indices leave in one coalesced pass at the end.
// ---------------------------------------------------------------------------
constexpr int SV_FPS_WARPS = 4;  // objects per block of the register path

__device__ __forceinline__ void sv_argmax_merge(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// floats of one warp's region: xyz (3 N, to a 16-byte multiple), then the
// step list (register path) or the min-distances (shared path)
__host__ __device__ inline int sv_fps_xyz_floats(int N) { return (3 * N + 3) & ~3; }
__host__ __device__ inline int sv_fps_warp_floats(int N, int npoint, int ppl) {
  return sv_fps_xyz_floats(N) + (ppl ? (npoint + 3) & ~3 : N);
}

template <int PPL>
__global__ void __launch_bounds__((PPL ? SV_FPS_WARPS : 1) * 32)
sv_fps_kernel(const float* __restrict__ xyz, int G, int N, int npoint,
              float* __restrict__ new_xyz, int* __restrict__ out_idx) {
  constexpr int W = PPL ? SV_FPS_WARPS : 1;
  extern __shared__ __align__(16) float fsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * W + warp;
  if (g >= G) return;  // the warp's own object only: nothing waits on it
  float* s = fsm + warp * sv_fps_warp_floats(N, npoint, PPL);
  const float* p = xyz + (size_t)g * N * 3;
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = lane; i < 3 * N / 4; i += 32) s4[i] = __ldg(p4 + i);
  } else {
    for (int i = lane; i < 3 * N; i += 32) s[i] = __ldg(p + i);
  }
  __syncwarp();
  // near-origin (padding) points are never candidates: -1 stays below every
  // distance; a slot past N holds -inf and never wins
  int* list = PPL ? reinterpret_cast<int*>(s + sv_fps_xyz_floats(N))
                  : out_idx + (size_t)g * npoint;
  float px[PPL ? PPL : 1], py[PPL ? PPL : 1], pz[PPL ? PPL : 1], md[PPL ? PPL : 1];
  float* mdS = s + sv_fps_xyz_floats(N);
  if constexpr (PPL > 0) {
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int i = lane + 32 * k;
      const bool in = i < N;
      px[k] = in ? s[3 * i] : 0.f;
      py[k] = in ? s[3 * i + 1] : 0.f;
      pz[k] = in ? s[3 * i + 2] : 0.f;
      md[k] = !in ? -INFINITY : (sv_sq3(px[k], py[k], pz[k]) > 1e-3f ? 1e10f : -1.0f);
    }
  } else {
    for (int i = lane; i < N; i += 32)
      mdS[i] = sv_sq3(s[3 * i], s[3 * i + 1], s[3 * i + 2]) > 1e-3f ? 1e10f : -1.0f;
  }
  int old = 0;
  if (lane == 0) list[0] = 0;
  for (int j = 1; j < npoint; ++j) {
    const float cx = s[3 * old], cy = s[3 * old + 1], cz = s[3 * old + 2];
    float bv = -INFINITY;
    int bi = N;
    if constexpr (PPL > 0) {
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        md[k] = fminf(md[k], sv_sq3(px[k] - cx, py[k] - cy, pz[k] - cz));
        if (md[k] > bv) { bv = md[k]; bi = lane + 32 * k; }  // strict: lowest k
      }
    } else {
      for (int i = lane; i < N; i += 32) {
        const float m = fminf(mdS[i], sv_sq3(s[3 * i] - cx, s[3 * i + 1] - cy,
                                             s[3 * i + 2] - cz));
        mdS[i] = m;
        if (m > bv) { bv = m; bi = i; }
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float v2 = __shfl_xor_sync(SV_FULL_MASK, bv, off);
      const int i2 = __shfl_xor_sync(SV_FULL_MASK, bi, off);
      sv_argmax_merge(bv, bi, v2, i2);
    }
    old = bi;  // the same on every lane
    if (lane == 0) list[j] = old;
  }
  if constexpr (PPL == 0) __threadfence_block();  // the list is the output
  __syncwarp();
  int* oi = out_idx + (size_t)g * npoint;
  if constexpr (PPL > 0)
    for (int j = lane; j < npoint; j += 32) oi[j] = list[j];
  float* oc = new_xyz + (size_t)g * npoint * 3;
  for (int e = lane; e < 3 * npoint; e += 32) {
    const int j = e / 3;
    oc[e] = s[3 * list[j] + e - 3 * j];
  }
}

// ---------------------------------------------------------------------------
// SA forward: ball query, compaction, the 3-layer folded MLP and the
// max-pool in one kernel for both entries (the design notes at the top of
// ops/sa_forward.py). Persistent blocks of 2 x (H3 / 32) warps walk the
// objects; w2 and w3 (bf16) stay in shared memory for the block's life.
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int SK_TM = 64;            // pair rows per tile: 2 warp rows of 32
constexpr int SK_SB = 16;            // staging loads in flight per thread
constexpr int SK_TABLE_MAX = 16384;  // bytes of the bf16 per-point layer-1 table

// The layer-1 projection pw = bf16(bf16(p) @ w1) comes from a per-point
// table where it fits (table: points staged bf16 [rows][kp + 8], w1 bf16
// [kp][H1 + 8], both zero-padded to kp = C rounded up to 16, one mma.sync
// product per object) and per pair otherwise (points staged as bf16-rounded
// f32 [N][C], w1 f32 [C][H1], an f32 FMA chain over k in order).
// The ball query's buffers (xyz planes, the per-center lists) share their
// bytes with the tiles' (h1, h2): the two are never live at once.
struct SkPlan {
  int table, kp, rows;  // per-point table?, C padded to 16, staged point rows
  int w1, w2, w3, aff, h1, h2, xyz, sel, pts, pw, ctr, cw, pool, pair, cnt, off, total;
};

__host__ __device__ inline int sk_align(int b) { return (b + 127) & ~127; }

// Shared-memory plan (byte offsets), the same on host and device.
__host__ __device__ inline SkPlan sk_plan(int N, int C, int m, int nsample, int H1, int H2,
                                          int H3) {
  SkPlan s;
  const int lim = nsample < N ? nsample : N;  // list slots per center
  s.table = N * H1 * 2 <= SK_TABLE_MAX;
  s.kp = (C + 15) & ~15;
  s.rows = s.table ? (N + 31) & ~31 : N;
  int off = 0;
  s.w1 = off;   off += sk_align(s.table ? s.kp * (H1 + 8) * 2 : C * H1 * 4);
  s.w2 = off;   off += sk_align(H1 * (H2 + 8) * 2);
  s.w3 = off;   off += sk_align(H2 * (H3 + 8) * 2);
  s.aff = off;  off += sk_align(2 * (H2 + H3) * 4);
  s.h1 = off;
  s.h2 = s.h1 + sk_align(SK_TM * (H1 + 8) * 2);
  s.xyz = off;
  s.sel = s.xyz + sk_align(3 * N * 4);
  const int tiles = s.h2 + sk_align(SK_TM * (H2 + 8) * 2), lists = s.sel + sk_align(m * lim * 4);
  off = tiles > lists ? tiles : lists;
  s.pts = off;  off += sk_align(s.table ? s.rows * (s.kp + 8) * 2 : N * C * 4);
  s.pw = off;   off += s.table ? sk_align(N * H1 * 2) : 0;
  s.ctr = off;  off += sk_align(m * 6 * 4);
  s.cw = off;   off += sk_align(m * H1 * 4);
  s.pool = off; off += sk_align(m * H3 * 4);
  s.pair = off; off += sk_align(m * lim * 4);
  s.cnt = off;  off += sk_align(m * 4);
  s.off = off;  off += sk_align((m + 1) * 4);
  s.total = off;
  return s;
}

__device__ __forceinline__ float sk_affine(float u, float a, float b) {
  return __fadd_rn(__fmul_rn(u, a), b);
}

// layer 1 of one (pair, column), the w1-fold of the plain twins: the dense
// branch's relu(a1 (pw - cw) + b1), the selection branch's
// relu(a1 pw + (b1 - a1 cw))
__device__ __forceinline__ float sk_layer1(float pw, float cw, float a, float b, bool dense) {
  const float v = dense ? __fadd_rn(__fmul_rn(a, __fsub_rn(pw, cw)), b)
                        : __fadd_rn(__fmul_rn(a, pw), __fsub_rn(b, __fmul_rn(a, cw)));
  return fmaxf(v, 0.f);
}

// acc (32 rows x NT n8 tiles) += A (32 x K rows of stride LA) B (K x NT * 8,
// stride LB), both bf16 in shared memory, on mma.sync m16n8k16
template <int NT>
__device__ __forceinline__ void sk_mma(float (&acc)[2][NT][4], const bf16* A, int LA,
                                       const bf16* B, int LB, int K, int lane) {
#pragma unroll 8
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      sv_ldsm4(af[mi], A + (mi * 16 + (lane & 15)) * LA + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      sv_ldsm4_t(b, B + (kk + (lane & 15)) * LB + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        sv_mma(acc[mi][2 * np], af[mi], b[0], b[1]);
        sv_mma(acc[mi][2 * np + 1], af[mi], b[2], b[3]);
      }
    }
  }
}

// the lane's values of 8-row slot s (rows 8 s + lane / 4 of the warp's 32):
// v[2 ni + e] at column ni * 8 + 2 (lane % 4) + e
template <int NT>
__device__ __forceinline__ void sk_slot(float (&v)[2 * NT], const float (&acc)[2][NT][4],
                                        int s) {
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    v[2 * ni] = acc[s >> 1][ni][2 * (s & 1)];
    v[2 * ni + 1] = acc[s >> 1][ni][2 * (s & 1) + 1];
  }
}

// one round of the fold: the lanes that differ in MASK swap halves and keep
// the max of the half they hold
template <int H, int MASK, int V>
__device__ __forceinline__ void sk_fold(float (&v)[V], int lane) {
  const bool up = lane & MASK;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = fmaxf(keep, __shfl_xor_sync(SV_FULL_MASK, send, MASK));
  }
}

// the max of each of the lane's V values over the 8 lanes of its column pair
// (the 8 rows of a slot of one center), folded so that each lane ends with
// V / 8 of them, then one shared atomicMax each on the bits of the
// non-negative values into the center's pool row
template <int V>
__device__ __forceinline__ void sk_pool_flush(float (&v)[V], unsigned* pool, int lane) {
  static_assert(V >= 8, "the fold needs 8 values per lane");
  sk_fold<V / 2, 16>(v, lane);
  sk_fold<V / 4, 8>(v, lane);
  sk_fold<V / 8, 4>(v, lane);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int o = i + (V / 8) * (lane >> 2);  // its index before the fold
    atomicMax(pool + (o >> 1) * 8 + (lane & 3) * 2 + (o & 1), __float_as_uint(v[i]));
  }
}

// warps per row of warps: each warp takes 32 columns of layer 3 and 16 of
// layer 2; the block has 2 x SK_WN warps
template <int H3> constexpr int SK_WN = H3 / 32;
template <int H3> constexpr int SK_THREADS = 64 * SK_WN<H3>;

template <int H1, int H2, int H3>
__global__ void __launch_bounds__(SK_THREADS<H3>, H3 <= 128 ? 2 : 1)
sv_sa_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ centers,
                 const bf16* __restrict__ w1, const float* __restrict__ a1,
                 const float* __restrict__ b1,
                 const bf16* __restrict__ w2, const float* __restrict__ a2,
                 const float* __restrict__ b2,
                 const bf16* __restrict__ w3, const float* __restrict__ a3,
                 const float* __restrict__ b3,
                 float* __restrict__ pooled, int G, int N, int C, int m, int nsample,
                 float r2) {
  constexpr int WN = SK_WN<H3>, T = SK_THREADS<H3>, NW = T / 32;
  static_assert(H2 == 16 * WN && H3 == 32 * WN && H1 % 16 == 0 && T % (H1 / 2) == 0,
                "layer 2: 16 columns a warp, layer 3: 32");
  constexpr int L1 = H1 + 8, L2 = H2 + 8, L3 = H3 + 8;  // bf16 row strides
  constexpr int CP1 = H1 / 2;                           // layer-1 column pairs
  constexpr int RPT = SK_TM / (T / CP1);                // layer-1 rows per thread
  extern __shared__ __align__(128) unsigned char sk_smem[];
  const SkPlan P = sk_plan(N, C, m, nsample, H1, H2, H3);
  bf16* w2S = reinterpret_cast<bf16*>(sk_smem + P.w2);
  bf16* w3S = reinterpret_cast<bf16*>(sk_smem + P.w3);
  float* a2S = reinterpret_cast<float*>(sk_smem + P.aff);
  float* b2S = a2S + H2;
  float* a3S = b2S + H2;
  float* b3S = a3S + H3;
  bf16* h1S = reinterpret_cast<bf16*>(sk_smem + P.h1);
  bf16* h2S = reinterpret_cast<bf16*>(sk_smem + P.h2);
  float* xyzS = reinterpret_cast<float*>(sk_smem + P.xyz);  // x, y, z planes, raw
  float* ptsS = reinterpret_cast<float*>(sk_smem + P.pts);  // per pair: bf16-rounded f32
  bf16* ptsB = reinterpret_cast<bf16*>(sk_smem + P.pts);    // table: bf16, zero-padded
  float* w1F = reinterpret_cast<float*>(sk_smem + P.w1);    // per pair: w1 in f32
  bf16* w1B = reinterpret_cast<bf16*>(sk_smem + P.w1);      // table: w1, zero-padded
  bf16* pwS = reinterpret_cast<bf16*>(sk_smem + P.pw);
  float* ctrS = reinterpret_cast<float*>(sk_smem + P.ctr);  // raw xyz, bf16 xyz
  float* cwS = reinterpret_cast<float*>(sk_smem + P.cw);    // bf16(center) @ w1[:3]
  unsigned* poolS = reinterpret_cast<unsigned*>(sk_smem + P.pool);
  int* selS = reinterpret_cast<int*>(sk_smem + P.sel);
  int* pairS = reinterpret_cast<int*>(sk_smem + P.pair);  // (center << 16) | point
  int* cntS = reinterpret_cast<int*>(sk_smem + P.cnt);
  int* offS = reinterpret_cast<int*>(sk_smem + P.off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WN, wc = warp % WN;  // the warp's 32 rows, its columns
  const bool dense = nsample >= N;
  const int lim = min(nsample, N);
  const int LK = P.kp + 8;  // bf16 row stride of the table's operands

  // once per block: w2, w3 into shared memory, a2 .. b3 beside them
  for (int i = tid; i < H1 * H2 / 8; i += T) {
    const int r = i / (H2 / 8), c = i % (H2 / 8) * 8;
    sv_cp16(w2S + r * L2 + c, w2 + r * H2 + c, 16);
  }
  for (int i = tid; i < H2 * H3 / 8; i += T) {
    const int r = i / (H3 / 8), c = i % (H3 / 8) * 8;
    sv_cp16(w3S + r * L3 + c, w3 + r * H3 + c, 16);
  }
  sv_cp_commit();
  if (P.table) {  // w1 zero-padded to kp rows; the points' pad columns zeroed once
    for (int i = tid; i < P.kp * H1; i += T) {
      const int k = i / H1, j = i - k * H1;
      w1B[k * (H1 + 8) + j] = k < C ? w1[i] : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < P.rows * (P.kp - C); i += T) {
      const int p = i / (P.kp - C);
      ptsB[p * LK + C + i - p * (P.kp - C)] = __float2bfloat16_rn(0.f);
    }
  } else {
    for (int i = tid; i < C * H1; i += T) w1F[i] = __bfloat162float(w1[i]);
  }
  for (int i = tid; i < H2; i += T) { a2S[i] = a2[i]; b2S[i] = b2[i]; }
  for (int i = tid; i < H3; i += T) { a3S[i] = a3[i]; b3S[i] = b3[i]; }
  // the thread's layer-1 columns jp, jp + 1
  const int jp = tid % CP1 * 2;
  const float2 a1j = make_float2(a1[jp], a1[jp + 1]), b1j = make_float2(b1[jp], b1[jp + 1]);

  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    const float* Pg = pts + (size_t)g * N * C;
    const float* Cg = centers + (size_t)g * m * 3;
    for (int base = 0; base < N * C; base += SK_SB * T) {
      float v[SK_SB];  // SK_SB loads in flight before the first store
#pragma unroll
      for (int u = 0; u < SK_SB; ++u) {
        const int i = base + u * T + tid;
        v[u] = i < N * C ? __ldg(Pg + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SK_SB; ++u) {
        const int i = base + u * T + tid;
        if (i >= N * C) break;
        const int p = i / C, k = i - p * C;
        if (P.table) ptsB[p * LK + k] = __float2bfloat16_rn(v[u]);
        else ptsS[i] = sv_bf16r(v[u]);
        if (k < 3) xyzS[k * N + p] = v[u];
      }
    }
    for (int i = tid; i < m * 3; i += T) {
      const float x = Cg[i];
      ctrS[i / 3 * 6 + i % 3] = x;
      ctrS[i / 3 * 6 + 3 + i % 3] = sv_bf16r(x);
    }
    for (int i = tid; i < m * H3; i += T) poolS[i] = 0u;  // post-ReLU >= 0
    sv_cp_wait<0>();
    __syncthreads();
    if (g + gridDim.x < G) {  // the block's next object into L2 while this one runs
      const char* nx = reinterpret_cast<const char*>(pts + (size_t)(g + gridDim.x) * N * C);
      for (int i = tid * 128; i < N * C * 4; i += T * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(nx + i));
    }

    // ball query: a warp lists, for up to 4 centers at once, the first lim
    // in-ball points (strict d2 < r^2) in index order; an empty ball takes
    // point 0
    for (int c0 = warp; c0 < m; c0 += 4 * NW) {
      float cx[4], cy[4], cz[4];
      int cnt[4];
      int* list[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = min(c0 + u * NW, m - 1);
        cx[u] = ctrS[c * 6];
        cy[u] = ctrS[c * 6 + 1];
        cz[u] = ctrS[c * 6 + 2];
        cnt[u] = c0 + u * NW < m ? 0 : lim;  // no center: nothing to list
        list[u] = selS + c * lim;
      }
      sv_ball_scan4<false>(xyzS, xyzS + N, xyzS + 2 * N, 1, N, r2, lim, cx, cy, cz, list,
                           cnt, lane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * NW;
        if (c < m && lane == 0) {
          if (cnt[u] == 0) selS[c * lim] = 0;
          cntS[c] = max(min(cnt[u], lim), 1);
        }
      }
    }
    for (int i = tid; i < m * H1; i += T) {  // the centering term, f32
      const int c = i / H1, j = i - c * H1;
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w[k] = P.table ? __bfloat162float(w1B[k * (H1 + 8) + j]) : w1F[k * H1 + j];
      const float* cb = ctrS + c * 6 + 3;
      float acc = __fmul_rn(cb[0], w[0]);
      acc = __fadd_rn(acc, __fmul_rn(cb[1], w[1]));
      cwS[i] = __fadd_rn(acc, __fmul_rn(cb[2], w[2]));
    }
    if (P.table) {  // pw of every point: bf16(ptsB w1B), 32 x 16 outputs per warp task
      for (int t = warp; t < P.rows / 32 * (H1 / 16); t += NW) {
        const int p0 = t / (H1 / 16) * 32, j0 = t % (H1 / 16) * 16;
        float acc[2][2][4] = {};
        sk_mma<2>(acc, ptsB + p0 * LK, LK, w1B + j0, H1 + 8, P.kp, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = p0 + mi * 16 + h * 8 + (lane >> 2);
              if (p < N)
                *reinterpret_cast<uint32_t*>(pwS + p * H1 + j0 + ni * 8 + (lane & 3) * 2) =
                    sv_pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            }
      }
    }
    __syncthreads();
    if (warp == 0) {  // each center's first row: an exclusive scan of the counts
      int run = 0;
      for (int base = 0; base < m; base += 32) {
        const int c = base + lane, v = c < m ? cntS[c] : 0;
        int inc = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(SV_FULL_MASK, inc, o);
          if (lane >= o) inc += u;
        }
        if (c < m) offS[c] = run + inc - v;
        run += __shfl_sync(SV_FULL_MASK, inc, 31);
      }
      if (lane == 0) offS[m] = run;
    }
    __syncthreads();
    for (int i = tid; i < m * lim; i += T) {  // the pairs, center-major
      const int c = i / lim, s = i - c * lim;
      if (s < cntS[c]) pairS[offS[c] + s] = (c << 16) | selS[i];
    }
    __syncthreads();
    const int R = offS[m];

    for (int r0 = 0; r0 < R; r0 += SK_TM) {
      // layer 1 -> h1S (bf16, the A layout of ldmatrix); rows past R are 0.
      // The thread's RPT rows at columns jp, jp + 1, k outermost for the
      // per-pair chain
      {
        int cq[RPT], pq[RPT];
        float2 pw[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int r = r0 + tid / CP1 + q * (T / CP1);
          const int pr = r < R ? pairS[r] : 0;
          cq[q] = r < R ? pr >> 16 : -1;
          pq[q] = pr & 0xffff;
          pw[q] = make_float2(0.f, 0.f);
        }
        if (P.table) {
#pragma unroll
          for (int q = 0; q < RPT; ++q)
            pw[q] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(pwS + pq[q] * H1 + jp));
        } else {
          for (int k = 0; k < C; ++k) {
            const float2 w = *reinterpret_cast<const float2*>(w1F + k * H1 + jp);
#pragma unroll
            for (int q = 0; q < RPT; ++q) {
              const float x = ptsS[pq[q] * C + k];
              pw[q].x = fmaf(x, w.x, pw[q].x);
              pw[q].y = fmaf(x, w.y, pw[q].y);
            }
          }
#pragma unroll
          for (int q = 0; q < RPT; ++q) pw[q] = make_float2(sv_bf16r(pw[q].x), sv_bf16r(pw[q].y));
        }
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          uint32_t packed = 0u;
          if (cq[q] >= 0) {
            const float2 cw = *reinterpret_cast<const float2*>(cwS + cq[q] * H1 + jp);
            packed = sv_pack_bf16(sk_layer1(pw[q].x, cw.x, a1j.x, b1j.x, dense),
                                  sk_layer1(pw[q].y, cw.y, a1j.y, b1j.y, dense));
          }
          const int rr = tid / CP1 + q * (T / CP1);
          *reinterpret_cast<uint32_t*>(h1S + rr * L1 + jp) = packed;
        }
      }
      __syncthreads();
      // layer 2: h2 = bf16(relu(h1 w2 * a2 + b2)) -> h2S
      {
        constexpr int NT = H2 / WN / 8;
        float acc[2][NT][4] = {};
        sk_mma<NT>(acc, h1S + wr * 32 * L1, L1, w2S + wc * (H2 / WN), L2, H1, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const int row = wr * 32 + mi * 16 + (lane >> 2);
            const int col = wc * (H2 / WN) + ni * 8 + (lane & 3) * 2;
            const float2 a = *reinterpret_cast<const float2*>(a2S + col);
            const float2 b = *reinterpret_cast<const float2*>(b2S + col);
            const float* u = acc[mi][ni];
            *reinterpret_cast<uint32_t*>(h2S + row * L2 + col) =
                sv_pack_bf16(fmaxf(sk_affine(u[0], a.x, b.x), 0.f),
                             fmaxf(sk_affine(u[1], a.y, b.y), 0.f));
            *reinterpret_cast<uint32_t*>(h2S + (row + 8) * L2 + col) =
                sv_pack_bf16(fmaxf(sk_affine(u[2], a.x, b.x), 0.f),
                             fmaxf(sk_affine(u[3], a.y, b.y), 0.f));
          }
      }
      __syncthreads();
      // layer 3: h3 = relu(h2 w3 * a3 + b3) (f32), pooled from the registers
      {
        constexpr int NT = H3 / WN / 8, V = 2 * NT;
        float acc[2][NT][4] = {};
        sk_mma<NT>(acc, h2S + wr * 32 * L2, L2, w3S + wc * (H3 / WN), L3, H2, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const int col = wc * (H3 / WN) + ni * 8 + (lane & 3) * 2;
            const float2 a = *reinterpret_cast<const float2*>(a3S + col);
            const float2 b = *reinterpret_cast<const float2*>(b3S + col);
            float* u = acc[mi][ni];
            u[0] = fmaxf(sk_affine(u[0], a.x, b.x), 0.f) + 0.f;  // no -0 in the max
            u[1] = fmaxf(sk_affine(u[1], a.y, b.y), 0.f) + 0.f;
            u[2] = fmaxf(sk_affine(u[2], a.x, b.x), 0.f) + 0.f;
            u[3] = fmaxf(sk_affine(u[3], a.y, b.y), 0.f) + 0.f;
          }
        // the warp's four 8-row slots: a slot whose rows all hold one center
        // joins the run of slots of that center in registers, and a run
        // leaves through sk_pool_flush; a slot of several centers (or past
        // R) sends each row's values to its own center (the lane's row)
        unsigned* pool = poolS + wc * (H3 / WN);
        float run[V];
        int rc = -1;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int row0 = r0 + wr * 32 + s * 8;
          const int c0 = row0 < R ? pairS[row0] >> 16 : -1;
          const bool one = row0 + 7 < R && pairS[row0 + 7] >> 16 == c0;  // warp-uniform
          float cur[V];
          sk_slot<NT>(cur, acc, s);
          if (one && c0 == rc) {
#pragma unroll
            for (int i = 0; i < V; ++i) run[i] = fmaxf(run[i], cur[i]);
            continue;
          }
          if (rc >= 0) sk_pool_flush<V>(run, pool + rc * H3, lane);
          rc = -1;
          if (one) {
            rc = c0;
#pragma unroll
            for (int i = 0; i < V; ++i) run[i] = cur[i];
          } else if (row0 + (lane >> 2) < R) {
            const int c = pairS[row0 + (lane >> 2)] >> 16;
#pragma unroll
            for (int i = 0; i < V; ++i)
              atomicMax(pool + c * H3 + (i >> 1) * 8 + (lane & 3) * 2 + (i & 1),
                        __float_as_uint(cur[i]));
          }
        }
        if (rc >= 0) sk_pool_flush<V>(run, pool + rc * H3, lane);
      }
      // the next tile's layer 1 writes h1S, which every warp has read
    }
    __syncthreads();
    float* out = pooled + (size_t)g * m * H3;
    for (int i = tid; i < m * H3; i += T) out[i] = __uint_as_float(poolS[i]);
    __syncthreads();
  }
}

template <int H1, int H2, int H3>
static int sk_launch(const float* pts, const float* centers, const bf16* w1, const float* a1,
                     const float* b1, const bf16* w2, const float* a2, const float* b2,
                     const bf16* w3, const float* a3, const float* b3, float* pooled, int G,
                     int N, int C, int m, int nsample, float r2, cudaStream_t stream) {
  const int smem = sk_plan(N, C, m, nsample, H1, H2, H3).total;
  cudaError_t e = cudaFuncSetAttribute(sv_sa_fwd_kernel<H1, H2, H3>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sv_sa_fwd_kernel<H1, H2, H3>,
                                                    SK_THREADS<H3>, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = G < sms * per_sm ? G : sms * per_sm;  // persistent: one wave
  sv_sa_fwd_kernel<H1, H2, H3><<<grid, SK_THREADS<H3>, smem, stream>>>(
      pts, centers, w1, a1, b1, w2, a2, b2, w3, a3, b3, pooled, G, N, C, m, nsample, r2);
  return (int)cudaGetLastError();
}

extern "C" int sv_sa_fwd_smem(int N, int C, int m, int nsample, int h1, int h2, int h3) {
  return sk_plan(N, C, m, nsample, h1, h2, h3).total;
}

// widths (64, 64, 128) and (128, 128, 256)
extern "C" int sv_sa_fwd(const float* pts, const float* centers, const void* w1,
                         const float* a1, const float* b1, const void* w2, const float* a2,
                         const float* b2, const void* w3, const float* a3, const float* b3,
                         float* pooled, int G, int N, int C, int m, int nsample, int h1,
                         float r2, void* stream) {
  const auto* W1 = static_cast<const bf16*>(w1);
  const auto* W2 = static_cast<const bf16*>(w2);
  const auto* W3 = static_cast<const bf16*>(w3);
  cudaStream_t s = (cudaStream_t)stream;
  if (h1 == 64)
    return sk_launch<64, 64, 128>(pts, centers, W1, a1, b1, W2, a2, b2, W3, a3, b3, pooled,
                                  G, N, C, m, nsample, r2, s);
  if (h1 == 128)
    return sk_launch<128, 128, 256>(pts, centers, W1, a1, b1, W2, a2, b2, W3, a3, b3, pooled,
                                    G, N, C, m, nsample, r2, s);
  return (int)cudaErrorInvalidValue;
}

// points per lane of the register path; 0: the shared-memory path
static int sv_fps_ppl(int N) {
  int ppl = 1;
  while (32 * ppl < N && ppl < 32) ppl *= 2;
  return 32 * ppl < N ? 0 : ppl;
}

extern "C" int sv_fps_smem(int N, int npoint) {
  const int ppl = sv_fps_ppl(N);
  return 4 * (ppl ? SV_FPS_WARPS : 1) * sv_fps_warp_floats(N, npoint, ppl);
}

template <int PPL>
static int sv_fps_launch(const float* xyz, int G, int N, int npoint, float* new_xyz, int* idx,
                         cudaStream_t stream) {
  constexpr int W = PPL ? SV_FPS_WARPS : 1;
  static int smem_allowed = 0;  // this instance's opt-in so far (the host's one card)
  const int smem = sv_fps_smem(N, npoint);
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(sv_fps_kernel<PPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  sv_fps_kernel<PPL><<<(G + W - 1) / W, W * 32, smem, stream>>>(xyz, G, N, npoint, new_xyz,
                                                                 idx);
  return (int)cudaGetLastError();
}

extern "C" int sv_fps(const float* xyz, int G, int N, int npoint, float* new_xyz,
                      int* idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (sv_fps_ppl(N)) {
    case 1: return sv_fps_launch<1>(xyz, G, N, npoint, new_xyz, idx, s);
    case 2: return sv_fps_launch<2>(xyz, G, N, npoint, new_xyz, idx, s);
    case 4: return sv_fps_launch<4>(xyz, G, N, npoint, new_xyz, idx, s);
    case 8: return sv_fps_launch<8>(xyz, G, N, npoint, new_xyz, idx, s);
    case 16: return sv_fps_launch<16>(xyz, G, N, npoint, new_xyz, idx, s);
    case 32: return sv_fps_launch<32>(xyz, G, N, npoint, new_xyz, idx, s);
    default: return sv_fps_launch<0>(xyz, G, N, npoint, new_xyz, idx, s);
  }
}
