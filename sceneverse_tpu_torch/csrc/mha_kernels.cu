// Fused multi-head attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of sceneverse_tpu/ops/pallas/mha.py:
//   sv_mha_fwd <- _mha_fwd_kernel (:181)
//   sv_mha_bwd <- _mha_bwd_kernel (:229), two launches: dq + dsw + delta,
//                 then dk + dv
//
// Layout: q (B, L, H*64), k/v (B, T, H*64) packed heads, head h at column
// h*64; pad (B, T) f32 additive row; optional 'cond' gate sw (B, H, L, 6) f32
// and locs (B, L, T, 5) f32; lse (B, H, L) f32; delta (B, H, L) f32 scratch
// of the backward (rowsum(do * o), written by the dq launch, read by dk/dv).
//
// Every product (q.k^T, p.v, do.v^T, ds.k, ds^T.q, a^T.do) runs on the
// tensor cores through nvcuda::wmma with f32 sums:
//   - bf16 operands: bf16 m16n16k16 fragments;
//   - f32 operands: 3xTF32 on m16n16k8 tf32 fragments. Each operand x splits
//     into big = tf32_rna(x) and small = tf32_rna(x - big) (cvt.rna, through
//     wmma::__float_to_tf32); the sum small.big + big.small + big.big keeps
//     about f32 accuracy (single-pass TF32 keeps ~3 decimal digits and is not
//     used). Three TF32 products per f32 product: the f32 rate of the card's
//     tensor cores is 495 / 3 = 165 TFLOP/s.
// The elementwise work (pad row, gate, exp, dropout counter) needs each
// element's (row, key); wmma accumulator fragments have no documented element
// layout, so scores go through shared memory (store_matrix_sync), as in
// flash_attn.cu. The forward needs the full score row in shared memory
// anyway (exact max and sum before rounding), so nothing extra is stored.
//
// Forward: grid (ceil(L/64), B*H), 8 warps. A block owns 64 query rows of
// one head. It walks K in 32-key tiles, then V in 32-key tiles, through one
// two-stage cp.async ring (tile i+1 loads while tile i multiplies), writing
// the q.k sums of its rows into a 64 x sld f32 slab (sld = ceil(T/16)*16 + 4,
// at least 68); each warp turns its own 16 x 16 block into logits
// s = dot*scale + pad [+ gate] as it lands. A row pass (a lane quad per row,
// keys 4 apart: eight rows in flight per warp, no bank conflicts) then takes
// the row's exact max and sum, lse, and pn = round_v(p / tot) with the
// dropout applied, written in place (bf16: packed into the front half of
// the row). Then o = pn . v over the V tiles. This keeps the TPU kernel's
// rounding points (normalise, round to v's dtype, drop, multiply), which an
// online softmax would move.
// Backward, launch 1 (dq, dsw, delta): grid (ceil(L/64), B*H); the block owns
// 64 query rows, computes delta for them once, walks 32-key (K, V) tile
// pairs: s = q.k^T and dp = do.v^T into shared scratch, ds = p (dp - delta)
// with the gate gradient summed per row inside one warp, dq += ds.k in
// registers. Launch 2 (dk, dv): grid (ceil(T/64), B*H); the block owns 64
// keys, walks 32-row (Q, dO) tile pairs: s, dp as above, a = round(p)
// dropped, dv += a^T.do, dk += ds^T.q. No float atomics: every sum has one
// owner, and two runs agree bit for bit. No (B, H, L, T) tensor reaches
// device memory. In every product but the forward's q.k^T (16 x 16) a warp
// owns a 16 x 32 output block; in the backward warps 0-3 form s while warps
// 4-7 form dp.
//
// Shared memory per block, f32 / bf16 (an SM holds 228 KB, 1 KB of it
// reserved per block):
//   fwd: slab + one 64-row and two 32-row operand tiles; at T = 300
//        (sld 308) 113,664 B / 97,280 B: two blocks per SM; T <= 768 fits.
//   dq:  Q, dO, 2 x (K, V) tiles, s and dp scratch (+ bf16 ds), row data:
//        90,112 B / 62,464 B, independent of L and T.
//   dkv: K, V, 2 x (Q, dO) tiles, s and dp scratch (+ bf16 a, ds), row
//        data: 87,296 B / 63,744 B.
// __launch_bounds__(256, 2): at most 128 registers a thread, two blocks
// (16 warps) per SM. ptxas (sm_90a, nvcc 12.9; chip_smoke.py saves its log
// as ptxas.txt beside its results): registers f32 / bf16 fwd 128 / 96,
// dq 128 / 128, dkv 128 / 126. The f32 backward spills a little at the 128 cap (dq 84 B
// stored / 120 B loaded, dkv 176 / 180 B: the 3xTF32 accumulators of the
// s / dp blocks); the others spill nothing.
// Bound on this card: at GPS lengths the products (f32: 165 TFLOP/s of
// 3xTF32; bf16: 989) above the bytes; in practice the mma.sync rate of wmma
// from shared memory, the per-tile barriers and the row pass. wgmma (64-row
// warpgroup products with B read from shared memory, asynchronous) and TMA
// (one-thread tile copies into an mbarrier ring) would lift the product
// rate and free the copy threads; they are not used here.
#include "common.cuh"
#include <mma.h>
#include <type_traits>

using namespace nvcuda;

constexpr int SV_THREADS = 256;  // 8 warps
constexpr int SV_KT = 32;        // keys (fwd, dq) or query rows (dk/dv) per walked tile
constexpr float SV_LOG1E6 = -13.815510557964274f;  // log(1e-6)

// a staged tile of ROWS x 64 operands of type T: row stride with 16 bytes of
// padding (conflict-free fragment loads)
template <typename T> struct SvTile {
  static constexpr int LD = 64 + 16 / (int)sizeof(T);
};
// f32 scratch strides: s / dp of (64 rows, 32 keys) and of (32 rows, 64 keys)
constexpr int SV_LD32 = SV_KT + 4, SV_LD64 = 64 + 4;
constexpr int SV_LDB32 = SV_KT + 8;  // bf16 ds of (64 rows, 32 keys)

template <typename T> struct SvFrag;
template <> struct SvFrag<float> {  // 3xTF32
  static constexpr int K = 8;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 8, float> Acc;
  template <typename Lay>
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, Lay>;
  template <typename Lay>
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, Lay>;
};
template <> struct SvFrag<__nv_bfloat16> {
  static constexpr int K = 16;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  template <typename Lay>
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, Lay>;
  template <typename Lay>
  using B = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, Lay>;
};

// big = tf32_rna(x) in place, small = tf32_rna(x - big)
template <typename Fr>
__device__ __forceinline__ void sv_split(Fr& big, Fr& small) {
#pragma unroll
  for (int i = 0; i < big.num_elements; ++i) {
    const float x = big.x[i];
    const float hi = wmma::__float_to_tf32(x);
    big.x[i] = hi;
    small.x[i] = wmma::__float_to_tf32(x - hi);
  }
}

template <typename Acc, int N>
__device__ __forceinline__ void sv_zero(Acc (&c)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) wmma::fill_fragment(c[j], 0.f);
}

// c[j] += A (16 x kd) . B_j (kd x 16), j < NJ, kd <= KD a multiple of 16.
// A's k-th column starts at a + k * as (ld lda); B_j's k-th row at
// b + j * bj + k * bs (ld ldb). f32 operands: 3xTF32, the three products
// summed in three accumulators (three independent MMA chains instead of one
// three times as long), added once at the end.
template <typename T, typename LA, typename LB, int KD, int NJ>
__device__ __forceinline__ void sv_mma(typename SvFrag<T>::Acc (&c)[NJ], const T* a, int lda,
                                       int as, const T* b, int ldb, int bj, int bs,
                                       int kd = KD) {
  typedef SvFrag<T> F;
  if constexpr (std::is_same<T, float>::value) {
    typename F::Acc e1[NJ], e2[NJ];
    sv_zero(e1);
    sv_zero(e2);
#pragma unroll
    for (int k = 0; k < KD; k += F::K) {
      if (k >= kd) break;
      typename F::template A<LA> fa, fa_lo;
      wmma::load_matrix_sync(fa, a + k * as, lda);
      sv_split(fa, fa_lo);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename F::template B<LB> fb, fb_lo;
        wmma::load_matrix_sync(fb, b + j * bj + k * bs, ldb);
        sv_split(fb, fb_lo);
        wmma::mma_sync(e1[j], fa_lo, fb, e1[j]);
        wmma::mma_sync(e2[j], fa, fb_lo, e2[j]);
        wmma::mma_sync(c[j], fa, fb, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < c[j].num_elements; ++i) c[j].x[i] += e1[j].x[i] + e2[j].x[i];
  } else {
#pragma unroll
    for (int k = 0; k < KD; k += F::K) {
      if (k >= kd) break;
      typename F::template A<LA> fa;
      wmma::load_matrix_sync(fa, a + k * as, lda);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename F::template B<LB> fb;
        wmma::load_matrix_sync(fb, b + j * bj + k * bs, ldb);
        wmma::mma_sync(c[j], fa, fb, c[j]);
      }
    }
  }
}


template <typename Acc, int N>
__device__ __forceinline__ void sv_store(float* dst, const Acc (&c)[N], int ld) {
#pragma unroll
  for (int j = 0; j < N; ++j) wmma::store_matrix_sync(dst + 16 * j, c[j], ld, wmma::mem_row_major);
}

// rows [r0, r0 + ROWS) of one head (row r at src + r * D) -> dst
// (ROWS x SvTile<T>::LD), zero past nrows
template <int ROWS, typename T>
__device__ __forceinline__ void sv_load_tile(T* dst, const T* __restrict__ src, int D, int r0,
                                             int nrows) {
  constexpr int PER = 16 / (int)sizeof(T), CPR = 64 / PER;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += SV_THREADS) {
    const int r = i / CPR, c = (i % CPR) * PER;
    const bool ok = r0 + r < nrows;
    sv_cp16(dst + r * SvTile<T>::LD + c, ok ? src + (size_t)(r0 + r) * D + c : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float sv_log_sigmoid(float z) {
  // -softplus(-z) = -(max(-z, 0) + log1p(exp(-|z|)))
  return -(fmaxf(-z, 0.f) + log1pf(expf(-fabsf(z))));
}

// counter-based murmur3-finalizer uniform in [0, 1): the stream of
// sceneverse_tpu ops/pallas/mha.py::_uniform01_hash (:133-149)
__device__ __forceinline__ float sv_uniform01(uint32_t seed, uint32_t idx) {
  uint32_t x = idx + seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// The dropout seed lives in device memory (an int64 the caller's device
// generator draws), so a CUDA graph that replays this launch draws a new
// mask each replay; its low 32 bits are the hash's seed. Read only when
// dropout is on (the pointer may be null otherwise).
__device__ __forceinline__ uint32_t sv_seed(const long long* seed, float rate) {
  return rate > 0.f ? (uint32_t)(unsigned long long)__ldg(seed) : 0u;
}

struct SvGate {
  float z, ls, loc;
};

// gate logit z = sw0 + sum_d sw[d+1] * locs[d] (sequential order), its
// log-sigmoid ls, and the clamped/masked additive term loc
__device__ __forceinline__ SvGate sv_gate(const float* __restrict__ swr,
                                          const float* __restrict__ lp, float pad) {
  SvGate g;
  float z = swr[0];
#pragma unroll
  for (int d = 0; d < 5; ++d) z = __fadd_rn(z, __fmul_rn(swr[d + 1], lp[d]));
  g.z = z;
  g.ls = sv_log_sigmoid(z);
  g.loc = pad < -1.f ? SV_LOG1E6 : fmaxf(g.ls, SV_LOG1E6);
  return g;
}

// forward slab: keys padded to 16 (at least 64, for the output tile), +4
static inline __host__ __device__ int sv_tp(int Tn) { return (Tn + 15) / 16 * 16; }
static inline __host__ __device__ int sv_sld(int Tn) {
  const int tp = sv_tp(Tn);
  return (tp > 64 ? tp : 64) + 4;
}

// ----------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(SV_THREADS, 2)
sv_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ pad, const float* __restrict__ sw,
                  const float* __restrict__ locs, T* __restrict__ o, float* __restrict__ lse,
                  int H, int L, int Tn, float scale, float rate, float inv_keep_t, const long long* seed) {
  typedef SvFrag<T> F;
  constexpr int LDT = SvTile<T>::LD, TE = SV_KT * LDT;  // ring stage elements
  constexpr bool BF = !std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char sv_smem[];
  const int tp = sv_tp(Tn), sld = sv_sld(Tn), nt = (tp + SV_KT - 1) / SV_KT;
  float* slab = reinterpret_cast<float*>(sv_smem);  // 64 x sld
  T* Qs = reinterpret_cast<T*>(sv_smem + sizeof(float) * 64 * sld);
  T* ring = Qs + 64 * LDT;  // two stages of SV_KT x LDT
  const int bh = blockIdx.y, b = bh / H, h = bh % H, D = H * 64, r0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rt = warp & 3, ch = warp >> 2;
  const T* qh = q + (size_t)b * L * D + h * 64;
  const T* kh = k + (size_t)b * Tn * D + h * 64;
  const T* vh = v + (size_t)b * Tn * D + h * 64;
  const float* padb = pad + (size_t)b * Tn;

  sv_load_tile<64>(Qs, qh, D, r0, L);
  sv_load_tile<SV_KT>(ring, kh, D, 0, Tn);
  sv_cp_commit();
  typename F::Acc acc[2];
  sv_zero(acc);
  // tiles 0..nt-1 are K, nt..2nt-1 are V, all through the ring
  for (int i = 0; i < 2 * nt; ++i) {
    if (i + 1 < 2 * nt) {
      const int n1 = i + 1;
      sv_load_tile<SV_KT>(ring + (n1 & 1) * TE, n1 < nt ? kh : vh, D, (n1 % nt) * SV_KT, Tn);
      sv_cp_commit();
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (i & 1) * TE;
    if (i < nt) {  // raw q.k sums: warp (rt, ch) owns rows 16rt.., keys 16ch..
      const int col = i * SV_KT + ch * 16;
      if (col < tp) {
        typename F::Acc s[1];
        sv_zero(s);
        sv_mma<T, wmma::row_major, wmma::col_major, 64, 1>(s, Qs + rt * 16 * LDT, LDT, 1,
                                                           st + ch * 16 * LDT, LDT, 0, 1);
        sv_store(slab + rt * 16 * sld + col, s, sld);
        __syncwarp();
        // s = dot*scale + pad [+ gate] on the warp's own 16 x 16 block, in
        // place, while other warps multiply (keys past T stay raw: unread)
        for (int e = lane; e < 256; e += 32) {
          const int rr = rt * 16 + (e >> 4), c = col + (e & 15), r = r0 + rr;
          if (c < Tn) {
            float* sp = slab + rr * sld + c;
            float x = __fadd_rn(__fmul_rn(*sp, scale), padb[c]);
            if (sw && r < L)
              x = __fadd_rn(x, sv_gate(sw + ((size_t)bh * L + r) * 6,
                                       locs + (((size_t)b * L + r) * Tn + c) * 5, padb[c]).loc);
            *sp = x;
          }
        }
      }
    } else {
      if (i == nt) {
        // row pass over the finished logits: lane quad (lane >> 2) of warp
        // w owns row 8w + lane/4 and walks its keys 4 apart (conflict-free);
        // no branch on the row, so the quad's shuffles stay converged
        const float keep = 1.f - rate;
        const uint32_t hseed = sv_seed(seed, rate) + (uint32_t)bh;
        const int tq = lane & 3, rr = warp * 8 + (lane >> 2), r = r0 + rr;
        const bool live = r < L;
        float* srow = slab + rr * sld;
        float mx = -INFINITY;
#pragma unroll 4
        for (int c = tq; c < Tn; c += 4) mx = fmaxf(mx, srow[c]);
        mx = fmaxf(mx, __shfl_xor_sync(SV_FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(SV_FULL_MASK, mx, 2));
        float tot = 0.f;
#pragma unroll 4
        for (int c = tq; c < Tn; c += 4) {
          const float p = expf(srow[c] - mx);
          srow[c] = p;
          tot += p;
        }
        tot += __shfl_xor_sync(SV_FULL_MASK, tot, 1);
        tot += __shfl_xor_sync(SV_FULL_MASK, tot, 2);
        if (live && tq == 0) lse[(size_t)bh * L + r] = mx + logf(tot);
        // value-dtype probabilities, dropped; zero past T and past L. In
        // bf16 the row packs into its front half: chunk c0's writes land on
        // f32 words < c0/2 + 32, read before (c0 = 0: this chunk) or earlier
        for (int c0 = 0; c0 < tp; c0 += 64) {
          float pn[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = c0 + tq + 4 * j;
            float x = 0.f;
            if (live && c < Tn) {
              x = sv_round<T>(srow[c] / tot);
              if (rate > 0.f) {
                const bool kept = sv_uniform01(hseed, (uint32_t)(r * Tn + c)) < keep;
                x = kept ? sv_round<T>(x * inv_keep_t) : 0.f;
              }
            }
            pn[j] = x;
          }
          __syncwarp();
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = c0 + tq + 4 * j;
            if (c < tp) {
              if constexpr (BF)
                reinterpret_cast<T*>(srow)[c] = sv_from<T>(pn[j]);
              else
                srow[c] = pn[j];
            }
          }
          __syncwarp();
        }
        __syncthreads();
      }
      // o += p . v: warp (rt, ch) owns rows 16rt.., columns 32ch..
      const int j0 = (i - nt) * SV_KT;
      const T* P = reinterpret_cast<const T*>(slab) + (BF ? 2 : 1) * rt * 16 * sld + j0;
      sv_mma<T, wmma::row_major, wmma::row_major, SV_KT, 2>(
          acc, P, (BF ? 2 : 1) * sld, 1, st + ch * 32, LDT, 16, LDT, min(SV_KT, tp - j0));
    }
    __syncthreads();
  }
  sv_store(slab + rt * 16 * sld + ch * 32, acc, sld);
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += SV_THREADS) {
    const int rr = e >> 6, d = e & 63, r = r0 + rr;
    if (r < L) o[((size_t)b * L + r) * D + h * 64 + d] = sv_from<T>(slab[rr * sld + d]);
  }
}

// ------------------------------------------------- backward: dq, dsw, delta
template <typename T>
__global__ void __launch_bounds__(SV_THREADS, 2)
sv_mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ pad, const float* __restrict__ sw,
                     const float* __restrict__ locs, const T* __restrict__ dout,
                     const T* __restrict__ o, const float* __restrict__ lse,
                     T* __restrict__ dq, float* __restrict__ dsw, float* __restrict__ delta,
                     int H, int L, int Tn, float scale, float rate, float inv_keep_f, const long long* seed) {
  typedef SvFrag<T> F;
  constexpr int LDT = SvTile<T>::LD, TE = SV_KT * LDT;
  constexpr bool BF = !std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char sv_smem[];
  T* Qs = reinterpret_cast<T*>(sv_smem);
  T* DOs = Qs + 64 * LDT;
  T* ring = DOs + 64 * LDT;  // stage s: K at ring + 2s TE, V at ring + (2s+1) TE
  float* Ss = reinterpret_cast<float*>(ring + 4 * TE);  // 64 x SV_LD32
  float* DPs = Ss + 64 * SV_LD32;
  T* DSb = reinterpret_cast<T*>(DPs + 64 * SV_LD32);  // bf16 only: 64 x SV_LDB32
  float* lseS = reinterpret_cast<float*>(DSb + (BF ? 64 * SV_LDB32 : 0));
  float* delS = lseS + 64;
  float* gS = delS + 64;  // 64 x 6 gate gradient sums
  const int bh = blockIdx.y, b = bh / H, h = bh % H, D = H * 64, r0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rt = warp & 3, ch = warp >> 2;
  const T* kh = k + (size_t)b * Tn * D + h * 64;
  const T* vh = v + (size_t)b * Tn * D + h * 64;
  const float* padb = pad + (size_t)b * Tn;
  const int nt = (Tn + SV_KT - 1) / SV_KT;

  sv_load_tile<64>(Qs, q + (size_t)b * L * D + h * 64, D, r0, L);
  sv_load_tile<64>(DOs, dout + (size_t)b * L * D + h * 64, D, r0, L);
  sv_load_tile<SV_KT>(ring, kh, D, 0, Tn);
  sv_load_tile<SV_KT>(ring + TE, vh, D, 0, Tn);
  sv_cp_commit();
  // delta = rowsum(do * o) once per row, shared with the dk/dv launch
  for (int rr = warp; rr < 64; rr += 8) {
    const int r = r0 + rr;
    float dl = 0.f, lr = 0.f;
    if (r < L) {
      const size_t row = ((size_t)b * L + r) * D + h * 64;
      dl = fmaf(sv_tof(dout[row + lane]), sv_tof(o[row + lane]), 0.f);
      dl = fmaf(sv_tof(dout[row + lane + 32]), sv_tof(o[row + lane + 32]), dl);
      dl = sv_warp_sum(dl);
      lr = lse[(size_t)bh * L + r];
    }
    if (lane == 0) {
      delS[rr] = dl;
      lseS[rr] = lr;
      if (r < L) delta[(size_t)bh * L + r] = dl;
    }
  }
  for (int i = threadIdx.x; i < 64 * 6; i += SV_THREADS) gS[i] = 0.f;
  const float keep = 1.f - rate;
  const uint32_t hseed = sv_seed(seed, rate) + (uint32_t)bh;
  typename F::Acc acc[2];
  sv_zero(acc);
  const T* DSp = BF ? DSb : reinterpret_cast<const T*>(Ss);
  const int ldds = BF ? SV_LDB32 : SV_LD32;
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      T* nx = ring + ((j + 1) & 1) * 2 * TE;
      sv_load_tile<SV_KT>(nx, kh, D, (j + 1) * SV_KT, Tn);
      sv_load_tile<SV_KT>(nx + TE, vh, D, (j + 1) * SV_KT, Tn);
      sv_cp_commit();
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    const T* Kst = ring + (j & 1) * 2 * TE;
    const T* Vst = Kst + TE;
    {  // warps 0-3: s = q.k^T of rows 16rt.., warps 4-7: dp = do.v^T
      typename F::Acc x[2];
      sv_zero(x);
      sv_mma<T, wmma::row_major, wmma::col_major, 64, 2>(
          x, (ch ? DOs : Qs) + rt * 16 * LDT, LDT, 1, ch ? Vst : Kst, LDT, 16 * LDT, 1);
      sv_store((ch ? DPs : Ss) + rt * 16 * SV_LD32, x, SV_LD32);
    }
    __syncthreads();
    // ds = p (dp - delta): warp w owns rows 8w..8w+7, lane the tile's key
    const int key = j * SV_KT + lane;
#pragma unroll 4
    for (int rr = warp * 8; rr < warp * 8 + 8; ++rr) {
      const int r = r0 + rr;
      const bool live = r < L;
      const float* swr = (sw && live) ? sw + ((size_t)bh * L + r) * 6 : nullptr;
      float ds = 0.f, g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (live && key < Tn) {
        float s = __fadd_rn(__fmul_rn(Ss[rr * SV_LD32 + lane], scale), padb[key]);
        SvGate gt;
        const float* lp = nullptr;
        if (swr) {
          lp = locs + (((size_t)b * L + r) * Tn + key) * 5;
          gt = sv_gate(swr, lp, padb[key]);
          s = __fadd_rn(s, gt.loc);
        }
        const float p = expf(s - lseS[rr]);
        float dp = DPs[rr * SV_LD32 + lane];
        if (rate > 0.f) {
          const bool kept = sv_uniform01(hseed, (uint32_t)(r * Tn + key)) < keep;
          dp = kept ? dp * inv_keep_f : 0.f;
        }
        ds = p * (dp - delS[rr]);
        if (swr && gt.ls > SV_LOG1E6 && padb[key] >= -1.f) {
          const float dz = ds * (1.f / (1.f + expf(gt.z)));  // ds * sigmoid(-z)
          g[0] = dz;
#pragma unroll
          for (int d = 0; d < 5; ++d) g[d + 1] = dz * lp[d];
        }
      }
      if constexpr (BF)
        DSb[rr * SV_LDB32 + lane] = sv_from<T>(ds);
      else
        Ss[rr * SV_LD32 + lane] = ds;
      if (sw && live) {  // warp-uniform
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          const float t = sv_warp_sum(g[jj]);
          if (lane == 0) gS[rr * 6 + jj] += t;
        }
      }
    }
    __syncthreads();
    // dq += ds . k: warp (rt, ch) owns rows 16rt.., columns 32ch..
    sv_mma<T, wmma::row_major, wmma::row_major, SV_KT, 2>(acc, DSp + rt * 16 * ldds, ldds, 1,
                                                          Kst + ch * 32, LDT, 16, LDT);
    __syncthreads();
  }
  // dq through the freed ring (an f32 64 x 64 view)
  float* out = reinterpret_cast<float*>(ring);
  sv_store(out + rt * 16 * SV_LD64 + ch * 32, acc, SV_LD64);
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += SV_THREADS) {
    const int rr = e >> 6, d = e & 63, r = r0 + rr;
    if (r < L) dq[((size_t)b * L + r) * D + h * 64 + d] = sv_from<T>(out[rr * SV_LD64 + d] * scale);
  }
  if (sw) {
    for (int e = threadIdx.x; e < 64 * 6; e += SV_THREADS) {
      const int r = r0 + e / 6;
      if (r < L) dsw[((size_t)bh * L + r) * 6 + e % 6] = gS[e];
    }
  }
}

// ------------------------------------------------- backward: dk and dv
template <typename T>
__global__ void __launch_bounds__(SV_THREADS, 2)
sv_mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ pad, const float* __restrict__ sw,
                      const float* __restrict__ locs, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int L, int Tn, float scale,
                      float rate, float inv_keep_t, float inv_keep_f, const long long* seed) {
  typedef SvFrag<T> F;
  constexpr int LDT = SvTile<T>::LD, TE = SV_KT * LDT;
  constexpr bool BF = !std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char sv_smem[];
  T* Ks = reinterpret_cast<T*>(sv_smem);
  T* Vs = Ks + 64 * LDT;
  T* ring = Vs + 64 * LDT;  // stage s: Q at ring + 2s TE, dO at ring + (2s+1) TE
  float* Ss = reinterpret_cast<float*>(ring + 4 * TE);  // SV_KT x SV_LD64
  float* DPs = Ss + SV_KT * SV_LD64;
  T* Ab = reinterpret_cast<T*>(DPs + SV_KT * SV_LD64);  // bf16 only: SV_KT x LDT
  T* DSb = Ab + (BF ? TE : 0);
  float* lseS = reinterpret_cast<float*>(DSb + (BF ? TE : 0));
  float* delS = lseS + SV_KT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, D = H * 64, k0 = blockIdx.x * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rt = warp & 3, ch = warp >> 2;
  const T* qh = q + (size_t)b * L * D + h * 64;
  const T* doh = dout + (size_t)b * L * D + h * 64;
  const float* padb = pad + (size_t)b * Tn;
  const int nq = (L + SV_KT - 1) / SV_KT;

  sv_load_tile<64>(Ks, k + (size_t)b * Tn * D + h * 64, D, k0, Tn);
  sv_load_tile<64>(Vs, v + (size_t)b * Tn * D + h * 64, D, k0, Tn);
  sv_load_tile<SV_KT>(ring, qh, D, 0, L);
  sv_load_tile<SV_KT>(ring + TE, doh, D, 0, L);
  sv_cp_commit();
  const float keep = 1.f - rate;
  const uint32_t hseed = sv_seed(seed, rate) + (uint32_t)bh;
  typename F::Acc acc_k[2], acc_v[2];
  sv_zero(acc_k);
  sv_zero(acc_v);
  const T* Ap = BF ? Ab : reinterpret_cast<const T*>(Ss);
  const T* DSp = BF ? DSb : reinterpret_cast<const T*>(DPs);
  const int lda = BF ? LDT : SV_LD64;
  // s (warps 0-3) or dp (warps 4-7) block: rows 16(w&1).., keys 32((w>>1)&1)..
  const int srt = warp & 1, skh = (warp >> 1) & 1;
  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) {
      T* nx = ring + ((i + 1) & 1) * 2 * TE;
      sv_load_tile<SV_KT>(nx, qh, D, (i + 1) * SV_KT, L);
      sv_load_tile<SV_KT>(nx + TE, doh, D, (i + 1) * SV_KT, L);
      sv_cp_commit();
      sv_cp_wait<1>();
    } else {
      sv_cp_wait<0>();
    }
    __syncthreads();
    if (threadIdx.x < SV_KT) {
      const int r = i * SV_KT + threadIdx.x;
      lseS[threadIdx.x] = r < L ? lse[(size_t)bh * L + r] : 0.f;
      delS[threadIdx.x] = r < L ? delta[(size_t)bh * L + r] : 0.f;
    }
    const T* Qst = ring + (i & 1) * 2 * TE;
    const T* DOst = Qst + TE;
    {
      typename F::Acc x[2];
      sv_zero(x);
      sv_mma<T, wmma::row_major, wmma::col_major, 64, 2>(
          x, (ch ? DOst : Qst) + srt * 16 * LDT, LDT, 1, (ch ? Vs : Ks) + skh * 32 * LDT, LDT,
          16 * LDT, 1);
      sv_store((ch ? DPs : Ss) + srt * 16 * SV_LD64 + skh * 32, x, SV_LD64);
    }
    __syncthreads();
    // warp w owns tile rows 4w..4w+3, lanes the keys (two each)
#pragma unroll
    for (int rr = warp * 4; rr < warp * 4 + 4; ++rr) {
      const int r = i * SV_KT + rr;
      const float* swr = (sw && r < L) ? sw + ((size_t)bh * L + r) * 6 : nullptr;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = lane + 32 * jj, key = k0 + c;
        float a = 0.f, ds = 0.f;
        if (r < L && key < Tn) {
          float s = __fadd_rn(__fmul_rn(Ss[rr * SV_LD64 + c], scale), padb[key]);
          if (swr)
            s = __fadd_rn(s, sv_gate(swr, locs + (((size_t)b * L + r) * Tn + key) * 5,
                                     padb[key]).loc);
          const float p = expf(s - lseS[rr]);
          float dp = DPs[rr * SV_LD64 + c];
          a = sv_round<T>(p);
          if (rate > 0.f) {
            const bool kept = sv_uniform01(hseed, (uint32_t)(r * Tn + key)) < keep;
            a = kept ? sv_round<T>(a * inv_keep_t) : 0.f;
            dp = kept ? dp * inv_keep_f : 0.f;
          }
          ds = sv_round<T>(p * (dp - delS[rr]));
        }
        if constexpr (BF) {
          Ab[rr * LDT + c] = sv_from<T>(a);
          DSb[rr * LDT + c] = sv_from<T>(ds);
        } else {
          Ss[rr * SV_LD64 + c] = a;
          DPs[rr * SV_LD64 + c] = ds;
        }
      }
    }
    __syncthreads();
    // warp (rt, ch): keys 16rt.., columns 32ch..; a^T and ds^T column-major
    sv_mma<T, wmma::col_major, wmma::row_major, SV_KT, 2>(acc_v, Ap + rt * 16, lda, lda,
                                                          DOst + ch * 32, LDT, 16, LDT);
    sv_mma<T, wmma::col_major, wmma::row_major, SV_KT, 2>(acc_k, DSp + rt * 16, lda, lda,
                                                          Qst + ch * 32, LDT, 16, LDT);
    __syncthreads();
  }
  // dk, dv through the freed ring and s / dp scratch behind it (two f32
  // 64 x 64 views; 34,816 bytes, within ring + scratch for both types)
  float* outk = reinterpret_cast<float*>(ring);
  float* outv = outk + 64 * SV_LD64;
  sv_store(outk + rt * 16 * SV_LD64 + ch * 32, acc_k, SV_LD64);
  sv_store(outv + rt * 16 * SV_LD64 + ch * 32, acc_v, SV_LD64);
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += SV_THREADS) {
    const int cc = e >> 6, d = e & 63, key = k0 + cc;
    if (key < Tn) {
      const size_t gi = ((size_t)b * Tn + key) * D + h * 64 + d;
      dk[gi] = sv_from<T>(outk[cc * SV_LD64 + d] * scale);
      dv[gi] = sv_from<T>(outv[cc * SV_LD64 + d]);
    }
  }
}

// ------------------------------------------------------------- C interface
template <typename T> static size_t sv_fwd_smem(int Tn) {
  return sizeof(float) * 64 * (size_t)sv_sld(Tn) + sizeof(T) * (64 + 2 * SV_KT) * SvTile<T>::LD;
}
template <typename T> static size_t sv_dq_smem() {
  const bool bf = !std::is_same<T, float>::value;
  return sizeof(T) * (2 * 64 + 4 * SV_KT) * SvTile<T>::LD + sizeof(float) * 2 * 64 * SV_LD32 +
         (bf ? sizeof(T) * 64 * SV_LDB32 : 0) + sizeof(float) * 64 * 8;
}
template <typename T> static size_t sv_dkv_smem() {
  const bool bf = !std::is_same<T, float>::value;
  return sizeof(T) * (2 * 64 + 4 * SV_KT) * SvTile<T>::LD + sizeof(float) * 2 * SV_KT * SV_LD64 +
         (bf ? sizeof(T) * 2 * SV_KT * SvTile<T>::LD : 0) + sizeof(float) * 2 * SV_KT;
}

template <typename K>
static cudaError_t sv_smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
static int sv_fwd_launch(const void* q, const void* k, const void* v, const float* pad,
                         const float* sw, const float* locs, void* o, float* lse, int B, int H,
                         int L, int Tn, float scale, float rate, float inv_keep_t,
                         const long long* seed, cudaStream_t st) {
  const size_t smem = sv_fwd_smem<T>(Tn);
  cudaError_t e = sv_smem_attr(sv_mha_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  sv_mha_fwd_kernel<T><<<dim3((L + 63) / 64, B * H), SV_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, pad, sw, locs, (T*)o, lse, H, L, Tn, scale, rate,
      inv_keep_t, seed);
  return (int)cudaGetLastError();
}

template <typename T>
static int sv_bwd_launch(const void* q, const void* k, const void* v, const float* pad,
                         const float* sw, const float* locs, const void* dout, const void* o,
                         const float* lse, void* dq, void* dk, void* dv, float* dsw,
                         float* delta, int B, int H, int L, int Tn, float scale, float rate,
                         float inv_keep_t, float inv_keep_f, const long long* seed,
                         cudaStream_t st) {
  size_t smem = sv_dq_smem<T>();
  cudaError_t e = sv_smem_attr(sv_mha_bwd_dq_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  sv_mha_bwd_dq_kernel<T><<<dim3((L + 63) / 64, B * H), SV_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, pad, sw, locs, (const T*)dout, (const T*)o, lse,
      (T*)dq, dsw, delta, H, L, Tn, scale, rate, inv_keep_f, seed);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  smem = sv_dkv_smem<T>();
  e = sv_smem_attr(sv_mha_bwd_dkv_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  sv_mha_bwd_dkv_kernel<T><<<dim3((Tn + 63) / 64, B * H), SV_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, pad, sw, locs, (const T*)dout, lse, delta, (T*)dk,
      (T*)dv, H, L, Tn, scale, rate, inv_keep_t, inv_keep_f, seed);
  return (int)cudaGetLastError();
}

// head width 64 only: every GPS tower runs 12 x 64
#define SV_DISPATCH(FN, ...)                                                         \
  do {                                                                               \
    if (dh != 64 || B * H > 65535) return (int)cudaErrorInvalidValue;                \
    if (bf16) return FN<__nv_bfloat16>(__VA_ARGS__);                                 \
    return FN<float>(__VA_ARGS__);                                                   \
  } while (0)

extern "C" int sv_mha_fwd(int bf16, int dh, const void* q, const void* k, const void* v,
                          const float* pad, const float* sw, const float* locs, void* o,
                          float* lse, int B, int H, int L, int Tn, float scale, float rate,
                          float inv_keep_t, const long long* seed, void* stream) {
  SV_DISPATCH(sv_fwd_launch, q, k, v, pad, sw, locs, o, lse, B, H, L, Tn, scale, rate,
              inv_keep_t, seed, (cudaStream_t)stream);
}

extern "C" int sv_mha_bwd(int bf16, int dh, const void* q, const void* k, const void* v,
                          const float* pad, const float* sw, const float* locs,
                          const void* dout, const void* o, const float* lse, void* dq,
                          void* dk, void* dv, float* dsw, float* delta, int B, int H, int L,
                          int Tn, float scale, float rate, float inv_keep_t, float inv_keep_f,
                          const long long* seed, void* stream) {
  SV_DISPATCH(sv_bwd_launch, q, k, v, pad, sw, locs, dout, o, lse, dq, dk, dv, dsw, delta, B,
              H, L, Tn, scale, rate, inv_keep_t, inv_keep_f, seed, (cudaStream_t)stream);
}
