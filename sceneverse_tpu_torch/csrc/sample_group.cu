// Ball query + grouping for Hopper (sm_90a).
//
// sv_ball_group replaces the ball-query and grouping half of the TPU kernel
// sceneverse_tpu/ops/pallas/sample_group.py::_kernel (:100-159); its FPS half
// is sv_fps in sa_kernels.cu. Design notes live in
// sceneverse_tpu_torch/ops/sample_group.py.
#include "common.cuh"

constexpr int SV_BG_THREADS = 256;
constexpr int SV_BG_WARPS = SV_BG_THREADS / 32;
constexpr int SV_BG_CHUNK = 4 * SV_BG_WARPS;  // centers per pass of the block
constexpr int SV_BG_SMEM_MAX = 232448;        // 227 KB, the most a block may use

// Shared memory in floats: the lists of a chunk of centers (chunk ns ints);
// nbuf buffers of an object's rows (N C) and centers (3 m), each rounded to
// 16 bytes; the x, y, z planes, padded with +inf to a multiple of 32 points.
// Two buffers where they fit, else one. Where one buffer and the planes do
// not fit either, the direct layout (planes == 0): one center a warp, the
// rows alone (centers read from global memory, the scan reads x, y, z from
// the rows), 4 (N C + 8 ns) bytes, so that every object of up to 227 KB
// runs.
struct BgPlan {
  int nbuf, chunk, rows, ctr, planes, buf, total;
};

__host__ __device__ inline BgPlan sv_bg_plan(int N, int C, int m, int ns) {
  BgPlan p;
  p.rows = (N * C + 3) & ~3;
  p.ctr = (3 * m + 3) & ~3;
  p.planes = (N + 31) & ~31;
  p.buf = p.rows + p.ctr;
  p.chunk = 4 * SV_BG_WARPS;
  const int fixed = p.chunk * ns + 3 * p.planes;
  p.nbuf = 4 * (2 * p.buf + fixed) <= SV_BG_SMEM_MAX ? 2 : 1;
  p.total = 4 * (p.nbuf * p.buf + fixed);
  if (p.total > SV_BG_SMEM_MAX) {
    p.chunk = SV_BG_WARPS;
    p.ctr = p.planes = 0;
    p.total = 4 * (p.chunk * ns + N * C);
  }
  return p;
}

// One chunk's grouped rows, one float a thread. The thread follows its
// element's (center, sample, channel) by adding the step's fixed advance,
// so no element pays an integer divide.
__device__ __forceinline__ void sv_bg_write(float* __restrict__ out, int n_el, const float* rowsS,
                                            const float* ctr, const int* sel, int C, int ns,
                                            int exact, int tid) {
  int r = tid / C, ch = tid - r * C;
  int cen = r / ns, s = r - cen * ns;
  const int dr = SV_BG_THREADS / C, dch = SV_BG_THREADS - dr * C;
  const int dcen = dr / ns, ds = dr - dcen * ns;
  for (int e = tid; e < n_el; e += SV_BG_THREADS) {
    float x = rowsS[sel[cen * ns + s] * C + ch];
    if (!exact) x = sv_bf16r(x);
    if (ch < 3) x = __fsub_rn(x, ctr[cen * 3 + ch]);
    out[e] = x;
    ch += dch;
    s += ds;
    cen += dcen;
    if (ch >= C) { ch -= C; ++s; }
    if (s >= ns) { s -= ns; ++cen; }
  }
}

// The same for an even C (the main path's is 6), a group of RG whole rows
// (RG C floats, a multiple of 4) a thread: the rows are read as float2 and
// the group leaves in RG C / 4 16-byte stores.
template <int C>
__device__ __forceinline__ void sv_bg_write_rows(float* __restrict__ out, int n_rows,
                                                 const float* rowsS, const float* ctr,
                                                 const int* sel, int ns, int exact, int tid) {
  static_assert(C % 2 == 0, "rows of 8-byte pairs");
  constexpr int RG = C % 4 == 0 ? 1 : 2, F = RG * C;
  constexpr int STEP = SV_BG_THREADS * RG;  // rows a pass of the block covers
  int r = tid * RG;
  int cen = r / ns, s = r - cen * ns;
  const int dcen = STEP / ns, ds = STEP - dcen * ns;
  for (; r < n_rows; r += STEP) {
    float v[F];
    int cc = cen, ss = s;
#pragma unroll
    for (int a = 0; a < RG; ++a) {
      const float* src = rowsS + sel[cc * ns + ss] * C;  // 8-byte aligned
#pragma unroll
      for (int h = 0; h < C; h += 2) {
        const float2 w = *reinterpret_cast<const float2*>(src + h);
        float x0 = exact ? w.x : sv_bf16r(w.x), x1 = exact ? w.y : sv_bf16r(w.y);
        if (h < 3) x0 = __fsub_rn(x0, ctr[cc * 3 + h]);
        if (h + 1 < 3) x1 = __fsub_rn(x1, ctr[cc * 3 + h + 1]);
        v[a * C + h] = x0;
        v[a * C + h + 1] = x1;
      }
      if (++ss == ns) { ss = 0; ++cc; }
    }
    float4* o = reinterpret_cast<float4*>(out + (size_t)r * C);
#pragma unroll
    for (int k = 0; k < F / 4; ++k)
      o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    s += ds;
    cen += dcen;
    if (s >= ns) { s -= ns; ++cen; }
  }
}

// Persistent blocks walk the objects. The next object's rows and centers are
// in flight (cp.async, second buffer) while the current one is scanned and
// written. Per object: x, y, z planes from the rows; per chunk of up to 32
// centers, each warp lists 4 centers in one pass over the planes
// (sv_ball_scan4: the first nsample points with strict d2 < r2, in index
// order), pads each list with its first hit (point 0 for an empty ball),
// then the block writes the chunk's contiguous indices and grouped rows
// (centered xyz ++ raw channels 3.., each value rounded to bf16 first when
// exact == 0) with 16-byte stores where aligned. The direct layout (see
// BgPlan) stages the rows alone and lists one center a warp from them.
__global__ void __launch_bounds__(SV_BG_THREADS)
sv_ball_group_kernel(const float* __restrict__ pts, const float* __restrict__ centers, int G,
                     int N, int C, int m, int ns, float r2, int exact,
                     float* __restrict__ grouped, int* __restrict__ idx_out) {
  extern __shared__ __align__(16) float bgsm[];
  const BgPlan P = sv_bg_plan(N, C, m, ns);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* sel = reinterpret_cast<int*>(bgsm);
  float* bufs = bgsm + P.chunk * ns;
  float* X = bufs + P.nbuf * P.buf;
  float* Y = X + P.planes;
  float* Z = Y + P.planes;
  const bool vec_rows = (N * C & 3) == 0 && (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
  const bool vec_ctr = (3 * m & 3) == 0 && (reinterpret_cast<uintptr_t>(centers) & 15) == 0;

  auto stage = [&](int g, int b) {  // this thread's share of object g's copies
    float* R = bufs + b * P.buf;
    const float* src = pts + (size_t)g * N * C;
    if (vec_rows)
      for (int i = tid; i < N * C / 4; i += SV_BG_THREADS) sv_cp16(R + 4 * i, src + 4 * i, 16);
    else
      for (int i = tid; i < N * C; i += SV_BG_THREADS) sv_cp4(R + i, src + i);
    if (P.planes == 0) return;
    float* Cs = R + P.rows;
    const float* cg = centers + (size_t)g * m * 3;
    if (vec_ctr)
      for (int i = tid; i < 3 * m / 4; i += SV_BG_THREADS) sv_cp16(Cs + 4 * i, cg + 4 * i, 16);
    else
      for (int i = tid; i < 3 * m; i += SV_BG_THREADS) sv_cp4(Cs + i, cg + i);
  };

  int b = 0;
  if (P.nbuf == 2) stage(blockIdx.x, 0);
  sv_cp_commit();
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    if (P.nbuf == 1) {
      stage(g, 0);
      sv_cp_commit();
      sv_cp_wait<0>();
    } else {  // object g's group was committed one iteration ago
      if (g + (int)gridDim.x < G) stage(g + gridDim.x, b ^ 1);
      sv_cp_commit();
      sv_cp_wait<1>();
    }
    __syncthreads();
    const float* R = bufs + b * P.buf;
    const float* Cs = P.planes ? R + P.rows : centers + (size_t)g * m * 3;
    for (int i = tid; i < P.planes; i += SV_BG_THREADS) {
      X[i] = i < N ? R[i * C] : INFINITY;
      Y[i] = i < N ? R[i * C + 1] : INFINITY;
      Z[i] = i < N ? R[i * C + 2] : INFINITY;
    }
    __syncthreads();
    for (int c0 = 0; c0 < m; c0 += P.chunk) {
      const int nc = min(P.chunk, m - c0);
      float cx[4], cy[4], cz[4];
      int cnt[4];
      int* list[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cl = min(warp + u * SV_BG_WARPS, nc - 1);
        cx[u] = Cs[(c0 + cl) * 3];
        cy[u] = Cs[(c0 + cl) * 3 + 1];
        cz[u] = Cs[(c0 + cl) * 3 + 2];
        cnt[u] = warp + u * SV_BG_WARPS < nc ? 0 : ns;  // no center: nothing to list
        list[u] = sel + cl * ns;
      }
      if (P.planes)
        sv_ball_scan4<true>(X, Y, Z, 1, N, r2, ns, cx, cy, cz, list, cnt, lane);
      else
        sv_ball_scan4<false>(R, R + 1, R + 2, C, N, r2, ns, cx, cy, cz, list, cnt, lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (warp + u * SV_BG_WARPS >= nc) continue;
        const int n = min(cnt[u], ns);
        const int first = n > 0 ? list[u][0] : 0;
        for (int s = n + lane; s < ns; s += 32) list[u][s] = first;
      }
      __syncthreads();
      const size_t row0 = (size_t)g * m + c0;
      int* io = idx_out + row0 * ns;
      const int n_idx = nc * ns;
      if ((n_idx & 3) == 0 && (reinterpret_cast<uintptr_t>(io) & 15) == 0)
        for (int q = tid; q < n_idx / 4; q += SV_BG_THREADS)
          reinterpret_cast<int4*>(io)[q] = reinterpret_cast<const int4*>(sel)[q];
      else
        for (int q = tid; q < n_idx; q += SV_BG_THREADS) io[q] = sel[q];
      float* go = grouped + row0 * ns * C;
      const int n_el = n_idx * C;
      if (C == 6 && (n_el & 3) == 0 && (reinterpret_cast<uintptr_t>(go) & 15) == 0)
        sv_bg_write_rows<6>(go, n_idx, R, Cs + c0 * 3, sel, ns, exact, tid);
      else
        sv_bg_write(go, n_el, R, Cs + c0 * 3, sel, C, ns, exact, tid);
      __syncthreads();  // sel, the planes and this buffer are rewritten next
    }
    if (P.nbuf == 2) b ^= 1;
  }
  sv_cp_wait<0>();
}

extern "C" int sv_ball_group_smem(int N, int C, int m, int nsample) {
  return sv_bg_plan(N, C, m, nsample).total;
}

extern "C" int sv_ball_group(const float* pts, const float* centers, int G, int N, int C,
                             int m, int nsample, float r2, int exact, float* grouped,
                             int* idx, void* stream) {
  // the opt-in and the occupancy query once per shared-memory size
  static int last_smem = -1, slots = 0;
  const int smem = sv_bg_plan(N, C, m, nsample).total;
  if (smem != last_smem) {
    cudaError_t e = cudaFuncSetAttribute(sv_ball_group_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sv_ball_group_kernel,
                                                      SV_BG_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
    last_smem = smem;
  }
  const int grid = G < slots ? G : slots;  // persistent: one wave
  sv_ball_group_kernel<<<grid, SV_BG_THREADS, smem, (cudaStream_t)stream>>>(
      pts, centers, G, N, C, m, nsample, r2, exact, grouped, idx);
  return (int)cudaGetLastError();
}
