// Ball query + grouping for Hopper (sm_90a).
//
// sv_ball_group replaces the ball-query and grouping half of the TPU kernel
// sceneverse_tpu/ops/pallas/sample_group.py::_kernel (:39-159); its FPS half
// is sv_fps in sa_kernels.cu. Design notes live in
// sceneverse_tpu_torch/ops/sample_group.py.
#include "common.cuh"

constexpr int SV_BG_THREADS = 256;
constexpr int SV_BG_WARPS = SV_BG_THREADS / 32;

// One block per object: the object's (N, C) points are staged in shared
// memory once; a warp per center scans them in index order with
// __ballot_sync, keeps the first nsample with strict d2 < r2, pads the rest
// with the first hit (point 0 for an empty ball), then writes the center's
// nsample indices and its (nsample, C) grouped rows: centered xyz ++ raw
// channels 3.., each value rounded to bf16 first when exact == 0.
__global__ void __launch_bounds__(SV_BG_THREADS)
sv_ball_group_kernel(const float* __restrict__ pts, const float* __restrict__ centers,
                     int N, int C, int m, int nsample, float r2, int exact,
                     float* __restrict__ grouped, int* __restrict__ idx_out) {
  extern __shared__ float bgsm[];
  float* ptsS = bgsm;                                      // N*C
  int* selS = reinterpret_cast<int*>(ptsS + N * C);        // SV_BG_WARPS*nsample
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* P = pts + (size_t)g * N * C;
  for (int i = threadIdx.x; i < N * C; i += SV_BG_THREADS) ptsS[i] = P[i];
  __syncthreads();

  int* sel = selS + warp * nsample;
  for (int c = warp; c < m; c += SV_BG_WARPS) {
    const float* cp = centers + ((size_t)g * m + c) * 3;
    const float cx = cp[0], cy = cp[1], cz = cp[2];
    int cnt = 0;  // warp-uniform: every lane adds the same popcounts
    for (int base = 0; base < N && cnt < nsample; base += 32) {
      const int i = base + lane;
      bool w = false;
      if (i < N) {
        const float* q = ptsS + i * C;
        w = sv_sq3(q[0] - cx, q[1] - cy, q[2] - cz) < r2;
      }
      const unsigned ball = __ballot_sync(SV_FULL_MASK, w);
      const int rank = __popc(ball & ((1u << lane) - 1u));
      if (w && cnt + rank < nsample) sel[cnt + rank] = i;
      cnt += __popc(ball);
    }
    __syncwarp();
    const int n = min(cnt, nsample);
    const int first = n > 0 ? sel[0] : 0;
    for (int s = n + lane; s < nsample; s += 32) sel[s] = first;
    __syncwarp();
    const size_t row = (size_t)g * m + c;
    int* io = idx_out + row * nsample;
    for (int s = lane; s < nsample; s += 32) io[s] = sel[s];
    float* out = grouped + row * nsample * C;
    for (int e = lane; e < nsample * C; e += 32) {
      const int s = e / C, ch = e - s * C;
      float v = ptsS[sel[s] * C + ch];
      if (!exact) v = sv_bf16r(v);
      if (ch < 3) v = __fsub_rn(v, ch == 0 ? cx : (ch == 1 ? cy : cz));
      out[e] = v;
    }
    __syncwarp();  // sel is rewritten by this warp's next center
  }
}

extern "C" int sv_ball_group(const float* pts, const float* centers, int G, int N, int C,
                             int m, int nsample, float r2, int exact, float* grouped,
                             int* idx, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(sv_ball_group_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sv_ball_group_kernel<<<G, SV_BG_THREADS, smem, (cudaStream_t)stream>>>(
      pts, centers, N, C, m, nsample, r2, exact, grouped, idx);
  return (int)cudaGetLastError();
}
