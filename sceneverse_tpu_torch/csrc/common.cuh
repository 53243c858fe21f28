// Shared helpers for the sceneverse_tpu_torch CUDA kernels.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define SV_FULL_MASK 0xffffffffu

__device__ __forceinline__ float sv_tof(float x) { return x; }
__device__ __forceinline__ float sv_tof(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T sv_from(float x);
template <> __device__ __forceinline__ float sv_from<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 sv_from<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float to T's precision and back (identity for float)
template <typename T> __device__ __forceinline__ float sv_round(float x) {
  return sv_tof(sv_from<T>(x));
}

__device__ __forceinline__ float sv_bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sv_warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(SV_FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float sv_warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(SV_FULL_MASK, v, off);
  return v;
}

// ((dx^2 + dy^2) + dz^2) with every op rounded on its own (no FMA contraction),
// the order of the plain twins and the JAX reference.
__device__ __forceinline__ float sv_sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks with documented register layouts (PTX ISA,
// "Matrix fragments for mma.m16n8k16"): g = lane / 4, t = lane % 4.
//   A (16 x 16 bf16, row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)
//                                a2 (g, 2t+8..)    a3 (g+8, 2t+8..)
//   B (16 x 8 bf16, k x n)       b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C (16 x 8 f32)               c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..)
// The lower 16 bits of a packed pair hold the smaller column (or k).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t sv_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy of which the first `bytes` are read and the
// rest zero-filled (bytes 0: src is not read)
__device__ __forceinline__ void sv_cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sv_smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void sv_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void sv_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void sv_ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sv_smem_addr(p)));
}
__device__ __forceinline__ void sv_ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sv_smem_addr(p)));
}

// c += a (16 x 16) b (16 x 8), bf16 operands, f32 accumulation
__device__ __forceinline__ void sv_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, the first in the lower half
__device__ __forceinline__ uint32_t sv_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
