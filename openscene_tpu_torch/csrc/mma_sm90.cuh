// Building blocks shared by the gather-GEMM kernels (csrc/gather_gemm_fwd.cu,
// csrc/gather_gemm_bwd.cu), for Hopper (sm_90a):
//   * cp.async 16-byte copies from global to shared memory that fill zeros
//     when the predicate is false (no global read then), grouped and waited
//     on as a ring of stages;
//   * ldmatrix (plain and transposed) of 8x8 bf16 matrices from shared
//     memory into mma fragments;
//   * the bf16 tensor-core product mma.sync m16n8k16 with fp32 accumulators;
//   * the 32 x 32 warp tile both kernels compute: 2 x 4 products per 16-deep
//     step, A (32 x 16) and B (16 x 32) read from shared memory.
// A row stride of (multiple of 32) + 8 elements keeps every ldmatrix free of
// bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gg {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes if !pred (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a 16 x 32 slab stored k-major (row i = reduction index,
// stride ldb elements): b[j] holds the fragments of columns j*16 .. j*16+15
__device__ __forceinline__ void load_b(unsigned (&b)[2][4],
                                       const __nv_bfloat16* bs, int ldb,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    ldsm_x4_t(b[j], bs + (lane & 15) * ldb + j * 16 + (lane >> 4) * 8);
}

// acc[i][t] += A(rows i*16.., 16) * B(16, columns t*8..)
__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4],
                                         const unsigned (&a)[2][4],
                                         const unsigned (&b)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      mma_bf16(acc[i][t], a[i], b[t >> 1][(t & 1) * 2],
               b[t >> 1][(t & 1) * 2 + 1]);
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.0f;
}

}  // namespace gg
