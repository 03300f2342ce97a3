// Inline-PTX building blocks shared by the hand-written tensor-core
// kernels (lstm_persistent.cuh, peephole_persistent.cuh, lstm_train.cu,
// peephole_train.cu, dw_gemm.cuh): 16-byte cp.async copies into shared
// memory, ldmatrix loads of 8x8 bf16 tiles, the bf16 x bf16 -> f32
// mma.sync.m16n8k16 and the global nanosecond clock. The fragment layout
// of mma.m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//
//   A (16 x 16, row-major) a0: (g, 2q..2q+1)   a1: (g+8, 2q..)
//                          a2: (g, 2q+8..)     a3: (g+8, 2q+8..)
//   B (16 x 8, k x n)      b0: (k 2q..2q+1, n g)  b1: (k 2q+8.., n g)
//   C (16 x 8, f32)        c0, c1: (g, 2q..2q+1)  c2, c3: (g+8, 2q..)
//
// with g = lane / 4 and q = lane % 4. Every register of A and B holds two
// bf16 values that are neighbours along k.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only (.cg): data other blocks
// wrote during the launch is read from L2, never from a stale L1 line.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Eight bf16 at dst (16-byte aligned shared memory) from src[0..7]:
// src[i] for i < avail, 0 beyond. One cp.async when vec (src 16-byte
// aligned) and all eight lie inside; element by element otherwise -- the
// ragged edge, or strides that are no multiple of eight elements.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int avail,
                                      bool vec) {
  if (vec && avail >= 8) {
    cp_async16(dst, src);
    return;
  }
  if (avail <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = (i < avail) ? src[i] : zero;
}

// Four 8x8 bf16 tiles; lane l gives the address of row l % 8 of tile
// l / 8, and lane (g, q) receives row g, columns 2q and 2q+1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 bf16 tiles; lanes 0-15 give the addresses (lane l: row l % 8
// of tile l / 8), the other lanes' are not read.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

}  // namespace mma_ptx
