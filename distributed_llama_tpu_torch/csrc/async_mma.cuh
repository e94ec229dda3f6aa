// Shared device helpers of K2 (q40_gemm.cu), K3/B8 (flash_attention.cu), K4
// (q40_grouped_gemm.cu) and K5 (paged_attention.cu):
// cp.async copies into shared memory, ldmatrix fragment loads and the bf16
// tensor-core MMA (mma.sync m16n8k16, f32 accumulate), as PTX.
//
// Fragment layouts of m16n8k16 (lane = 4 * gid + tig, gid = lane / 4,
// tig = lane % 4), each register two bf16 with the lower k in its low half:
//   A (16 x 16, row-major): a0 (row gid, k 2tig..), a1 (row gid + 8, k
//     2tig..), a2 (row gid, k 8 + 2tig..), a3 (row gid + 8, k 8 + 2tig..);
//   B (16 x 8, "col"): b0 (k 2tig.., column gid), b1 (k 8 + 2tig.., gid);
//   C (16 x 8, f32): c0, c1 (row gid, columns 2tig, 2tig + 1), c2, c3
//     (row gid + 8, the same columns).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dlt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous, bypassing L1. src_bytes 0 reads
// nothing and fills the 16 bytes with zeros (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronous (through L1: the .cg form takes
// 16-byte copies only)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit(){ asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b on the tensor cores, bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two bf16 from two floats, each rounded to nearest even; lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// d = a * b + c on bf16 pairs, one rounding
__device__ __forceinline__ unsigned fma_bf16x2(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b, unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

}  // namespace dlt
