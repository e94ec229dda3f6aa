// K2: bf16-dequant Q40 GEMM for prefill row counts, on the packed T-layout
// weight (ops/quant.py): out[m, n] = sum_k x[m, k] * w[k, n], f32 out.
//
// Replaces the JAX package's ops/pallas_q40.py q40_matmul_pallas_stacked
// (:253), body _dequant_dot_accum (:160). The layer index of the stacked
// weight only offsets the base pointers.
//
// Numerics, as in _dequant_dot_accum's bf16 branch (:173-178): the f16 scale
// goes to f32 and rounds to bf16; each weight is (u - 8) * bf16(scale),
// exact in f32 and rounded once to bf16; the product x . w accumulates in
// f32 on the tensor cores (WMMA bf16 m16n16k16).
//
// What bounds it on Hopper: at the 16..32 rows of a prefill chunk, memory.
// It reads 0.5625 bytes per weight and does 2 * rows flops per weight; at
// 32 rows that is ~114 flops per weight byte, under the ~295 flops per byte
// where the bf16 tensor cores become the limit. Its bound is the larger of
// weight bytes / bandwidth and 2 * rows * in * out / peak bf16 rate.
//
// Design (right and simple first): one CTA of 4 warps owns a 32-row x
// 64-column output tile and walks the whole contraction, one Q40 block (32
// features) per step: the x tile (32 x 32 bf16) and the dequantized weight
// tile (32 x 64 bf16, unpacked from 4 words per column) go to shared
// memory, and each warp runs two m16n16k16 steps for its 16 columns and both
// 16-row halves. Rows past M load zeros and are not stored. No cp.async,
// no double buffering, no wgmma yet: making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QB = 32;
constexpr int BM = 32;  // rows per CTA
constexpr int BN = 64;  // columns per CTA (16 per warp)
constexpr int BK = QB;  // one Q40 block per step
constexpr int XLD = BK + 8;  // padded leading dims (multiples of 8 / 4
constexpr int WLD = BN + 8;  // elements, 32-byte aligned fragment rows)
constexpr int CLD = BN + 4;

__global__ void __launch_bounds__(128)
q40_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ q,
                     const __half* __restrict__ d, float* __restrict__ out, int M,
                     int nb, int out_f) {
  __shared__ __align__(32) __nv_bfloat16 xs[BM * XLD];
  __shared__ __align__(32) __nv_bfloat16 ws[BK * WLD];
  __shared__ __align__(32) float cs[BM * CLD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int in_f = nb * QB;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
  wmma::fill_fragment(c0, 0.0f);
  wmma::fill_fragment(c1, 0.0f);

  for (int b = 0; b < nb; ++b) {
    {  // x tile: 32 rows x 32 bf16, 16 bytes per thread
      const int r = tid >> 2;
      const int c = (tid & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * in_f + (size_t)b * QB + c);
      *reinterpret_cast<uint4*>(&xs[r * XLD + c]) = v;
    }
    // weight tile: 4 words x 64 columns; word g byte kk holds features
    // 4g+kk (low nibble) and 16+4g+kk (high nibble)
    for (int i = tid; i < 4 * BN; i += 128) {
      const int g = i / BN;
      const int n = i % BN;
      const int gn = n0 + n;
      unsigned w = 0x88888888u;  // u = 8: value 0 past the last column
      float sc = 0.0f;
      if (gn < out_f) {
        w = (unsigned)__ldg(q + ((size_t)b * 4 + g) * out_f + gn);
        sc = __bfloat162float(__float2bfloat16_rn(__half2float(d[(size_t)b * out_f + gn])));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ulo = (int)((w >> (8 * kk)) & 0xFu);
        const int uhi = (int)((w >> (8 * kk + 4)) & 0xFu);
        ws[(4 * g + kk) * WLD + n] = __float2bfloat16_rn(__fmul_rn((float)(ulo - 8), sc));
        ws[(16 + 4 * g + kk) * WLD + n] = __float2bfloat16_rn(__fmul_rn((float)(uhi - 8), sc));
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(a0, &xs[0 * XLD + ks * 16], XLD);
      wmma::load_matrix_sync(a1, &xs[16 * XLD + ks * 16], XLD);
      wmma::load_matrix_sync(bf, &ws[(ks * 16) * WLD + warp * 16], WLD);
      wmma::mma_sync(c0, a0, bf, c0);
      wmma::mma_sync(c1, a1, bf, c1);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&cs[0 * CLD + warp * 16], c0, CLD, wmma::mem_row_major);
  wmma::store_matrix_sync(&cs[16 * CLD + warp * 16], c1, CLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += 128) {
    const int r = i / BN;
    const int n = i % BN;
    if (m0 + r < M && n0 + n < out_f) out[(size_t)(m0 + r) * out_f + n0 + n] = cs[r * CLD + n];
  }
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [rows, in] bf16; q [L, in/8, out] int32; d [L, in/32, out] f16;
// out [rows, out] f32.
extern "C" int q40_gemm_bf16(const void* x, const void* q, const void* d, void* out,
                             int rows, int in_features, int out_features,
                             long long layer, void* stream) {
  if (rows < 1 || in_features % QB != 0 || out_features < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int nb = in_features / QB;
  const int* qp = reinterpret_cast<const int*>(q) + (size_t)layer * nb * 4 * out_features;
  const __half* dp = reinterpret_cast<const __half*>(d) + (size_t)layer * nb * out_features;
  dim3 grid((out_features + BN - 1) / BN, (rows + BM - 1) / BM);
  q40_gemm_bf16_kernel<<<grid, 128, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), qp, dp, reinterpret_cast<float*>(out),
      rows, nb, out_features);
  return (int)cudaGetLastError();
}
