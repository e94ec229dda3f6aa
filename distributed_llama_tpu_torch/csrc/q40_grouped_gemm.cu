// K4: grouped bf16-dequant Q40 GEMM for MoE prefill, on the packed T-layout
// expert stacks (ops/quant.py): row block i of x times group
// block_group[i] of a flat [G, in/8, out] stack, f32 out.
//
// Replaces the JAX package's ops/pallas_q40.py q40_matmul_pallas_grouped
// (:779), body _kernel_grouped (:772) -> _dequant_dot_accum (:160). The
// groups are the all-layers expert stack flattened to G = L * E, so the
// caller folds the layer into the index (layer * E + expert) and no layer
// slice is ever copied. Rows come grouped by expert, each group padded to a
// block_r multiple (ops/moe.py _grouped_layout_direct); pad rows are zeros,
// and trailing blocks clipped to the last group multiply zero rows whose
// outputs nobody gathers.
//
// Numerics, as K2 (csrc/q40_gemm.cu) and _dequant_dot_accum's bf16 branch:
// the f16 scale goes to f32 and rounds to bf16; each weight is
// (u - 8) * bf16(scale), exact in f32 and rounded once to bf16; x . w
// accumulates in f32 on the tensor cores (WMMA bf16 m16n16k16).
//
// What bounds it on Hopper: memory. A 32-token chunk of Qwen3-30B-A3B
// routes 256 rows over 128 experts, ~2 rows an expert: ~2 * 2 flops per
// weight against 0.5625 bytes per weight, far under the ~295 flops per byte
// where the tensor cores become the limit. The bound is the bytes of the
// experts that the rows hit.
//
// Design (right and simple first): one CTA of 4 warps owns one row block
// (block_r = 8, 16, 32 or 64 rows; a block of 8 fills half of a 16-row MMA
// fragment, and rows past block_r load zeros and are not stored) and 64
// columns, and walks the whole contraction one Q40 block (32 features) per
// step, as K2 does. The CTA loads its own group from block_group (device
// memory: the Hopper counterpart of the Pallas kernel's scalar prefetch),
// and every offset from there on is size_t: one role's flat stack at
// Qwen3-30B-A3B width is 5.4 GB, past 2^31 bytes from group 2,731 up. A
// group outside [0, G) gives NaN rows instead of a read out of bounds. No
// cp.async, no wgmma, no TMA yet: making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QB = 32;
constexpr int BN = 64;  // columns per CTA (16 per warp)
constexpr int BK = QB;  // one Q40 block per step
constexpr int XLD = BK + 8;  // padded leading dims (multiples of 8 / 4
constexpr int WLD = BN + 8;  // elements, 32-byte aligned fragment rows)
constexpr int CLD = BN + 4;

// MF 16-row MMA fragments per CTA: the row block's block_r <= 16 * MF rows
template <int MF>
__global__ void __launch_bounds__(128)
q40_grouped_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ q,
                        const __half* __restrict__ d, const int* __restrict__ block_group,
                        long long n_groups, float* __restrict__ out, int block_r, int nb,
                        int out_f) {
  constexpr int BM = 16 * MF;
  __shared__ __align__(32) __nv_bfloat16 xs[BM * XLD];
  __shared__ __align__(32) __nv_bfloat16 ws[BK * WLD];
  __shared__ __align__(32) float cs[BM * CLD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const size_t m0 = (size_t)blockIdx.y * block_r;
  const size_t in_f = (size_t)nb * QB;
  const long long g = block_group[blockIdx.y];  // uniform over the CTA
  if (g < 0 || g >= n_groups) {
    for (int i = tid; i < block_r * BN; i += 128) {
      const int n = n0 + i % BN;
      if (n < out_f) out[(m0 + i / BN) * out_f + n] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const int* qg = q + (size_t)g * nb * 4 * out_f;
  const __half* dg = d + (size_t)g * nb * out_f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) wmma::fill_fragment(c[f], 0.0f);

  for (int b = 0; b < nb; ++b) {
    // x tile: BM rows x 32 bf16, 16 bytes per load; rows past block_r are 0
    for (int i = tid; i < BM * 4; i += 128) {
      const int r = i >> 2;
      const int c8 = (i & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < block_r)
        v = *reinterpret_cast<const uint4*>(x + (m0 + r) * in_f + (size_t)b * QB + c8);
      *reinterpret_cast<uint4*>(&xs[r * XLD + c8]) = v;
    }
    // weight tile: 4 words x 64 columns; word g byte kk holds features
    // 4g+kk (low nibble) and 16+4g+kk (high nibble)
    for (int i = tid; i < 4 * BN; i += 128) {
      const int w4 = i / BN;
      const int n = i % BN;
      const int gn = n0 + n;
      unsigned w = 0x88888888u;  // u = 8: value 0 past the last column
      float sc = 0.0f;
      if (gn < out_f) {
        w = (unsigned)__ldg(qg + ((size_t)b * 4 + w4) * out_f + gn);
        sc = __bfloat162float(__float2bfloat16_rn(__half2float(dg[(size_t)b * out_f + gn])));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ulo = (int)((w >> (8 * kk)) & 0xFu);
        const int uhi = (int)((w >> (8 * kk + 4)) & 0xFu);
        ws[(4 * w4 + kk) * WLD + n] = __float2bfloat16_rn(__fmul_rn((float)(ulo - 8), sc));
        ws[(16 + 4 * w4 + kk) * WLD + n] = __float2bfloat16_rn(__fmul_rn((float)(uhi - 8), sc));
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, &ws[(ks * 16) * WLD + warp * 16], WLD);
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &xs[(f * 16) * XLD + ks * 16], XLD);
        wmma::mma_sync(c[f], a, bf, c[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < MF; ++f)
    wmma::store_matrix_sync(&cs[(f * 16) * CLD + warp * 16], c[f], CLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < block_r * BN; i += 128) {
    const int r = i / BN;
    const int n = i % BN;
    if (n0 + n < out_f) out[(m0 + r) * out_f + n0 + n] = cs[r * CLD + n];
  }
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [n_blocks * block_r, in] bf16; q [n_groups, in/8, out] int32; d
// [n_groups, in/32, out] f16; block_group [n_blocks] int32 on the device;
// out [n_blocks * block_r, out] f32.
extern "C" int q40_grouped_gemm_bf16(const void* x, const void* q, const void* d,
                                     const void* block_group, int n_blocks,
                                     long long n_groups, void* out, int block_r,
                                     int in_features, int out_features, void* stream) {
  if (n_blocks < 1 || n_blocks > 65535 || n_groups < 1 || in_features % QB != 0 ||
      out_features < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int nb = in_features / QB;
  dim3 grid((out_features + BN - 1) / BN, n_blocks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(x);
  const int* qp = reinterpret_cast<const int*>(q);
  const __half* dp = reinterpret_cast<const __half*>(d);
  const int* bg = reinterpret_cast<const int*>(block_group);
  float* o = reinterpret_cast<float*>(out);
  switch (block_r) {
    case 8:
    case 16:
      q40_grouped_gemm_kernel<1><<<grid, 128, 0, s>>>(xp, qp, dp, bg, n_groups, o, block_r, nb,
                                                      out_features);
      break;
    case 32:
      q40_grouped_gemm_kernel<2><<<grid, 128, 0, s>>>(xp, qp, dp, bg, n_groups, o, block_r, nb,
                                                      out_features);
      break;
    case 64:
      q40_grouped_gemm_kernel<4><<<grid, 128, 0, s>>>(xp, qp, dp, bg, n_groups, o, block_r, nb,
                                                      out_features);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
