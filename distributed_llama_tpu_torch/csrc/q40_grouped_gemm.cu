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
// x is rounded to bf16 (by the wrapper); the f16 scale goes to f32 and
// rounds to bf16; each weight is (u - 8) * bf16(scale), exact, rounded
// once to bf16; x . w accumulates in f32 on the tensor cores. Only the
// order of the f32 sums differs from the plain version.
//
// The exact-scale rounding (`exact_scale`, the small-row MoE arm's, where
// the JAX package gathers each row's experts and dequantizes them with
// `dequantize_t`): each weight is bf16(f32(scale) * (u - 8)), the f32
// product exact (4 bits by 11), rounded once, so the weights are the gather
// arm's bit for bit. It costs two f32 multiplies and one pack a pair where
// the default costs one bf16 FMA; the small-row arm reads few rows, so the
// weight bytes bound it either way.
//
// What bounds it on Hopper: memory. A 32-token chunk of Qwen3-30B-A3B
// routes 256 rows over ~110 of 128 experts, ~2 rows an expert: ~2 * 2
// flops per weight against 0.5625 bytes per weight, far under the ~295
// flops per byte where the tensor cores become the limit. The bound is the
// bytes of the experts that the rows hit: ~97 MB for w1 (or w3) of one
// layer, ~29 us at 3.35 TB/s.
//
// Design (K2's machinery with the operands swapped):
//   * out^T = W^T . x^T on mma.sync m16n8k16: the weights are the 16-row A
//     operand (16 output columns), the row block the 8-column B operand, so
//     block_r 8 (the main path's) fills the MMA without zero rows, and
//     block_r 16-64 adds N tiles. Lane (gid, tig) reads word tig of
//     columns gid and gid + 8, the same word K2's B fragment reads, and
//     dequantizes it in registers with K2's exponent trick (0x4300 | u is
//     128 + u in bf16; one bf16 FMA subtracts 136, one multiplies by
//     bf16(scale), each exact or rounded once): the pairs hold features
//     (4tig, 4tig + 2) and (4tig + 1, 4tig + 3), and x goes into the B
//     fragment in the same permuted order (one prmt a register).
//   * a CTA owns one row block and a tile of 128 output columns (64 where
//     out_features <= 64): 4 warps of 32 columns, each warp walking the
//     whole contraction, so no warp's partial needs another's and a row
//     block's sums never depend on the call's other blocks. No split-K: a
//     30B-A3B chunk has 144 row blocks x 6 tiles = 864 CTAs for w1 / w3
//     and x 16 = 2,304 for w2. The tile is ops/cuda_q40.py grouped_plan's,
//     a function of (nb, out_features, block_r) alone.
//   * a ring of 3 stages in shared memory fed by cp.async (16 bytes a
//     thread, one commit group a stage): a stage holds 4 Q40 blocks' raw
//     words and f16 scales for the column tile and the row block's matching
//     x slice; stages s + 1 and s + 2 are in flight while stage s is
//     multiplied. One __syncthreads a stage, no dequant pass through shared
//     memory. Resident CTAs, not ring depth, move the time (as in K2): on
//     an H100 SXM at the 30B-A3B chunk 3 stages tie 4 and 6 lose.
//   * the CTA loads its own group from block_group (device memory: the
//     Hopper counterpart of the Pallas kernel's scalar prefetch), and every
//     offset from there on is size_t: one role's flat stack at
//     Qwen3-30B-A3B width is 5.4 GB, past 2^31 bytes from group 2,731 up. A
//     group outside [0, G) gives NaN rows instead of a read out of bounds.
//   * x is staged in bf16, cast by the wrapper: w1 and w3 take the bf16
//     rows as they are, and w2's f32 input still costs one cast launch (K2's
//     finding: staging f32 and rounding in the kernel reads twice the bytes
//     and halves the CTAs an SM holds).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_mma.cuh"

namespace {

constexpr int QB = 32;          // features per Q40 block
constexpr int WARPS = 4;        // along the columns
constexpr int THREADS = WARPS * 32;
constexpr int SB = 4;           // Q40 blocks per ring stage
constexpr int STAGES = 3;       // ring depth
constexpr int XLD = SB * QB + 16;  // bf16 per staged x row: 288 bytes, so the 8-byte
                                   // fragment reads of 4 rows hit 32 distinct banks
constexpr int MAX_DEVICES = 64; // shared-memory opt-ins are kept per device

// shared memory of a CTA with MT 16-column m-tiles a warp (BN = 64 * MT
// columns) and NT 8-row n-tiles (block_r = 8 * NT)
template <int MT, int NT>
struct Smem {
  static constexpr int BN = WARPS * 16 * MT;
  static constexpr int WLD = BN + 8;  // int32 per staged word row (conflict-free reads)
  static constexpr size_t words = (size_t)SB * 4 * WLD * 4;
  static constexpr size_t scales = (size_t)SB * BN * 2;
  static constexpr size_t xs = (size_t)8 * NT * XLD * 2;
  static constexpr size_t stage = words + scales + xs;
  static constexpr size_t total = STAGES * stage;
  static_assert(words % 16 == 0 && scales % 16 == 0 && xs % 16 == 0, "16-byte stage parts");
};

// One ring stage: blocks b0 .. b0 + SB - 1 (those below nb) of the group's
// words and scales for columns n0 .. n0 + BN - 1, and of the row block's x.
// vec: out_f % 8 == 0 and aligned planes, so every 16-byte chunk of a word
// or scale row is aligned and lies wholly in or out of range; otherwise
// (widths no model serves) they load element by element.
template <int MT, int NT>
__device__ __forceinline__ void load_stage(unsigned char* st, const __nv_bfloat16* x,
                                           const int* q, const __half* d, int b0, int nb,
                                           int in_f, int out_f, int n0, bool vec, int tid) {
  using L = Smem<MT, NT>;
  int* ws = reinterpret_cast<int*>(st);
  __half* ds = reinterpret_cast<__half*>(st + L::words);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + L::words + L::scales);
  constexpr int WCH = L::BN / 4;  // 16-byte chunks of one word row
  for (int i = tid; i < SB * 4 * WCH; i += THREADS) {
    const int row = i / WCH;  // blk * 4 + word
    const int ch = i % WCH;
    const int b = b0 + row / 4;
    if (b >= nb) continue;
    const int n = n0 + ch * 4;
    int* dst = ws + row * L::WLD + ch * 4;
    const int* src = q + ((size_t)b * 4 + (row & 3)) * out_f + n;
    if (vec) {
      dlt::cp_async16(dst, n < out_f ? src : q, n < out_f ? 16 : 0);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = n + e < out_f ? __ldg(src + e) : 0;
    }
  }
  constexpr int SCH = L::BN / 8;
  for (int i = tid; i < SB * SCH; i += THREADS) {
    const int blk = i / SCH;
    const int ch = i % SCH;
    const int b = b0 + blk;
    if (b >= nb) continue;
    const int n = n0 + ch * 8;
    __half* dst = ds + blk * L::BN + ch * 8;
    const __half* src = d + (size_t)b * out_f + n;
    if (vec) {
      dlt::cp_async16(dst, n < out_f ? src : d, n < out_f ? 16 : 0);
    } else {
      for (int e = 0; e < 8; ++e) dst[e] = n + e < out_f ? src[e] : __float2half(0.0f);
    }
  }
  for (int i = tid; i < 8 * NT * SB * 4; i += THREADS) {
    const int r = i / (SB * 4);
    const int blk = (i / 4) % SB;
    const int ch = i % 4;
    const int b = b0 + blk;
    if (b >= nb) continue;
    dlt::cp_async16(xs + r * XLD + blk * QB + ch * 8,
                    x + (size_t)r * in_f + (size_t)b * QB + ch * 8);
  }
}

// 0x4300 | u pairs -> bf16((u - 8) * s) pairs: the subtraction is exact, the
// multiply rounds once
__device__ __forceinline__ unsigned dequant2(unsigned biased, unsigned s2) {
  const unsigned t = dlt::fma_bf16x2(biased, 0x3F803F80u, 0xC308C308u);  // * 1 - 136
  return dlt::fma_bf16x2(t, s2, 0x80008000u);                            // * s + (-0)
}

// 0x4300 | u pairs -> bf16(f32(u - 8) * s) pairs: the subtraction is exact,
// the f32 products are exact, the pack rounds once (cvt.rn.bf16x2.f32)
__device__ __forceinline__ unsigned dequant2_exact(unsigned biased, float s) {
  const unsigned t = dlt::fma_bf16x2(biased, 0x3F803F80u, 0xC308C308u);  // * 1 - 136
  const __nv_bfloat162 w = __floats2bfloat162_rn(__uint_as_float(t << 16) * s,
                                                 __uint_as_float(t & 0xFFFF0000u) * s);
  return *reinterpret_cast<const unsigned*>(&w);
}

// bf16(f32(f16 scale)) in both halves
__device__ __forceinline__ unsigned scale2(__half h) {
  const __nv_bfloat16 sb = __float2bfloat16_rn(__half2float(h));
  const unsigned bits = *reinterpret_cast<const unsigned short*>(&sb);
  return bits | (bits << 16);
}

template <int MT, int NT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
q40_grouped_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ q,
                        const __half* __restrict__ d, const int* __restrict__ block_group,
                        long long n_groups, float* __restrict__ out, int nb, int out_f,
                        int vec) {
  using L = Smem<MT, NT>;
  constexpr int BR = 8 * NT;  // block_r
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * L::BN;
  const size_t m0 = (size_t)blockIdx.y * BR;
  const int in_f = nb * QB;
  const long long g = block_group[blockIdx.y];  // uniform over the CTA
  if (g < 0 || g >= n_groups) {
    for (int i = tid; i < BR * L::BN; i += THREADS) {
      const int n = n0 + i % L::BN;
      if (n < out_f) out[(m0 + i / L::BN) * out_f + n] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const int* qg = q + (size_t)g * nb * 4 * out_f;
  const __half* dg = d + (size_t)g * nb * out_f;
  x += m0 * in_f;
  const int n_stages = (nb + SB - 1) / SB;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages)
      load_stage<MT, NT>(smem + s * L::stage, x, qg, dg, s * SB, nb, in_f, out_f, n0, vec, tid);
    dlt::cp_async_commit();
  }

  for (int it = 0; it < n_stages; ++it) {
    dlt::cp_async_wait<STAGES - 2>();  // stage it has landed (this thread's copies)
    __syncthreads();                   // ... and everyone's; slot it - 1 is free
    {
      const int s = it + STAGES - 1;
      if (s < n_stages)
        load_stage<MT, NT>(smem + (s % STAGES) * L::stage, x, qg, dg, s * SB, nb, in_f, out_f,
                           n0, vec, tid);
      dlt::cp_async_commit();
    }
    const unsigned char* st = smem + (it % STAGES) * L::stage;
    const int* ws = reinterpret_cast<const int*>(st);
    const __half* ds = reinterpret_cast<const __half*>(st + L::words);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + L::words + L::scales);
#pragma unroll
    for (int blk = 0; blk < SB; ++blk) {
      if (it * SB + blk >= nb) break;  // the ragged last stage; uniform
      // x as B fragments: row gid of each n-tile, features (4tig, 4tig + 2)
      // and (4tig + 1, 4tig + 3) of each 16-feature half
      unsigned bx[NT][2][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 v =
              *reinterpret_cast<const uint2*>(xs + (8 * nt + gid) * XLD + blk * QB + 16 * h + 4 * tig);
          bx[nt][h][0] = dlt::prmt(v.x, v.y, 0x5410);
          bx[nt][h][1] = dlt::prmt(v.x, v.y, 0x7632);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int col = warp * 16 * MT + 16 * mt + gid;
        const unsigned w0 = (unsigned)ws[(blk * 4 + tig) * L::WLD + col];
        const unsigned w1 = (unsigned)ws[(blk * 4 + tig) * L::WLD + col + 8];
        const __half h0 = ds[blk * L::BN + col];
        const __half h1 = ds[blk * L::BN + col + 8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned a[4];
          const unsigned p0 = ((w0 >> (4 * h)) & 0x000F000Fu) | 0x43004300u;      // 4tig, +2
          const unsigned p1 = ((w1 >> (4 * h)) & 0x000F000Fu) | 0x43004300u;
          const unsigned p2 = ((w0 >> (8 + 4 * h)) & 0x000F000Fu) | 0x43004300u;  // +1, +3
          const unsigned p3 = ((w1 >> (8 + 4 * h)) & 0x000F000Fu) | 0x43004300u;
          if constexpr (EXACT) {
            const float f0 = __half2float(h0), f1 = __half2float(h1);
            a[0] = dequant2_exact(p0, f0);
            a[1] = dequant2_exact(p1, f1);
            a[2] = dequant2_exact(p2, f0);
            a[3] = dequant2_exact(p3, f1);
          } else {
            const unsigned s0 = scale2(h0), s1 = scale2(h1);
            a[0] = dequant2(p0, s0);
            a[1] = dequant2(p1, s1);
            a[2] = dequant2(p2, s0);
            a[3] = dequant2(p3, s1);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) dlt::mma_bf16(acc[mt][nt], a, bx[nt][h][0], bx[nt][h][1]);
        }
      }
    }
  }
  dlt::cp_async_wait<0>();

  // c0, c1: column gid, rows 2tig and 2tig + 1 of the n-tile; c2, c3:
  // column gid + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int col = n0 + warp * 16 * MT + 16 * mt + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = col + 8 * (e >> 1);
        const size_t r = m0 + 8 * nt + 2 * tig + (e & 1);
        if (n < out_f) out[r * out_f + n] = acc[mt][nt][e];
      }
  }
}

template <int MT, int NT, bool EXACT>
cudaError_t launch(const __nv_bfloat16* x, const int* q, const __half* d, const int* bg,
                   long long n_groups, float* out, int n_blocks, int nb, int out_f, int vec,
                   cudaStream_t stream) {
  const size_t smem = Smem<MT, NT>::total;
  static bool raised[MAX_DEVICES] = {};  // the opt-in is per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(q40_grouped_gemm_kernel<MT, NT, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  dim3 grid((out_f + Smem<MT, NT>::BN - 1) / Smem<MT, NT>::BN, n_blocks);
  q40_grouped_gemm_kernel<MT, NT, EXACT><<<grid, THREADS, smem, stream>>>(
      x, q, d, bg, n_groups, out, nb, out_f, vec);
  return cudaGetLastError();
}

template <int MT, bool EXACT>
cudaError_t launch_rows(const __nv_bfloat16* x, const int* q, const __half* d, const int* bg,
                        long long n_groups, float* out, int n_blocks, int block_r, int nb,
                        int out_f, int vec, cudaStream_t s) {
  switch (block_r) {
    case 8:
      return launch<MT, 1, EXACT>(x, q, d, bg, n_groups, out, n_blocks, nb, out_f, vec, s);
    case 16:
      return launch<MT, 2, EXACT>(x, q, d, bg, n_groups, out, n_blocks, nb, out_f, vec, s);
    case 32:
      return launch<MT, 4, EXACT>(x, q, d, bg, n_groups, out, n_blocks, nb, out_f, vec, s);
    case 64:
      return launch<MT, 8, EXACT>(x, q, d, bg, n_groups, out, n_blocks, nb, out_f, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [n_blocks * block_r, in] bf16; q [n_groups, in/8, out] int32; d
// [n_groups, in/32, out] f16; block_group [n_blocks] int32 on the device;
// out [n_blocks * block_r, out] f32. exact_scale: 1 forms each weight as
// bf16(f32(scale) * (u - 8)), 0 as bf16((u - 8) * bf16(scale)). The plan
// (ops/cuda_q40.py grouped_plan): cols 64 or 128 output columns a CTA.
extern "C" int q40_grouped_gemm_bf16(const void* x, const void* q, const void* d,
                                     const void* block_group, int n_blocks,
                                     long long n_groups, void* out, int block_r,
                                     int in_features, int out_features, int exact_scale,
                                     int cols, void* stream) {
  if (n_blocks < 1 || n_blocks > 65535 || n_groups < 1 || in_features % QB != 0 ||
      in_features < QB || out_features < 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int nb = in_features / QB;
  const int* qp = reinterpret_cast<const int*>(q);
  const __half* dp = reinterpret_cast<const __half*>(d);
  // 16-byte copies of the word and scale rows where every row start of
  // every group is aligned; element loads otherwise
  const int vec = out_features % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(qp) | reinterpret_cast<uintptr_t>(dp)) % 16 == 0;
  const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(x);
  const int* bg = reinterpret_cast<const int*>(block_group);
  float* o = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (exact_scale != 0 && exact_scale != 1) return (int)cudaErrorInvalidValue;
  if (cols == 128)
    return (int)(exact_scale ? launch_rows<2, true>(xp, qp, dp, bg, n_groups, o, n_blocks,
                                                    block_r, nb, out_features, vec, s)
                             : launch_rows<2, false>(xp, qp, dp, bg, n_groups, o, n_blocks,
                                                     block_r, nb, out_features, vec, s));
  if (cols == 64)
    return (int)(exact_scale ? launch_rows<1, true>(xp, qp, dp, bg, n_groups, o, n_blocks,
                                                    block_r, nb, out_features, vec, s)
                             : launch_rows<1, false>(xp, qp, dp, bg, n_groups, o, n_blocks,
                                                     block_r, nb, out_features, vec, s));
  return (int)cudaErrorInvalidValue;
}
