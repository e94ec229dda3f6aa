// K1: Q80 x Q40 decode matmul for 1..8 activation rows, on the packed
// T-layout weight (ops/quant.py). out[r, o] = sum_k x[r, k] * w[k, o].
//
// Replaces the JAX package's ops/pallas_q40.py q40_matmul_pallas_stacked_i8
// (:725) and q40_matmul_pallas_i8 (:686): body _kernel_fs_i8 (:591), prologue
// _quantize_rows_q80_split (:506). The layer index of a stacked weight only
// offsets the base pointers; an unstacked weight is layer 0.
//
// q40_gemv_q80_indexed is the same per-row function for the MoE decode
// experts (q40_matmul_pallas_stacked_i8 as models/transformer.py
// _moe_decode_i8 calls it, with a flat layer * E + expert index): row r of x
// (or x's one row, shared by every slot) against group idx[r] of a flat
// [G, nb*4, out] stack. idx lives in device memory and each CTA loads its
// own group, so the host never reads it. One launch covers all slots (grid
// y = slot). Group offsets are size_t from the index load on: one role's
// flat Qwen3-30B-A3B stack is 5.4 GB, so idx * nb * 4 * out passes 2^31 from
// index 2,731 up. A group outside [0, G) gives NaN rows instead of a read
// out of bounds. Bound: the bytes of the slots' experts (memory).
//
// What bounds it on Hopper: memory. It reads each weight once, 0.5625 bytes
// per weight (a 4-bit nibble plus a 2-byte f16 scale per 32), and does 2
// integer ops per weight per row, far below the card's integer rate; the
// activations (at most 8 rows) are a rounding error beside the weights.
//
// Design:
//   * a prologue kernel quantizes each row per 32-block to int8 exactly as
//     _quantize_rows_q80_split does (f32 row, x * (1 / scale), rintf = half
//     to even, clip to +-127, f16-rounded dequant scale, int32 block sums),
//     one warp per (row, block);
//   * the GEMV kernel keeps the int8 rows, their scales and block sums in
//     shared memory. One thread owns one output column, so the 32 lanes of
//     a warp read 32 neighbouring words of the T layout (out is innermost):
//     coalesced 128-byte rows. Eight warps of a CTA split the 32-blocks of
//     the contraction between them and add their partial sums in a fixed
//     order at the end, so the result does not depend on scheduling.
//   * word g of block b holds features 4g..4g+3 in its low nibbles and
//     16+4g..16+4g+3 in its high nibbles, so __dp4a(w & 0x0F0F0F0F, x_a[g])
//     then __dp4a((w >> 4) & 0x0F0F0F0F, x_b[g]) is the Pallas unpack, one
//     for one; the int8 row viewed as int32 words gives x_a[g] = word 8b+g
//     and x_b[g] = word 8b+4+g. The partial is exact; the +8 offset leaves
//     as partial - 8 * bsum; the scale combine is f32, one product then one
//     sum per block as in the Pallas kernel (no fused multiply-add).
//   * out = 2048..3072 columns fill 64..96 CTAs, under the 132 SMs: accepted
//     for this first kernel (split-K across CTAs is later work).

#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;      // Q40/Q80 block
constexpr int COLS = 32;    // output columns per CTA (one per lane)
constexpr int KSPLIT = 8;   // warps per CTA, each takes blocks b = warp + 8j
constexpr unsigned NIB = 0x0F0F0F0Fu;

__global__ void quantize_rows_q80(const void* __restrict__ x, int x_is_bf16,
                                  int in_features, int nb, int rows,
                                  int8_t* __restrict__ x8, float* __restrict__ xs,
                                  int* __restrict__ bs) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * nb) return;  // uniform per warp
  const int r = warp / nb;
  const int b = warp % nb;
  const size_t idx = (size_t)r * in_features + (size_t)b * QB + lane;
  const float v = x_is_bf16
                      ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[idx])
                      : reinterpret_cast<const float*>(x)[idx];
  float a = fabsf(v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float scale = a / 127.0f;
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  const float qf = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  const int qi = (int)qf;
  x8[idx] = (int8_t)qi;
  int s = qi;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    xs[(size_t)r * nb + b] = __half2float(__float2half_rn(scale));
    bs[(size_t)r * nb + b] = s;
  }
}

// One CTA's 32 output columns of R rows: x8w/xsg/bsg point at the rows'
// quantized activations, q/d at the weight, out at the rows' outputs.
template <int R>
__device__ __forceinline__ void gemv_tile(const int* __restrict__ x8w,
                                          const float* __restrict__ xsg,
                                          const int* __restrict__ bsg,
                                          const int* __restrict__ q,
                                          const __half* __restrict__ d,
                                          float* __restrict__ out, int nb, int out_f,
                                          unsigned char* smem) {
  int* xw = reinterpret_cast<int*>(smem);             // [R][nb * 8] int8 x4
  float* xs = reinterpret_cast<float*>(xw + R * nb * 8);  // [R][nb]
  int* bs = reinterpret_cast<int*>(xs + R * nb);          // [R][nb]
  float* red = reinterpret_cast<float*>(bs + R * nb);     // [KSPLIT][R][COLS]

  const int tid = threadIdx.y * COLS + threadIdx.x;
  for (int i = tid; i < R * nb * 8; i += COLS * KSPLIT) xw[i] = x8w[i];
  for (int i = tid; i < R * nb; i += COLS * KSPLIT) {
    xs[i] = xsg[i];
    bs[i] = bsg[i];
  }
  __syncthreads();

  const int col = blockIdx.x * COLS + threadIdx.x;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;

  if (col < out_f) {
    const size_t stride = (size_t)out_f;
    for (int b = threadIdx.y; b < nb; b += KSPLIT) {
      const int* qb = q + (size_t)b * 4 * stride + col;
      const unsigned w0 = (unsigned)__ldg(qb);
      const unsigned w1 = (unsigned)__ldg(qb + stride);
      const unsigned w2 = (unsigned)__ldg(qb + 2 * stride);
      const unsigned w3 = (unsigned)__ldg(qb + 3 * stride);
      const float dv = __half2float(d[(size_t)b * stride + col]);
      const int lo0 = (int)(w0 & NIB), hi0 = (int)((w0 >> 4) & NIB);
      const int lo1 = (int)(w1 & NIB), hi1 = (int)((w1 >> 4) & NIB);
      const int lo2 = (int)(w2 & NIB), hi2 = (int)((w2 >> 4) & NIB);
      const int lo3 = (int)(w3 & NIB), hi3 = (int)((w3 >> 4) & NIB);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int* xr = xw + (r * nb + b) * 8;
        int p = __dp4a(lo0, xr[0], 0);
        p = __dp4a(lo1, xr[1], p);
        p = __dp4a(lo2, xr[2], p);
        p = __dp4a(lo3, xr[3], p);
        p = __dp4a(hi0, xr[4], p);
        p = __dp4a(hi1, xr[5], p);
        p = __dp4a(hi2, xr[6], p);
        p = __dp4a(hi3, xr[7], p);
        p -= 8 * bs[r * nb + b];
        const float scale = __fmul_rn(xs[r * nb + b], dv);
        acc[r] = __fadd_rn(acc[r], __fmul_rn((float)p, scale));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) red[(threadIdx.y * R + r) * COLS + threadIdx.x] = acc[r];
  __syncthreads();
  if (threadIdx.y == 0 && col < out_f) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < KSPLIT; ++k) s = __fadd_rn(s, red[(k * R + r) * COLS + threadIdx.x]);
      out[(size_t)r * out_f + col] = s;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(COLS * KSPLIT)
q40_gemv_kernel(const int* __restrict__ x8w, const float* __restrict__ xsg,
                const int* __restrict__ bsg, const int* __restrict__ q,
                const __half* __restrict__ d, float* __restrict__ out, int nb,
                int out_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemv_tile<R>(x8w, xsg, bsg, q, d, out, nb, out_f, smem);
}

// grid (column tiles, slots): slot s multiplies activation row
// (x_shared ? 0 : s) by group idx[s] of the flat stack.
__global__ void __launch_bounds__(COLS * KSPLIT)
q40_gemv_indexed_kernel(const int* __restrict__ x8w, const float* __restrict__ xsg,
                        const int* __restrict__ bsg, const int* __restrict__ q,
                        const __half* __restrict__ d, const int* __restrict__ idx,
                        int x_shared, long long n_groups, float* __restrict__ out,
                        int nb, int out_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = blockIdx.y;
  const long long g = idx[slot];  // uniform over the CTA
  float* o = out + (size_t)slot * out_f;
  if (g < 0 || g >= n_groups) {
    const int col = blockIdx.x * COLS + threadIdx.x;
    if (threadIdx.y == 0 && col < out_f) o[col] = __int_as_float(0x7fc00000);
    return;
  }
  const size_t xr = x_shared ? 0 : (size_t)slot;
  const size_t gq = (size_t)g * (size_t)nb * 4 * (size_t)out_f;
  const size_t gd = (size_t)g * (size_t)nb * (size_t)out_f;
  gemv_tile<1>(x8w + xr * nb * 8, xsg + xr * nb, bsg + xr * nb, q + gq, d + gd, o, nb,
               out_f, smem);
}

template <int R>
size_t gemv_smem(int nb) {
  return (size_t)R * nb * 8 * sizeof(int) + (size_t)R * nb * 2 * sizeof(float) +
         (size_t)KSPLIT * R * COLS * sizeof(float);
}

// Allow `smem` bytes of dynamic shared memory for `kernel` (above 48 KB it
// must be asked for); `raised` is the kernel's allowance so far.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* raised) {
  if (smem <= *raised) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) *raised = smem;
  return e;
}

template <int R>
cudaError_t launch_gemv(const int8_t* x8, const float* xs, const int* bs,
                        const int* q, const __half* d, float* out, int nb,
                        int out_f, cudaStream_t stream) {
  const size_t smem = gemv_smem<R>(nb);
  static size_t raised = 48 * 1024;  // dynamic shared memory allowed so far
  cudaError_t e = allow_smem(q40_gemv_kernel<R>, smem, &raised);
  if (e != cudaSuccess) return e;
  dim3 block(COLS, KSPLIT);
  dim3 grid((out_f + COLS - 1) / COLS);
  q40_gemv_kernel<R><<<grid, block, smem, stream>>>(
      reinterpret_cast<const int*>(x8), xs, bs, q, d, out, nb, out_f);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [rows, in] f32 or bf16; q [L, in/8, out] int32; d [L, in/32, out] f16;
// out [rows, out] f32; x8 [rows, in] int8, xs/bs [rows, in/32] scratch.
extern "C" int q40_gemv_q80(const void* x, int x_is_bf16, const void* q,
                            const void* d, void* out, int rows, int in_features,
                            int out_features, long long layer, void* x8, void* xs,
                            void* bs, void* stream) {
  if (rows < 1 || rows > 8 || in_features % QB != 0 || out_features < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int warps = rows * nb;
  quantize_rows_q80<<<(warps * 32 + 255) / 256, 256, 0, s>>>(
      x, x_is_bf16, in_features, nb, rows, reinterpret_cast<int8_t*>(x8),
      reinterpret_cast<float*>(xs), reinterpret_cast<int*>(bs));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int* qp = reinterpret_cast<const int*>(q) + (size_t)layer * nb * 4 * out_features;
  const __half* dp = reinterpret_cast<const __half*>(d) + (size_t)layer * nb * out_features;
  const int8_t* x8p = reinterpret_cast<const int8_t*>(x8);
  const float* xsp = reinterpret_cast<const float*>(xs);
  const int* bsp = reinterpret_cast<const int*>(bs);
  float* o = reinterpret_cast<float*>(out);
  switch (rows) {
    case 1: e = launch_gemv<1>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    case 2: e = launch_gemv<2>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    case 3: e = launch_gemv<3>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    case 4: e = launch_gemv<4>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    case 5: e = launch_gemv<5>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    case 6: e = launch_gemv<6>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    case 7: e = launch_gemv<7>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
    default: e = launch_gemv<8>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s); break;
  }
  return (int)e;
}

// x [x_rows, in] f32 or bf16, x_rows 1 (shared by every slot) or n_slots;
// q [n_groups, in/8, out] int32; d [n_groups, in/32, out] f16; idx
// [n_slots] int32 on the device; out [n_slots, out] f32; x8 [x_rows, in]
// int8, xs/bs [x_rows, in/32] scratch.
extern "C" int q40_gemv_q80_indexed(const void* x, int x_is_bf16, int x_rows, const void* q,
                                    const void* d, const void* idx, int n_slots,
                                    long long n_groups, void* out, int in_features,
                                    int out_features, void* x8, void* xs, void* bs,
                                    void* stream) {
  if (n_slots < 1 || n_slots > 8 || (x_rows != 1 && x_rows != n_slots) ||
      in_features % QB != 0 || out_features < 1 || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int warps = x_rows * nb;
  quantize_rows_q80<<<(warps * 32 + 255) / 256, 256, 0, s>>>(
      x, x_is_bf16, in_features, nb, x_rows, reinterpret_cast<int8_t*>(x8),
      reinterpret_cast<float*>(xs), reinterpret_cast<int*>(bs));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = gemv_smem<1>(nb);
  static size_t raised = 48 * 1024;
  e = allow_smem(q40_gemv_indexed_kernel, smem, &raised);
  if (e != cudaSuccess) return (int)e;
  dim3 block(COLS, KSPLIT);
  dim3 grid((out_features + COLS - 1) / COLS, n_slots);
  q40_gemv_indexed_kernel<<<grid, block, smem, s>>>(
      reinterpret_cast<const int*>(x8), reinterpret_cast<const float*>(xs),
      reinterpret_cast<const int*>(bs), reinterpret_cast<const int*>(q),
      reinterpret_cast<const __half*>(d), reinterpret_cast<const int*>(idx), x_rows == 1,
      n_groups, reinterpret_cast<float*>(out), nb, out_features);
  return (int)cudaGetLastError();
}
