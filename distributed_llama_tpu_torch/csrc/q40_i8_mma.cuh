// The int8 decode matmul template shared by B9 (q40_i8_mma.cu) and the
// scale-plane and tile sweep P13 (i8_tile_probe.cu). P2, P3, P4, P5, P6 and
// P9/P10, the same function at one row from other weight storages, run the
// one-row GEMV of i8_gemv.cuh.
// out[r, o] = sum over 32-blocks b of partial[r, b, o] * (xs[r, b] * dt[b, o]),
// where partial = the exact integer dot of the int8 row block with the
// unpacked int8 weight block.
//
// Replaces the JAX package's ops/pallas_q40.py _i8_call (:657), body
// _kernel_i8 (:323) (B9: unpacked int8 weights [nb, 32, out] into the
// matrix unit), and the sweep of that body over its tile and its scale
// plane's storage, scripts/sweep_i8_tiles.py build_call (:69, P13).
//
// What bounds it on Hopper: memory. Each weight byte is read once plus a
// 2-byte (f16, raw f16 bits) or 4-byte (f32) scale per 32; at most 8
// activation rows do 2 ops per weight each, far below the int8 tensor rate.
//
// Design (a simple kernel that is right; speed is later work):
//   * one kernel template over the scale plane's storage (SCALE) and the
//     output columns a CTA owns (TN: 32, 64 or 128; B9 runs at 64);
//   * a CTA owns TN output columns and a range of 32-blocks (split-K across
//     CTAs); its 4 warps take the range's blocks in turn, each warp on all
//     TN columns;
//   * the dot is mma.sync m16n8k32 s8.s8.s32: k = 32 is exactly one Q40
//     block, so one MMA per 8 columns yields the block's exact integer
//     partial (no block-diagonal lhs as in the TPU kernel). The R <= 8
//     activation rows fill M rows 0..7; rows 8..15 are zero and not stored;
//   * `qt` puts `out` innermost, so k is strided in memory while the MMA's B
//     fragment wants 4 consecutive k per register. A warp stages each block
//     as [column][k] words in shared memory, a 4 x 4 byte transpose with
//     __byte_perm; every partial is an integer of magnitude <= 32 * 127 * 8
//     = 32,512 < 2^24, exact in f32;
//   * the scale: an f16 plane converts with __half2float, an f32 plane is
//     read as it is, and raw f16 bits (int16) convert with the JAX
//     package's integer algorithm (`half_bits_to_f32`, pallas_q40.py
//     :112-130). All three give the same f32 for every finite f16;
//   * the order of the f32 sums: acc += p * (xs * dt) (JAX's association,
//     no fused multiply-add), blocks in a fixed order per warp, then warps
//     0..3, then splits 0..S-1 in a second pass. At one tile and split the
//     planes therefore agree bit for bit;
//   * shared memory is TN * 320 bytes: static up to TN 128, under the 48 KB
//     static limit.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;      // Q40/Q80 block = the MMA's k
constexpr int WARPS = 4;    // warps per CTA; warp w takes blocks kb + w + 4i
constexpr int SROW = 12;    // words per staged column (8 used; 12 spreads the banks)
constexpr int MAXR = 8;

enum Scale { SC_F16 = 0, SC_F32 = 1, SC_I16 = 2 };

template <int SCALE> struct ScaleStorage { using T = __half; };
template <> struct ScaleStorage<SC_F32> { using T = float; };
template <> struct ScaleStorage<SC_I16> { using T = uint16_t; };

// raw f16 bits (low 16 bits of h) -> f32 with integer ops, as the JAX
// package's _scale_f32 (pallas_q40.py:112-130) and the probes'
// f16bits_to_f32: sign, exponent rebiased by +112, mantissa shifted by 13;
// exponent 0 gives mant * 2^-24 * sign. Zero, subnormal and normal values
// are exact; exponent 31 (inf, NaN) gives a finite 2^16 * (1 + mant / 1024).
__device__ __forceinline__ float half_bits_to_f32(unsigned h) {
  h &= 0xFFFFu;
  const unsigned sign = (h & 0x8000u) << 16;
  const unsigned ex = (h >> 10) & 0x1Fu;
  const unsigned mant = h & 0x3FFu;
  const float normal = __uint_as_float(sign | ((ex + 112u) << 23) | (mant << 13));
  const float sub = __fmul_rn(__fmul_rn(__uint2float_rn(mant), 0x1p-24f), sign ? -1.0f : 1.0f);
  return ex == 0 ? sub : normal;
}

// the f32 scales of columns col and col + 1 (col even) of plane row i0
template <int SCALE>
__device__ __forceinline__ float2 scale_pair(const typename ScaleStorage<SCALE>::T* __restrict__ dt,
                                             size_t i0) {
  if constexpr (SCALE == SC_F16) {
    const __half2 d2 = *reinterpret_cast<const __half2*>(dt + i0);
    return make_float2(__low2float(d2), __high2float(d2));
  } else if constexpr (SCALE == SC_F32) {
    return *reinterpret_cast<const float2*>(dt + i0);
  } else {
    const unsigned h2 = *reinterpret_cast<const unsigned*>(dt + i0);
    return make_float2(half_bits_to_f32(h2), half_bits_to_f32(h2 >> 16));
  }
}

// 4 words, word r holding row r's bytes for columns 0..3 -> word c holding
// column c's bytes for rows 0..3.
__device__ __forceinline__ void transpose4x4(unsigned a0, unsigned a1, unsigned a2,
                                             unsigned a3, unsigned* o) {
  const unsigned t0 = __byte_perm(a0, a1, 0x5140);
  const unsigned t1 = __byte_perm(a2, a3, 0x5140);
  const unsigned t2 = __byte_perm(a0, a1, 0x7362);
  const unsigned t3 = __byte_perm(a2, a3, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// Stage block b's [32 k][TN columns] int8 weights as sT[column * SROW +
// kq]: word kq holds k = 4kq..4kq+3 of the column (low byte first). 8 * CQ
// (kq, column-quad) pairs, TN / 16 a lane; CQ lanes read one TN-byte row
// segment, the next CQ lanes the next kq's. Columns at or past out_f stage
// zeros.
template <int TN>
__device__ __forceinline__ void stage_block(const int8_t* __restrict__ q, int b, int c0,
                                            int out_f, int lane, unsigned* sT) {
  constexpr int CQ = TN / 4;
  constexpr int CQ_SHIFT = CQ == 8 ? 3 : CQ == 16 ? 4 : 5;
#pragma unroll
  for (int i = 0; i < TN / 16; ++i) {
    const int p = lane + 32 * i;
    const int cq = p & (CQ - 1), kq = p >> CQ_SHIFT;
    const int col = c0 + cq * 4;
    unsigned a[4] = {0u, 0u, 0u, 0u};
    if (col < out_f) {
      const size_t row = (size_t)b * QB + kq * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = (unsigned)__ldg(reinterpret_cast<const int*>(q + (row + r) * out_f + col));
    }
    unsigned o[4];
    transpose4x4(a[0], a[1], a[2], a[3], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) sT[(cq * 4 + j) * SROW + kq] = o[j];
  }
}

__device__ __forceinline__ void mma_s8(unsigned a0, unsigned a2, unsigned b0, unsigned b1,
                                       int* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0), "r"(0));
}

template <int SCALE, int TN>
__global__ void __launch_bounds__(WARPS * 32)
q40_i8_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
                  const int8_t* __restrict__ qt,
                  const typename ScaleStorage<SCALE>::T* __restrict__ dt,
                  float* __restrict__ dst, int R, int nb, int out_f, int splits) {
  constexpr int NT = TN / 8;  // n8 MMA tiles per CTA
  __shared__ unsigned s_tile[WARPS][TN * SROW];
  __shared__ float s_red[WARPS][MAXR][TN];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int c0 = blockIdx.x * TN;
  const int split = blockIdx.y;
  const int kb = (int)((long long)split * nb / splits);
  const int ke = (int)((long long)(split + 1) * nb / splits);
  const int in_f = nb * QB;
  unsigned* sT = s_tile[warp];
  const bool row_ok = g < R;

  float acc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = 0.0f;

  for (int b = kb + warp; b < ke; b += WARPS) {
    stage_block<TN>(qt, b, c0, out_f, lane, sT);
    __syncwarp();
    // A fragment: row g, k = 4t..4t+3 and 16+4t..16+4t+3 (zero rows >= R)
    unsigned xa0 = 0u, xa2 = 0u;
    if (row_ok) {
      const int* xr = reinterpret_cast<const int*>(x8 + (size_t)g * in_f + (size_t)b * QB);
      xa0 = (unsigned)__ldg(xr + t);
      xa2 = (unsigned)__ldg(xr + 4 + t);
    }
    float p[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned* col = sT + (nt * 8 + g) * SROW;
      int c[4];
      mma_s8(xa0, xa2, col[t], col[4 + t], c);
      p[nt][0] = (float)c[0];
      p[nt][1] = (float)c[1];
    }
    // scale and accumulate: acc += p * (xs * dt), no FMA
    if (row_ok) {
      const float xsv = xs[(size_t)g * nb + b];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
        if (col < out_f) {
          const float2 d2 = scale_pair<SCALE>(dt, (size_t)b * out_f + col);
          const float s0 = __fmul_rn(xsv, d2.x);
          const float s1 = __fmul_rn(xsv, d2.y);
          acc[nt][0] = __fadd_rn(acc[nt][0], __fmul_rn(p[nt][0], s0));
          acc[nt][1] = __fadd_rn(acc[nt][1], __fmul_rn(p[nt][1], s1));
        }
      }
    }
    __syncwarp();  // the next block restages sT
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s_red[warp][g][nt * 8 + 2 * t] = acc[nt][0];
    s_red[warp][g][nt * 8 + 2 * t + 1] = acc[nt][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * TN; e += WARPS * 32) {
    const int r = e / TN, cc = e % TN;
    const int col = c0 + cc;
    if (col >= out_f) continue;
    float s = s_red[0][r][cc];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) s = __fadd_rn(s, s_red[k][r][cc]);
    dst[((size_t)split * R + r) * out_f + col] = s;
  }
}

// out[r, o] = sum of the splits' partial outputs, in split order
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out, int n,
                           int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[(size_t)k * n + i]);
  out[i] = s;
}

// One launch of an instance on `splits` x ceil(out_f / TN) CTAs. dst is out
// itself when splits == 1, else the [splits, R, out_f] partials.
template <int SCALE, int TN>
cudaError_t launch(const int8_t* x8, const float* xs, const void* qt, const void* dt,
                   float* dst, int R, int nb, int out_f, int splits, cudaStream_t s) {
  dim3 grid((out_f + TN - 1) / TN, splits);
  q40_i8_mma_kernel<SCALE, TN><<<grid, WARPS * 32, 0, s>>>(
      x8, xs, reinterpret_cast<const int8_t*>(qt),
      reinterpret_cast<const typename ScaleStorage<SCALE>::T*>(dt), dst, R, nb, out_f, splits);
  return cudaGetLastError();
}

// `launch` at a CTA width chosen at run time: 32, 64 or 128 columns.
template <int SCALE>
cudaError_t launch_cols(int cols, const int8_t* x8, const float* xs, const void* qt,
                        const void* dt, float* dst, int R, int nb, int out_f, int splits,
                        cudaStream_t s) {
  switch (cols) {
    case 32: return launch<SCALE, 32>(x8, xs, qt, dt, dst, R, nb, out_f, splits, s);
    case 64: return launch<SCALE, 64>(x8, xs, qt, dt, dst, R, nb, out_f, splits, s);
    case 128: return launch<SCALE, 128>(x8, xs, qt, dt, dst, R, nb, out_f, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// The second pass of a split launch: out = the splits' partials summed in
// split order (nothing to do for one split).
inline cudaError_t finish_splits(const float* part, void* out, int R, int out_f, int splits,
                                 cudaStream_t s) {
  if (splits == 1) return cudaSuccess;
  const int n = R * out_f;
  sum_splits<<<(n + 255) / 256, 256, 0, s>>>(part, reinterpret_cast<float*>(out), n, splits);
  return cudaGetLastError();
}

}  // namespace
