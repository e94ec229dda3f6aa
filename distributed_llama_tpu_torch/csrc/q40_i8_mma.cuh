// The int8 decode matmul template shared by B9 and P4 (q40_i8_mma.cu) and
// by the scale-plane and tile sweep P13 (i8_tile_probe.cu). P2, P3, P5, P6
// and P9/P10, the same function at one row from other weight storages, run
// the one-row GEMV of i8_gemv.cuh.
// out[r, o] = sum over 32-blocks b of partial[r, b, o] * (xs[r, b] * dt[b, o]),
// where partial = the exact integer dot of the int8 row block with the
// weight block.
//
// Replaces the JAX package's ops/pallas_q40.py _i8_call (:657), body
// _kernel_i8 (:323) (B9: unpacked int8 weights [nb, 32, out] into the
// matrix unit), the probe kernel that A/Bs against it in
// scripts/probe_int4.py: i32_call (:219, P4: [nb, 4, out] int32 words,
// nibble j of word g holding q[4j + g] + 8; int8, bf16 or f32 dot), and the
// sweep of that body over its tile and its scale plane's storage,
// scripts/sweep_i8_tiles.py build_call (:69, P13).
//
// What bounds it on Hopper: memory. Each weight is read once (1 byte for B9,
// half a byte for P4) plus a 2-byte (f16, raw f16 bits) or 4-byte (f32)
// scale per 32; at most 8 activation rows do 2 ops per weight each, far
// below the int8 tensor rate.
//
// Design (a simple kernel that is right; speed is later work):
//   * one kernel template over a weight loader (unpacked int8, P4's i32
//     nibble words), a dot type, the scale plane's storage (SCALE) and the
//     output columns a CTA owns (TN: 32, 64 or 128; B9 and P4 run at 64);
//   * a CTA owns TN output columns and a range of 32-blocks (split-K across
//     CTAs); its 4 warps take the range's blocks in turn, each warp on all
//     TN columns;
//   * the int8 dot is mma.sync m16n8k32 s8.s8.s32: k = 32 is exactly one Q40
//     block, so one MMA per 8 columns yields the block's exact integer
//     partial (no block-diagonal lhs as in the TPU kernel). The R <= 8
//     activation rows fill M rows 0..7; rows 8..15 are zero and not stored;
//   * `qt` puts `out` innermost, so k is strided in memory while the MMA's B
//     fragment wants 4 consecutive k per register. Each loader stages the
//     block as [column][k] words in shared memory (a 4 x 4 byte transpose
//     with __byte_perm for the int8 plane; P4's words already hold a
//     column's 32 values);
//   * the bf16 dot is two m16n8k16 MMAs per block, f32 accumulate; the f32
//     dot is fmaf in one lane per column. Every partial is an integer of
//     magnitude <= 32 * 127 * 8 = 32,512 < 2^24, exact in every dot type;
//   * the scale: an f16 plane converts with __half2float, an f32 plane is
//     read as it is, and raw f16 bits (int16) convert with the JAX
//     package's integer algorithm (`half_bits_to_f32`, pallas_q40.py
//     :112-130). All three give the same f32 for every finite f16;
//   * the scale-and-accumulate code is shared: acc += p * (xs * dt) in f32
//     (JAX's association, no fused multiply-add), blocks in a fixed order per
//     warp, then warps 0..3, then splits 0..S-1 in a second pass. At one
//     tile and split every instance therefore agrees bit for bit;
//   * shared memory is TN * 448 bytes: static up to TN 64, dynamic (with
//     the opt-in attribute) at TN 128, whose 56 KB pass the 48 KB static
//     limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;      // Q40/Q80 block = the MMA's k
constexpr int WARPS = 4;    // warps per CTA; warp w takes blocks kb + w + 4i
constexpr int SROW = 12;    // words per staged column (8 used; 12 spreads the banks)
constexpr int MAXR = 8;

enum Weights { W_I8 = 0, W_I32 = 2 };  // the entries' weights codes
enum Dot { DOT_I8 = 0, DOT_BF16 = 1, DOT_F32 = 2 };
enum Scale { SC_F16 = 0, SC_F32 = 1, SC_I16 = 2 };

template <int SCALE> struct ScaleStorage { using T = __half; };
template <> struct ScaleStorage<SC_F32> { using T = float; };
template <> struct ScaleStorage<SC_I16> { using T = uint16_t; };

// shared memory of one CTA: the staged tiles, the f32 dot's partials and
// the warps' sums
template <int TN>
__host__ __device__ constexpr size_t i8_mma_smem_bytes() {
  return sizeof(unsigned) * WARPS * TN * SROW + 2 * sizeof(float) * WARPS * MAXR * TN;
}
template <int TN>
__host__ __device__ constexpr bool i8_mma_dynamic_smem() {
  return i8_mma_smem_bytes<TN>() > 48 * 1024;
}

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

// Stage block b's [32 k][TN columns] weights as sT[column * SROW + kq]: word
// kq holds k = 4kq..4kq+3 of the column (low byte first) as int8. Columns at
// or past out_f stage zeros.
template <int WK, int TN>
__device__ __forceinline__ void stage_block(const void* __restrict__ w, int b, int c0,
                                            int out_f, int lane, unsigned* sT) {
  if constexpr (WK == W_I8) {
    // 8 * CQ (kq, column-quad) pairs, TN / 16 a lane; CQ lanes read one
    // TN-byte row segment, the next CQ lanes the next kq's
    constexpr int CQ = TN / 4;
    constexpr int CQ_SHIFT = CQ == 8 ? 3 : CQ == 16 ? 4 : 5;
#pragma unroll
    for (int i = 0; i < TN / 16; ++i) {
      const int p = lane + 32 * i;
      const int cq = p & (CQ - 1), kq = p >> CQ_SHIFT;
      const int col = c0 + cq * 4;
      unsigned a[4] = {0u, 0u, 0u, 0u};
      if (col < out_f) {
        const int8_t* q = reinterpret_cast<const int8_t*>(w);
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
  } else {
    // P4: word g of column o holds q[4j + g] + 8 in nibble j, so the four
    // words give word kq = bytes (nibble kq of word g) - 8, g = 0..3
    const int* q = reinterpret_cast<const int*>(w);
#pragma unroll
    for (int h = 0; h < TN / 32; ++h) {
      const int cc = lane + 32 * h;
      const int col = c0 + cc;
      unsigned g4[4] = {0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u};  // zeros
      if (col < out_f) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          g4[g] = (unsigned)__ldg(q + ((size_t)b * 4 + g) * out_f + col);
      }
#pragma unroll
      for (int kq = 0; kq < 8; ++kq) {
        const int s = 4 * kq;
        const unsigned u = ((g4[0] >> s) & 0xFu) | (((g4[1] >> s) & 0xFu) << 8) |
                           (((g4[2] >> s) & 0xFu) << 16) | (((g4[3] >> s) & 0xFu) << 24);
        sT[cc * SROW + kq] = __vsub4(u, 0x08080808u);
      }
    }
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

__device__ __forceinline__ void mma_bf16(unsigned a0, unsigned a2, unsigned b0, unsigned b1,
                                         float* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// bytes i and i + 1 of `w` (int8) as a bf16 pair, byte i in the low half
__device__ __forceinline__ unsigned bf16x2(unsigned w, int i) {
  const float lo = (float)(int8_t)(w >> (8 * i));
  const float hi = (float)(int8_t)(w >> (8 * (i + 1)));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int WK, int DOT, int SCALE, int TN>
__global__ void __launch_bounds__(WARPS * 32)
q40_i8_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
                  const void* __restrict__ w,
                  const typename ScaleStorage<SCALE>::T* __restrict__ dt,
                  float* __restrict__ dst, int R, int nb, int out_f, int splits) {
  constexpr int NT = TN / 8;  // n8 MMA tiles per CTA
  unsigned (*s_tile)[TN * SROW];
  float (*s_part)[MAXR][TN];  // the f32 dot's partials
  float (*s_red)[MAXR][TN];
  if constexpr (i8_mma_dynamic_smem<TN>()) {
    extern __shared__ __align__(16) unsigned char i8_mma_smem[];
    s_tile = reinterpret_cast<unsigned (*)[TN * SROW]>(i8_mma_smem);
    s_part = reinterpret_cast<float (*)[MAXR][TN]>(i8_mma_smem +
                                                   sizeof(unsigned) * WARPS * TN * SROW);
    s_red = s_part + WARPS;
  } else {
    __shared__ unsigned tile[WARPS][TN * SROW];
    __shared__ float part[WARPS][MAXR][TN];
    __shared__ float red[WARPS][MAXR][TN];
    s_tile = tile;
    s_part = part;
    s_red = red;
  }

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
    stage_block<WK, TN>(w, b, c0, out_f, lane, sT);
    __syncwarp();
    float p[NT][2];
    if (DOT == DOT_F32) {
      // lane owns tile columns lane + 32h, every row
#pragma unroll
      for (int h = 0; h < TN / 32; ++h) {
        const int cc = lane + 32 * h;
        for (int r = 0; r < R; ++r) {
          const int* xr = reinterpret_cast<const int*>(x8 + (size_t)r * in_f + (size_t)b * QB);
          float s = 0.0f;
#pragma unroll
          for (int kq = 0; kq < 8; ++kq) {
            const unsigned xw = (unsigned)__ldg(xr + kq);
            const unsigned ww = sT[cc * SROW + kq];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              s = fmaf((float)(int8_t)(xw >> (8 * i)), (float)(int8_t)(ww >> (8 * i)), s);
          }
          s_part[warp][r][cc] = s;
        }
      }
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        p[nt][0] = row_ok ? s_part[warp][g][nt * 8 + 2 * t] : 0.0f;
        p[nt][1] = row_ok ? s_part[warp][g][nt * 8 + 2 * t + 1] : 0.0f;
      }
    } else {
      // A fragment: row g, k = 4t..4t+3 and 16+4t..16+4t+3 (zero rows >= R)
      unsigned xa0 = 0u, xa2 = 0u;
      if (row_ok) {
        const int* xr = reinterpret_cast<const int*>(x8 + (size_t)g * in_f + (size_t)b * QB);
        xa0 = (unsigned)__ldg(xr + t);
        xa2 = (unsigned)__ldg(xr + 4 + t);
      }
      if (DOT == DOT_I8) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned* col = sT + (nt * 8 + g) * SROW;
          int c[4];
          mma_s8(xa0, xa2, col[t], col[4 + t], c);
          p[nt][0] = (float)c[0];
          p[nt][1] = (float)c[1];
        }
      } else {
        // two k16 halves; within half h the thread's k are 16h + 2t, +1
        // (regs a0/b0) and 16h + 8 + 2t, +1 (a2/b1)
        const int* xr = reinterpret_cast<const int*>(x8 + (size_t)(row_ok ? g : 0) * in_f +
                                                     (size_t)b * QB);
        unsigned xa[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned lo = row_ok ? (unsigned)__ldg(xr + 4 * h + (t >> 1)) : 0u;
          const unsigned hi = row_ok ? (unsigned)__ldg(xr + 4 * h + 2 + (t >> 1)) : 0u;
          xa[h][0] = bf16x2(lo, 2 * (t & 1));
          xa[h][1] = bf16x2(hi, 2 * (t & 1));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned* col = sT + (nt * 8 + g) * SROW;
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned b0 = bf16x2(col[4 * h + (t >> 1)], 2 * (t & 1));
            const unsigned b1 = bf16x2(col[4 * h + 2 + (t >> 1)], 2 * (t & 1));
            mma_bf16(xa[h][0], xa[h][1], b0, b1, c);
          }
          p[nt][0] = c[0];
          p[nt][1] = c[1];
        }
      }
    }
    // shared scale and accumulate: acc += p * (xs * dt), no FMA
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
    __syncwarp();  // the next block restages sT (and s_part)
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

// One launch of an instance on `splits` x ceil(out_f / TN) CTAs, raising
// the instance's dynamic shared memory limit once where TN needs it. dst is
// out itself when splits == 1, else the [splits, R, out_f] partials.
template <int WK, int DOT, int SCALE, int TN>
cudaError_t launch(const int8_t* x8, const float* xs, const void* w, const void* dt,
                   float* dst, int R, int nb, int out_f, int splits, cudaStream_t s) {
  constexpr size_t smem = i8_mma_dynamic_smem<TN>() ? i8_mma_smem_bytes<TN>() : 0;
  if (smem > 0) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(q40_i8_mma_kernel<WK, DOT, SCALE, TN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
      if (e != cudaSuccess) return e;
      raised = true;
    }
  }
  dim3 grid((out_f + TN - 1) / TN, splits);
  q40_i8_mma_kernel<WK, DOT, SCALE, TN><<<grid, WARPS * 32, smem, s>>>(
      x8, xs, w, reinterpret_cast<const typename ScaleStorage<SCALE>::T*>(dt), dst, R, nb,
      out_f, splits);
  return cudaGetLastError();
}

// `launch` at a CTA width chosen at run time: 32, 64 or 128 columns.
template <int WK, int DOT, int SCALE>
cudaError_t launch_cols(int cols, const int8_t* x8, const float* xs, const void* w,
                        const void* dt, float* dst, int R, int nb, int out_f, int splits,
                        cudaStream_t s) {
  switch (cols) {
    case 32: return launch<WK, DOT, SCALE, 32>(x8, xs, w, dt, dst, R, nb, out_f, splits, s);
    case 64: return launch<WK, DOT, SCALE, 64>(x8, xs, w, dt, dst, R, nb, out_f, splits, s);
    case 128: return launch<WK, DOT, SCALE, 128>(x8, xs, w, dt, dst, R, nb, out_f, splits, s);
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
