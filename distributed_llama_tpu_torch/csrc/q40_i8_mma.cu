// B9, P3, P4: the int8 decode matmul over pre-quantized activations, with
// the weight in three storages and three dot types. out[r, o] =
// sum over 32-blocks b of partial[r, b, o] * (xs[r, b] * dt[b, o]), where
// partial = the exact integer dot of the int8 row block with the weight block.
//
// Replaces the JAX package's ops/pallas_q40.py _i8_call (:657), body
// _kernel_i8 (:323) (B9: unpacked int8 weights [nb, 32, out] into the
// matrix unit), and the two probe kernels that A/B against it in
// scripts/probe_int4.py: i4_call (:153, P3: 4-bit stored weights, int8 or
// bf16 dot) and i32_call (:219, P4: [nb, 4, out] int32 words, nibble j of
// word g holding q[4j + g] + 8; int8, bf16 or f32 dot).
//
// What bounds it on Hopper: memory. Each weight is read once (1 byte for B9,
// half a byte for P3 and P4) plus a 2-byte f16 scale per 32; at most 8
// activation rows do 2 ops per weight each, far below the int8 tensor rate.
//
// Design (a simple kernel that is right; speed is later work):
//   * one templated kernel over a weight loader (unpacked int8, the port's
//     s4 bytes, P4's i32 nibble words) and a dot type; six instances;
//   * a CTA owns 64 output columns and a range of 32-blocks (split-K across
//     CTAs when the column tiles alone do not fill the card); its 4 warps
//     take the range's blocks in turn, each warp on all 64 columns;
//   * the int8 dot is mma.sync m16n8k32 s8.s8.s32: k = 32 is exactly one Q40
//     block, so one MMA per 8 columns yields the block's exact integer
//     partial (no block-diagonal lhs as in the TPU kernel). The R <= 8
//     activation rows fill M rows 0..7; rows 8..15 are zero and not stored;
//   * `qt` puts `out` innermost, so k is strided in memory while the MMA's B
//     fragment wants 4 consecutive k per register. Each loader stages the
//     block as [column][k] words in shared memory (a 4 x 4 byte transpose
//     with __byte_perm for the int8 and s4 planes; P4's words already hold
//     a column's 32 values);
//   * the bf16 dot is two m16n8k16 MMAs per block, f32 accumulate; the f32
//     dot is fmaf in one lane per column. Every partial is an integer of
//     magnitude <= 32 * 127 * 8 = 32,512 < 2^24, exact in every dot type;
//   * the scale-and-accumulate code is shared: acc += p * (xs * dt) in f32
//     (JAX's association, no fused multiply-add), blocks in a fixed order per
//     warp, then warps 0..3, then splits 0..S-1 in a second pass. The six
//     instances therefore agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;      // Q40/Q80 block = the MMA's k
constexpr int TN = 64;      // output columns per CTA
constexpr int NT = TN / 8;  // n8 MMA tiles per CTA
constexpr int WARPS = 4;    // warps per CTA; warp w takes blocks kb + w + 4i
constexpr int SROW = 12;    // words per staged column (8 used; 12 spreads the banks)
constexpr int MAXR = 8;

enum Weights { W_I8 = 0, W_S4 = 1, W_I32 = 2 };
enum Dot { DOT_I8 = 0, DOT_BF16 = 1, DOT_F32 = 2 };

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

// four two's-complement nibbles, one per byte (0..15) -> four int8
__device__ __forceinline__ unsigned sext4(unsigned u) {
  return __vsub4(u ^ 0x08080808u, 0x08080808u);
}

// Stage block b's [32 k][64 columns] weights as sT[column * SROW + kq]: word
// kq holds k = 4kq..4kq+3 of the column (low byte first) as int8. Columns at
// or past out_f stage zeros.
template <int WK>
__device__ __forceinline__ void stage_block(const void* __restrict__ w, int b, int c0,
                                            int out_f, int lane, unsigned* sT) {
  if (WK == W_I8 || WK == W_S4) {
    // 128 (kq, column-quad) pairs, four a lane; lanes 0..15 read one
    // 64-byte row segment, lanes 16..31 the next kq's
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = lane + 32 * i;
      const int cq = p & 15, kq = p >> 4;
      const int col = c0 + cq * 4;
      unsigned a[4] = {0u, 0u, 0u, 0u};
      if (col < out_f) {
        if (WK == W_I8) {
          const int8_t* q = reinterpret_cast<const int8_t*>(w);
          const size_t row = (size_t)b * QB + kq * 4;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = (unsigned)__ldg(reinterpret_cast<const int*>(q + (row + r) * out_f + col));
        } else {
          // s4: byte row i holds k = 2i (low nibble) and 2i + 1 (high)
          const uint8_t* q = reinterpret_cast<const uint8_t*>(w);
          const size_t row = (size_t)b * (QB / 2) + kq * 2;
          const unsigned w0 = (unsigned)__ldg(reinterpret_cast<const int*>(q + row * out_f + col));
          const unsigned w1 =
              (unsigned)__ldg(reinterpret_cast<const int*>(q + (row + 1) * out_f + col));
          a[0] = sext4(w0 & 0x0F0F0F0Fu);
          a[1] = sext4((w0 >> 4) & 0x0F0F0F0Fu);
          a[2] = sext4(w1 & 0x0F0F0F0Fu);
          a[3] = sext4((w1 >> 4) & 0x0F0F0F0Fu);
        }
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
    for (int h = 0; h < 2; ++h) {
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

template <int WK, int DOT>
__global__ void __launch_bounds__(WARPS * 32)
q40_i8_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs,
                  const void* __restrict__ w, const __half* __restrict__ dt,
                  float* __restrict__ dst, int R, int nb, int out_f, int splits) {
  __shared__ unsigned s_tile[WARPS][TN * SROW];
  __shared__ float s_part[WARPS][MAXR][TN];  // the f32 dot's partials
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
    stage_block<WK>(w, b, c0, out_f, lane, sT);
    __syncwarp();
    float p[NT][2];
    if (DOT == DOT_F32) {
      // lane owns tile columns lane and lane + 32, every row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
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
          const __half2 d2 = *reinterpret_cast<const __half2*>(dt + (size_t)b * out_f + col);
          const float s0 = __fmul_rn(xsv, __low2float(d2));
          const float s1 = __fmul_rn(xsv, __high2float(d2));
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

template <int WK, int DOT>
cudaError_t launch(const int8_t* x8, const float* xs, const void* w, const __half* dt,
                   float* dst, int R, int nb, int out_f, int splits, cudaStream_t s) {
  dim3 grid((out_f + TN - 1) / TN, splits);
  q40_i8_mma_kernel<WK, DOT><<<grid, WARPS * 32, 0, s>>>(x8, xs, w, dt, dst, R, nb, out_f,
                                                        splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; w: weights == 0 unpacked
// [nb, 32, out] int8, 1 the port's s4 [nb, 16, out] uint8, 2 P4's
// [nb, 4, out] int32 nibble words; dt [nb, out] f16; out [rows, out] f32;
// part [splits, rows, out] f32 scratch (unused when splits == 1). dot: 0
// int8 MMA, 1 bf16 MMA, 2 f32 FMA. Instances: (0, 0), (1, 0), (1, 1),
// (2, 0), (2, 1), (2, 2).
extern "C" int q40_i8_mma(const void* x8, const void* xs, const void* w, int weights, int dot,
                          const void* dt, void* out, void* part, int rows, int nb,
                          int out_features, int splits, void* stream) {
  if (rows < 1 || rows > MAXR || nb < 1 || out_features < 8 || out_features % 8 != 0 ||
      splits < 1 || splits > nb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x = reinterpret_cast<const int8_t*>(x8);
  const float* xsp = reinterpret_cast<const float*>(xs);
  const __half* d = reinterpret_cast<const __half*>(dt);
  float* dst = reinterpret_cast<float*>(splits == 1 ? out : part);
  cudaError_t e;
  const int key = weights * 4 + dot;
  switch (key) {
    case W_I8 * 4 + DOT_I8:
      e = launch<W_I8, DOT_I8>(x, xsp, w, d, dst, rows, nb, out_features, splits, s);
      break;
    case W_S4 * 4 + DOT_I8:
      e = launch<W_S4, DOT_I8>(x, xsp, w, d, dst, rows, nb, out_features, splits, s);
      break;
    case W_S4 * 4 + DOT_BF16:
      e = launch<W_S4, DOT_BF16>(x, xsp, w, d, dst, rows, nb, out_features, splits, s);
      break;
    case W_I32 * 4 + DOT_I8:
      e = launch<W_I32, DOT_I8>(x, xsp, w, d, dst, rows, nb, out_features, splits, s);
      break;
    case W_I32 * 4 + DOT_BF16:
      e = launch<W_I32, DOT_BF16>(x, xsp, w, d, dst, rows, nb, out_features, splits, s);
      break;
    case W_I32 * 4 + DOT_F32:
      e = launch<W_I32, DOT_F32>(x, xsp, w, d, dst, rows, nb, out_features, splits, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int n = rows * out_features;
  sum_splits<<<(n + 255) / 256, 256, 0, s>>>(dst, reinterpret_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}
