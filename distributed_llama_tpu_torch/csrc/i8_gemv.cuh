// The one-row int8 decode-matmul GEMV of the kernel probes P2
// (i8_gemv_probe.cu: int8 weights on an f32 or raw-f16-bits scale plane),
// P3, P4 and P6 (i4_gemv_probe.cu: 4-bit stored weights on an f16 or
// raw-bits plane, int8 or bf16 dot, P4's f32 dot the bf16 arm's arithmetic)
// and P5 and P9/P10 (i4_codec_probe.cu: the two codecs that store u = q + 8
// in half a byte, int8 dot). R is 1..8 activation rows.
// out[r, o] = sum over 32-blocks b of p[r, b, o] * (xs[r, b] * dt[b, o]),
// p the exact integer dot of the int8 row block x8[r, 32b .. 32b + 31] with
// the block's weight values in [-8, 7] (int8 weights: [-128, 127]).
//
// What bounds it on Hopper: memory. Each weight is read once (1 byte for
// P2, half a byte for the others) with a 2- or 4-byte scale per 32 of them;
// at most 8 rows do 2 integer ops a weight, far below the card's integer
// rate. The bytes in flight across the card and a call's fixed costs set
// its time.
//
// Design (one launch a call, no scratch, no barrier a block):
//   * a plan from the weight's shape alone (probes/gemv.py probe_plan: the
//     columns a lane owns, the warps along the contraction, the split
//     count), never from the row count, so a row's bits are the same in
//     every call;
//   * a CTA of 256 threads owns a column tile and one of `splits`
//     contiguous ranges of the contraction's blocks; its KW warps split the
//     range into contiguous runs, its 8 / KW column warps split the tile of
//     32V columns a warp;
//   * for the __dp4a dot a lane owns V consecutive columns and loads each
//     weight row of a block with one wide load along `out` (V bytes of an
//     int8, s4 or split-half byte row, 4V bytes of a nibble-word row), so a
//     warp reads 32V or 128V contiguous bytes a row; for the bf16 MMA the 4
//     lanes of a group (g, t) = (lane / 4, lane % 4) share 4V columns, lane
//     t loading byte rows t, t + 4, t + 8, t + 12 (s4) or word row t (nibble
//     words) of them. Either way a lane keeps FLIGHT (64) words of weights in
//     registers: a block is 8V words of int8 and split-half bytes and 4V of
//     the other 4-bit storages, so 1 to 4 blocks are in flight, issued
//     before the first use and refilled as each block is used;
//   * five loaders, the unpack in registers, no shared-memory staging of
//     the weights:
//       W_I8 (P2, [nb, 32, out] int8): each 4 x 4 byte patch (4 k-rows of
//         4 columns) transposed with __byte_perm, so word kq of a column
//         holds k = 4kq .. 4kq + 3;
//       W_S4 (P3, [nb, 16, out] uint8, byte row i holding k = 2i in its low
//         nibble and 2i + 1 in its high one, two's complement): for __dp4a
//         each 4 x 4 patch of byte rows 4i .. 4i + 3 transposed, then a
//         column's word masked by 0x0F0F0F0F holds k = 8i, 8i + 2, 8i + 4,
//         8i + 6 and shifted down by 4 k = 8i + 1, 8i + 3, ..; XOR 0x08 per
//         byte turns the nibble n into u = n ^ 8 = q + 8. For the MMA a byte
//         is one register of the A fragment as it stands (its two k);
//       W_I32 (P4, P6, [nb, 4, out] int32, nibble j of word g holding
//         q[4j + g] + 8): a word is one column's 8 values, so no transpose:
//         masked it holds u for k = g, 8 + g, 16 + g, 24 + g, shifted down
//         by 4 k = 4 + g, 12 + g, ..; for the MMA byte 2h + e of word t is
//         the register of k 16h + 8e + t and + 4;
//       W_FS (P9, P10, [nb, 4, out] int32, the T layout: byte j of word g
//         holding u of k = 4g + j in its low nibble and of 16 + 4g + j in
//         its high one): W_I32's loads, and word g masked holds k = 4g ..
//         4g + 3, shifted down by 4 k = 16 + 4g .., the natural k order;
//       W_SH (P5, [nb, 32, out / 2] bytes, byte [b, k, c] holding u of
//         column c in its low nibble and of column c + out / 2 in its high
//         one): W_I8's loads of V byte columns, each 4 x 4 patch transposed,
//         then a word masked is column c's four k and shifted down by 4
//         column c + out / 2's. A lane's V bytes give 2V output columns in
//         two runs, one in each half of the output, each packed byte read
//         once; a CTA's tile is two runs of 32V * (8 / KW) columns;
//     the CTA stages its rows' x words once (for __dp4a in the same k
//     order: a byte permutation once a CTA, not once a block);
//   * two dots:
//       DOT_I8 (P2, the int8 arms of P3 and P4, P5, P9/P10): __dp4a on the
//         CUDA cores, 8 a column a block (the int8 MMA would use 1 of its 16
//         M rows at one activation row). The 4-bit loaders dot u with x and start from
//         -8 * the row block's sum, staged with x (W_FS and W_SH take the
//         sums the caller gives, as the JAX probes do; the others count
//         them): u <= 15 is a nonnegative int8, so the signed dp4a takes it
//         as it is, and the difference is the signed partial exactly;
//       the bf16 dot (P3's bf16 arm, P4's bf16 and f32 arms, P6; the JAX
//         probes cast both operands to bf16 and accumulate in f32) on one
//         of two routes, which i4_gemv_probe.cu picks a loader (bf16_route):
//       DOT_BF16_MMA: mma.sync m16n8k16 bf16, the weights as A (a group's
//         column pair j as A's rows g and g + 8, so 16 columns an MMA) and
//         x as B (its 8 columns the 8 rows, all live at 8 rows). A byte
//         becomes the exact bf16 pair {128 + u_lo, 128 + u_hi} = {136 +
//         q_lo, 136 + q_hi} with one prmt and one lop3, and C starts at -136
//         * the row block's sum: every product and sum is an integer of
//         magnitude below 2^21, exact in f32, so the MMA's C is the signed
//         partial, bit for bit the __dp4a dot's. Its instructions a weight
//         do not grow with the rows;
//       DOT_BF16_FMA: exact f32 products on the CUDA cores in the __dp4a
//         layout, a byte placed in the mantissa of 2^23 with one
//         __byte_perm and the offset taken off with one subtract (q = (2^23
//         + u) - (2^23 + 8), x = (2^23 + (x + 128)) - (2^23 + 128)), fmaf
//         accumulating; the same partial bit for bit;
//   * the scale: f16 with __half2float; raw f16 bits (int16) the same, but
//     exponent 31 (inf, NaN), which the JAX integer algorithm
//     (half_bits_to_f32) maps to the finite 2^16 * (1 + mant / 1024), takes
//     one compare and select, so every bit pattern gives JAX's value; f32
//     as it is;
//   * the f32 order is fixed by the plan: acc += p * (xs * dt) (JAX's
//     association, no fused multiply-add), blocks in order within a warp's
//     run, the warps' sums in warp order (shared memory), then the splits
//     of a column tile in split order through distributed shared memory:
//     they form one thread-block cluster of <= 8 CTAs along grid x,
//     reduced in the same launch. The plain versions (probes/scales.py
//     scale_plane_call_plain, probes/int4.py i4_call_plain and
//     i32_call_plain, probes/i4_tiles.py i4_sweep_call_plain,
//     probes/int4b.py sh_call_plain, probes/int4c.py fs_call_plain) repeat
//     that order with torch ops and equal the kernels bit for bit; at one
//     plan's warps along k and blocks a split the loaders, dots and planes
//     give the same bits on the same values.

#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int QB = 32;          // Q80 block = the k-rows of a weight block
constexpr int NT = 256;         // threads of a CTA
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int MAX_DEVICES = 64; // shared-memory opt-ins are kept per device
constexpr int FLIGHT = 64;      // weight words a lane keeps in flight

enum Weights { W_I8 = 0, W_S4 = 1, W_I32 = 2, W_FS = 3, W_SH = 4 };
enum Dot { DOT_I8 = 0, DOT_BF16_MMA = 1, DOT_BF16_FMA = 2 };  // the template's dot routes
enum Scale { SC_F16 = 0, SC_F32 = 1, SC_I16 = 2 };  // the entries' scale_kind codes

// a column's row is one int32 word (the nibble words), else one byte
template <int WK>
__host__ __device__ constexpr bool words() {
  return WK == W_I32 || WK == W_FS;
}
// the rows of a weight block in memory, and a lane's words of one row
template <int WK>
__host__ __device__ constexpr int block_rows() {
  return WK == W_I8 || WK == W_SH ? QB : WK == W_S4 ? QB / 2 : 4;
}
template <int WK, int V>
__host__ __device__ constexpr int row_words() {
  return words<WK>() ? V : V / 4;
}
// the bytes of one column in one row of the weight
template <int WK>
__host__ __device__ constexpr int col_bytes() {
  return words<WK>() ? 4 : 1;
}
// the output runs a lane's columns feed: the split-half bytes two (column c
// and c + out / 2), the others one
template <int WK>
__host__ __device__ constexpr int runs() {
  return WK == W_SH ? 2 : 1;
}
// the 4-bit loaders stage -8 * each row block's sum beside x for the int8
// dot, the bf16 MMA -136 * it (its weights are 136 + q)
template <int WK, int DOT>
__host__ __device__ constexpr bool stages_sums() {
  return (WK != W_I8 && DOT == DOT_I8) || DOT == DOT_BF16_MMA;
}
// the unsigned codecs take the row blocks' sums as an operand (the JAX
// probes' bs); the others count them from x
template <int WK>
__host__ __device__ constexpr bool takes_sums() {
  return WK == W_FS || WK == W_SH;
}
// The MMA layout (DOT_BF16_MMA, the 4-bit loaders): lane (g, t) = (lane /
// 4, lane % 4) of a warp loads its group's 4V columns of byte rows t, t +
// 4, t + 8, t + 12 (s4) or of word row t (nibble words), and keeps the sums
// of those columns for x rows 2t and 2t + 1; the other dots' lanes load
// every row of their own V columns and keep them for every row.
template <int DOT>
__host__ __device__ constexpr bool mma_layout() {
  return DOT == DOT_BF16_MMA;
}
template <int WK, int DOT>
__host__ __device__ constexpr int lane_rows() {
  return !mma_layout<DOT>() ? block_rows<WK>() : WK == W_S4 ? 4 : 1;
}
template <int WK, int DOT, int V>
__host__ __device__ constexpr int lane_row_words() {
  return !mma_layout<DOT>() ? row_words<WK, V>() : WK == W_S4 ? V : 4 * V;
}
template <int WK, int DOT, int V>
__host__ __device__ constexpr int lane_cols() {
  return runs<WK>() * (mma_layout<DOT>() ? 4 * V : V);
}
template <int R, int DOT>
__host__ __device__ constexpr int lane_out_rows() {
  return mma_layout<DOT>() ? 2 : R;
}

// raw f16 bits -> f32, equal to the JAX integer algorithm on every pattern:
// the hardware convert, but exponent 31 (inf, NaN) gives 2^16 * (1 + mant /
// 1024) with the sign, as sign | (31 + 112) << 23 | mant << 13 does
__device__ __forceinline__ float i16_scale(unsigned h) {
  const float f = __half2float(__ushort_as_half((unsigned short)h));
  return (h & 0x7C00u) == 0x7C00u
             ? __uint_as_float(((h & 0x8000u) << 16) | (143u << 23) | ((h & 0x3FFu) << 13))
             : f;
}

// 4 words, word r holding k-row r's bytes of columns 0..3 -> word c holding
// column c's bytes of k-rows 0..3 (q40_i8_mma.cuh's transpose4x4)
__device__ __forceinline__ void transpose4x4(unsigned& a0, unsigned& a1, unsigned& a2,
                                             unsigned& a3) {
  const unsigned t0 = __byte_perm(a0, a1, 0x5140);
  const unsigned t1 = __byte_perm(a2, a3, 0x5140);
  const unsigned t2 = __byte_perm(a0, a1, 0x7362);
  const unsigned t3 = __byte_perm(a2, a3, 0x7362);
  a0 = __byte_perm(t0, t1, 0x5410);
  a1 = __byte_perm(t0, t1, 0x7632);
  a2 = __byte_perm(t2, t3, 0x5410);
  a3 = __byte_perm(t2, t3, 0x7632);
}

// byte j of w (0..255) as the f32 2^23 + byte
__device__ __forceinline__ float byte_f32(unsigned w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j));
}

// one weight block of a lane's columns: w[row][i] holds the lane's words of
// its rows (V / 4 or V words of 4 byte-columns, or V nibble words); s the
// raw scales of its lane_cols columns (f32 words, or two f16 bit patterns a
// word)
template <int WK, int DOT, int V, int SCALE>
struct WBlock {
  unsigned w[lane_rows<WK, DOT>()][lane_row_words<WK, DOT, V>()];
  unsigned s[SCALE == SC_F32 ? lane_cols<WK, DOT, V>() : lane_cols<WK, DOT, V>() / 2];
};

// n words from p with the widest loads (p aligned to 4n bytes, n 1, 2 or a
// multiple of 4), or with 8-byte loads at most (WIDE false: p aligned to 8)
template <int N, bool WIDE = true>
__device__ __forceinline__ void load_words(unsigned (&w)[N], const void* p) {
  if constexpr (N == 1) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (N == 2 || !WIDE) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}

// n words from p, only those of columns below `left` (the MMA layout's
// group at the ragged edge: each word 4 s4 columns, or 2 f16 scales)
template <int N>
__device__ __forceinline__ void load_words_edge(unsigned (&w)[N], const void* p, int left,
                                                int cols_a_word) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    w[i] = i * cols_a_word < left ? __ldg(reinterpret_cast<const unsigned*>(p) + i) : 0u;
}

// block b's rows of the lane (row0, row0 + step, ..: every row, or the MMA
// layout's t, t + 4, ..) at its first column col, and the scales of its
// columns (out_f the plane's width)
template <int WK, int DOT, int V, int SCALE>
__device__ __forceinline__ void load_block(WBlock<WK, DOT, V, SCALE>& f,
                                           const void* __restrict__ qt,
                                           const void* __restrict__ dt, int b, int col,
                                           int out_f, int row0) {
  constexpr int ROWS = lane_rows<WK, DOT>();
  constexpr int STEP = mma_layout<DOT>() ? 4 : 1;
  constexpr bool S4_MMA = mma_layout<DOT>() && WK == W_S4;
  if constexpr (WK == W_SH) {
    // byte rows of out / 2; the scales of byte column col's two columns
    // (f16 or raw bits: V / 2 words a run)
    static_assert(SCALE != SC_F32, "the split-half loader takes a 2-byte plane");
    const int half = out_f / 2;
    const unsigned char* q = reinterpret_cast<const unsigned char*>(qt) +
                             (size_t)b * QB * half + col;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) load_words(f.w[k], q + (size_t)k * half);
    const unsigned short* d = reinterpret_cast<const unsigned short*>(dt) + (size_t)b * out_f + col;
    using Run = unsigned[V / 2];
    load_words(*reinterpret_cast<Run*>(f.s), d);
    load_words(*reinterpret_cast<Run*>(f.s + V / 2), d + half);
    return;
  }
  const unsigned char* q =
      reinterpret_cast<const unsigned char*>(qt) +
      ((size_t)(b * block_rows<WK>() + row0) * out_f + col) * col_bytes<WK>();
  const unsigned char* d = reinterpret_cast<const unsigned char*>(dt) +
                           ((size_t)b * out_f + col) * (SCALE == SC_F32 ? 4 : 2);
  if (!mma_layout<DOT>() || col + lane_cols<WK, DOT, V>() <= out_f) {
    // the s4 MMA layout's rows start 8-byte aligned (out % 8 == 0)
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      load_words<lane_row_words<WK, DOT, V>(), !S4_MMA>(
          f.w[k], q + (size_t)k * STEP * out_f * col_bytes<WK>());
    load_words(f.s, d);
  } else {
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      load_words_edge(f.w[k], q + (size_t)k * STEP * out_f * col_bytes<WK>(), out_f - col,
                      4 / col_bytes<WK>());
    load_words_edge(f.s, d, out_f - col, 2);
  }
}

// the f32 scale of the lane's column c
template <int V, int SCALE>
__device__ __forceinline__ float scale_of(const unsigned* s, int c) {
  if constexpr (SCALE == SC_F32) {
    return __uint_as_float(s[c]);
  } else {
    const unsigned h = (s[c / 2] >> (16 * (c & 1))) & 0xFFFFu;
    if constexpr (SCALE == SC_I16) return i16_scale(h);
    return __half2float(__ushort_as_half((unsigned short)h));
  }
}

// The 4-bit loaders' u-words (u = q + 8 in each byte) of group i of a
// block: lo[c] pairs with staged x word 2i, hi[c] with word 2i + 1 (not
// W_SH, whose two nibbles are two columns: dot_block unpacks it).
template <int WK, int DOT, int V, int SCALE>
__device__ __forceinline__ void u_words(WBlock<WK, DOT, V, SCALE>& f, int i, unsigned (&lo)[V],
                                        unsigned (&hi)[V]) {
  if constexpr (WK == W_S4) {
#pragma unroll
    for (int v = 0; v < V / 4; ++v) {
      unsigned t[4] = {f.w[4 * i][v], f.w[4 * i + 1][v], f.w[4 * i + 2][v], f.w[4 * i + 3][v]};
      transpose4x4(t[0], t[1], t[2], t[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[4 * v + j] = (t[j] & 0x0F0F0F0Fu) ^ 0x08080808u;
        hi[4 * v + j] = ((t[j] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      }
    }
  } else {  // W_I32, W_FS: one word a column, no transpose
#pragma unroll
    for (int c = 0; c < V; ++c) {
      lo[c] = f.w[i][c] & 0x0F0F0F0Fu;
      hi[c] = (f.w[i][c] >> 4) & 0x0F0F0F0Fu;
    }
  }
}

// byte b of w as the bf16 pair {128 + u_lo, 128 + u_hi} of its low and
// high nibbles (the low one in the low half), exact: u the nibble as it is
// (the nibble words' u = q + 8), or XOR 8 (the s4 bytes' two's complement
// n, u = n ^ 8 = q + 8); both 136 + q
template <int WK>
__device__ __forceinline__ unsigned nibbles_bf16x2(unsigned w, int b) {
  const unsigned x = __byte_perm(w, w >> 4, b | ((4 + b) << 8));
  return (x & 0x000F000Fu) ^ (WK == W_S4 ? 0x43084308u : 0x43004300u);
}

// the MMA layout's block: lane (g, t) takes x row g as B (rows >= R zero)
// and its group's weights as A, A's row g one column of a pair and g + 8
// the other; C starts at -136 * the row block's sum, so the MMA's exact
// integer sum of x * (136 + q) ends as the signed partial p of column pair
// j for x rows 2t and 2t + 1, and acc[i][c] += p * (xs * d) as the other
// dots. The k order within a half: s4 thread t holds byte rows 8h + t and
// 8h + t + 4 (k = 16h + 2t, + 1 and 16h + 2t + 8, + 9, x as it is); the
// nibble words' thread t holds word t, nibbles 4h .. 4h + 3 (k = 16h + t,
// + 4, + 8, + 12), so its x is taken in that order.
template <int R, int V, int WK, int SCALE>
__device__ __forceinline__ void mma_block(float (&acc)[2][4 * V],
                                          WBlock<WK, DOT_BF16_MMA, V, SCALE>& f,
                                          const int4* __restrict__ xw,
                                          const float* __restrict__ xs,
                                          const int* __restrict__ xb, int bl, int bps, int g,
                                          int t) {
  unsigned bx[2][2] = {{0u, 0u}, {0u, 0u}};
  if (g < R) {
    const int4 xa = xw[2 * (g * bps + bl)];
    const int4 xc = xw[2 * (g * bps + bl) + 1];
    const unsigned n[8] = {(unsigned)xa.x, (unsigned)xa.y, (unsigned)xa.z, (unsigned)xa.w,
                           (unsigned)xc.x, (unsigned)xc.y, (unsigned)xc.z, (unsigned)xc.w};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int lo, hi;  // the register's two x bytes
        if constexpr (WK == W_S4) {
          const unsigned w = n[4 * h + 2 * e + (t >> 1)] >> (16 * (t & 1));
          lo = (int8_t)(w & 0xFFu);                      // k 16h + 8e + 2t
          hi = (int8_t)((w >> 8) & 0xFFu);               // and + 1
        } else {
          lo = (int8_t)((n[4 * h + 2 * e] >> (8 * t)) & 0xFFu);      // k 16h + 8e + t
          hi = (int8_t)((n[4 * h + 2 * e + 1] >> (8 * t)) & 0xFFu);  // and + 4
        }
        bx[h][e] = dlt::pack_bf16x2((float)lo, (float)hi);
      }
  }
  float c0[2], s[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * t + i;
    c0[i] = r < R ? __int2float_rn(xb[r * bps + bl]) : 0.0f;
    s[i] = r < R ? xs[r * bps + bl] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 2 * V; ++j) {
    float c[4] = {c0[0], c0[1], c0[0], c0[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned a[4];
      if constexpr (WK == W_S4) {  // columns 2j, 2j + 1: bytes of word j / 2
        const int v = j >> 1, b0 = 2 * (j & 1);
        a[0] = nibbles_bf16x2<WK>(f.w[2 * h][v], b0);
        a[1] = nibbles_bf16x2<WK>(f.w[2 * h][v], b0 + 1);
        a[2] = nibbles_bf16x2<WK>(f.w[2 * h + 1][v], b0);
        a[3] = nibbles_bf16x2<WK>(f.w[2 * h + 1][v], b0 + 1);
      } else {  // columns 2j, 2j + 1: words 2j, 2j + 1, bytes 2h and 2h + 1
        a[0] = nibbles_bf16x2<WK>(f.w[0][2 * j], 2 * h);
        a[1] = nibbles_bf16x2<WK>(f.w[0][2 * j + 1], 2 * h);
        a[2] = nibbles_bf16x2<WK>(f.w[0][2 * j], 2 * h + 1);
        a[3] = nibbles_bf16x2<WK>(f.w[0][2 * j + 1], 2 * h + 1);
      }
      dlt::mma_bf16(c, a, bx[h][0], bx[h][1]);
    }
    const float d0 = scale_of<V, SCALE>(f.s, 2 * j);
    const float d1 = scale_of<V, SCALE>(f.s, 2 * j + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i][2 * j] = __fadd_rn(acc[i][2 * j], __fmul_rn(c[i], __fmul_rn(s[i], d0)));
      acc[i][2 * j + 1] = __fadd_rn(acc[i][2 * j + 1], __fmul_rn(c[2 + i], __fmul_rn(s[i], d1)));
    }
  }
}

// acc[r][c] += p * (xs * d) for block bl of the CTA's range, p the exact
// integer partial of row r and column c (W_SH: c < V the lane's columns of
// the first half, V + c the same of the second)
template <int R, int V, int WK, int DOT, int SCALE>
__device__ __forceinline__ void dot_block(float (&acc)[R][lane_cols<WK, DOT, V>()],
                                          WBlock<WK, DOT, V, SCALE>& f,
                                          const int4* __restrict__ xw,
                                          const float* __restrict__ xs,
                                          const int* __restrict__ xb, int bl, int bps) {
  constexpr int AC = lane_cols<WK, DOT, V>();
  float d[AC];
#pragma unroll
  for (int c = 0; c < AC; ++c) d[c] = scale_of<V, SCALE>(f.s, c);
  if constexpr (WK == W_SH) {
    // per x word kq (k = 4kq .. 4kq + 3): the 4 x 4 patches of byte rows
    // 4kq .. 4kq + 3 transposed, each column word masked (column c) and
    // shifted (column c + out / 2), both dotted with the natural x word
    int p[R][AC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < AC; ++c) p[r][c] = xb[r * bps + bl];  // -8 * the row block's sum
#pragma unroll
    for (int kq = 0; kq < QB / 4; ++kq) {
      unsigned lo[V], hi[V];
#pragma unroll
      for (int v = 0; v < V / 4; ++v) {
        unsigned t[4] = {f.w[4 * kq][v], f.w[4 * kq + 1][v], f.w[4 * kq + 2][v],
                         f.w[4 * kq + 3][v]};
        transpose4x4(t[0], t[1], t[2], t[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[4 * v + j] = t[j] & 0x0F0F0F0Fu;
          hi[4 * v + j] = (t[j] >> 4) & 0x0F0F0F0Fu;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int4 xv = xw[2 * (r * bps + bl) + (kq >> 2)];
        const int e = kq & 3;
        const int x = e == 0 ? xv.x : e == 1 ? xv.y : e == 2 ? xv.z : xv.w;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          p[r][c] = __dp4a((int)lo[c], x, p[r][c]);
          p[r][V + c] = __dp4a((int)hi[c], x, p[r][V + c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xsv = xs[r * bps + bl];
#pragma unroll
      for (int c = 0; c < AC; ++c)
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(__int2float_rn(p[r][c]), __fmul_rn(xsv, d[c])));
    }
  } else if constexpr (WK == W_I8) {
    // the block's 4 x 4 patches transposed in place once, then per row its
    // 8 x words against every column
#pragma unroll
    for (int kq = 0; kq < QB / 4; ++kq)
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        transpose4x4(f.w[4 * kq][i], f.w[4 * kq + 1][i], f.w[4 * kq + 2][i], f.w[4 * kq + 3][i]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * bps + bl;
      const int4 xa = xw[2 * i];      // k 0..15: words 0..3
      const int4 xc = xw[2 * i + 1];  // k 16..31: words 4..7
      const int x[8] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
      const float xsv = xs[i];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        int p = 0;
#pragma unroll
        for (int kq = 0; kq < QB / 4; ++kq)
          p = __dp4a((int)f.w[4 * kq + (c & 3)][c >> 2], x[kq], p);
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(__int2float_rn(p), __fmul_rn(xsv, d[c])));
      }
    }
  } else {
    using P = typename std::conditional<DOT == DOT_I8, int, float>::type;
    P p[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        if constexpr (DOT == DOT_I8)
          p[r][c] = xb[r * bps + bl];  // -8 * the row block's sum
        else
          p[r][c] = 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned lo[V], hi[V];
      u_words<WK, DOT, V, SCALE>(f, i, lo, hi);
      if constexpr (DOT == DOT_I8) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int4 xv = xw[2 * (r * bps + bl) + (i >> 1)];
          const int xl = (i & 1) ? xv.z : xv.x;
          const int xh = (i & 1) ? xv.w : xv.y;
#pragma unroll
          for (int c = 0; c < V; ++c) {
            p[r][c] = __dp4a((int)lo[c], xl, p[r][c]);
            p[r][c] = __dp4a((int)hi[c], xh, p[r][c]);
          }
        }
      } else {
        // q = (2^23 + u) - (2^23 + 8) and, staged as x + 128, x = (2^23 + x +
        // 128) - (2^23 + 128): exact f32 operands, converted once a group for
        // the side with fewer (the weights' columns or the rows)
        const auto wf = [&](int c, int j) {
          return __fsub_rn(byte_f32(j < 4 ? lo[c] : hi[c], j & 3), 8388616.0f);
        };
        const auto xrow = [&](int r, float (&x)[8]) {
          const int4 xv = xw[2 * (r * bps + bl) + (i >> 1)];
          const unsigned xl = (unsigned)((i & 1) ? xv.z : xv.x);
          const unsigned xh = (unsigned)((i & 1) ? xv.w : xv.y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j] = __fsub_rn(byte_f32(xl, j), 8388736.0f);
            x[4 + j] = __fsub_rn(byte_f32(xh, j), 8388736.0f);
          }
        };
        if constexpr (V <= R) {
          float w[V][8];
#pragma unroll
          for (int c = 0; c < V; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) w[c][j] = wf(c, j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float x[8];
            xrow(r, x);
#pragma unroll
            for (int c = 0; c < V; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j) p[r][c] = __fmaf_rn(x[j], w[c][j], p[r][c]);
          }
        } else {
          float x[R][8];
#pragma unroll
          for (int r = 0; r < R; ++r) xrow(r, x[r]);
#pragma unroll
          for (int c = 0; c < V; ++c) {
            float w[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) w[j] = wf(c, j);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int j = 0; j < 8; ++j) p[r][c] = __fmaf_rn(x[r][j], w[j], p[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xsv = xs[r * bps + bl];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        float pf;
        if constexpr (DOT == DOT_I8)
          pf = __int2float_rn(p[r][c]);
        else
          pf = p[r][c];
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(pf, __fmul_rn(xsv, d[c])));
      }
    }
  }
}

// A row block's 8 natural x words n (word w holding k = 4w .. 4w + 3) in
// the loader's k order: W_I8 and W_SH as they are; W_FS the same words,
// word 2g = n[g] and 2g + 1 = n[4 + g]; W_S4 word 2i the even k of
// 8i .. 8i + 7 and 2i + 1 the odd ones; W_I32 word 2g k = g, 8 + g, 16 + g,
// 24 + g and 2g + 1 the same plus 4. The bf16 dot stages x + 128 (x ^ 0x80
// a byte).
template <int WK, int DOT>
__device__ __forceinline__ void stage_x(const unsigned (&n)[8], unsigned (&o)[8]) {
  if constexpr (WK == W_I8 || WK == W_SH || mma_layout<DOT>()) {
#pragma unroll
    for (int w = 0; w < 8; ++w) o[w] = n[w];
  } else if constexpr (WK == W_FS) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      o[2 * g] = n[g];
      o[2 * g + 1] = n[4 + g];
    }
  } else if constexpr (WK == W_S4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __byte_perm(n[2 * i], n[2 * i + 1], 0x6420);
      o[2 * i + 1] = __byte_perm(n[2 * i], n[2 * i + 1], 0x7531);
    }
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const unsigned sel = g | ((4 + g) << 4);
      o[2 * g] = __byte_perm(__byte_perm(n[0], n[2], sel), __byte_perm(n[4], n[6], sel), 0x5410);
      o[2 * g + 1] =
          __byte_perm(__byte_perm(n[1], n[3], sel), __byte_perm(n[5], n[7], sel), 0x5410);
    }
  }
  if constexpr (DOT == DOT_BF16_FMA) {
#pragma unroll
    for (int w = 0; w < 8; ++w) o[w] ^= 0x80808080u;
  }
}

// shared memory of a CTA: the warps' sums [KW][R][TILE] f32 (TILE the
// CTA's output columns), then its range's int8 rows [R][bps] x 32 bytes,
// row scales [R][bps] f32 and, for the 4-bit loaders' int8 dot and the MMA,
// -8 or -136 * the row blocks' sums [R][bps] int32
template <int R, int V, int KW, int WK, int DOT>
constexpr size_t smem_bytes(int bps) {
  return (size_t)KW * R * runs<WK>() * 32 * V * (NT / 32 / KW) * 4 +
         (size_t)R * bps * (QB + 4 + (stages_sums<WK, DOT>() ? 4 : 0));
}

// x8 [R, nb * 32] int8, xs_g [R, nb] f32, bs_g [R, nb] int32 (read where
// takes_sums), qt the weight, dt [nb, out_f] the plane, out [R, out_f] f32
template <int R, int V, int KW, int WK, int DOT, int SCALE>
__global__ void __launch_bounds__(NT, 1)
gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs_g,
            const void* __restrict__ qt, const void* __restrict__ dt, float* __restrict__ out,
            int nb, int out_f, int bps, int splits, const int* __restrict__ bs_g) {
  constexpr int CW = NT / 32 / KW;  // warps across the column tile
  constexpr int BT = 32 * V * CW;   // the tile's weight columns (W_SH: bytes)
  constexpr int TILE = runs<WK>() * BT;  // and output columns
  constexpr int U = FLIGHT / (lane_rows<WK, DOT>() * lane_row_words<WK, DOT, V>());  // in flight
  static_assert(U >= 1, "a block's loads must fit FLIGHT words");
  constexpr int NEL = R * TILE;
  constexpr bool MMA = mma_layout<DOT>();
  constexpr int AR = lane_out_rows<R, DOT>();    // a lane's rows of sums
  constexpr int AC = lane_cols<WK, DOT, V>();    // and columns
  constexpr int LC = AC / runs<WK>();            // of each run
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % KW;
  const int cw = warp / KW;
  const int split = blockIdx.x % splits;  // the CTA's rank in its cluster
  const int c0 = blockIdx.x / splits * BT;
  const int g = lane >> 2, t = lane & 3;  // the MMA layout's group and thread
  const int lcol = cw * 32 * V + (MMA ? g * 4 * V : lane * V);  // its first column in the tile
  const int col = c0 + lcol;
  const int row_w = out_f / runs<WK>();  // a weight row's columns (W_SH: bytes)
  // row_w % V == 0: a lane's V columns are all in range or none; the MMA
  // runs on the whole warp, a group past the edge on zeros
  const bool live = MMA ? c0 + cw * 32 * V < row_w : col < row_w;
  const int first = split * bps;
  const int nblk = max(0, min(nb, first + bps) - first);
  const int wb0 = first + kw * nblk / KW;
  const int wb1 = first + (kw + 1) * nblk / KW;
  const int in_f = nb * QB;

  float* red = reinterpret_cast<float*>(smem);             // [KW][R][TILE]
  int4* xw = reinterpret_cast<int4*>(red + KW * NEL);      // [R][bps][2]
  float* xs = reinterpret_cast<float*>(xw + R * bps * 2);  // [R][bps]
  int* xb = reinterpret_cast<int*>(xs + R * bps);          // [R][bps]

  WBlock<WK, DOT, V, SCALE> f[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (live && wb0 + u < wb1)
      load_block<WK, DOT, V, SCALE>(f[u], qt, dt, wb0 + u, col, out_f, MMA ? t : 0);
  for (int i = tid; i < R * nblk; i += NT) {
    const int r = i / nblk;
    const int b = i - r * nblk;
    const int4* src =
        reinterpret_cast<const int4*>(x8 + (size_t)r * in_f + (size_t)(first + b) * QB);
    const int4 a = __ldg(src);
    const int4 c = __ldg(src + 1);
    const unsigned n[8] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z, (unsigned)a.w,
                           (unsigned)c.x, (unsigned)c.y, (unsigned)c.z, (unsigned)c.w};
    unsigned o[8];
    stage_x<WK, DOT>(n, o);
    const int at = r * bps + b;
    xw[2 * at] = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
    xw[2 * at + 1] = make_int4((int)o[4], (int)o[5], (int)o[6], (int)o[7]);
    xs[at] = __ldg(xs_g + (size_t)r * nb + first + b);
    if constexpr (takes_sums<WK>()) {
      xb[at] = -8 * __ldg(bs_g + (size_t)r * nb + first + b);
    } else if constexpr (stages_sums<WK, DOT>()) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) s = __dp4a((int)n[w], 0x01010101, s);
      xb[at] = (MMA ? -136 : -8) * s;
    }
  }
  __syncthreads();

  float acc[AR][AC];
#pragma unroll
  for (int r = 0; r < AR; ++r)
#pragma unroll
    for (int c = 0; c < AC; ++c) acc[r][c] = 0.0f;
  if (live) {
    for (int b = wb0; b < wb1; b += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (b + u < wb1) {
          if constexpr (MMA)
            mma_block<R, V, WK, SCALE>(acc, f[u], xw, xs, xb, b + u - first, bps, g, t);
          else
            dot_block<R, V, WK, DOT, SCALE>(acc, f[u], xw, xs, xb, b + u - first, bps);
          if (b + u + U < wb1)
            load_block<WK, DOT, V, SCALE>(f[u], qt, dt, b + u + U, col, out_f, MMA ? t : 0);
        }
      }
    }
  }

  // the warps' sums, then the CTA's: warps in order (a run's columns at
  // run * BT of the tile)
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int r = MMA ? 2 * t + i : i;
    if (r < R) {
      float* dst = red + (kw * R + r) * TILE + lcol;
#pragma unroll
      for (int c = 0; c < AC; c += 4)
        *reinterpret_cast<float4*>(dst + c / LC * BT + c % LC) =
            make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
    }
  }
  __syncthreads();
  // output column of tile element j: run j / BT's column, or -1 past the edge
  const auto out_col = [&](int j) {
    const int c = c0 + j % BT;
    return c < row_w ? c + j / BT * row_w : -1;
  };
  for (int e = tid; e < NEL; e += NT) {
    float v = red[e];
#pragma unroll
    for (int w = 1; w < KW; ++w) v = __fadd_rn(v, red[w * NEL + e]);
    if (splits == 1) {
      const int c = out_col(e % TILE);
      if (c >= 0) out[(size_t)(e / TILE) * out_f + c] = v;
    } else {
      red[e] = v;
    }
  }
  if (splits == 1) return;

  // the cluster's splits in split order through distributed shared memory:
  // CTA `split` stores its share of the tile's outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (NEL + splits - 1) / splits;
  const int e1 = min(NEL, (split + 1) * per);
  for (int e = split * per + tid; e < e1; e += NT) {
    float p[MAX_SPLITS];  // every remote read in flight before the first add
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) p[s] = s < splits ? *cluster.map_shared_rank(red + e, s) : 0.0f;
    float v = p[0];
#pragma unroll
    for (int s = 1; s < MAX_SPLITS; ++s)
      if (s < splits) v = __fadd_rn(v, p[s]);
    const int c = out_col(e % TILE);
    if (c >= 0) out[(size_t)(e / TILE) * out_f + c] = v;
  }
  cluster.sync();  // no CTA leaves while its sums may be read
}

template <int R, int V, int KW, int WK, int DOT, int SCALE>
cudaError_t launch(const int8_t* x8, const float* xs, const void* qt, const void* dt,
                   float* out, int nb, int out_f, int splits, int bps, cudaStream_t stream,
                   const int* bs = nullptr) {
  constexpr int BT = 32 * V * (NT / 32 / KW);
  const size_t smem = smem_bytes<R, V, KW, WK, DOT>(bps);
  static size_t raised[MAX_DEVICES] = {};  // dynamic shared memory allowed so far
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > raised[dev]) {
    e = cudaFuncSetAttribute(gemv_kernel<R, V, KW, WK, DOT, SCALE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised[dev] = smem;
  }
  const int row_w = out_f / runs<WK>();
  const int tiles = (row_w + BT - 1) / BT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * splits));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, gemv_kernel<R, V, KW, WK, DOT, SCALE>, x8, xs, qt, dt, out, nb,
                         out_f, bps, splits, bs);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// `launch` at a row count chosen at run time: 1..8, or with
// DLT_GEMV_ROWS_1_8 (a sweep build) 1 and 8 only
template <int V, int KW, int WK, int DOT, int SCALE>
cudaError_t launch_rows(int rows, const int8_t* x8, const float* xs, const void* qt,
                        const void* dt, float* out, int nb, int out_f, int splits, int bps,
                        cudaStream_t s, const int* bs = nullptr) {
#define DLT_GEMV_ROW(N)                                                                      \
  case N:                                                                                    \
    return launch<N, V, KW, WK, DOT, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s, \
                                            bs);
  switch (rows) {
    DLT_GEMV_ROW(1)
#ifndef DLT_GEMV_ROWS_1_8
    DLT_GEMV_ROW(2)
    DLT_GEMV_ROW(3)
    DLT_GEMV_ROW(4)
    DLT_GEMV_ROW(5)
    DLT_GEMV_ROW(6)
    DLT_GEMV_ROW(7)
#endif
    DLT_GEMV_ROW(8)
    default: return cudaErrorInvalidValue;
  }
#undef DLT_GEMV_ROW
}

// the plan's checks shared by the entries: vec columns a lane dividing out,
// cols = 32 * vec * (8 / kw), splits block ranges of bps blocks (the last
// may be shorter, none empty), every operand aligned for the wide loads
inline bool plan_ok(int rows, int nb, int out_f, int vec, int cols, int kw, int splits,
                    int bps) {
  return rows >= 1 && rows <= 8 && nb >= 1 && out_f >= vec && vec >= 4 && out_f % vec == 0 &&
         (kw == 1 || kw == 2 || kw == 4 || kw == 8) && cols == 32 * vec * (NT / 32 / kw) &&
         splits >= 1 && splits <= MAX_SPLITS && bps >= 1 && (long long)splits * bps >= nb &&
         (long long)(splits - 1) * bps < nb;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

}  // namespace
