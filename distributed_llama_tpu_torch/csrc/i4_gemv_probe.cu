// P3, P4 and P6: the int8 decode matmul from 4-bit stored weights, as
// one-row GEMVs on the CUDA cores that unpack the nibbles in registers.
// out[r, o] = sum over 32-blocks b of p[r, b, o] * (xs[r, b] * dt[b, o]),
// p the exact integer dot of the int8 row block x8[r, 32b .. 32b + 31] with
// the block's weight values q in [-8, 7].
//
// Replaces scripts/probe_int4.py i4_call (:153; body _kernel_i8_w4 :125:
// the s4 weight [nb, 32, out] `jnp.int4`, here the port's bytes [nb, 16,
// out] uint8, pack_s4; an int8 or a bf16 dot, `wconv`; the f16 plane),
// scripts/probe_int4.py i32_call (:219; body _kernel_i8_w32 :187: [nb, 4,
// out] int32 words, nibble j of word g holding q[4j + g] + 8; an int8, a
// bf16 or an f32 dot; the f16 plane) and scripts/sweep_i4_tiles.py
// i4_sweep_call (:123; body _kernel_w32 :56:
// [nb, 4, out] int32 words, nibble j of word g holding q[4j + g] + 8; a
// bf16 dot in each of the variants concat-bf16, concat-i32 and split-dot,
// which differ only in where Mosaic relayouts and are one instance here;
// the raw-f16-bits plane). All follow ops/pallas_q40.py _kernel_i8's math
// (:323): acc += p * (xs * dt), no fused multiply-add. R is 1..8 rows; the
// probes time one.
//
// What bounds it on Hopper: memory. Each weight is half a byte, read once,
// with a 2-byte scale per 32: the 1B wcls 2048 -> 128256 moves 147.7 MB
// (57.7 us at the 2.56 TB/s the card streams cold, probe P14), P6's 2048 ->
// 32768 37.7 MB. At most 8 rows do 2 ops a weight.
//
// Design: the one-row GEMV template of csrc/i8_gemv.cuh (P2's, whose note
// has the layout, the loaders, the dots and the order), one launch a call
// with no partials buffer and no second kernel:
//   * P3 (`i4_call_int8`, `i4_call_bf16`): the W_S4 loader on the f16
//     plane. The int8 arm takes __dp4a, a lane's 8-byte load of a byte row
//     covering its 8 columns, each pair of 4 x 4 byte patches transposed in
//     registers and masked to low and high nibbles; the bf16 arm takes
//     mma.sync, the 4 lanes of a group loading 4 byte rows each of the
//     group's 32 columns, a byte one A register as it stands. Both at the
//     plan i4_gemv_plan(nb, out) of the shape alone (probes/gemv.py): 8
//     columns a lane, all 8 warps along k (4 where 8 would leave more than
//     128 column tiles: the vocab widths), the fewest splits of a cluster
//     that reach 128 CTAs while each warp keeps its 2 blocks in flight.
//     probes/p3_p6_ab.py --sweep chose it (NVIDIA H100 80GB HBM3, 700 W):
//     of 9 (columns a lane, warps along k) pairs by 1..8 splits at P3's
//     five shapes, 1 and 8 rows, each dot and route (960 points, each bit
//     for bit its plain order), this rule came within 3% (int8) and 6%
//     (bf16) of each shape's best at 1 row, mean over the shapes. 4 warps
//     along k at the vocab width took the 1B wcls from 61.66 / 76.09 us
//     (int8 / bf16) to 56.94 / 70.66, near its best (55.06 / 69.16); 16
//     columns a lane ran 8 rows 2.3x slower (int8 207.41 against 90.90).
//     Both arms give the same bits;
//   * P4 (`i32_call_int8`, `i32_call_bf16`, `i32_call_f32`): the W_I32
//     loader on the f16 plane, one launch a call (it ran on the int8-MMA
//     template of q40_i8_mma.cuh, whose split-K took a second kernel). The
//     int8 arm takes __dp4a on the masked words, starting from -8 * the
//     row block's sum, which the template counts from x; the bf16 arm takes
//     the nibble words' route (bf16_route: exact f32 products on the CUDA
//     cores); the f32 arm is JAX's f32 dot of exact integers, the same
//     arithmetic, so it is the bf16 arm's instance under a second entry
//     name and launch counter. Its plan, probes/int4.py i32_plan, is the
//     codecs' rule at the feature-split words' geometry (u4_gemv_plan of
//     W_FS: W_I32's loads, 8 columns a lane, one block a warp in flight per
//     split doubling), at P3's (V, KW) pairs; probes/p4_p11_ab.py --sweep
//     chose it over P3's rule (NVIDIA H100 80GB HBM3, 700 W): of the 9
//     pairs by 1..8 splits at P4's five shapes (960 points, each bit for
//     bit its plain order), it came within 2.1% (int8) and 5.1% (bf16) of
//     each shape's best at 1 row, mean over the shapes (P3's rule 2.5% and
//     8.5%: it splits wqkv 4 ways, not 8), and 14% / 2.2% at 8 rows; the
//     CUDA cores beat mma.sync for the bf16 dot at every shape at 1 row
//     (the 1B wcls 70.29 against 75.31 us). All three arms give P3's bits
//     where the two plans agree (w13, w2, the wcls widths);
//   * P6 (`i4_sweep_call`): the W_I32 loader on the raw-bits plane, the
//     bf16 dot as exact f32 products on the CUDA cores, a lane's 16-byte
//     load of a word row covering its 4 columns, each word one column's 8
//     values (no transpose). Its tile (cols, blocks_per_cta) is the plan (4
//     columns a lane, 8 / (cols / 128) warps along k, nb / blocks_per_cta
//     splits of a cluster); a plan's order does not depend on the columns
//     a lane or the route, so at P3's warps and blocks a split it gives
//     P3's bits on the same values.

#include "i8_gemv.cuh"

namespace {

// P3's and P4's (V, KW) plan pairs; built with -DDLT_P3_SWEEP (with
// -DDLT_GEMV_ROWS_1_8), every pair probes/p3_p6_ab.py --sweep and
// probes/p4_p11_ab.py --sweep choose among and the bf16 dot's other route
// (dot code 2) for P3, P4 and P6, at 1 and 8 rows
#ifdef DLT_P3_SWEEP
#define DLT_P3_PLANS(X) \
  X(4, 2) X(4, 4) X(4, 8) X(8, 2) X(8, 4) X(8, 8) X(16, 2) X(16, 4) X(16, 8)
#define DLT_BF16_OTHER 1
#else
#define DLT_P3_PLANS(X) X(8, 8) X(8, 4)
#define DLT_BF16_OTHER 0
#endif
#define DLT_P6_KWS(X) X(1) X(2) X(4) X(8)
constexpr int P6_VEC = 4;  // P6's columns a lane: one 16-byte load of a word row

// The bf16 dot's route for each loader, as probes/p3_p6_ab.py --sweep chose
// it (NVIDIA H100 80GB HBM3, 700 W): P3's s4 bytes on mma.sync, within 10%
// of the CUDA cores either way at one row and 1.7-2.3x faster at 8 (the 1B
// wcls 70.66 / 76.70 us at 1 row, 83.44 / 192.54 at 8); P6's nibble words
// on the CUDA cores, whose best tile beat the MMA's best 1.08-1.27x at each
// of P6's five shapes at one row (2048 -> 32768: 23.23 against 28.53 us).
// The entries' dot
// code 1 takes the chosen route, code 2 (a sweep build only) the other.
template <int WK>
constexpr int bf16_route(bool chosen) {
  return (WK == W_S4) == chosen ? DOT_BF16_MMA : DOT_BF16_FMA;
}

template <int V, int KW, int WK, int DOT, int SCALE>
cudaError_t launch_route(int rows, const int8_t* x8, const float* xs, const void* w,
                         const void* dt, float* out, int nb, int out_f, int splits, int bps,
                         cudaStream_t s) {
  if constexpr (DOT == DOT_BF16_MMA && V > 8)  // the MMA layout keeps 8V sums a lane
    return cudaErrorInvalidValue;
  else
    return launch_rows<V, KW, WK, DOT, SCALE>(rows, x8, xs, w, dt, out, nb, out_f, splits, bps,
                                              s);
}

template <int V, int KW, int WK, int SCALE>
cudaError_t launch_dot(int dot, int rows, const int8_t* x8, const float* xs, const void* w,
                       const void* dt, float* out, int nb, int out_f, int splits, int bps,
                       cudaStream_t s) {
  if constexpr (WK == W_S4 || SCALE == SC_F16)  // P6 (the raw-bits plane) has the bf16 dot only
    if (dot == 0)
      return launch_rows<V, KW, WK, DOT_I8, SCALE>(rows, x8, xs, w, dt, out, nb, out_f, splits,
                                                   bps, s);
  if (dot == 1)
    return launch_route<V, KW, WK, bf16_route<WK>(true), SCALE>(rows, x8, xs, w, dt, out, nb,
                                                                out_f, splits, bps, s);
  if constexpr (DLT_BF16_OTHER)
    if (dot == 2)
      return launch_route<V, KW, WK, bf16_route<WK>(false), SCALE>(rows, x8, xs, w, dt, out, nb,
                                                                   out_f, splits, bps, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_plan(int weights, int dot, int scale_kind, int vec, int kw, int rows,
                        const int8_t* x8, const float* xs, const void* w, const void* dt,
                        float* out, int nb, int out_f, int splits, int bps, cudaStream_t s) {
  if (weights == W_S4 && scale_kind == SC_F16) {
#define DLT_P3_CASE(V, KW)                                                                   \
  if (vec == V && kw == KW)                                                                  \
    return launch_dot<V, KW, W_S4, SC_F16>(dot, rows, x8, xs, w, dt, out, nb, out_f, splits, \
                                           bps, s);
    DLT_P3_PLANS(DLT_P3_CASE)
#undef DLT_P3_CASE
  } else if (weights == W_I32 && scale_kind == SC_F16) {
#define DLT_P4_CASE(V, KW)                                                                    \
  if (vec == V && kw == KW)                                                                   \
    return launch_dot<V, KW, W_I32, SC_F16>(dot, rows, x8, xs, w, dt, out, nb, out_f, splits, \
                                            bps, s);
    DLT_P3_PLANS(DLT_P4_CASE)
#undef DLT_P4_CASE
  } else if (weights == W_I32 && scale_kind == SC_I16 && vec == P6_VEC) {
#define DLT_P6_CASE(KW)                                                                       \
  if (kw == KW)                                                                               \
    return launch_dot<P6_VEC, KW, W_I32, SC_I16>(dot, rows, x8, xs, w, dt, out, nb, out_f,    \
                                                 splits, bps, s);
    DLT_P6_KWS(DLT_P6_CASE)
#undef DLT_P6_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; w: weights 1 the s4 bytes [nb,
// 16, out] uint8, 2 the nibble words [nb, 4, out] int32; dot 0 int8
// (__dp4a), 1 bf16 on the loader's route (bf16_route; built with
// -DDLT_P3_SWEEP also 2, bf16 on the other route); dt [nb, out] f16
// (scale_kind 0) or raw f16 bits as int16 (scale_kind 2); out [rows, out]
// f32; every operand but xs 16-byte aligned. Instances (weights, dot,
// scale_kind): (1, 0, 0) and (1, 1, 0) for P3, (2, 0, 0) and (2, 1, 0) for
// P4, both at P3's (vec, kw) pairs, (2, 1, 2) for P6. The plan: vec columns a lane (dividing out), cols columns a
// CTA, kw warps along the contraction, splits block ranges of bps blocks
// (the last may be shorter, none empty), one cluster a column tile.
extern "C" int i4_gemv(const void* x8, const void* xs, const void* w, int weights, int dot,
                       const void* dt, int scale_kind, void* out, int rows, int nb,
                       int out_features, int vec, int cols, int kw, int splits, int bps,
                       void* stream) {
  if (!plan_ok(rows, nb, out_features, vec, cols, kw, splits, bps))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x8, 16) || !aligned(xs, 4) || !aligned(w, 16) || !aligned(dt, 16) ||
      !aligned(out, 16))
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_plan(weights, dot, scale_kind, vec, kw, rows,
                          reinterpret_cast<const int8_t*>(x8),
                          reinterpret_cast<const float*>(xs), w, dt,
                          reinterpret_cast<float*>(out), nb, out_features, splits, bps,
                          reinterpret_cast<cudaStream_t>(stream));
}
