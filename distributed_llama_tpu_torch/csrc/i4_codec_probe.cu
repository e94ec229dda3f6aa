// P5, P9 and P10: the int8 decode matmul from the two codecs that store
// u = q + 8 in half a byte a weight, as one-row GEMVs on the CUDA cores
// that unpack the nibbles in registers.
// out[r, o] = sum over 32-blocks b of (dot(x8[r, 32b .. 32b + 31], u[b, :, o])
// - 8 * bs[r, b]) * (xs[r, b] * dt[b, o]), bs the row block's sum of x8: the
// corrected partial is the signed one exactly.
//
// Replaces scripts/probe_int4b.py sh_call (:119; body _kernel_sh :71: the
// split-half bytes [nb, 32, out / 2], byte [b, k, c] holding column c in its
// low nibble and column c + out / 2 in its high nibble, read as int8 bytes
// ("i8ops") or as int32 words ("i32st"), output [R, 2, out / 2]) and
// scripts/probe_int4c.py fs2d_call (:145; body _kernel_fs2d :110) and
// fs_call (:173; body _kernel_fs :75): the feature-split words, byte j of
// word g holding k = 4g + j in its low nibble and 16 + 4g + j in its high,
// as [nb * 4, out] or [nb, 4, out] int32. The feature-split plane is the
// port's T layout byte for byte (ops/quant.py pack_q), the operand K1 reads
// with __dp4a (q40_gemv.cu). The dt plane is f16 or its raw bits (int16,
// the JAX probes' _dt_operand). What differs between the JAX kernels and
// not here: P5's two storages are one byte plane, and P9 / P10's 2-D and
// 3-D blocks differ only in the TPU's vreg padding; each pair is one
// instance on the card.
//
// What bounds it on Hopper: memory. Each weight is half a byte, read once,
// with a 2-byte scale per 32: the probes' 2048 -> 32768 moves 37.7 MB. At
// most 8 rows do 2 ops a weight.
//
// Design: the one-row GEMV template of csrc/i8_gemv.cuh (P2's, P3's and
// P6's; its note has the layout, the loaders and the order), the int8 dot
// (__dp4a, as the JAX kernels' int8 dot), one launch a call with no
// partials buffer and no second kernel, the row blocks' sums taken from bs:
//   * P9 / P10 (`fs2d_call`, `fs_call`): the W_FS loader, a lane's V
//     columns of a word row in one wide load, 4 rows a block; word g masked
//     by 0x0F0F0F0F is k = 4g .. 4g + 3 and shifted down by 4 k = 16 + 4g ..,
//     the natural k order, so x is staged as it is: K1's body on K1's
//     operand with x8, xs and bs given;
//   * P5 (`sh_call`): the W_SH loader, a lane's V bytes of each of a
//     block's 32 rows, each 4 x 4 patch transposed with __byte_perm, a word
//     masked giving column c's four k and shifted column c + out / 2's: V
//     bytes, 2V output columns in two runs, each packed byte read once;
//   * the plan (probes/gemv.py): V columns (P5: byte columns) a lane, cols
//     output columns a CTA (8 / KW warps across them, KW along k), splits of
//     bps blocks merged in split order in one thread-block cluster. Its tile
//     (cols, blocks_per_cta) is the wrappers' `cols`, `blocks_per_cta`; the
//     default plan u4_gemv_plan(nb, out, weights) is a function of the
//     shape alone, so a row's bits are the same in every call. A plan's
//     order does not depend on the loader or V, so at P3's warps along k and
//     blocks a split P5 and P9 give P3's int8 arm's bits on the same values.

#include "i8_gemv.cuh"

namespace {

// The columns a lane of each loader: P9/P10's V words of a row (W_FS), P5's
// V bytes (W_SH, 2V output columns); the default build holds each at every
// KW of 8 warps (the tiles' cols) and 1..8 rows. Built with -DDLT_U4_SWEEP
// (with -DDLT_GEMV_ROWS_1_8), every (V, KW) pair probes/p5_p9_ab.py --sweep
// times instead, on the raw-bits plane at 1 and 8 rows. That sweep chose
// them (NVIDIA H100 80GB HBM3, 700 W; 592 plans, each bit for bit its plain
// order): 8 words a lane for P9 (2048 -> 32768 at 1 row 16.35 us against
// 18.49 at 4, though 4 won every 8-row shape, w13 14.28 against 17.82: 8
// rows of 8 columns spill), 4 bytes for P5 (17.51 against 20.28 at 8; 8
// rows at 8 bytes ran up to 2.3x slower), 8 warps along k.
constexpr int FS_VEC = 8;
constexpr int SH_VEC = 4;
#ifdef DLT_U4_SWEEP
#define DLT_FS_PLANS(X) \
  X(4, 2) X(4, 4) X(4, 8) X(8, 2) X(8, 4) X(8, 8) X(16, 2) X(16, 4) X(16, 8)
#define DLT_SH_PLANS(X) X(4, 2) X(4, 4) X(4, 8) X(8, 2) X(8, 4) X(8, 8)
#define DLT_U4_SCALES(X, V, KW, WK) X(V, KW, WK, SC_I16)
#else
#define DLT_FS_PLANS(X) X(FS_VEC, 1) X(FS_VEC, 2) X(FS_VEC, 4) X(FS_VEC, 8)
#define DLT_SH_PLANS(X) X(SH_VEC, 1) X(SH_VEC, 2) X(SH_VEC, 4) X(SH_VEC, 8)
#define DLT_U4_SCALES(X, V, KW, WK) X(V, KW, WK, SC_F16) X(V, KW, WK, SC_I16)
#endif

cudaError_t launch_plan(int weights, int scale_kind, int vec, int kw, int rows,
                        const int8_t* x8, const float* xs, const int* bs, const void* w,
                        const void* dt, float* out, int nb, int out_f, int splits, int bps,
                        cudaStream_t s) {
#define DLT_U4_INSTANCE(V, KW, WK, SCALE)                                                     \
  if (vec == V && kw == KW && scale_kind == SCALE)                                            \
    return launch_rows<V, KW, WK, DOT_I8, SCALE>(rows, x8, xs, w, dt, out, nb, out_f, splits, \
                                                 bps, s, bs);
#define DLT_FS_CASE(V, KW) DLT_U4_SCALES(DLT_U4_INSTANCE, V, KW, W_FS)
#define DLT_SH_CASE(V, KW) DLT_U4_SCALES(DLT_U4_INSTANCE, V, KW, W_SH)
  if (weights == W_FS) {
    DLT_FS_PLANS(DLT_FS_CASE)
  } else if (weights == W_SH) {
    DLT_SH_PLANS(DLT_SH_CASE)
  }
#undef DLT_FS_CASE
#undef DLT_SH_CASE
#undef DLT_U4_INSTANCE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; bs [rows, nb] int32 block sums
// of x8; w: weights 3 the feature-split words [nb, 4, out] int32, 4 the
// split-half bytes [nb, 32, out / 2]; dt [nb, out]: scale_kind 0 f16, 2 raw
// f16 bits (int16); out [rows, out] f32 in natural column order; every
// operand but xs and bs 16-byte aligned. The plan: vec columns a lane (W_SH:
// byte columns, dividing out / 2), cols output columns a CTA (W_SH: two runs
// of cols / 2), kw warps along the contraction, splits block ranges of bps
// blocks (the last may be shorter, none empty), one cluster a column tile.
extern "C" int u4_gemv(const void* x8, const void* xs, const void* bs, const void* w,
                       int weights, const void* dt, int scale_kind, void* out, int rows, int nb,
                       int out_features, int vec, int cols, int kw, int splits, int bps,
                       void* stream) {
  if (weights != W_FS && weights != W_SH) return (int)cudaErrorInvalidValue;
  const int runs = weights == W_SH ? 2 : 1;
  if (bs == nullptr || out_features % (8 * runs) != 0 || cols % runs != 0 ||
      !plan_ok(rows, nb, out_features / runs, vec, cols / runs, kw, splits, bps))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x8, 16) || !aligned(xs, 4) || !aligned(bs, 4) || !aligned(w, 16) ||
      !aligned(dt, 16) || !aligned(out, 16))
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_plan(weights, scale_kind, vec, kw, rows,
                          reinterpret_cast<const int8_t*>(x8),
                          reinterpret_cast<const float*>(xs), reinterpret_cast<const int*>(bs),
                          w, dt, reinterpret_cast<float*>(out), nb, out_features, splits, bps,
                          reinterpret_cast<cudaStream_t>(stream));
}
