// P5, P9 and P10: the int8 decode matmul (q40_i8_mma.cuh) fed from the two
// codecs that store u = q + 8 in half a byte a weight.
//
// Replaces scripts/probe_int4b.py sh_call (:119; body _kernel_sh :71: the
// split-half bytes [nb, 32, out / 2], byte [b, k, c] holding column c in its
// low nibble and column c + out / 2 in its high nibble, read as int8 bytes
// ("i8ops") or as int32 words ("i32st"), output [R, 2, out / 2]) and
// scripts/probe_int4c.py fs2d_call (:145; body _kernel_fs2d :110) and
// fs_call (:173; body _kernel_fs :75): the feature-split words, byte k of
// word g holding k = 4g + k in its low nibble and 16 + 4g + k in its high,
// as [nb * 4, out] or [nb, 4, out] int32. The feature-split plane is the
// port's T layout byte for byte (ops/quant.py pack_q), the operand K1 reads
// with __dp4a (q40_gemv.cu).
//
// Each JAX kernel takes the integer dot with u and subtracts 8 * bs, the row
// block's sum of x8, before it scales; so does the template's epilogue for
// these two loaders, and the corrected partial is the signed one exactly.
// What differs between the JAX kernels and not here: the two storages of
// P5 are one byte plane (the int32 view is the same bytes), and P9 / P10's
// 2-D and 3-D blocks differ only in the TPU's vreg padding; each pair is
// one instance on the card. The JAX grid is (out // tile_n, nb // tile_knb)
// (P5: over out / 2); here a CTA owns `cols` output columns (32, 64 or 128;
// for P5 cols / 2 bytes of each k row, both nibbles) and `blocks_per_cta`
// 32-blocks, the splits summed in split order by a second pass.
// Instances: loader W_FS or W_SH, dot DOT_I8, scale F16 (K1's operand) or
// I16 (the JAX probes' raw f16 bits), each at cols 32, 64 and 128: 12.
// At one tile and split, W_FS and W_SH with the F16 plane equal B9 (and with
// I16 equal P13) bit for bit on the same weights.

#include "q40_i8_mma.cuh"

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; bs [rows, nb] int32 block sums
// of x8; w: weights == 3 the feature-split words [nb * 4, out] int32, 4 the
// split-half bytes [nb, 32, out / 2]; dt [nb, out]: scale_kind 0 f16, 2 raw
// f16 bits (int16); out [rows, out] f32 in natural column order; part
// [nb / blocks_per_cta, rows, out] f32 scratch (unused for one split). The
// split-half plane needs (out / 2) % (cols / 2) == 0.
extern "C" int q40_u4_mma(const void* x8, const void* xs, const void* bs, const void* w,
                          int weights, const void* dt, int scale_kind, void* out, void* part,
                          int rows, int nb, int out_features, int cols, int blocks_per_cta,
                          void* stream) {
  if (rows < 1 || rows > MAXR || nb < 1 || out_features < 8 || out_features % 8 != 0 ||
      blocks_per_cta < 1 || nb % blocks_per_cta != 0 || bs == nullptr ||
      (cols != 32 && cols != 64 && cols != 128))
    return (int)cudaErrorInvalidValue;
  if (weights == W_SH && (out_features / 2) % (cols / 2) != 0) return (int)cudaErrorInvalidValue;
  const int splits = nb / blocks_per_cta;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x = reinterpret_cast<const int8_t*>(x8);
  const float* xsp = reinterpret_cast<const float*>(xs);
  const int* bsp = reinterpret_cast<const int*>(bs);
  float* dst = reinterpret_cast<float*>(splits == 1 ? out : part);
  cudaError_t e;
  switch (weights * 4 + scale_kind) {
    case W_FS * 4 + SC_F16:
      e = launch_cols<W_FS, DOT_I8, SC_F16>(cols, x, xsp, w, dt, dst, rows, nb, out_features,
                                            splits, s, bsp);
      break;
    case W_FS * 4 + SC_I16:
      e = launch_cols<W_FS, DOT_I8, SC_I16>(cols, x, xsp, w, dt, dst, rows, nb, out_features,
                                            splits, s, bsp);
      break;
    case W_SH * 4 + SC_F16:
      e = launch_cols<W_SH, DOT_I8, SC_F16>(cols, x, xsp, w, dt, dst, rows, nb, out_features,
                                            splits, s, bsp);
      break;
    case W_SH * 4 + SC_I16:
      e = launch_cols<W_SH, DOT_I8, SC_I16>(cols, x, xsp, w, dt, dst, rows, nb, out_features,
                                            splits, s, bsp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)finish_splits(dst, out, rows, out_features, splits, s);
}
