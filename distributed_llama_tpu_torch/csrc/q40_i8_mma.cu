// B9, P4: the int8 decode matmul over pre-quantized activations, with the
// weight unpacked or in int32 nibble words and three dot types, on an f16
// scale plane at 64 output columns a CTA. The kernel template, its design
// and what it replaces are in q40_i8_mma.cuh; the scale-plane and tile
// sweep P13 instantiates the same template in i8_tile_probe.cu.

#include "q40_i8_mma.cuh"

namespace {

constexpr int TN_B9 = 64;  // output columns per CTA

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; w: weights == 0 unpacked
// [nb, 32, out] int8, 2 P4's [nb, 4, out] int32 nibble words; dt [nb, out]
// f16; out [rows, out] f32; part [splits, rows, out] f32 scratch (unused
// when splits == 1). dot: 0 int8 MMA, 1 bf16 MMA, 2 f32 FMA. Instances:
// (0, 0), (2, 0), (2, 1), (2, 2).
extern "C" int q40_i8_mma(const void* x8, const void* xs, const void* w, int weights, int dot,
                          const void* dt, void* out, void* part, int rows, int nb,
                          int out_features, int splits, void* stream) {
  if (rows < 1 || rows > MAXR || nb < 1 || out_features < 8 || out_features % 8 != 0 ||
      splits < 1 || splits > nb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x = reinterpret_cast<const int8_t*>(x8);
  const float* xsp = reinterpret_cast<const float*>(xs);
  float* dst = reinterpret_cast<float*>(splits == 1 ? out : part);
  cudaError_t e;
  const int key = weights * 4 + dot;
  switch (key) {
    case W_I8 * 4 + DOT_I8:
      e = launch<W_I8, DOT_I8, SC_F16, TN_B9>(x, xsp, w, dt, dst, rows, nb, out_features,
                                              splits, s);
      break;
    case W_I32 * 4 + DOT_I8:
      e = launch<W_I32, DOT_I8, SC_F16, TN_B9>(x, xsp, w, dt, dst, rows, nb, out_features,
                                               splits, s);
      break;
    case W_I32 * 4 + DOT_BF16:
      e = launch<W_I32, DOT_BF16, SC_F16, TN_B9>(x, xsp, w, dt, dst, rows, nb, out_features,
                                                 splits, s);
      break;
    case W_I32 * 4 + DOT_F32:
      e = launch<W_I32, DOT_F32, SC_F16, TN_B9>(x, xsp, w, dt, dst, rows, nb, out_features,
                                                splits, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)finish_splits(dst, out, rows, out_features, splits, s);
}
