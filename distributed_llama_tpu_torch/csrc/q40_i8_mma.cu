// B9: the int8 decode matmul over pre-quantized activations and an unpacked
// int8 weight, on an f16 scale plane at 64 output columns a CTA. The kernel
// template, its design and what it replaces are in q40_i8_mma.cuh; the
// scale-plane and tile sweep P13 instantiates the same template in
// i8_tile_probe.cu.

#include "q40_i8_mma.cuh"

namespace {

constexpr int TN_B9 = 64;  // output columns per CTA

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; qt [nb, 32, out] int8; dt [nb,
// out] f16; out [rows, out] f32; part [splits, rows, out] f32 scratch
// (unused when splits == 1).
extern "C" int q40_i8_mma(const void* x8, const void* xs, const void* qt, const void* dt,
                          void* out, void* part, int rows, int nb, int out_features, int splits,
                          void* stream) {
  if (rows < 1 || rows > MAXR || nb < 1 || out_features < 8 || out_features % 8 != 0 ||
      splits < 1 || splits > nb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* dst = reinterpret_cast<float*>(splits == 1 ? out : part);
  const cudaError_t e = launch<SC_F16, TN_B9>(reinterpret_cast<const int8_t*>(x8),
                                              reinterpret_cast<const float*>(xs), qt, dt, dst,
                                              rows, nb, out_features, splits, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_splits(dst, out, rows, out_features, splits, s);
}
