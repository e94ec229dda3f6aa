// P13: the int8 decode matmul (q40_i8_mma.cuh) swept over its tile and its
// scale plane's storage, and P1: the raw f16 bits -> f32 convert alone.
//
// Replaces scripts/sweep_i8_tiles.py build_call (:69; bodies _kernel_i8 and
// _kernel_i8_i16 :46: unpacked int8 weights, an f32 or raw-f16-bits scale
// plane, at a (tile_n, tile_knb) tile) and probe_f16_scales.py
// probe_convert (:48; body _kernel :44: int16 bits -> f32 with integer
// ops). P2, P4 and P6, the same function at one row from int8 and from i32
// nibble words, run the one-row GEMV of i8_gemv.cuh (i8_gemv_probe.cu,
// i4_gemv_probe.cu).
//
// The JAX grid is (out // tile_n, nb // tile_knb): its k axis adds tile_knb
// blocks a step into one output tile. Here a CTA owns TN = `cols` output
// columns (32, 64 or 128: the TPU's tile_n of 256..2048 lanes has no CTA
// counterpart) and `blocks_per_cta` blocks (tile_knb's counterpart); the
// nb / blocks_per_cta splits are summed in split order by a second pass.
// Instances: scale F16 / F32 / I16, each at TN 32, 64 and 128: 9
// instances. At TN 64 and B9's split the F16 instance is
// B9's kernel.
//
// P1 is memory-bound (2 bytes read and 4 written an element): one thread
// converts 4 elements from one 8-byte load into one 16-byte store.

#include "q40_i8_mma.cuh"

namespace {

constexpr int CONVERT_THREADS = 256;
constexpr int CONVERT_PER_THREAD = 4;

__global__ void __launch_bounds__(CONVERT_THREADS)
f16bits_to_f32_kernel(const uint16_t* __restrict__ bits, float* __restrict__ out, long long n) {
  const long long i =
      ((long long)blockIdx.x * CONVERT_THREADS + threadIdx.x) * CONVERT_PER_THREAD;
  if (i + CONVERT_PER_THREAD <= n) {
    const uint2 v = *reinterpret_cast<const uint2*>(bits + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(half_bits_to_f32(v.x), half_bits_to_f32(v.x >> 16),
                    half_bits_to_f32(v.y), half_bits_to_f32(v.y >> 16));
  } else {
    for (long long j = i; j < n; ++j) out[j] = half_bits_to_f32(bits[j]);
  }
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; qt [nb, 32, out] int8; dt [nb,
// out]: scale_kind 0 f16, 1 f32, 2 raw f16 bits (int16); out [rows, out]
// f32; part [nb / blocks_per_cta, rows, out] f32 scratch (unused for one
// split). The int8 MMA at cols 32, 64 or 128.
extern "C" int q40_i8_mma_tiled(const void* x8, const void* xs, const void* qt, const void* dt,
                                int scale_kind, void* out, void* part, int rows, int nb,
                                int out_features, int cols, int blocks_per_cta, void* stream) {
  if (rows < 1 || rows > MAXR || nb < 1 || out_features < 8 || out_features % 8 != 0 ||
      blocks_per_cta < 1 || nb % blocks_per_cta != 0)
    return (int)cudaErrorInvalidValue;
  const int splits = nb / blocks_per_cta;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x = reinterpret_cast<const int8_t*>(x8);
  const float* xsp = reinterpret_cast<const float*>(xs);
  float* dst = reinterpret_cast<float*>(splits == 1 ? out : part);
  cudaError_t e;
  switch (scale_kind) {
    case SC_F16:
      e = launch_cols<SC_F16>(cols, x, xsp, qt, dt, dst, rows, nb, out_features, splits, s);
      break;
    case SC_F32:
      e = launch_cols<SC_F32>(cols, x, xsp, qt, dt, dst, rows, nb, out_features, splits, s);
      break;
    case SC_I16:
      e = launch_cols<SC_I16>(cols, x, xsp, qt, dt, dst, rows, nb, out_features, splits, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)finish_splits(dst, out, rows, out_features, splits, s);
}

// bits [n] int16 raw f16 bits (8-byte aligned) -> out [n] f32 (16-byte
// aligned), with half_bits_to_f32's integer algorithm.
extern "C" int f16bits_to_f32(const void* bits, void* out, long long n, void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(bits) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (n + CONVERT_PER_THREAD - 1) / CONVERT_PER_THREAD;
  const long long blocks = (threads + CONVERT_THREADS - 1) / CONVERT_THREADS;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  f16bits_to_f32_kernel<<<(unsigned)blocks, CONVERT_THREADS, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint16_t*>(bits), reinterpret_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
