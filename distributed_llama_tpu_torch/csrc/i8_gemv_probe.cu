// P2: the int8 decode matmul on an f32 or raw-f16-bits (int16) scale plane,
// as a one-row GEMV on the CUDA cores.
// out[r, o] = sum over 32-blocks b of p[r, b, o] * (xs[r, b] * dt[b, o]),
// p the exact integer dot of the int8 row block x8[r, 32b .. 32b + 31] with
// the int8 weights qt[b, :, o] ([nb, 32, out], out innermost).
//
// Replaces scripts/probe_f16_scales.py's `build` (:118; bodies _kernel_i8
// for the f32 plane and _mm_kernel_i16 :72 for the raw bits, both
// ops/pallas_q40.py _kernel_i8's math :323: acc += p * (xs * dt), no fused
// multiply-add). R is 1..8 rows; the probe times one, as `bench_mm` does.
//
// What bounds it on Hopper: memory. Each weight byte is read once, with a
// 4-byte (f32) or 2-byte (raw bits) scale per 32 of them; at most 8 rows do
// 2 integer ops a weight, far below the card's integer rate. At the probe's
// 2048 -> 8192 the call moves 17.8-18.9 MB, 5.3-5.6 us at 3.35 TB/s, so the
// bytes in flight across the card and a call's fixed costs set its time.
//
// Design: the one-row GEMV template of csrc/i8_gemv.cuh (shared with P3 and
// P6, i4_gemv_probe.cu) with its int8 loader (each 4 x 4 byte patch
// transposed in registers) and __dp4a, at the plan i8_gemv_plan(nb, out)
// of the shape alone. probes/p2_p12_ab.py --sweep chose it at 2048 -> 8192
// (NVIDIA H100 80GB HBM3, 700 W): 4 columns a lane, all 8 warps along k
// and 2 splits (128 CTAs), 11.2 us at 1 row and 14.6 at 8 on either plane,
// the fastest of the 24 plans at both; 64 to 128 CTAs stay within 12 us,
// fewer run up to 3x slower. probes/scales.py scale_plane_call_plain
// repeats the plan's order with torch ops and equals the kernel bit for
// bit, and the f32 and i16 planes give the same bits.

#include "i8_gemv.cuh"

namespace {

// The (V, KW) pairs i8_gemv_plan hands out; built with -DDLT_P2_SWEEP,
// every pair probes/p2_p12_ab.py --sweep chooses among.
#ifdef DLT_P2_SWEEP
#define DLT_P2_PLANS(X) X(4, 2) X(4, 4) X(4, 8) X(8, 2) X(8, 4) X(8, 8)
#else
#define DLT_P2_PLANS(X) X(4, 8)
#endif

cudaError_t launch_plan(int vec, int kw, int scale_kind, int rows, const int8_t* x8,
                        const float* xs, const int8_t* qt, const void* dt, float* out, int nb,
                        int out_f, int splits, int bps, cudaStream_t s) {
#define DLT_P2_CASE(V, KW)                                                                      \
  if (vec == V && kw == KW)                                                                     \
    return scale_kind == SC_F32                                                                 \
               ? launch_rows<V, KW, W_I8, DOT_I8, SC_F32>(rows, x8, xs, qt, dt, out, nb, out_f,  \
                                                          splits, bps, s)                        \
               : launch_rows<V, KW, W_I8, DOT_I8, SC_I16>(rows, x8, xs, qt, dt, out, nb, out_f,  \
                                                          splits, bps, s);
  DLT_P2_PLANS(DLT_P2_CASE)
#undef DLT_P2_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x8 [rows, nb*32] int8; xs [rows, nb] f32; qt [nb, 32, out] int8; dt [nb,
// out] f32 (scale_kind 1) or raw f16 bits as int16 (scale_kind 2); out
// [rows, out] f32; every operand 16-byte aligned. The plan (probes/scales.py
// i8_gemv_plan): vec columns a lane (4 or 8, dividing out), cols columns a
// CTA, kw warps along the contraction, splits block ranges of bps blocks
// (the last may be shorter, none empty).
extern "C" int i8_gemv(const void* x8, const void* xs, const void* qt, const void* dt,
                       int scale_kind, void* out, int rows, int nb, int out_features, int vec,
                       int cols, int kw, int splits, int bps, void* stream) {
  if (!plan_ok(rows, nb, out_features, vec, cols, kw, splits, bps) || (vec != 4 && vec != 8) ||
      kw == 1 || (scale_kind != SC_F32 && scale_kind != SC_I16))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x8, 16) || !aligned(xs, 4) || !aligned(qt, 16) || !aligned(dt, 16) ||
      !aligned(out, 16))
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_plan(vec, kw, scale_kind, rows, reinterpret_cast<const int8_t*>(x8),
                          reinterpret_cast<const float*>(xs),
                          reinterpret_cast<const int8_t*>(qt), dt, reinterpret_cast<float*>(out),
                          nb, out_features, splits, bps, reinterpret_cast<cudaStream_t>(stream));
}
