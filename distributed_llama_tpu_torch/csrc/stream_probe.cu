// P14: stream a packed [nb*4, out] int32 weight plane, tile by tile, to
// measure what the card's memory streams.
//
// Replaces the JAX package's scripts/probe_dma.py stream_call (:40), body
// _kernel_stream (:29). Its function, at tile (tile_knb * 4 rows, tile_n
// columns): out = bias + the sum over grid tiles (j, k) of the tile's [8, 128]
// corner qp[k*4*tile_knb : +8, j*tile_n : +128], as f32.
//
// What bounds it on Hopper: memory, the plane's bytes once.
//
// Design:
//   * a TPU pays for a block's whole DMA whatever the kernel reads; a GPU
//     loads only what a thread asks for, and drops a load whose value is
//     never used. So one CTA per grid tile loads every word of its tile
//     (16-byte loads, four in flight per thread) and folds them into the
//     tile's XOR checksum, a second output [grid_j, grid_k] int32 that the
//     plain version computes too;
//   * the corner sum is exact: each CTA adds its corner's 1,024 words as
//     64-bit integers (atomics, spread over 32 slots by tile so that no
//     address sees more than 1/32 of the tiles), and a second pass sums the
//     slots and forms f32(f64(bias) + sum). An integer sum does not depend on
//     the order of the tiles, so the kernel and the plain version agree
//     exactly, where an f32 running sum of words up to 2^31 would not;
//   * the slots stay zero between calls: the caller zeroes them once, and
//     the second pass sets each slot back to 0 after reading it. A call is
//     then two kernels, with no memset before them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CORNER = 8 * 128;
constexpr int SLOTS = 32;

// grid (grid_j, grid_k): CTA (j, k) streams rows [k * tile_rows, +tile_rows)
// and columns [j * tile_n, +tile_n); tile_n is a power of two >= 128.
__global__ void __launch_bounds__(THREADS)
stream_tiles(const int* __restrict__ qp, int out_f, int tile_rows, int tile_n, int log2_vpr,
             unsigned long long* __restrict__ acc, int* __restrict__ chk) {
  const int j = blockIdx.x, k = blockIdx.y;
  const int* base = qp + (size_t)k * tile_rows * out_f + (size_t)j * tile_n;
  const int vmask = (1 << log2_vpr) - 1;  // 16-byte vectors per tile row - 1
  const int total = tile_rows << log2_vpr;
  unsigned x0 = 0u, x1 = 0u, x2 = 0u, x3 = 0u;
  int i = threadIdx.x;
  for (; i + 3 * THREADS < total; i += 4 * THREADS) {
    int4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = i + u * THREADS;
      v[u] = __ldcs(reinterpret_cast<const int4*>(base + (size_t)(e >> log2_vpr) * out_f) +
                    (e & vmask));
    }
    x0 ^= (unsigned)(v[0].x ^ v[0].y ^ v[0].z ^ v[0].w);
    x1 ^= (unsigned)(v[1].x ^ v[1].y ^ v[1].z ^ v[1].w);
    x2 ^= (unsigned)(v[2].x ^ v[2].y ^ v[2].z ^ v[2].w);
    x3 ^= (unsigned)(v[3].x ^ v[3].y ^ v[3].z ^ v[3].w);
  }
  for (; i < total; i += THREADS) {
    const int4 v =
        __ldcs(reinterpret_cast<const int4*>(base + (size_t)(i >> log2_vpr) * out_f) +
               (i & vmask));
    x0 ^= (unsigned)(v.x ^ v.y ^ v.z ^ v.w);
  }
  unsigned x = x0 ^ x1 ^ x2 ^ x3;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  __shared__ unsigned s_x[THREADS / 32];
  if ((threadIdx.x & 31) == 0) s_x[threadIdx.x >> 5] = x;

  // the tile's corner, as exact 64-bit sums
  unsigned long long* slot = acc + (size_t)((j * gridDim.y + k) % SLOTS) * CORNER;
  for (int c = threadIdx.x; c < CORNER; c += THREADS) {
    const long long v = base[(size_t)(c >> 7) * out_f + (c & 127)];
    atomicAdd(slot + c, (unsigned long long)v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0u;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t ^= s_x[w];
    chk[(size_t)j * gridDim.y + k] = (int)t;
  }
}

// out[c] = f32(f64(bias[c]) + the slots' sum); wrapping 64-bit adds give the
// exact signed sum. Each slot is set back to 0 for the next call.
__global__ void finish(const float* __restrict__ bias, unsigned long long* __restrict__ acc,
                       float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= CORNER) return;
  unsigned long long s = 0ull;
  for (int k = 0; k < SLOTS; ++k) {
    s += acc[(size_t)k * CORNER + c];
    acc[(size_t)k * CORNER + c] = 0ull;
  }
  out[c] = (float)((double)bias[c] + (double)(long long)s);
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// bias [8, 128] f32; qp [rows, out] int32 with rows % (4 * tile_knb) == 0 and
// out % tile_n == 0; out [8, 128] f32; chk [out / tile_n, rows / (4 *
// tile_knb)] int32; acc [32, 8 * 128] uint64, all zero on entry and on
// return (the caller zeroes it once; calls that share it run in stream order).
extern "C" int stream_probe(const void* bias, const void* qp, int rows, int out_features,
                            int tile_n, int tile_knb, void* out, void* chk, void* acc,
                            void* stream) {
  const int tile_rows = 4 * tile_knb;
  if (tile_knb < 2 || tile_n < 128 || (tile_n & (tile_n - 1)) != 0 || rows % tile_rows != 0 ||
      out_features % tile_n != 0)
    return (int)cudaErrorInvalidValue;
  int log2_vpr = 0;
  while ((1 << log2_vpr) < tile_n / 4) ++log2_vpr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(out_features / tile_n, rows / tile_rows);
  stream_tiles<<<grid, THREADS, 0, s>>>(reinterpret_cast<const int*>(qp), out_features,
                                        tile_rows, tile_n, log2_vpr,
                                        reinterpret_cast<unsigned long long*>(acc),
                                        reinterpret_cast<int*>(chk));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finish<<<CORNER / 256, 256, 0, s>>>(reinterpret_cast<const float*>(bias),
                                      reinterpret_cast<unsigned long long*>(acc),
                                      reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}
