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
// Design (one launch a call, no scratch, no barrier a block):
//   * a plan from the weight's shape alone (probes/scales.py i8_gemv_plan:
//     the words a lane loads per weight row, the warps along the
//     contraction, the split count), never from the row count, so a row's
//     bits are the same in every call. probes/p2_p12_ab.py --sweep chose
//     it at 2048 -> 8192 (NVIDIA H100 80GB HBM3, 700 W): 4 columns a lane,
//     all 8 warps along k and 2 splits (128 CTAs), 11.2 us at 1 row and
//     14.6 at 8 on either plane, the fastest of the 24 plans at both; 64
//     to 128 CTAs stay within 12 us, fewer run up to 3x slower;
//   * a CTA of 256 threads owns a column tile and one of `splits`
//     contiguous ranges of the contraction's blocks; its KW warps split the
//     range into contiguous runs, its 8 / KW column warps split the tile. A
//     lane owns V = 4 or 8 consecutive columns and loads each of a block's
//     32 k-rows with one V-byte load (a warp reads 128 or 256 contiguous
//     bytes a row), so a lane holds 64 words of weights in registers: two
//     blocks in flight at V 4, one at V 8, issued before the first use and
//     refilled as each block is used;
//   * no shared-memory staging of the weights: a lane transposes each 4 x 4
//     byte patch (4 k-rows of 4 columns) in registers with __byte_perm, so
//     word kq of a column holds its k = 4kq .. 4kq + 3, and takes __dp4a
//     against the row's packed x words; 8 dp4a give a column's exact block
//     partial. The CUDA cores beat the int8 MMA here: one activation row
//     would use 1 of its 16 M rows (PERF.md, P9/P10 against K1's body);
//   * the CTA's int8 rows and row scales are staged in shared memory once,
//     after the first weight loads are issued, under them;
//   * the i16 scale converts with __half2float, equal to the JAX integer
//     algorithm (half_bits_to_f32) for every finite f16; exponent 31, which
//     the JAX algorithm maps to the finite 2^16 * (1 + mant / 1024), takes
//     one compare and select, so every bit pattern gives JAX's value;
//   * the f32 order is fixed by the plan: blocks in order within a warp's
//     run, the warps' sums in warp order (shared memory), then the splits
//     of a column tile in split order through distributed shared memory:
//     they form one thread-block cluster of <= 8 CTAs along grid x, reduced
//     in the same launch. probes/scales.py scale_plane_call_plain repeats
//     that order with torch ops and equals the kernel bit for bit, and the
//     f32 and i16 planes give the same bits.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QB = 32;          // Q80 block = the k-rows of a weight block
constexpr int NT = 256;         // threads of a CTA
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int MAX_DEVICES = 64; // shared-memory opt-ins are kept per device
constexpr int FLIGHT = 64;      // weight words a lane keeps in flight

enum Scale { SC_F32 = 1, SC_I16 = 2 };  // i8_tile_probe.cu's scale_kind codes

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

// one weight block of a lane's V columns: w[k][i] holds k-row k's bytes of
// columns 4i .. 4i + 3 (after dot_block's transposes, w[4kq + j][i] holds column
// 4i + j's bytes of k = 4kq .. 4kq + 3); s the raw scales (f32 words, or
// two f16 bit patterns a word)
template <int V, int SCALE>
struct WBlock {
  unsigned w[QB][V / 4];
  unsigned s[SCALE == SC_F32 ? V : V / 2];
};

template <int V, int SCALE>
__device__ __forceinline__ void load_block(WBlock<V, SCALE>& f, const int8_t* __restrict__ qt,
                                           const void* __restrict__ dt, int b, int col,
                                           int out_f) {
  const int8_t* q = qt + (size_t)b * QB * out_f + col;
#pragma unroll
  for (int k = 0; k < QB; ++k) {
    if constexpr (V == 4) {
      f.w[k][0] = __ldg(reinterpret_cast<const unsigned*>(q + (size_t)k * out_f));
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(q + (size_t)k * out_f));
      f.w[k][0] = v.x;
      f.w[k][1] = v.y;
    }
  }
  if constexpr (SCALE == SC_F32) {
    const uint4* d = reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(dt) +
                                                    (size_t)b * out_f + col);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const uint4 v = __ldg(d + i);
      f.s[4 * i] = v.x;
      f.s[4 * i + 1] = v.y;
      f.s[4 * i + 2] = v.z;
      f.s[4 * i + 3] = v.w;
    }
  } else {
    const uint16_t* d = reinterpret_cast<const uint16_t*>(dt) + (size_t)b * out_f + col;
    if constexpr (V == 4) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(d));
      f.s[0] = v.x;
      f.s[1] = v.y;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(d));
      f.s[0] = v.x;
      f.s[1] = v.y;
      f.s[2] = v.z;
      f.s[3] = v.w;
    }
  }
}

// acc[r][c] += p * (xs * d) for block bl of the CTA's range: the block's
// 4 x 4 patches transposed in place once, then per row its 8 x words from
// shared memory against every column
template <int R, int V, int SCALE>
__device__ __forceinline__ void dot_block(float (&acc)[R][V], WBlock<V, SCALE>& f,
                                          const int4* __restrict__ xw,
                                          const float* __restrict__ xs, int bl, int bps) {
#pragma unroll
  for (int kq = 0; kq < QB / 4; ++kq)
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      transpose4x4(f.w[4 * kq][i], f.w[4 * kq + 1][i], f.w[4 * kq + 2][i], f.w[4 * kq + 3][i]);
  float d[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    if constexpr (SCALE == SC_F32)
      d[c] = __uint_as_float(f.s[c]);
    else
      d[c] = i16_scale(f.s[c / 2] >> (16 * (c & 1)));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * bps + bl;
    const int4 xa = xw[2 * i];      // k 0..15: words 0..3
    const int4 xb = xw[2 * i + 1];  // k 16..31: words 4..7
    const int x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float xsv = xs[i];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      int p = 0;
#pragma unroll
      for (int kq = 0; kq < QB / 4; ++kq) p = __dp4a((int)f.w[4 * kq + (c & 3)][c >> 2], x[kq], p);
      acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(__int2float_rn(p), __fmul_rn(xsv, d[c])));
    }
  }
}

// shared memory of a CTA: the warps' sums [KW][R][TILE] f32, then its range's
// int8 rows [R][bps] x 32 bytes and row scales [R][bps] f32
template <int R, int V, int KW>
constexpr size_t smem_bytes(int bps) {
  return (size_t)KW * R * 32 * V * (NT / 32 / KW) * 4 + (size_t)R * bps * (QB + 4);
}

template <int R, int V, int KW, int SCALE>
__global__ void __launch_bounds__(NT, 1)
i8_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ xs_g,
               const int8_t* __restrict__ qt, const void* __restrict__ dt,
               float* __restrict__ out, int nb, int out_f, int bps, int splits) {
  constexpr int CW = NT / 32 / KW;  // warps across the column tile
  constexpr int TILE = 32 * V * CW;
  constexpr int U = FLIGHT / (QB * V / 4);  // blocks a lane keeps in flight
  constexpr int NEL = R * TILE;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % KW;
  const int cw = warp / KW;
  const int split = blockIdx.x % splits;  // the CTA's rank in its cluster
  const int c0 = blockIdx.x / splits * TILE;
  const int lcol = cw * 32 * V + lane * V;  // the lane's first column in the tile
  const int col = c0 + lcol;
  const bool live = col < out_f;  // out_f % V == 0: all V columns in range
  const int first = split * bps;
  const int nblk = max(0, min(nb, first + bps) - first);
  const int wb0 = first + kw * nblk / KW;
  const int wb1 = first + (kw + 1) * nblk / KW;
  const int in_f = nb * QB;

  float* red = reinterpret_cast<float*>(smem);             // [KW][R][TILE]
  int4* xw = reinterpret_cast<int4*>(red + KW * NEL);      // [R][bps][2]
  float* xs = reinterpret_cast<float*>(xw + R * bps * 2);  // [R][bps]

  WBlock<V, SCALE> f[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (live && wb0 + u < wb1) load_block<V, SCALE>(f[u], qt, dt, wb0 + u, col, out_f);
  for (int i = tid; i < R * nblk * 2; i += NT) {
    const int r = i / (nblk * 2);
    const int h = i - r * nblk * 2;  // block h / 2, half h % 2
    xw[r * bps * 2 + h] =
        __ldg(reinterpret_cast<const int4*>(x8 + (size_t)r * in_f + (size_t)first * QB) + h);
  }
  for (int i = tid; i < R * nblk; i += NT) {
    const int r = i / nblk;
    xs[r * bps + i - r * nblk] = __ldg(xs_g + (size_t)r * nb + first + i - r * nblk);
  }
  __syncthreads();

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[r][c] = 0.0f;
  if (live) {
    for (int b = wb0; b < wb1; b += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (b + u < wb1) {
          dot_block<R, V, SCALE>(acc, f[u], xw, xs, b + u - first, bps);
          if (b + u + U < wb1) load_block<V, SCALE>(f[u], qt, dt, b + u + U, col, out_f);
        }
      }
    }
  }

  // the warps' sums, then the CTA's: warps in order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* dst = red + (kw * R + r) * TILE + lcol;
#pragma unroll
    for (int c = 0; c < V; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
  }
  __syncthreads();
  for (int e = tid; e < NEL; e += NT) {
    float v = red[e];
#pragma unroll
    for (int w = 1; w < KW; ++w) v = __fadd_rn(v, red[w * NEL + e]);
    if (splits == 1) {
      const int c = c0 + e % TILE;
      if (c < out_f) out[(size_t)(e / TILE) * out_f + c] = v;
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
    const int c = c0 + e % TILE;
    if (c < out_f) out[(size_t)(e / TILE) * out_f + c] = v;
  }
  cluster.sync();  // no CTA leaves while its sums may be read
}

template <int R, int V, int KW, int SCALE>
cudaError_t launch(const int8_t* x8, const float* xs, const int8_t* qt, const void* dt,
                   float* out, int nb, int out_f, int splits, int bps, cudaStream_t stream) {
  constexpr int TILE = 32 * V * (NT / 32 / KW);
  const size_t smem = smem_bytes<R, V, KW>(bps);
  static size_t raised[MAX_DEVICES] = {};  // dynamic shared memory allowed so far
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > raised[dev]) {
    e = cudaFuncSetAttribute(i8_gemv_kernel<R, V, KW, SCALE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised[dev] = smem;
  }
  const int tiles = (out_f + TILE - 1) / TILE;
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
  e = cudaLaunchKernelEx(&cfg, i8_gemv_kernel<R, V, KW, SCALE>, x8, xs, qt, dt, out, nb, out_f,
                         bps, splits);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int V, int KW, int SCALE>
cudaError_t launch_rows(int rows, const int8_t* x8, const float* xs, const int8_t* qt,
                        const void* dt, float* out, int nb, int out_f, int splits, int bps,
                        cudaStream_t s) {
  switch (rows) {
    case 1: return launch<1, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    case 2: return launch<2, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    case 3: return launch<3, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    case 4: return launch<4, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    case 5: return launch<5, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    case 6: return launch<6, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    case 7: return launch<7, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
    default: return launch<8, V, KW, SCALE>(x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
  }
}

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
               ? launch_rows<V, KW, SC_F32>(rows, x8, xs, qt, dt, out, nb, out_f, splits, bps, s) \
               : launch_rows<V, KW, SC_I16>(rows, x8, xs, qt, dt, out, nb, out_f, splits, bps, s);
  DLT_P2_PLANS(DLT_P2_CASE)
#undef DLT_P2_CASE
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
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
  if (rows < 1 || rows > 8 || nb < 1 || out_features < vec || (vec != 4 && vec != 8) ||
      out_features % vec != 0 || (kw != 2 && kw != 4 && kw != 8) ||
      cols != 32 * vec * (NT / 32 / kw) || splits < 1 || splits > MAX_SPLITS || bps < 1 ||
      (long long)splits * bps < nb || (long long)(splits - 1) * bps >= nb ||
      (scale_kind != SC_F32 && scale_kind != SC_I16))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x8, 16) || !aligned(xs, 4) || !aligned(qt, 16) || !aligned(dt, 16) ||
      !aligned(out, 16))
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_plan(vec, kw, scale_kind, rows, reinterpret_cast<const int8_t*>(x8),
                          reinterpret_cast<const float*>(xs),
                          reinterpret_cast<const int8_t*>(qt), dt, reinterpret_cast<float*>(out),
                          nb, out_features, splits, bps, reinterpret_cast<cudaStream_t>(stream));
}
