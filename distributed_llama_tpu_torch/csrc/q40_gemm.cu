// K2: bf16-dequant Q40 GEMM for prefill row counts, on the packed T-layout
// weight (ops/quant.py): out[m, n] = sum_k x[m, k] * w[k, n], f32 out.
//
// Replaces the JAX package's ops/pallas_q40.py q40_matmul_pallas_stacked
// (:253), body _dequant_dot_accum (:160). The layer index of the stacked
// weight only offsets the base pointers; an unstacked weight is layer 0,
// which also makes this kernel B5 (q40_matmul_pallas, :880: the wcls at more
// than 8 rows). Any block count, any out_features (the last column tile is
// masked) and any row count run; calls above 32 rows tile the rows.
//
// Numerics, as in _dequant_dot_accum's bf16 branch (:173-178): x is rounded
// to bf16 (by the wrapper); the f16 scale goes to f32 and rounds to bf16;
// each weight is (u - 8) * bf16(scale), exact, rounded once to bf16; the
// products x . w accumulate in f32 on the tensor cores. The dequantized
// weights equal the plain version's bit for bit; only the order of the f32
// sums differs.
//
// What bounds it on Hopper: memory. At the 16..32 rows of a prefill chunk
// it reads 0.5625 bytes per weight and does 2 * rows flops per weight: at 32
// rows ~114 flops per weight byte, under the ~295 where the bf16 tensor
// cores become the limit. A Llama-3.2-1B layer's four calls move 1-19 MB
// each, 0.3-5.6 us at 3.35 TB/s, so the call is also short: latency (bytes
// in flight) and the launch count matter as much as the bytes.
//
// Design:
//   * split-K to fill the card. A CTA owns a column tile of 64 outputs (128
//     where two splits of such tiles fill the card: 1B's w13, the vocab
//     widths; each tile reads its rows' x, so wider tiles read less of it)
//     x 32 rows and one of `splits` contiguous block ranges of the
//     contraction. The plan (ops/cuda_q40.py gemm_plan: column tile,
//     splits, blocks per split) is a function of (nb, out_features) alone,
//     so a row's sums never depend on the call's row count or data: a 1B
//     layer's four calls get 256-384 CTAs on 132 SMs.
//   * the splits of one column tile form a thread-block cluster (at most 8
//     CTAs, grid.y) and are reduced through distributed shared memory, in
//     split order, in the same launch; no workspace, no atomics. Within a
//     CTA, four warps each take one Q40 block of every ring stage (warp kw:
//     block kw) and their partials are summed in warp order.
//   * a ring of 4 stages in shared memory, fed by cp.async (16 bytes a
//     thread, one commit group a stage): a stage holds 4 Q40 blocks' words
//     and f16 scales for the column tile and the matching 32 x 128 slice of
//     x; stages s + 1..s + 3 are in flight while stage s is multiplied.
//   * the weights are dequantized in registers, straight into the B
//     fragments of mma.sync m16n8k16: lane (gid, tig) reads word tig of its
//     column, whose nibbles are features 4tig + kk (low) and 16 + 4tig + kk
//     (high), and builds bf16 pairs with the exponent trick: 0x4300 | u is
//     128 + u exactly, one bf16 FMA subtracts 136 exactly, a second
//     multiplies by bf16(scale) with one rounding (the product of a 4-bit
//     integer and an 8-bit mantissa is exact before it). A fragment pair
//     then holds features (4tig, 4tig + 2) and (4tig + 1, 4tig + 3): the x
//     fragment is read in the same permuted order (one prmt per register),
//     so the dot product is unchanged and no nibble is shuffled.
//   * mma.sync and not wgmma: at <= 32 rows the tensor cores are not the
//     limit, and a 16 x 8 A tile of x keeps a 16-row call from padding to
//     64 rows.
//   * x is staged in bf16, cast by the wrapper (one small kernel a call).
//     Staging the caller's f32 and rounding it in the kernel, or loading
//     each warp's x straight into registers, saves that launch but reads
//     twice the bytes from L2 and needs more shared memory or registers:
//     on an H100 SXM both lost at 32 rows. A deeper ring lost too (fewer
//     CTAs fit an SM): resident CTAs, not ring depth, move the time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int QB = 32;          // features per Q40 block
constexpr int ROWS = 32;        // rows per CTA
constexpr int KW = 4;           // warps along the contraction, one block of a stage each
constexpr int SB = KW;          // Q40 blocks per ring stage
constexpr int STAGES = 4;       // ring depth
constexpr int XLD = SB * QB + 16;  // bf16 per staged x row: 288 bytes, so the 8-byte
                                   // fragment reads of 4 rows hit 32 distinct banks
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr int MAX_DEVICES = 64; // shared-memory opt-ins are kept per device

// shared memory of a CTA with CG column groups of 64 (BN = 64 * CG columns,
// 128 * CG threads): the ring, reused after the loop for the warps' partials
template <int CG>
struct Smem {
  static constexpr int BN = 64 * CG;
  static constexpr int WLD = BN + 8;  // int32 per staged word row (conflict-free reads)
  static constexpr int RLD = BN + 8;  // f32 per row of a warp's partial
  static constexpr size_t words = (size_t)SB * 4 * WLD * 4;
  static constexpr size_t scales = (size_t)SB * BN * 2;
  static constexpr size_t xs = (size_t)ROWS * XLD * 2;
  static constexpr size_t stage = words + scales + xs;
  static constexpr size_t red = (size_t)KW * ROWS * RLD * 4;
  static constexpr size_t total = STAGES * stage > red ? STAGES * stage : red;
  static_assert(words % 16 == 0 && scales % 16 == 0 && xs % 16 == 0, "16-byte stage parts");
};

// One ring stage: blocks b0 .. b0 + SB - 1 (those below b_end) of the words,
// scales and x rows. vec: out_f % 8 == 0 and aligned planes, so every
// 16-byte chunk of a word or scale row is aligned and lies wholly in or out
// of range; otherwise (widths no model serves) they load element by element.
template <int CG>
__device__ __forceinline__ void load_stage(unsigned char* st, const __nv_bfloat16* x,
                                           const int* q, const __half* d, int b0, int b_end,
                                           int x_rows, int m_rows, int in_f, int out_f, int n0,
                                           bool vec, int tid) {
  using L = Smem<CG>;
  constexpr int NT = 128 * CG;
  int* ws = reinterpret_cast<int*>(st);
  __half* ds = reinterpret_cast<__half*>(st + L::words);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + L::words + L::scales);
  constexpr int WCH = L::BN / 4;  // 16-byte chunks of one word row
  for (int i = tid; i < SB * 4 * WCH; i += NT) {
    const int row = i / WCH;  // blk * 4 + g
    const int ch = i % WCH;
    const int b = b0 + row / 4;
    if (b >= b_end) continue;
    const int n = n0 + ch * 4;
    int* dst = ws + row * L::WLD + ch * 4;
    const int* src = q + ((size_t)b * 4 + (row & 3)) * out_f + n;
    if (vec) {
      dlt::cp_async16(dst, n < out_f ? src : q, n < out_f ? 16 : 0);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = n + e < out_f ? __ldg(src + e) : 0;
    }
  }
  constexpr int SCH = L::BN / 8;
  for (int i = tid; i < SB * SCH; i += NT) {
    const int blk = i / SCH;
    const int ch = i % SCH;
    const int b = b0 + blk;
    if (b >= b_end) continue;
    const int n = n0 + ch * 8;
    __half* dst = ds + blk * L::BN + ch * 8;
    const __half* src = d + (size_t)b * out_f + n;
    if (vec) {
      dlt::cp_async16(dst, n < out_f ? src : d, n < out_f ? 16 : 0);
    } else {
      for (int e = 0; e < 8; ++e) dst[e] = n + e < out_f ? src[e] : __float2half(0.0f);
    }
  }
  // x: rows below m_rows (the m-tiles in use); rows past x_rows read zeros
  for (int i = tid; i < m_rows * SB * 4; i += NT) {
    const int r = i / (SB * 4);
    const int blk = (i / 4) % SB;
    const int ch = i % 4;
    const int b = b0 + blk;
    if (b >= b_end) continue;
    const __nv_bfloat16* src = x + (size_t)r * in_f + (size_t)b * QB + ch * 8;
    dlt::cp_async16(xs + r * XLD + blk * QB + ch * 8, r < x_rows ? src : x, r < x_rows ? 16 : 0);
  }
}

// 0x4300 | u pairs -> bf16((u - 8) * s) pairs: the subtraction is exact, the
// multiply rounds once
__device__ __forceinline__ unsigned dequant2(unsigned biased, unsigned s2) {
  const unsigned t = dlt::fma_bf16x2(biased, 0x3F803F80u, 0xC308C308u);  // * 1 - 136
  return dlt::fma_bf16x2(t, s2, 0x80008000u);                            // * s + (-0)
}

template <int CG>
__global__ void __launch_bounds__(128 * CG)
q40_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ q,
                     const __half* __restrict__ d, float* __restrict__ out, int M, int nb,
                     int out_f, int bps, int splits, int vec) {
  using L = Smem<CG>;
  constexpr int NT = 128 * CG;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int cgi = warp / KW;  // column group: columns 64 * cgi .. + 63 of the tile
  const int kw = warp % KW;   // block kw of every stage
  const int n0 = blockIdx.x * L::BN;
  const int m0 = blockIdx.z * ROWS;
  const int x_rows = min(ROWS, M - m0);
  const int mts = x_rows > 16 ? 2 : 1;  // 16-row m-tiles in use
  const int in_f = nb * QB;
  const int kb0 = blockIdx.y * bps;
  const int kb1 = min(nb, kb0 + bps);
  const int n_stages = kb1 > kb0 ? (kb1 - kb0 + SB - 1) / SB : 0;
  x += (size_t)m0 * in_f;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages)
      load_stage<CG>(smem + s * L::stage, x, q, d, kb0 + s * SB, kb1, x_rows, 16 * mts, in_f,
                     out_f, n0, vec, tid);
    dlt::cp_async_commit();
  }

  for (int it = 0; it < n_stages; ++it) {
    dlt::cp_async_wait<STAGES - 2>();  // stage it has landed (this thread's copies)
    __syncthreads();                   // ... and everyone's; slot it - 1 is free
    {
      const int s = it + STAGES - 1;
      if (s < n_stages)
        load_stage<CG>(smem + (s % STAGES) * L::stage, x, q, d, kb0 + s * SB, kb1, x_rows,
                       16 * mts, in_f, out_f, n0, vec, tid);
      dlt::cp_async_commit();
    }
    if (kb0 + it * SB + kw >= kb1) continue;  // the split's ragged last stage
    const unsigned char* st = smem + (it % STAGES) * L::stage;
    const int* ws = reinterpret_cast<const int*>(st) + kw * 4 * L::WLD;
    const __half* ds = reinterpret_cast<const __half*>(st + L::words) + kw * L::BN;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(st + L::words + L::scales) + kw * QB;

    // x fragments of this block: features (4tig, 4tig + 2) and (4tig + 1,
    // 4tig + 3) of each half, the order the weight pairs come in
    unsigned a[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= mts) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat16* p = xs + (16 * mt + gid) * XLD + 16 * h + 4 * tig;
        const uint2 v0 = *reinterpret_cast<const uint2*>(p);
        const uint2 v1 = *reinterpret_cast<const uint2*>(p + 8 * XLD);
        a[mt][h][0] = dlt::prmt(v0.x, v0.y, 0x5410);
        a[mt][h][1] = dlt::prmt(v1.x, v1.y, 0x5410);
        a[mt][h][2] = dlt::prmt(v0.x, v0.y, 0x7632);
        a[mt][h][3] = dlt::prmt(v1.x, v1.y, 0x7632);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * cgi + 8 * j + gid;
      const unsigned w = (unsigned)ws[tig * L::WLD + col];
      const __nv_bfloat16 sb = __float2bfloat16_rn(__half2float(ds[col]));
      const unsigned short sbits = *reinterpret_cast<const unsigned short*>(&sb);
      const unsigned s2 = (unsigned)sbits | ((unsigned)sbits << 16);
      const unsigned b0 = dequant2((w & 0x000F000Fu) | 0x43004300u, s2);          // 4tig, +2
      const unsigned b1 = dequant2(((w >> 8) & 0x000F000Fu) | 0x43004300u, s2);   // +1, +3
      const unsigned b2 = dequant2(((w >> 4) & 0x000F000Fu) | 0x43004300u, s2);   // 16 + ...
      const unsigned b3 = dequant2(((w >> 12) & 0x000F000Fu) | 0x43004300u, s2);
      dlt::mma_bf16(acc[0][j], a[0][0], b0, b1);
      dlt::mma_bf16(acc[0][j], a[0][1], b2, b3);
      if (mts == 2) {
        dlt::mma_bf16(acc[1][j], a[1][0], b0, b1);
        dlt::mma_bf16(acc[1][j], a[1][1], b2, b3);
      }
    }
  }
  dlt::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' partials now

  float* red = reinterpret_cast<float*>(smem);  // [KW][ROWS][RLD]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= mts) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * cgi + 8 * j + 2 * tig;
      float* r0 = red + ((size_t)kw * ROWS + 16 * mt + gid) * L::RLD + col;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(r0 + 8 * L::RLD) = make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
  __syncthreads();

  // this CTA's partial: the warps' sums in warp order, kept in place in
  // red[0] for the cluster (or stored when there is one split)
  const int n_el = x_rows * L::BN;
  for (int e = tid; e < n_el; e += NT) {
    const int r = e / L::BN;
    const int n = e % L::BN;
    float v = red[(size_t)r * L::RLD + n];
#pragma unroll
    for (int w = 1; w < KW; ++w) v = __fadd_rn(v, red[((size_t)w * ROWS + r) * L::RLD + n]);
    if (splits == 1) {
      if (n0 + n < out_f) out[(size_t)(m0 + r) * out_f + n0 + n] = v;
    } else {
      red[(size_t)r * L::RLD + n] = v;
    }
  }
  if (splits == 1) return;

  // the cluster's splits, summed in split order through distributed shared
  // memory: CTA `rank` stores every splits-th run of NT elements
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int e = rank * NT + tid; e < n_el; e += splits * NT) {
    const int r = e / L::BN;
    const int n = e % L::BN;
    float* mine = red + (size_t)r * L::RLD + n;
    float p[MAX_SPLITS];  // every remote read in flight before the first add
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      p[s] = s < splits ? *cluster.map_shared_rank(mine, s) : 0.0f;
    float v = p[0];
#pragma unroll
    for (int s = 1; s < MAX_SPLITS; ++s)
      if (s < splits) v = __fadd_rn(v, p[s]);
    if (n0 + n < out_f) out[(size_t)(m0 + r) * out_f + n0 + n] = v;
  }
  cluster.sync();  // no CTA leaves while its partial may still be read
}

template <int CG>
cudaError_t launch(const __nv_bfloat16* x, const int* q, const __half* d, float* out, int rows,
                   int nb, int out_f, int bps, int splits, int vec, cudaStream_t stream) {
  const size_t smem = Smem<CG>::total;
  static bool raised[MAX_DEVICES] = {};  // the opt-in is per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(q40_gemm_bf16_kernel<CG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((out_f + Smem<CG>::BN - 1) / Smem<CG>::BN, splits, (rows + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(128 * CG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, q40_gemm_bf16_kernel<CG>, x, q, d, out, rows, nb, out_f, bps,
                         splits, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [rows, in] bf16; q [L, in/8, out] int32; d [L, in/32, out] f16;
// out [rows, out] f32. The plan (ops/cuda_q40.py gemm_plan): cols 64 or
// 128 per CTA, `splits` in {1, 2, 4, 8} block ranges of `bps` blocks each
// (the last may be shorter), splits * bps >= in / 32.
extern "C" int q40_gemm_bf16(const void* x, const void* q, const void* d, void* out, int rows,
                             int in_features, int out_features, long long layer, int cols,
                             int splits, int bps, void* stream) {
  if (rows < 1 || in_features % QB != 0 || in_features < QB || out_features < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  if ((cols != 64 && cols != 128) || splits < 1 || splits > MAX_SPLITS ||
      (splits & (splits - 1)) != 0 || bps < 1 || (long long)splits * bps < nb)
    return (int)cudaErrorInvalidValue;
  const int* qp = reinterpret_cast<const int*>(q) + (size_t)layer * nb * 4 * out_features;
  const __half* dp = reinterpret_cast<const __half*>(d) + (size_t)layer * nb * out_features;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // 16-byte copies of the word and scale rows where every row start is
  // aligned; element loads otherwise
  const int vec = out_features % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(qp) | reinterpret_cast<uintptr_t>(dp)) % 16 == 0;
  const __nv_bfloat16* xp = reinterpret_cast<const __nv_bfloat16*>(x);
  float* o = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (cols == 64)
    return (int)launch<1>(xp, qp, dp, o, rows, nb, out_features, bps, splits, vec, s);
  return (int)launch<2>(xp, qp, dp, o, rows, nb, out_features, bps, splits, vec, s);
}
