// K1: Q80 x Q40 decode matmul for 1..8 activation rows, on the packed
// T-layout weight (ops/quant.py). out[r, o] = sum_k x[r, k] * w[k, o].
//
// Replaces the JAX package's ops/pallas_q40.py q40_matmul_pallas_stacked_i8
// (:725) and q40_matmul_pallas_i8 (:686): body _kernel_fs_i8 (:591), prologue
// _quantize_rows_q80_split (:506). The layer index of a stacked weight only
// offsets the base pointers; an unstacked weight is layer 0.
//
// q40_gemv_q80_indexed is the same per-row function for the MoE decode
// experts (q40_matmul_pallas_stacked_i8 as models/transformer.py
// _moe_decode_i8 calls it, with a flat layer * E + expert index): row s of x
// (or x's one row, shared by every slot) against group idx[s] of a flat
// [G, nb*4, out] stack. idx lives in device memory and each CTA loads its
// own group, so the host never reads it. One launch covers all slots (grid
// y = slot). Group offsets are size_t from the index load on: one role's
// flat Qwen3-30B-A3B stack is 5.4 GB, so idx * nb * 4 * out passes 2^31 from
// index 2,731 up. A group outside [0, G) gives NaN rows instead of a read
// out of bounds. Bound: the bytes of the slots' experts (memory).
//
// What bounds it on Hopper: memory, and at the main path's sizes latency.
// It reads each weight once, 0.5625 bytes per weight (a 4-bit nibble plus a
// 2-byte f16 scale per 32), and does 2 integer ops per weight per row, far
// below the card's integer rate. A Llama-3.2-1B layer's calls move 2.4-19
// MB each, 0.7-5.7 us at 3.35 TB/s: about 2.3 MB must be in flight across
// the card (~18 KB an SM) to keep its memory busy, so bytes in flight and
// the launch count decide the time.
//
// Design (one launch a call, no scratch):
//   * a plan from the weight's shape alone (ops/cuda_q40.py gemv_plan: words
//     a thread loads per weight row, the CTA's column tile, the warps that
//     split its contraction range, the split count), never from the row or
//     slot count, so a row's bits are the same in every call;
//   * a CTA of 256 threads owns a column tile and one of `splits` contiguous
//     ranges of the contraction's Q40 blocks. Its KW warps split that range
//     into contiguous runs (warp kw: blocks first + kw n / KW ..), its 8 / KW
//     column groups split the tile; a lane owns V neighbouring columns and
//     reads each of a block's 4 word rows with one V-word vector load (16
//     bytes at V 4) and the V f16 scales with one more, so a warp still
//     reads whole 128-byte lines. Each warp keeps U = 8 / V blocks' loads in
//     flight in registers (issued before the first use, refilled as each
//     block is used);
//   * the Q80 prologue is fused: each CTA quantizes, into shared memory, the
//     blocks of its own contraction range for its rows (8 lanes a 32-block,
//     4 features a lane; the arithmetic of quantize_rows_q80 below, so the
//     int8 rows, scales and sums are bit-equal to the separate prologue's).
//     The first weight loads go out before it, so it runs under them;
//   * the integer partial of a block is exact: word g of block b holds
//     features 4g..4g+3 in its low nibbles and 16+4g..16+4g+3 in its high
//     nibbles, so __dp4a(w & 0x0F0F0F0F, x word g) and __dp4a((w >> 4) &
//     0x0F0F0F0F, x word 4 + g) are the Pallas unpack one for one; the +8
//     offset leaves as partial - 8 * bsum; the scale combine is f32, one
//     product then one sum per block (no fused multiply-add);
//   * the f32 order is fixed by the plan: blocks in order within a warp's
//     run, the warps' partials in warp order (shared memory), then the
//     splits of a column tile in split order through distributed shared
//     memory: they form one thread-block cluster of <= 8 CTAs along grid x,
//     reduced in the same launch, with no workspace and no atomics.
//     ops/cuda_q40.py q40_gemv_q80_blocked repeats that order with torch
//     ops, and equals the kernel bit for bit;
//   * a call with more column tiles than RESIDENT (2) CTAs an SM launches
//     that many and has each walk every grid-th tile (the vocab widths): its
//     x is quantized once, and the next tile's first blocks load under this
//     one's epilogue. A tile's sums never depend on the CTA that runs it;
//   * word rows and scale rows load as vectors where out % V == 0 and the
//     planes are aligned; elsewhere (widths no model serves) word by word.
//
// The plan (gemv_plan), chosen by probes/k1_ab.py --sweep: every (V, KW,
// splits) with V in {1, 2, 4}, KW in {2, 4, 8}, at each main-path shape,
// cold, one row (NVIDIA H100 80GB HBM3, 700 W; us a call, the plan taken /
// the sweep's best; units = tiles x splits, each a CTA up to 2 an SM):
//   1B wqkv 2048 -> 3072      V 1, 1 split,  96 units     4.98 / 4.98
//   1B wo 2048 -> 2048        V 1, 1 split,  64 units     4.56 / 4.56
//   1B w13 2048 -> 16384      V 4, 1 split, 128 units    11.25 / 11.20
//   1B w2 8192 -> 2048        V 4, 8 splits, 128 units    9.03 / 9.03
//   1B wcls 2048 -> 128256    V 4, 1 split, 1002 units   55.58 / 55.28
//   30B-A3B wqkv 2048 -> 5120 V 1, 1 split, 160 units     6.26 / 6.26
//   30B-A3B wo 4096 -> 2048   V 1, 2 splits, 128 units    6.83 / 6.83
//   30B-A3B wcls -> 151936    V 4, 1 split, 1187 units   67.02 / 67.02
//   K1-indexed w1 2048 -> 768 V 1, 1 split, 24 x 8 slots  6.78 / 6.78
//   K1-indexed w2 768 -> 2048 V 4, 1 split, 16 x 8 slots  6.73 / 6.73
// KW is 8 everywhere. What the sweep showed: a CTA's fixed costs (its
// prologue, two barriers, a cluster's two syncs) are paid again by every
// CTA, so more CTAs than ~1 an SM lose at these sizes (wqkv at 192 CTAs
// 6.68 us, w13 at 512 13.43) even where they leave SMs idle (wo's 64 CTAs
// beat 128 by 1.25 us); what wins is every warp's blocks in flight at once
// (8 blocks of 18 bytes a lane at V 1) and splits only where the
// contraction is deep (w2: 21.87 us unsplit at V 1). Splits and V 4
// together beat one-word lanes there because a lane's 16-byte loads need
// 4x fewer requests. At 8 rows the sweep prefers V 4 with 4 splits at in
// 2048 (1B wqkv 13.64 us against the plan's 16.11): the plan is the
// shape's alone, so it serves the one-row decode. Only (1, 8) and (4, 8)
// are built; -DDLT_GEMV_SWEEP builds all nine.
//
// The K1 of the port's first design, kept as P7's template: q40_gemv_body
// launches that GEMV kernel alone on rows that are already quantized (x8,
// xs, bs), at a chosen CTA tile: the counterpart of the JAX package's
// scripts/probe_int4_prod.py fs_call_tiles (:49), which runs _kernel_fs_i8
// at chosen (tile_n, tile_knb) on the prologue's operands. The tile is (COLS
// output columns a CTA, KSPLIT warps that split the contraction, warp w
// taking blocks w + KSPLIT j), COLS in {32, 64, 128} and KSPLIT in {4, 8,
// 16}; a thread owns COLS / 32 columns, lane + 32 j. Its (32, 8) instance,
// built at 1..8 rows, is the first K1's body; the other eight tiles are
// built at 1 and 8 rows only. q40_quantize_q80 launches the prologue alone
// (one warp per (row, block)): it and q40_gemv_body at (32, 8) are together
// exactly the first K1's call, the in-build baseline of probes/k1_ab.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QB = 32;        // Q40/Q80 block
constexpr int P7_COLS = 32;   // the first K1's tile: output columns per CTA
constexpr int P7_KSPLIT = 8;  // ... and warps per CTA, each takes blocks b = warp + 8j
constexpr unsigned NIB = 0x0F0F0F0Fu;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;  // shared-memory opt-ins are kept per device
constexpr int NT = 256;          // threads of a K1 CTA
constexpr int MAX_SPLITS = 8;    // the portable cluster size
constexpr int RESIDENT = 2;      // CTAs an SM a call keeps when it has more tiles

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

// One launch's operands. Stacked: idx null, one slot, R rows of x against
// the weight at q/d (already offset to the layer). Indexed: R = 1, slot s
// takes x row (x_shared ? 0 : s) against group idx[s].
struct K1Args {
  const void* x;
  const int* q;
  const __half* d;
  const int* idx;
  float* out;
  long long n_groups;
  int x_is_bf16, xvec, x_shared, wvec;
  int nb, out_f, bps, splits;
};

// one Q40 block of a thread's V columns: the 4 word rows and the f16 scales
// (raw bits)
template <int V>
struct WBlock {
  unsigned w[4][V];
  unsigned s[V];
};

template <int V>
__device__ __forceinline__ void load_block(WBlock<V>& f, const int* __restrict__ q,
                                           const __half* __restrict__ d, int b, int col,
                                           int out_f, int wvec) {
  const size_t stride = (size_t)out_f;
  const int* qb = q + (size_t)b * 4 * stride + col;
  const unsigned short* db = reinterpret_cast<const unsigned short*>(d) + (size_t)b * stride + col;
  if (wvec && col < out_f) {  // out_f % V == 0: the V columns are all in range
    if constexpr (V == 4) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(qb + g * stride));
        f.w[g][0] = (unsigned)w.x;
        f.w[g][1] = (unsigned)w.y;
        f.w[g][2] = (unsigned)w.z;
        f.w[g][3] = (unsigned)w.w;
      }
      const uint2 s = __ldg(reinterpret_cast<const uint2*>(db));
      f.s[0] = s.x & 0xFFFFu;
      f.s[1] = s.x >> 16;
      f.s[2] = s.y & 0xFFFFu;
      f.s[3] = s.y >> 16;
    } else if constexpr (V == 2) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int2 w = __ldg(reinterpret_cast<const int2*>(qb + g * stride));
        f.w[g][0] = (unsigned)w.x;
        f.w[g][1] = (unsigned)w.y;
      }
      const unsigned s = __ldg(reinterpret_cast<const unsigned*>(db));
      f.s[0] = s & 0xFFFFu;
      f.s[1] = s >> 16;
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) f.w[g][0] = (unsigned)__ldg(qb + g * stride);
      f.s[0] = __ldg(db);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool in = col + j < out_f;
#pragma unroll
      for (int g = 0; g < 4; ++g) f.w[g][j] = in ? (unsigned)__ldg(qb + g * stride + j) : 0u;
      f.s[j] = in ? __ldg(db + j) : 0u;
    }
  }
}

// acc[j][r] += (partial - 8 bsum) * (xs * d) for block bl of the CTA's range
template <int R, int V>
__device__ __forceinline__ void dot_block(float (&acc)[V][R], const WBlock<V>& f,
                                          const int4* __restrict__ xw4,
                                          const float* __restrict__ xs,
                                          const int* __restrict__ bs, int bl, int nblk) {
  float dv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) dv[j] = __half2float(__ushort_as_half((unsigned short)f.s[j]));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * nblk + bl;
    const int4 xa = xw4[2 * i];      // features 0..15: words 0..3
    const int4 xb = xw4[2 * i + 1];  // features 16..31: words 4..7
    const int off = 8 * bs[i];
    const float xsv = xs[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      int p = __dp4a((int)(f.w[0][j] & NIB), xa.x, 0);
      p = __dp4a((int)(f.w[1][j] & NIB), xa.y, p);
      p = __dp4a((int)(f.w[2][j] & NIB), xa.z, p);
      p = __dp4a((int)(f.w[3][j] & NIB), xa.w, p);
      p = __dp4a((int)((f.w[0][j] >> 4) & NIB), xb.x, p);
      p = __dp4a((int)((f.w[1][j] >> 4) & NIB), xb.y, p);
      p = __dp4a((int)((f.w[2][j] >> 4) & NIB), xb.z, p);
      p = __dp4a((int)((f.w[3][j] >> 4) & NIB), xb.w, p);
      acc[j][r] = __fadd_rn(acc[j][r], __fmul_rn((float)(p - off), __fmul_rn(xsv, dv[j])));
    }
  }
}

// four consecutive features of x at element offset `off` (zeros if !in)
__device__ __forceinline__ void load_x4(float (&v)[4], const K1Args& a, size_t off, bool in) {
  if (!in) {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
  } else if (a.x_is_bf16) {
    const unsigned short* xp = reinterpret_cast<const unsigned short*>(a.x) + off;
    if (a.xvec) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(xp));
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xFFFF0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __uint_as_float((unsigned)__ldg(xp + k) << 16);
    }
  } else {
    const float* xp = reinterpret_cast<const float*>(a.x) + off;
    if (a.xvec) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(xp));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __ldg(xp + k);
    }
  }
}

// The fused prologue: blocks first .. first + nblk - 1 of x's R rows (from
// element x_row0) into shared memory, item i = r * nblk + bl: int8 words
// xw[8 i ..], f16-rounded scales xs[i], block sums bs[i]. 8 lanes a block,
// 4 features a lane; the arithmetic of quantize_rows_q80. Every lane runs
// every shuffle (the loop is uniform over the CTA); items past the end only
// skip their stores.
template <int R>
__device__ __forceinline__ void quantize_range(const K1Args& a, size_t x_row0, int first,
                                               int nblk, int* __restrict__ xw,
                                               float* __restrict__ xs, int* __restrict__ bs) {
  constexpr int GROUPS = NT / 8;  // blocks a pass
  constexpr int PF = 2 * R;       // passes whose loads go out together: all of a
                                  // 64-block range's (R * 64 blocks)
  const int sub = threadIdx.x & 7;
  const int grp = threadIdx.x >> 3;
  const int items = R * nblk;
  const size_t in_f = (size_t)a.nb * QB;
  for (int p0 = 0; p0 < items; p0 += GROUPS * PF) {
    float v[PF][4];
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int it = p0 + k * GROUPS + grp;
      const bool in = it < items;
      const int r = in ? it / nblk : 0;
      const int b = first + (in ? it - r * nblk : 0);
      load_x4(v[k], a, x_row0 + (size_t)r * in_f + (size_t)b * QB + 4 * sub, in);
    }
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int it = p0 + k * GROUPS + grp;
      float amax = fmaxf(fmaxf(fabsf(v[k][0]), fabsf(v[k][1])),
                         fmaxf(fabsf(v[k][2]), fabsf(v[k][3])));
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
      const float scale = amax / 127.0f;
      const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
      unsigned word = 0;
      int s = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = (int)fminf(fmaxf(rintf(__fmul_rn(v[k][e], inv)), -127.0f), 127.0f);
        word |= ((unsigned)qi & 0xFFu) << (8 * e);
        s += qi;
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (it < items) {
        xw[it * 8 + sub] = (int)word;
        if (sub == 0) {
          xs[it] = __half2float(__float2half_rn(scale));
          bs[it] = s;
        }
      }
    }
  }
}

// At most 128 registers a thread, so two CTAs share an SM, except with
// one word a lane at 4 rows and more: there the cap spills (1B wqkv at 8
// rows 16.2 us capped, 12.7 uncapped) and those plans' <= 160 CTAs fit
// about one an SM anyway.
template <int R, int V, int KW>
__global__ void __launch_bounds__(NT, V == 1 && R >= 4 ? 1 : RESIDENT)
q40_gemv_q80_kernel(K1Args a) {
  constexpr int CW = NT / 32 / KW;  // warps across the column tile
  constexpr int TILE = 32 * V * CW;
  constexpr int U = 8 / V;          // blocks a warp keeps in flight
  constexpr int NEL = R * TILE;     // a tile's outputs
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % KW;
  const int cw = warp / KW;
  const int split = blockIdx.x % a.splits;  // the CTA's rank in its cluster
  const int tiles = (a.out_f + TILE - 1) / TILE;
  const int t0 = blockIdx.x / a.splits;     // the cluster's first tile
  const int stride = gridDim.x / a.splits;  // ... and its step over the tiles
  const int slot = blockIdx.y;
  const int* q = a.q;
  const __half* d = a.d;
  float* o = a.out + (size_t)slot * R * a.out_f;
  if (a.idx != nullptr) {
    const long long g = a.idx[slot];  // uniform over the cluster
    if (g < 0 || g >= a.n_groups) {
      if (split == 0)
        for (int t = t0; t < tiles; t += stride)
          for (int c = t * TILE + tid; c < min(a.out_f, (t + 1) * TILE); c += NT)
            o[c] = __int_as_float(0x7fc00000);
      return;
    }
    q += (size_t)g * (size_t)a.nb * 4 * (size_t)a.out_f;
    d += (size_t)g * (size_t)a.nb * (size_t)a.out_f;
  }
  const size_t x_row0 = (a.x_shared ? 0 : (size_t)slot) * R * (size_t)a.nb * QB;
  const int first = split * a.bps;
  const int nblk = max(0, min(a.nb, first + a.bps) - first);
  const int wb0 = first + kw * nblk / KW;
  const int wb1 = first + (kw + 1) * nblk / KW;
  const int lcol = cw * 32 * V + lane * V;  // the lane's first column in a tile

  float* red = reinterpret_cast<float*>(smem);                    // [KW][R][TILE]
  int* xw = reinterpret_cast<int*>(red + KW * NEL);               // [R][nblk][8]
  float* xs = reinterpret_cast<float*>(xw + (size_t)R * a.bps * 8);  // [R][nblk]
  int* bs = reinterpret_cast<int*>(xs + (size_t)R * a.bps);          // [R][nblk]

  WBlock<V> f[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (wb0 + u < wb1) load_block<V>(f[u], q, d, wb0 + u, t0 * TILE + lcol, a.out_f, a.wvec);
  quantize_range<R>(a, x_row0, first, nblk, xw, xs, bs);
  __syncthreads();

  const int4* xw4 = reinterpret_cast<const int4*>(xw);
  for (int t = t0; t < tiles; t += stride) {  // uniform over the cluster
    const int c0 = t * TILE;
    const int col = c0 + lcol;
    float acc[V][R];
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[j][r] = 0.0f;
    for (int b = wb0; b < wb1; b += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (b + u < wb1) {
          dot_block<R, V>(acc, f[u], xw4, xs, bs, b + u - first, nblk);
          if (b + u + U < wb1) load_block<V>(f[u], q, d, b + u + U, col, a.out_f, a.wvec);
        }
      }
    }
    // the next tile's first blocks go out before this one's epilogue
    if (t + stride < tiles) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (wb0 + u < wb1) load_block<V>(f[u], q, d, wb0 + u, col + stride * TILE, a.out_f, a.wvec);
    }

    // the warps' partials, then this CTA's: warps in order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* dst = red + (kw * R + r) * TILE + lcol;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[0][r], acc[1][r]);
      } else {
        dst[0] = acc[0][r];
      }
    }
    __syncthreads();
    for (int e = tid; e < NEL; e += NT) {
      float v = red[e];
#pragma unroll
      for (int w = 1; w < KW; ++w) v = __fadd_rn(v, red[w * NEL + e]);
      if (a.splits == 1) {
        const int c = c0 + e % TILE;
        if (c < a.out_f) o[(size_t)(e / TILE) * a.out_f + c] = v;
      } else {
        red[e] = v;
      }
    }
    if (a.splits == 1) {
      if (t + stride < tiles) __syncthreads();  // the next tile rewrites red
      continue;
    }

    // the cluster's splits in split order through distributed shared
    // memory: CTA `split` stores its share of the tile's outputs
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int per = (NEL + a.splits - 1) / a.splits;
    const int e1 = min(NEL, (split + 1) * per);
    for (int e = split * per + tid; e < e1; e += NT) {
      float p[MAX_SPLITS];  // every remote read in flight before the first add
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        p[s] = s < a.splits ? *cluster.map_shared_rank(red + e, s) : 0.0f;
      float v = p[0];
#pragma unroll
      for (int s = 1; s < MAX_SPLITS; ++s)
        if (s < a.splits) v = __fadd_rn(v, p[s]);
      const int c = c0 + e % TILE;
      if (c < a.out_f) o[(size_t)(e / TILE) * a.out_f + c] = v;
    }
    cluster.sync();  // no CTA rewrites or leaves while its partial may be read
  }
}

// ---------------------------------------------------------------------------
// P7: the first K1's prologue and body, apart
// ---------------------------------------------------------------------------

__global__ void quantize_rows_q80(const void* __restrict__ x, int x_is_bf16,
                                  int in_features, int nb, int rows,
                                  int8_t* __restrict__ x8, float* __restrict__ xs,
                                  int* __restrict__ bs) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * nb) return;  // uniform per warp
  const int r = warp / nb;
  const int b = warp % nb;
  const size_t idx = (size_t)r * in_features + (size_t)b * QB + lane;
  const float v = x_is_bf16
                      ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[idx])
                      : reinterpret_cast<const float*>(x)[idx];
  float a = fabsf(v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(FULL, a, o));
  const float scale = a / 127.0f;
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  const float qf = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  const int qi = (int)qf;
  x8[idx] = (int8_t)qi;
  int s = qi;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) {
    xs[(size_t)r * nb + b] = __half2float(__float2half_rn(scale));
    bs[(size_t)r * nb + b] = s;
  }
}

// One CTA's COLS output columns of R rows: x8w/xsg/bsg point at the rows'
// quantized activations, q/d at the weight, out at the rows' outputs. KSPLIT
// warps split the blocks (warp w takes b = w + KSPLIT j) and add their
// partials in warp order at the end.
template <int R, int COLS, int KSPLIT>
__device__ __forceinline__ void gemv_tile(const int* __restrict__ x8w,
                                          const float* __restrict__ xsg,
                                          const int* __restrict__ bsg,
                                          const int* __restrict__ q,
                                          const __half* __restrict__ d,
                                          float* __restrict__ out, int nb, int out_f,
                                          unsigned char* smem) {
  constexpr int CPT = COLS / 32;  // columns a thread owns: lane + 32 j
  constexpr int NTB = 32 * KSPLIT;
  int* xw = reinterpret_cast<int*>(smem);                 // [R][nb * 8] int8 x4
  float* xs = reinterpret_cast<float*>(xw + R * nb * 8);  // [R][nb]
  int* bs = reinterpret_cast<int*>(xs + R * nb);          // [R][nb]
  float* red = reinterpret_cast<float*>(bs + R * nb);     // [KSPLIT][R][COLS]

  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int i = tid; i < R * nb * 8; i += NTB) xw[i] = x8w[i];
  for (int i = tid; i < R * nb; i += NTB) {
    xs[i] = xsg[i];
    bs[i] = bsg[i];
  }
  __syncthreads();

  const int col0 = blockIdx.x * COLS + threadIdx.x;
  float acc[CPT][R];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r] = 0.0f;

  // a column's whole walk over b sits under one bounds check, out of the loop
  const size_t stride = (size_t)out_f;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = col0 + 32 * j;
    if (col >= out_f) continue;
    for (int b = threadIdx.y; b < nb; b += KSPLIT) {
      const int* qb = q + (size_t)b * 4 * stride + col;
      const unsigned w0 = (unsigned)__ldg(qb);
      const unsigned w1 = (unsigned)__ldg(qb + stride);
      const unsigned w2 = (unsigned)__ldg(qb + 2 * stride);
      const unsigned w3 = (unsigned)__ldg(qb + 3 * stride);
      const float dv = __half2float(d[(size_t)b * stride + col]);
      const int lo0 = (int)(w0 & NIB), hi0 = (int)((w0 >> 4) & NIB);
      const int lo1 = (int)(w1 & NIB), hi1 = (int)((w1 >> 4) & NIB);
      const int lo2 = (int)(w2 & NIB), hi2 = (int)((w2 >> 4) & NIB);
      const int lo3 = (int)(w3 & NIB), hi3 = (int)((w3 >> 4) & NIB);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int* xr = xw + (r * nb + b) * 8;
        int p = __dp4a(lo0, xr[0], 0);
        p = __dp4a(lo1, xr[1], p);
        p = __dp4a(lo2, xr[2], p);
        p = __dp4a(lo3, xr[3], p);
        p = __dp4a(hi0, xr[4], p);
        p = __dp4a(hi1, xr[5], p);
        p = __dp4a(hi2, xr[6], p);
        p = __dp4a(hi3, xr[7], p);
        p -= 8 * bs[r * nb + b];
        const float scale = __fmul_rn(xs[r * nb + b], dv);
        acc[j][r] = __fadd_rn(acc[j][r], __fmul_rn((float)p, scale));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int r = 0; r < R; ++r)
      red[(threadIdx.y * R + r) * COLS + 32 * j + threadIdx.x] = acc[j][r];
  __syncthreads();
  if (threadIdx.y == 0) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = col0 + 32 * j;
      if (col >= out_f) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < KSPLIT; ++k)
          s = __fadd_rn(s, red[(k * R + r) * COLS + 32 * j + threadIdx.x]);
        out[(size_t)r * out_f + col] = s;
      }
    }
  }
}

template <int R, int COLS, int KSPLIT>
__global__ void __launch_bounds__(32 * KSPLIT)
q40_gemv_kernel(const int* __restrict__ x8w, const float* __restrict__ xsg,
                const int* __restrict__ bsg, const int* __restrict__ q,
                const __half* __restrict__ d, float* __restrict__ out, int nb,
                int out_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemv_tile<R, COLS, KSPLIT>(x8w, xsg, bsg, q, d, out, nb, out_f, smem);
}

template <int R, int COLS, int KSPLIT>
size_t gemv_smem(int nb) {
  return (size_t)R * nb * 8 * sizeof(int) + (size_t)R * nb * 2 * sizeof(float) +
         (size_t)KSPLIT * R * COLS * sizeof(float);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Allow `smem` bytes of dynamic shared memory for `kernel` on the current
// device (above 48 KB it must be asked for, device by device); `raised`
// holds the kernel's allowance so far on each device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= raised[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) raised[dev] = smem;
  return e;
}

// the current device's SM count, kept per device
cudaError_t sm_count(int* sms) {
  static int known[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    e = cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = known[dev];
  return cudaSuccess;
}

// A call with more column tiles than RESIDENT CTAs an SM launches that many
// and has each walk every grid-th tile: its x quantized once, the next
// tile's first blocks loading under this one's epilogue. A tile's sums do
// not depend on the CTA that runs it.
template <int R, int V, int KW>
cudaError_t launch_k1(const K1Args& a, int n_slots, cudaStream_t stream) {
  constexpr int TILE = 32 * V * (NT / 32 / KW);
  const size_t smem = (size_t)KW * R * TILE * sizeof(float) + (size_t)R * a.bps * 40;
  static size_t raised[MAX_DEVICES] = {};  // dynamic shared memory allowed so far
  cudaError_t e = allow_smem(q40_gemv_q80_kernel<R, V, KW>, smem, raised);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int tiles = (a.out_f + TILE - 1) / TILE;
  const int clusters = min(tiles, max(1, RESIDENT * sms / a.splits));
  const dim3 grid((unsigned)(clusters * a.splits), (unsigned)n_slots);
  if (a.splits == 1) {  // the plain launch costs the host less than the Ex one
    q40_gemv_q80_kernel<R, V, KW><<<grid, NT, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, q40_gemv_q80_kernel<R, V, KW>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int V, int KW>
cudaError_t launch_k1_rows(int rows, const K1Args& a, int n_slots, cudaStream_t s) {
  switch (rows) {
    case 1: return launch_k1<1, V, KW>(a, n_slots, s);
    case 2: return launch_k1<2, V, KW>(a, n_slots, s);
    case 3: return launch_k1<3, V, KW>(a, n_slots, s);
    case 4: return launch_k1<4, V, KW>(a, n_slots, s);
    case 5: return launch_k1<5, V, KW>(a, n_slots, s);
    case 6: return launch_k1<6, V, KW>(a, n_slots, s);
    case 7: return launch_k1<7, V, KW>(a, n_slots, s);
    default: return launch_k1<8, V, KW>(a, n_slots, s);
  }
}

// The (V, KW) pairs gemv_plan hands out; built with -DDLT_GEMV_SWEEP, every
// pair probes/k1_ab.py --sweep chooses among.
#ifdef DLT_GEMV_SWEEP
#define DLT_K1_PLANS(X) X(1, 2) X(1, 4) X(1, 8) X(2, 2) X(2, 4) X(2, 8) X(4, 2) X(4, 4) X(4, 8)
#else
#define DLT_K1_PLANS(X) X(1, 8) X(4, 8)
#endif

cudaError_t launch_plan(int vec, int kw, int rows, const K1Args& a, int n_slots,
                        cudaStream_t s) {
#define DLT_K1_CASE(V, KW) \
  if (vec == V && kw == KW) return launch_k1_rows<V, KW>(rows, a, n_slots, s);
  DLT_K1_PLANS(DLT_K1_CASE)
#undef DLT_K1_CASE
  return cudaErrorInvalidValue;
}

// a plan the kernel takes: every split non-empty and the tile its (V, KW)
bool plan_ok(int nb, int vec, int cols, int kw, int splits, int bps) {
  if ((vec != 1 && vec != 2 && vec != 4) || (kw != 2 && kw != 4 && kw != 8)) return false;
  if (cols != 32 * vec * (NT / 32 / kw)) return false;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0) return false;
  return bps >= 1 && (long long)splits * bps >= nb && (long long)(splits - 1) * bps < nb;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

template <int R, int COLS, int KSPLIT>
cudaError_t launch_gemv(const int8_t* x8, const float* xs, const int* bs,
                        const int* q, const __half* d, float* out, int nb,
                        int out_f, cudaStream_t stream) {
  const size_t smem = gemv_smem<R, COLS, KSPLIT>(nb);
  static size_t raised[MAX_DEVICES] = {};  // dynamic shared memory allowed so far
  cudaError_t e = allow_smem(q40_gemv_kernel<R, COLS, KSPLIT>, smem, raised);
  if (e != cudaSuccess) return e;
  dim3 block(32, KSPLIT);
  dim3 grid((out_f + COLS - 1) / COLS);
  q40_gemv_kernel<R, COLS, KSPLIT><<<grid, block, smem, stream>>>(
      reinterpret_cast<const int*>(x8), xs, bs, q, d, out, nb, out_f);
  return cudaGetLastError();
}

template <int COLS, int KSPLIT>
cudaError_t launch_rows(int rows, const int8_t* x8, const float* xs, const int* bs,
                        const int* q, const __half* d, float* out, int nb, int out_f,
                        cudaStream_t s) {
  switch (rows) {
    case 1: return launch_gemv<1, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    case 2: return launch_gemv<2, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    case 3: return launch_gemv<3, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    case 4: return launch_gemv<4, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    case 5: return launch_gemv<5, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    case 6: return launch_gemv<6, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    case 7: return launch_gemv<7, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
    default: return launch_gemv<8, COLS, KSPLIT>(x8, xs, bs, q, d, out, nb, out_f, s);
  }
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [rows, in] f32 or bf16; q [L, in/8, out] int32; d [L, in/32, out] f16;
// out [rows, out] f32. The plan (ops/cuda_q40.py gemv_plan): vec words a
// thread loads per weight row, cols output columns a CTA, kw warps along
// the contraction, splits block ranges of bps blocks (the last may be
// shorter, none empty).
extern "C" int q40_gemv_q80(const void* x, int x_is_bf16, const void* q, const void* d,
                            void* out, int rows, int in_features, int out_features,
                            long long layer, int vec, int cols, int kw, int splits, int bps,
                            void* stream) {
  if (rows < 1 || rows > 8 || in_features % QB != 0 || in_features < QB || out_features < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  if (!plan_ok(nb, vec, cols, kw, splits, bps)) return (int)cudaErrorInvalidValue;
  K1Args a = {};
  a.x = x;
  a.q = reinterpret_cast<const int*>(q) + (size_t)layer * nb * 4 * out_features;
  a.d = reinterpret_cast<const __half*>(d) + (size_t)layer * nb * out_features;
  a.out = reinterpret_cast<float*>(out);
  a.x_is_bf16 = x_is_bf16;
  a.xvec = aligned(x, x_is_bf16 ? 8 : 16);
  a.wvec = out_features % vec == 0 && aligned(a.q, 4 * vec) && aligned(a.d, 2 * vec);
  a.nb = nb;
  a.out_f = out_features;
  a.bps = bps;
  a.splits = splits;
  return (int)launch_plan(vec, kw, rows, a, 1, reinterpret_cast<cudaStream_t>(stream));
}

// x [x_rows, in] f32 or bf16, x_rows 1 (shared by every slot) or n_slots;
// q [n_groups, in/8, out] int32; d [n_groups, in/32, out] f16; idx
// [n_slots] int32 on the device; out [n_slots, out] f32; the plan as
// q40_gemv_q80 takes it.
extern "C" int q40_gemv_q80_indexed(const void* x, int x_is_bf16, int x_rows, const void* q,
                                    const void* d, const void* idx, int n_slots,
                                    long long n_groups, void* out, int in_features,
                                    int out_features, int vec, int cols, int kw, int splits,
                                    int bps, void* stream) {
  if (n_slots < 1 || n_slots > 8 || (x_rows != 1 && x_rows != n_slots) ||
      in_features % QB != 0 || in_features < QB || out_features < 1 || n_groups < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  if (!plan_ok(nb, vec, cols, kw, splits, bps)) return (int)cudaErrorInvalidValue;
  K1Args a = {};
  a.x = x;
  a.q = reinterpret_cast<const int*>(q);
  a.d = reinterpret_cast<const __half*>(d);
  a.idx = reinterpret_cast<const int*>(idx);
  a.out = reinterpret_cast<float*>(out);
  a.n_groups = n_groups;
  a.x_is_bf16 = x_is_bf16;
  a.xvec = aligned(x, x_is_bf16 ? 8 : 16);
  a.x_shared = x_rows == 1;
  // a group's planes start aligned when the stack's do and out % vec == 0
  a.wvec = out_features % vec == 0 && aligned(a.q, 4 * vec) && aligned(a.d, 2 * vec);
  a.nb = nb;
  a.out_f = out_features;
  a.bps = bps;
  a.splits = splits;
  return (int)launch_plan(vec, kw, 1, a, n_slots, reinterpret_cast<cudaStream_t>(stream));
}

// P7's prologue alone: x [rows, in] f32 or bf16 -> x8 [rows, in] int8, xs
// [rows, in/32] f32 (f16-rounded scales), bs [rows, in/32] int32 block sums.
extern "C" int q40_quantize_q80(const void* x, int x_is_bf16, int rows, int in_features,
                                void* x8, void* xs, void* bs, void* stream) {
  if (rows < 1 || in_features % QB != 0 || in_features < QB) return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  const int warps = rows * nb;
  quantize_rows_q80<<<(warps * 32 + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, x_is_bf16, in_features, nb, rows, reinterpret_cast<int8_t*>(x8),
      reinterpret_cast<float*>(xs), reinterpret_cast<int*>(bs));
  return (int)cudaGetLastError();
}

// P7: the first K1's GEMV alone at CTA tile (cols, ksplit) on pre-quantized
// rows: x8 [rows, in] int8, xs [rows, in/32] f32, bs [rows, in/32] int32; q
// [in/8, out] int32; d [in/32, out] f16; out [rows, out] f32.
extern "C" int q40_gemv_body(const void* x8, const void* xs, const void* bs, const void* q,
                             const void* d, void* out, int rows, int in_features,
                             int out_features, int cols, int ksplit, void* stream) {
  if (rows < 1 || rows > 8 || in_features % QB != 0 || out_features < 1)
    return (int)cudaErrorInvalidValue;
  const int nb = in_features / QB;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* x8p = reinterpret_cast<const int8_t*>(x8);
  const float* xsp = reinterpret_cast<const float*>(xs);
  const int* bsp = reinterpret_cast<const int*>(bs);
  const int* qp = reinterpret_cast<const int*>(q);
  const __half* dp = reinterpret_cast<const __half*>(d);
  float* o = reinterpret_cast<float*>(out);
  if (cols == P7_COLS && ksplit == P7_KSPLIT)
    return (int)launch_rows<P7_COLS, P7_KSPLIT>(rows, x8p, xsp, bsp, qp, dp, o, nb,
                                                out_features, s);
  if (rows != 1 && rows != 8) return (int)cudaErrorInvalidValue;
#define DLT_BODY(C, K)                                                                   \
  if (cols == C && ksplit == K)                                                          \
    return (int)(rows == 1 ? launch_gemv<1, C, K>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s) \
                           : launch_gemv<8, C, K>(x8p, xsp, bsp, qp, dp, o, nb, out_features, s));
  DLT_BODY(32, 4) DLT_BODY(32, 16)
  DLT_BODY(64, 4) DLT_BODY(64, 8) DLT_BODY(64, 16)
  DLT_BODY(128, 4) DLT_BODY(128, 8) DLT_BODY(128, 16)
#undef DLT_BODY
  return (int)cudaErrorInvalidValue;
}
