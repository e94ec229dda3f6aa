// K5: int8 paged GQA decode attention through the page table:
// o = softmax(q k^T * scale + causal) v over a row's pages, with k and v
// dequantized from the int8 page pool and its f32 per-(token, kv head) scales.
//
// Replaces the JAX package's ops/pallas_attention.py paged_flash_attention
// (:313), body _paged_kernel (:250). Semantics taken from that source:
//   * the row's first n_read table entries, each clamped with max(entry, 0)
//     (an unmapped -1 slot reads page 0, which the causal mask discards);
//   * a page whose first position lies past the row's last query position
//     (pos_base + t - 1) is skipped; a parked row (pos_base = seq_len) reads
//     all n_read pages and its output is junk the host discards;
//   * k and v dequantize as int8 -> f32 times the f32 scale, in f32;
//   * scores in f32 times scale, masked by col_pos <= row_pos; the online
//     softmax clamps m at NEG_INF / 2 and floors l at 1e-30;
//   * P . V in f32: P is NOT rounded to bf16 (K3 rounds it; B6 does not);
//   * the output is written in q's dtype.
// Entries are also clamped below n_pages, so a bad table can never read
// outside the pool.
//
// What bounds it on Hopper: memory. A decode step reads each needed page's
// int8 K and V (ps * (hd + 4) bytes a kv head each, scales included) once
// per (row, kv head) and does ~4 * g * hd flops per byte pair: far below
// the tensor cores' ratio, so the bound is the bytes of the pages the
// causal limit needs. At batch 16 and a few hundred positions that is a
// few MB a layer: the call is short, so the number of CTAs that stream the
// pages and the latency along each CTA's chain of loads, math and combine
// set its time.
//
// Design:
//   * split-S (flash-decoding): one CTA of 4 warps per (batch * kv head,
//     tile of 4 score rows, split). Split s covers the absolute pages
//     [s * SP, (s + 1) * SP), SP = 4 * max(1, 16 / ps): 16 tokens or one
//     page a warp. SP comes from the shape-only plan (ops/cuda_attention.py
//     paged_plan), never from b, n_read or the other rows, so a row's bits
//     do not depend on its co-tenants or on the KV bucket. The g query heads
//     of a kv head fold into the rows as _paged_kernel folds them: row R is
//     token R / g, head kvh * g + R % g, position pos_base + R / g. A CTA
//     whose split lies wholly past its tile's last position exits at once;
//     the others stop at that position (the pages between it and the
//     block's last position are fully masked for these rows: the same bits
//     as reading them).
//   * inside a CTA each warp takes its own 16 tokens (max(1, 16 / ps)
//     consecutive pages, page by page with the online softmax from the
//     empty state), and the 4 warps' unnormalized (o, m, l) merge in warp
//     order through shared memory: M = max m_w, o and l summed with weights
//     e^(m_w - M). The same ordered merge then joins the splits.
//   * the split merge in the same launch: with one visible split the CTA
//     writes the output itself. With more, each writes its (o, m, l) to a
//     workspace the wrapper allocated and takes a ticket from a per-(batch
//     * kv head, tile) counter; the last to arrive merges the splits in
//     split order, divides by max(l, 1e-30) and resets the counter to 0, so
//     the zeroed counters the wrapper keeps serve every later call and a
//     CUDA graph replay. The order is fixed whichever CTA comes last. A
//     second kernel (K3's way) would cost a launch on a launch-bound path.
//   * each warp's pages land in shared memory by cp.async, all at once:
//     16-byte copies of the hd contiguous int8 bytes of K and V a token
//     (strided by n_kv * hd in the pool) and 4-byte copies of their scales,
//     issued before q is read. The four warps' slots are the ring laid out
//     in space: the split's pages stream together, and page p + 1 lands
//     while the warp beside scores page p, with no barrier between pages.
//     (A ring of 3 stages walked by one warp, 2 pages a CTA, measured
//     slower on the card: its pages' math ran in series.)
//   * the math on CUDA cores in f32, q's 4 rows in registers: 8 lanes a
//     token (hd / 8 elements each), 4 tokens a warp at a time; the four
//     rows' partial dots of a token reduce-scatter over its 8 lanes in 3
//     xor-shuffle steps (4 shuffles for the 4 rows), leaving each lane pair
//     one row's score; the row max and sum take 2 more across the 4 tokens.
//     P goes through shared memory ([token][row]) to P . V, where a lane
//     owns hd / 32 consecutive output columns of the 4 rows. K and V
//     dequantize as __fmul_rn(float(x), scale), exactly as _paged_kernel
//     (float(x) built by a PRMT and an exact subtraction: the quarter-rate
//     integer convert cost more than the multiply), so only the order of
//     the f32 sums differs. At g * t <= 8 rows a kv
//     head the work is far under the tensor cores' ratio, and a bf16 or
//     int8 MMA would round where the JAX arm does not.
//   * templated on head_dim (64, 128) and on the page's token passes
//     (max(1, ps / 4): page sizes 1-64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "async_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RT = 4;              // score rows per CTA
constexpr int WT = 16;             // tokens a warp takes when pages are smaller
constexpr int PS_MAX = 64;         // largest page size
constexpr int CS = 32;             // splits a combine chunk
constexpr float NEG_INF = -FLT_MAX;
constexpr int MAX_DEVICES = 64;    // shared-memory opt-ins are kept per device
static_assert(RT == WARPS, "the combine gives each row a warp");

// pages a warp takes, and a split's pages
__host__ __device__ constexpr int warp_pages(int ps) { return ps < WT ? WT / ps : 1; }

// one page: K [ps][HD] int8, V [ps][HD] int8, then the K and V scales [ps]
// f32 each, padded to 16 bytes
template <int HD>
__host__ __device__ constexpr size_t page_bytes(int ps) {
  return 2 * (size_t)ps * HD + (((size_t)ps * 8 + 15) / 16) * 16;
}

// the dynamic shared memory: each warp's pages, then each warp's P
// [ps][RT] f32; the pages' room then holds the warps' (o, m, l) for the
// merge, and the combine's [CS][RT] weights
template <int HD>
__host__ __device__ constexpr size_t pages_room(int ps) {
  return (size_t)WARPS * warp_pages(ps) * page_bytes<HD>(ps);
}
template <int HD>
__host__ __device__ constexpr size_t merge_bytes() {
  return (size_t)WARPS * RT * (HD + 2) * 4;
}
template <int HD>
constexpr size_t smem_bytes(int ps) {
  return (pages_room<HD>(ps) > merge_bytes<HD>() ? pages_room<HD>(ps) : merge_bytes<HD>()) +
         (size_t)WARPS * ps * RT * 4;
}

// The last CTA of a (batch * kv head, tile): the n_vis splits' triples of
// its nr rows merged in split order, M = max m_s, then o and l summed with
// weights f_s = e^(m_s - M), and o / max(l, 1e-30) written in q's dtype.
// Warp r takes row r's m and l (a lane a split, 32 splits at a time), each
// thread 4 consecutive columns of a row's o; a chunk's m, l and first 16
// splits' o are loaded together, the weights go through shared memory
// `fs`. Past 32 splits a first pass finds M.
template <int HD>
__device__ __forceinline__ void combine(const float* __restrict__ o_ws,
                                        const float* __restrict__ m_ws,
                                        const float* __restrict__ l_ws, void* __restrict__ out,
                                        int q_is_f32, float* fs, int n_vis, int BK, int bk,
                                        int bi, int kvh, int row0, int nr, int t, int n_rows,
                                        int n_heads, int g) {
  constexpr int C4 = HD / 4;  // float4 column groups a row
  constexpr int U = 16;       // splits' o loads in flight
  __shared__ float row_l[RT];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t split_stride = (size_t)BK * n_rows;
  const size_t ws0 = (size_t)bk * n_rows + row0;
  const int r = warp;  // the row whose M, weights and l this warp finds
  const bool row_ok = r < nr;
  // the output columns this thread sums: row rk, columns 4 * c4 ..
  const int rk = tid / C4;
  const int c4 = tid % C4;
  const bool col_ok = tid < RT * C4 && rk < nr;
  const float4* src = reinterpret_cast<const float4*>(o_ws + (ws0 + (col_ok ? rk : 0)) * HD) + c4;

  float M = NEG_INF;
  if (n_vis > CS) {
    if (row_ok)
      for (int s = lane; s < n_vis; s += 32) M = fmaxf(M, __ldcg(m_ws + ws0 + r + s * split_stride));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  }
  float L = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < n_vis; c0 += CS) {
    const int n_c = min(CS, n_vis - c0);
    float mv = NEG_INF;
    float lv = 0.0f;
    if (row_ok && lane < n_c) {
      const size_t w = ws0 + r + (size_t)(c0 + lane) * split_stride;
      mv = __ldcg(m_ws + w);
      lv = __ldcg(l_ws + w);
    }
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (col_ok && u < n_c) v[u] = __ldcg(src + (size_t)(c0 + u) * split_stride * C4);
    if (n_vis <= CS) {  // one chunk: its m are every split's
      M = mv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    }
    const float f = row_ok && lane < n_c ? expf(mv - M) : 0.0f;
    const float lf = __fmul_rn(lv, f);
    __syncthreads();  // the previous chunk's weights are used
    fs[lane * RT + r] = f;
    for (int u = 0; u < n_c; ++u) {  // l in split order
      const float x = __shfl_sync(0xffffffffu, lf, u);
      L = c0 + u == 0 ? x : __fadd_rn(L, x);
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int u0 = 0; u0 < n_c; u0 += U) {
      if (u0 > 0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u0 + u < n_c) v[u] = __ldcg(src + (size_t)(c0 + u0 + u) * split_stride * C4);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u >= n_c) break;
        const float w = fs[(u0 + u) * RT + rk];
        const bool first = c0 + u0 + u == 0;
        const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float os = __fmul_rn(x[e], w);
          acc[e] = first ? os : __fadd_rn(acc[e], os);
        }
      }
    }
  }
  if (lane == 0) row_l[r] = L;
  __syncthreads();
  if (!col_ok) return;
  const float den = fmaxf(row_l[rk], 1e-30f);
  const int R = row0 + rk;
  const size_t oi = (((size_t)bi * t + R / g) * n_heads + kvh * g + R % g) * HD + 4 * c4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float o = acc[e] / den;
    if (q_is_f32)
      reinterpret_cast<float*>(out)[oi + e] = o;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[oi + e] = __float2bfloat16_rn(o);
  }
}

// page `page` of the pool (clamped by the caller) for kv head kvh into a
// warp's room, by the warp's 32 lanes
template <int HD>
__device__ __forceinline__ void load_page(unsigned char* st, const int8_t* __restrict__ kpool,
                                          const int8_t* __restrict__ vpool,
                                          const float* __restrict__ kscale,
                                          const float* __restrict__ vscale, int page, int ps,
                                          int n_kv, int kvh, int lane) {
  constexpr int CHK = HD / 16;  // 16-byte chunks a token row
  int8_t* ks = reinterpret_cast<int8_t*>(st);
  int8_t* vs = ks + ps * HD;
  float* kss = reinterpret_cast<float*>(st + 2 * (size_t)ps * HD);
  float* vss = kss + ps;
  const size_t tok0 = (size_t)page * ps;
  for (int i = lane; i < ps * CHK; i += 32) {
    const int tok = i / CHK;
    const int c = (i % CHK) * 16;
    const size_t off = ((tok0 + tok) * n_kv + kvh) * HD + c;
    dlt::cp_async16(ks + tok * HD + c, kpool + off);
    dlt::cp_async16(vs + tok * HD + c, vpool + off);
  }
  for (int i = lane; i < ps; i += 32) {
    const size_t so = (tok0 + i) * n_kv + kvh;
    dlt::cp_async4(kss + i, kscale + so);
    dlt::cp_async4(vss + i, vscale + so);
  }
}

// the N int8 of little-endian words w, each as f32 times f, without the
// quarter-rate integer-to-float convert: a byte with its sign bit flipped
// (b + 128) becomes the low mantissa bits of 2^23 (one PRMT), 2^23 + 128
// comes off exactly, and the product with f rounds once, as float(b) * f
template <int N>
__device__ __forceinline__ void dequant(float (&out)[N], const unsigned* w, float f) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const unsigned u = w[e / 4] ^ 0x80808080u;
    const float b = __fsub_rn(__uint_as_float(dlt::prmt(u, 0x4B000000u, 0x7650u | (e % 4))),
                              8388736.0f);
    out[e] = __fmul_rn(b, f);
  }
}

// 4 CTAs an SM (128 registers a thread at most): a decode step's CTAs at
// batch 16 and kv_len 256 (512 at either model's width) fit one wave
template <int HD, int NP>
__global__ void __launch_bounds__(THREADS, 4)
paged_attention_kernel(const void* __restrict__ qp, int q_is_f32,
                       const int8_t* __restrict__ kpool, const int8_t* __restrict__ vpool,
                       const float* __restrict__ kscale, const float* __restrict__ vscale,
                       const int* __restrict__ table, int table_stride,
                       const long long* __restrict__ pos_base, void* __restrict__ out,
                       float* __restrict__ o_ws, float* __restrict__ m_ws,
                       float* __restrict__ l_ws, int* __restrict__ tickets, int t, int n_heads,
                       int n_kv, int ps, int n_read, int n_pages, float scale) {
  constexpr int EPL = HD / 8;   // head_dim elements a lane scores (8 lanes a token)
  constexpr int CPL = HD / 32;  // output columns a lane owns in P . V
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tg = lane >> 3;  // token of the pass's 4
  const int j = lane & 7;    // chunk of head_dim
  const int rr = j >> 1;     // the row whose score the lane ends with
  const int g = n_heads / n_kv;
  const int bk = blockIdx.x;
  const int bi = bk / n_kv;
  const int kvh = bk % n_kv;
  const int row0 = blockIdx.y * RT;
  const int n_rows = t * g;
  const int nr = min(RT, n_rows - row0);
  const int split = blockIdx.z;
  const int ppw = warp_pages(ps);
  const int split_pages = WARPS * ppw;
  const size_t pb_bytes = page_bytes<HD>(ps);
  unsigned char* room = smem + (size_t)warp * ppw * pb_bytes;  // this warp's pages
  float* P = reinterpret_cast<float*>(
      smem + (pages_room<HD>(ps) > merge_bytes<HD>() ? pages_room<HD>(ps) : merge_bytes<HD>()) +
      (size_t)warp * ps * RT * 4);  // this warp's [ps][RT] probabilities

  // this warp's table entries (one a lane), fetched beside pos_base
  const int pw0 = split * split_pages + warp * ppw;  // the warp's first page
  const int* row_table = table + (size_t)bi * table_stride;
  const int entry = lane < ppw && pw0 + lane < n_read ? row_table[pw0 + lane] : 0;
  // the pages this tile sees (its last row's position, capped at n_read)
  const long long pb = pos_base[bi];
  const long long tile_last = pb + (row0 + nr - 1) / g;
  const int vis_pages = (int)min((long long)n_read, tile_last / ps + 1);
  const int n_vis = (vis_pages + split_pages - 1) / split_pages;
  if (split >= n_vis) return;  // uniform over the CTA
  const int n_pg = max(0, min(vis_pages - pw0, ppw));  // this warp's pages
  for (int i = 0; i < n_pg; ++i) {
    const int page = min(max(__shfl_sync(0xffffffffu, entry, i), 0), n_pages - 1);
    load_page<HD>(room + i * pb_bytes, kpool, vpool, kscale, vscale, page, ps, n_kv, kvh, lane);
  }
  dlt::cp_async_commit();

  // q's 4 rows, chunk j, in registers (zeros past the tile's rows)
  float qr[RT][EPL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = 0.0f;
    if (r >= nr) continue;
    const int R = row0 + r;
    const size_t idx = (((size_t)bi * t + R / g) * n_heads + kvh * g + R % g) * HD + j * EPL;
    if (q_is_f32) {
      const float4* src = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(qp) + idx);
#pragma unroll
      for (int u = 0; u < EPL / 4; ++u) {
        const float4 v = src[u];
        qr[r][4 * u] = v.x;
        qr[r][4 * u + 1] = v.y;
        qr[r][4 * u + 2] = v.z;
        qr[r][4 * u + 3] = v.w;
      }
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(qp) + idx);
#pragma unroll
      for (int u = 0; u < EPL / 8; ++u) {
        const uint4 v = src[u];
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          qr[r][8 * u + 2 * h] = __uint_as_float(w[h] << 16);
          qr[r][8 * u + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
        }
      }
    }
  }
  // the lane's score row: its position and running state (the 8 lanes
  // 2rr, 2rr + 1 of each token group hold the same); P . V's accumulators
  // for the tile's 4 rows, columns lane * CPL ..
  const bool row_ok = rr < nr;
  const long long my_pos = pb + (row0 + (row_ok ? rr : 0)) / g;
  float m = NEG_INF;
  float l = 0.0f;
  float acc[RT][CPL];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.0f;
  dlt::cp_async_wait<0>();  // this lane's copies have landed
  __syncwarp();             // ... and the warp's

  for (int it = 0; it < n_pg; ++it) {
    const unsigned char* st = room + it * pb_bytes;
    const int8_t* ks = reinterpret_cast<const int8_t*>(st);
    const int8_t* vs = ks + ps * HD;
    const float* kss = reinterpret_cast<const float*>(st + 2 * (size_t)ps * HD);
    const float* vss = kss + ps;
    const long long col0 = (long long)(pw0 + it) * ps;

    // scores: pass p takes tokens 4p .. 4p + 3, lane group tg token 4p + tg;
    // the 4 rows' partial dots reduce-scatter over the group's 8 lanes
    float sc[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int tok = 4 * p + tg;
      const bool in = tok < ps;
      float kd[EPL];
      if (in) {
        const int8_t* src = ks + tok * HD + j * EPL;
        if constexpr (EPL == 8) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          const unsigned w[2] = {v.x, v.y};
          dequant<EPL>(kd, w, kss[tok]);
        } else {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          const unsigned w[4] = {v.x, v.y, v.z, v.w};
          dequant<EPL>(kd, w, kss[tok]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kd[e] = 0.0f;
      }
      float d[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        d[r] = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d[r] = fmaf(qr[r][e], kd[e], d[r]);
      }
      // xor 4: lanes j < 4 keep rows 0, 1, the others rows 2, 3
      const bool hi = j & 4;
      const float a0 = __fadd_rn(hi ? d[2] : d[0],
                                 __shfl_xor_sync(0xffffffffu, hi ? d[0] : d[2], 4));
      const float a1 = __fadd_rn(hi ? d[3] : d[1],
                                 __shfl_xor_sync(0xffffffffu, hi ? d[1] : d[3], 4));
      // xor 2: of those two rows, j & 2 keeps the second
      const bool h2 = j & 2;
      float sdot = __fadd_rn(h2 ? a1 : a0, __shfl_xor_sync(0xffffffffu, h2 ? a0 : a1, 2));
      sdot = __fadd_rn(sdot, __shfl_xor_sync(0xffffffffu, sdot, 1));  // row rr
      sc[p] = in && row_ok && col0 + tok <= my_pos ? __fmul_rn(sdot, scale) : NEG_INF;
    }

    // online softmax of the lane's row over the page
    float mx = NEG_INF;
#pragma unroll
    for (int p = 0; p < NP; ++p) mx = fmaxf(mx, sc[p]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_safe = fmaxf(fmaxf(mx, m), NEG_INF / 2);
    const float corr = expf(m - m_safe);
    float psum = 0.0f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float e = sc[p] == NEG_INF ? 0.0f : expf(sc[p] - m_safe);
      if (!(j & 1) && 4 * p + tg < ps) P[(4 * p + tg) * RT + rr] = e;
      psum = __fadd_rn(psum, e);
    }
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 8));
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 16));
    l = __fadd_rn(__fmul_rn(l, corr), psum);
    m = m_safe;
    float corr_r[RT];  // every row's correction, from the lanes that own it
#pragma unroll
    for (int r = 0; r < RT; ++r) corr_r[r] = __shfl_sync(0xffffffffu, corr, 2 * r);
    __syncwarp();  // P is written

    // P . V: the lane's CPL consecutive columns of the 4 rows, tokens in order
    float pv[RT][CPL];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) pv[r][c] = 0.0f;
#pragma unroll 4
    for (int tok = 0; tok < ps; ++tok) {
      const int8_t* src = vs + tok * HD + lane * CPL;
      const unsigned w = CPL == 2 ? *reinterpret_cast<const unsigned short*>(src)
                                  : *reinterpret_cast<const unsigned*>(src);
      float vd[CPL];
      dequant<CPL>(vd, &w, vss[tok]);
      const float4 p4 = *reinterpret_cast<const float4*>(P + tok * RT);
      const float pr[RT] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) pv[r][c] = fmaf(pr[r], vd[c], pv[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], corr_r[r]), pv[r][c]);
    __syncwarp();  // P is read before the next page writes it
  }

  // the warps' states through shared memory (over their pages), merged in
  // warp order
  __syncthreads();  // every warp is done with its pages
  float* o_s = reinterpret_cast<float*>(smem);  // [WARPS][RT][HD]
  float* m_s = o_s + WARPS * RT * HD;            // [WARPS][RT]
  float* l_s = m_s + WARPS * RT;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float* dst = o_s + (warp * RT + r) * HD + lane * CPL;
    if constexpr (CPL == 2)
      *reinterpret_cast<float2*>(dst) = make_float2(acc[r][0], acc[r][1]);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (lane < 2 * RT && !(lane & 1)) {  // lane 2r holds row r's m and l
    m_s[warp * RT + rr] = m;
    l_s[warp * RT + rr] = l;
  }
  __syncthreads();
  constexpr int C4 = HD / 4;
  const int rk = tid / C4;  // this thread's row and float4 column group
  const int c4 = tid % C4;
  const bool col_ok = tid < RT * C4 && rk < nr;
  float o4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float M = NEG_INF;
  float L = 0.0f;
  if (col_ok) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_s[w * RT + rk]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_s[w * RT + rk] - M);
      const float4 v = *reinterpret_cast<const float4*>(o_s + (w * RT + rk) * HD + 4 * c4);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float os = __fmul_rn(x[e], f);
        o4[e] = w == 0 ? os : __fadd_rn(o4[e], os);
      }
      const float lf = __fmul_rn(l_s[w * RT + rk], f);
      L = w == 0 ? lf : __fadd_rn(L, lf);
    }
  }

  const int BK = gridDim.x;
  if (n_vis == 1) {  // the only split: the output directly
    if (!col_ok) return;
    const int R = row0 + rk;
    const size_t oi = (((size_t)bi * t + R / g) * n_heads + kvh * g + R % g) * HD + 4 * c4;
    const float den = fmaxf(L, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float o = o4[e] / den;
      if (q_is_f32)
        reinterpret_cast<float*>(out)[oi + e] = o;
      else
        reinterpret_cast<__nv_bfloat16*>(out)[oi + e] = __float2bfloat16_rn(o);
    }
    return;
  }

  // this split's triple into the workspace, then a ticket: thread 0's
  // fence after the barrier makes the CTA's stores visible to the device
  // before the ticket (the pattern of a cooperative grid barrier), and the
  // last CTA's fence after it orders its reads of the other splits
  if (col_ok) {
    const size_t ws_row = ((size_t)split * BK + bk) * n_rows + row0 + rk;
    *reinterpret_cast<float4*>(o_ws + ws_row * HD + 4 * c4) = make_float4(o4[0], o4[1], o4[2], o4[3]);
    if (c4 == 0) {
      m_ws[ws_row] = M;
      l_ws[ws_row] = L;
    }
  }
  __syncthreads();
  int* ticket = tickets + (size_t)bk * gridDim.y + blockIdx.y;
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(ticket, 1) == n_vis - 1;
    if (last) __threadfence();
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  combine<HD>(o_ws, m_ws, l_ws, out, q_is_f32, reinterpret_cast<float*>(smem), n_vis, BK, bk,
              bi, kvh, row0, nr, t, n_rows, n_heads, g);
  if (tid == 0) *ticket = 0;  // every split has arrived: ready for the next call
}

template <int HD, int NP>
cudaError_t launch_np(const void* q, int q_is_f32, const int8_t* k, const int8_t* v,
                      const float* ks, const float* vs, const int* table, int table_stride,
                      const long long* pos_base, void* out, float* o_ws, float* m_ws, float* l_ws,
                      int* tickets, int b, int t, int n_heads, int n_kv, int ps, int n_read,
                      int n_pages, float scale, int split_pages, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {};  // the opt-in is per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(paged_attention_kernel<HD, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<HD>(PS_MAX));
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  const int g = n_heads / n_kv;
  const int splits = (n_read + split_pages - 1) / split_pages;
  dim3 grid(b * n_kv, (t * g + RT - 1) / RT, splits);
  paged_attention_kernel<HD, NP><<<grid, THREADS, smem_bytes<HD>(ps), stream>>>(
      q, q_is_f32, k, v, ks, vs, table, table_stride, pos_base, out, o_ws, m_ws, l_ws, tickets, t,
      n_heads, n_kv, ps, n_read, n_pages, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, int q_is_f32, const int8_t* k, const int8_t* v,
                   const float* ks, const float* vs, const int* table, int table_stride,
                   const long long* pos_base, void* out, float* o_ws, float* m_ws, float* l_ws,
                   int* tickets, int b, int t, int n_heads, int n_kv, int ps, int n_read,
                   int n_pages, float scale, int split_pages, cudaStream_t stream) {
#define DLT_PAGED(NP)                                                                          \
  launch_np<HD, NP>(q, q_is_f32, k, v, ks, vs, table, table_stride, pos_base, out, o_ws, m_ws, \
                    l_ws, tickets, b, t, n_heads, n_kv, ps, n_read, n_pages, scale,            \
                    split_pages, stream)
  switch (ps) {
    case 1:
    case 2:
    case 4:
      return DLT_PAGED(1);
    case 8:
      return DLT_PAGED(2);
    case 16:
      return DLT_PAGED(4);
    case 32:
      return DLT_PAGED(8);
    case 64:
      return DLT_PAGED(16);
    default:
      return cudaErrorInvalidValue;
  }
#undef DLT_PAGED
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [b, t, n_heads, hd] f32 or bf16, contiguous, 16-byte aligned; k_pool,
// v_pool int8 [L, n_pages, ps, n_kv, hd] and k_scale, v_scale f32 [L,
// n_pages, ps, n_kv], all contiguous; table int32 [b, table_stride] (-1 =
// unmapped); pos_base int64 [b]; out [b, t, n_heads, hd] in q's dtype. The
// layer only offsets the pool pointers. The plan (ops/cuda_attention.py
// paged_plan): split_pages pages a split, 4 * max(1, 16 / ps) (the kernel
// refuses another count). With more than one split
// (n_read > split_pages) the workspace o_ws [splits, b * n_kv, t * g, hd],
// m_ws and l_ws [splits, b * n_kv, t * g] f32 and the tickets, b * n_kv *
// ceil(t * g / 4) int32 that are 0 before the call (and are again after
// it); else all four may be null.
extern "C" int paged_attention_fwd(const void* q, int q_is_f32, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* table, int table_stride,
                                   const void* pos_base, void* out, int b, int t, int n_heads,
                                   int n_kv, int head_dim, int ps, int n_read, int n_pages,
                                   long long layer, float scale, int split_pages, void* o_ws,
                                   void* m_ws, void* l_ws, void* tickets, void* stream) {
  if (b < 1 || t < 1 || n_kv < 1 || n_heads % n_kv != 0 || n_read < 1 || n_pages < 1 ||
      table_stride < n_read || ps < 1 || ps > PS_MAX || (ps & (ps - 1)) != 0 || t > ps ||
      split_pages != WARPS * warp_pages(ps))
    return (int)cudaErrorInvalidValue;
  const int splits = (n_read + split_pages - 1) / split_pages;
  if (splits > 65535 || (long long)t * (n_heads / n_kv) > 65535LL * RT)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (o_ws == nullptr || m_ws == nullptr || l_ws == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const size_t layer_elems = (size_t)n_pages * ps * n_kv * head_dim;
  const size_t layer_scales = (size_t)n_pages * ps * n_kv;
  const int8_t* k = reinterpret_cast<const int8_t*>(k_pool) + (size_t)layer * layer_elems;
  const int8_t* v = reinterpret_cast<const int8_t*>(v_pool) + (size_t)layer * layer_elems;
  const float* ks = reinterpret_cast<const float*>(k_scale) + (size_t)layer * layer_scales;
  const float* vs = reinterpret_cast<const float*>(v_scale) + (size_t)layer * layer_scales;
  const int* tb = reinterpret_cast<const int*>(table);
  const long long* pb = reinterpret_cast<const long long*>(pos_base);
  float* ow = reinterpret_cast<float*>(o_ws);
  float* mw = reinterpret_cast<float*>(m_ws);
  float* lw = reinterpret_cast<float*>(l_ws);
  int* tk = reinterpret_cast<int*>(tickets);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(q, q_is_f32, k, v, ks, vs, tb, table_stride, pb, out, ow, mw, lw, tk,
                           b, t, n_heads, n_kv, ps, n_read, n_pages, scale, split_pages, s);
  if (head_dim == 128)
    return (int)launch<128>(q, q_is_f32, k, v, ks, vs, tb, table_stride, pb, out, ow, mw, lw, tk,
                            b, t, n_heads, n_kv, ps, n_read, n_pages, scale, split_pages, s);
  return (int)cudaErrorInvalidValue;
}
