// The decode-attention floor probes on a head-major [b, kv, S, hd] bf16 cache.
//
// P11 pure_read replaces the JAX package's scripts/probe_att_floor.py
// pure_read (:68, body _read_kernel :52): out[b, 0, :] = the sum over
// (kv head, s) of K[b, kv, s, :] + V[b, kv, s, :], in f32. It is the floor of
// a decode-attention read: the bytes of K and V once, no arithmetic to speak
// of.
//
// P12 decode_attention replaces scripts/probe_grouped_decode_att.py
// decode_attention (:73, body _kernel :26): grouped decode attention for one
// query token per row, q [b, h, hd], K/V [b, kv, S, hd] bf16, from scalar
// pos and col0; cache column s is at position col0 + s and is visible iff
// col0 + s <= pos. Numerics of _kernel: q cast to bf16, scores = (q . k) *
// (1 / sqrt(hd)) in f32, an f32 online softmax with NEG_INF = -FLT_MAX and m
// clamped to NEG_INF / 2, p rounded to bf16 before P . V, and a final
// division by max(l, 1e-30). Output [b, h, hd] in q's dtype.
//
// What bounds both on Hopper: memory, the K/V rows once (P12 only the
// visible ones). At the Llama-3.2-1B width (kv 8, hd 64) a layer's cache at
// S 1024 is 2.1 MB, which L2 holds; at S 32768 it is 67 MB, a cold stream.
//
// P11's design: the TPU kernel walks the cache in order on one core,
// carrying the sum in scratch; one CTA per row would give a handful of
// CTAs on 132 SMs. So P11 splits the flattened [kv * S, hd] rows into
// chunks (a function of the shape alone), each CTA loads every element, 16
// bytes a thread, four rows in flight, and adds each into its sum (a GPU
// drops a load whose value is unused, so a read that is not summed would
// not be a read; K and V are distinct buffers, as a cache has them), and a
// second kernel combines the chunks in a fixed order: 1024 / hd lanes an
// output, each summing every (1024 / hd)-th chunk in turn, then one lane
// adding the lane sums in turn.
//
// P12's design (one launch a call, no scratch, no second pass):
//   * split-S as absolute column ranges from (S, hd) alone
//     (probes/attention.py attention_plan), never from pos: the cluster's C
//     CTAs of a (row, kv head) take `width` columns each, and each CTA's W
//     warps a contiguous run of width / W of those. A warp walks its run in
//     TR-row tiles up to the last visible column and keeps its own
//     online-softmax state; a run wholly past the visible columns keeps m =
//     NEG_INF, l = 0;
//   * a warp streams its run through its own cp.async ring of ST tiles (K
//     and V rows, 16 bytes a copy, rows past the visible end zero-filled,
//     never read), so the next tiles are in flight while one is computed,
//     with no barrier between tiles (__syncwarp only). More warps an SM,
//     not a deeper ring, set the streaming rate (the sweep of
//     probes/p2_p12_ab.py on an NVIDIA H100 80GB HBM3 at 700 W, in PERF.md:
//     at S 32768, hd 64, 4 warps a CTA 42-44 us whatever the depth, 8 warps
//     31), so the plan's instances put
//     8 warps on a CTA; copying a row a lane with the copy engine
//     (cp.async.bulk) measured 1.8-2.3x slower than cp.async and is gone;
//   * scores and P . V on mma.sync m16n8k16 bf16 (csrc/async_mma.cuh), the
//     g <= 8 query heads of the kv head as the M rows: q's A fragments are
//     built once from global memory (cast to bf16 as the JAX wrapper does),
//     K's B fragments come by ldmatrix, the row max and sum combine the four
//     lanes of a head (two xor-shuffles), p is rounded to bf16 in registers
//     and is P . V's A fragment as it stands, V's B fragments come by
//     ldmatrix.trans, and the accumulators stay in registers;
//   * the merge inside the launch, in a fixed order: the CTA's W warps'
//     (m, l, acc) through shared memory in warp order, then the cluster's
//     CTAs through distributed shared memory in rank order, CTA `rank`
//     writing its share of the g * hd outputs; each merge takes M = the
//     largest m, sums acc * e^(m - M) and l * e^(m - M) in order, and the
//     output is acc / max(l, 1e-30). No partials buffer, no ticket, no fence.
//     probes/attention.py decode_attention_plain repeats the runs, tiles and
//     merges with torch ops;
//   * the cluster is C <= 16 CTAs (above 8 with the non-portable cluster
//     size allowed), so a (row, kv head) is C CTAs; templated on head_dim
//     (64, 128), the warps a CTA, the tile rows and the ring depth, the plan
//     naming one built instance (the sweep of probes/p2_p12_ab.py chose it).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "async_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int READ_THREADS = 256;
constexpr int COMBINE_THREADS = 1024;  // P11's second pass: HD columns x (1024 / HD) lanes
constexpr int MAX_CLUSTER = 16;        // the non-portable cluster size
constexpr int MAX_G = 8;  // query heads a kv head: the MMA's rows 0..7 (8..15 stay zero)
constexpr float NEG_INF = -FLT_MAX;
constexpr int MAX_DEVICES = 64;  // shared-memory opt-ins are kept per device

__device__ __forceinline__ void add8(float* acc, const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

// P11, pass 1. grid (splits, b): CTA (sp, bi) sums rows [sp * chunk, +chunk)
// of row bi's flattened [rows, HD] K and V into part[bi, sp, :].
template <int HD>
__global__ void __launch_bounds__(READ_THREADS)
pure_read_partial(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                  long long rows, long long chunk, float* __restrict__ part) {
  constexpr int VPR = HD / 8;                // 16-byte vectors a row
  constexpr int RPI = READ_THREADS / VPR;    // rows an iteration
  __shared__ float red[RPI * HD];
  const int tx = threadIdx.x % VPR;
  const int ty = threadIdx.x / VPR;
  const long long r0 = blockIdx.x * chunk;
  const long long r1 = min(r0 + chunk, rows);
  const size_t base = (size_t)blockIdx.y * rows * HD;
  const uint4* kv4 = reinterpret_cast<const uint4*>(k + base) + tx;
  const uint4* vv4 = reinterpret_cast<const uint4*>(v + base) + tx;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  long long r = r0 + ty;
  for (; r + 3 * RPI < r1; r += 4 * RPI) {
    uint4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = __ldcs(kv4 + (r + u * RPI) * VPR);
      b[u] = __ldcs(vv4 + (r + u * RPI) * VPR);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      add8(acc, a[u]);
      add8(acc, b[u]);
    }
  }
  for (; r < r1; r += RPI) {
    add8(acc, __ldcs(kv4 + r * VPR));
    add8(acc, __ldcs(vv4 + r * VPR));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[ty * HD + tx * 8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float s = 0.0f;
    for (int y = 0; y < RPI; ++y) s += red[y * HD + threadIdx.x];
    part[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * HD + threadIdx.x] = s;
  }
}

// P11, pass 2. grid b, COMBINE_THREADS threads as (column c, lane y): lane
// y sums splits y, y + Y, ... in order, then lane 0 adds the Y lane sums in
// order. Y lanes a column keep that many partial loads in flight, where one
// thread a column would wait on each load in turn.
template <int HD>
__global__ void __launch_bounds__(COMBINE_THREADS)
pure_read_combine(const float* __restrict__ part, int splits, float* __restrict__ out) {
  constexpr int Y = COMBINE_THREADS / HD;
  __shared__ float red[COMBINE_THREADS];
  const int c = threadIdx.x % HD;
  const int y = threadIdx.x / HD;
  const float* p = part + (size_t)blockIdx.x * splits * HD + c;
  float s = 0.0f;
#pragma unroll 4
  for (int sp = y; sp < splits; sp += Y) s += p[(size_t)sp * HD];
  red[threadIdx.x] = s;
  __syncthreads();
  if (y == 0) {
    float t = 0.0f;
    for (int i = 0; i < Y; ++i) t += red[i * HD + c];
    out[(size_t)blockIdx.x * HD + c] = t;
  }
}

// P12's shared memory: each of the W warps' ring of ST tiles, a tile K [TR]
// [HD + 8] then V [TR][HD + 8] bf16 (the pad spreads ldmatrix rows over the
// banks). After the loop the rings' room holds the CTA's merged (o [MAX_G]
// [HD], m [MAX_G], l [MAX_G]) and the warps' (o, m, l) beside it.
template <int HD, int W, int TR, int ST>
struct AttSmem {
  static constexpr int LD = HD + 8;
  static constexpr int TILE = 2 * TR * LD;  // bf16 elements
  static constexpr size_t ring = (size_t)W * ST * TILE * 2;
  static constexpr size_t merge = (size_t)(W + 1) * MAX_G * (HD + 2) * 4;
  static constexpr size_t bytes = ring > merge ? ring : merge;
};

// rows [w0 + t * TR, + TR) of a (row, kv head)'s K and V into a ring slot by
// the warp's 16-byte cp.async copies; rows at or past w1 are zero-filled
// without a read
template <int HD, int TR>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int w0, int w1, int t,
                                          int lane) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  __nv_bfloat16* vs = ks + TR * LD;
#pragma unroll
  for (int i = lane; i < TR * CH; i += 32) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int row = w0 + t * TR + r;
    const bool in = row < w1;
    const size_t off = in ? (size_t)row * HD + c : 0;
    dlt::cp_async16(ks + r * LD + c, kb + off, in ? 16 : 0);
    dlt::cp_async16(vs + r * LD + c, vb + off, in ? 16 : 0);
  }
}

// grid (C, b * n_kv), clusters of C along x: CTA `rank` of cluster bk takes
// columns [rank * width, (rank + 1) * width) of kv head bk % n_kv of row
// bk / n_kv, cut at `visible` (columns s < visible are visible)
template <int HD, int W, int TR, int ST>
__global__ void __launch_bounds__(W * 32)
grouped_decode_kernel(const void* __restrict__ qp, int q_is_f32,
                      const __nv_bfloat16* __restrict__ kc,
                      const __nv_bfloat16* __restrict__ vc, void* __restrict__ out, int n_kv,
                      int g, int S, int width, int visible, float scale) {
  using L = AttSmem<HD, W, TR, ST>;
  constexpr int LD = L::LD;
  constexpr int KS = HD / 16;  // k-steps of q K^T
  constexpr int NO = HD / 8;   // 8-column groups of the output
  constexpr int NS = TR / 8;   // 8-column groups of a tile's scores
  constexpr int KV = TR / 16;  // k-steps of P V
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // the MMA row = query head of the kv head
  const int tig = lane & 3;
  const int bk = blockIdx.y;
  const int bi = bk / n_kv;
  const int kvh = bk % n_kv;
  const int h = n_kv * g;

  // the warp's run and its tiles
  const int wr = width / W;
  const int w0 = rank * width + warp * wr;
  const int w1 = min(w0 + wr, visible);
  const int n_t = w1 > w0 ? (w1 - w0 + TR - 1) / TR : 0;
  const __nv_bfloat16* kb = kc + (size_t)bk * S * HD;
  const __nv_bfloat16* vb = vc + (size_t)bk * S * HD;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + (size_t)warp * ST * L::TILE;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_t) load_tile<HD, TR>(ring + s * L::TILE, kb, vb, w0, w1, s, lane);
    dlt::cp_async_commit();
  }

  // q's A fragments: row gid = head kvh * g + gid, k 2tig.. and 8 + 2tig..
  // of each k-step, in bf16 (rows >= g and rows 8..15 are zero)
  unsigned qa[KS][4];
  {
    const bool q_ok = gid < g;
    const size_t q0 = ((size_t)bi * h + (size_t)kvh * g + (q_ok ? gid : 0)) * HD + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned lo = 0u, hi = 0u;
      if (q_ok) {
        const size_t i = q0 + 16 * kk;
        if (q_is_f32) {
          const float* qf = reinterpret_cast<const float*>(qp);
          const float2 a = *reinterpret_cast<const float2*>(qf + i);
          const float2 c = *reinterpret_cast<const float2*>(qf + i + 8);
          lo = dlt::pack_bf16x2(a.x, a.y);
          hi = dlt::pack_bf16x2(c.x, c.y);
        } else {
          const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(qp);
          lo = *reinterpret_cast<const unsigned*>(qb + i);
          hi = *reinterpret_cast<const unsigned*>(qb + i + 8);
        }
      }
      qa[kk][0] = lo;
      qa[kk][1] = 0u;
      qa[kk][2] = hi;
      qa[kk][3] = 0u;
    }
  }

  float m_r = NEG_INF;
  float l_r = 0.0f;
  float acc[NO][2];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = 0.0f;

  for (int t = 0; t < n_t; ++t) {
    if (t + ST - 1 < n_t)
      load_tile<HD, TR>(ring + (t + ST - 1) % ST * L::TILE, kb, vb, w0, w1, t + ST - 1, lane);
    dlt::cp_async_commit();
    dlt::cp_async_wait<ST - 1>();  // tile t has landed (this lane's copies)
    __syncwarp();                  // ... and the warp's
    const __nv_bfloat16* Ks = ring + t % ST * L::TILE;
    const __nv_bfloat16* Vs = Ks + TR * LD;

    // scores of the g heads (rows gid) x the tile's TR columns
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned b[4];
        dlt::ldmatrix_x4(b, Ks + (8 * (n + (lane >> 4)) + (lane & 7)) * LD + 16 * kk +
                                8 * ((lane >> 3) & 1));
        dlt::mma_bf16(sc[n], qa[kk], b[0], b[1]);
        dlt::mma_bf16(sc[n + 1], qa[kk], b[2], b[3]);
      }
    }
    // the online softmax of row gid over the tile
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = w0 + t * TR + 8 * n + 2 * tig + e < w1;
        const float s = ok ? __fmul_rn(sc[n][e], scale) : NEG_INF;
        sc[n][e] = s;
        mx = fmaxf(mx, s);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_safe = fmaxf(fmaxf(mx, m_r), NEG_INF / 2);
    const float corr = expf(m_r - m_safe);
    float ps = 0.0f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = sc[n][e];
        const float p = s == NEG_INF ? 0.0f : expf(s - m_safe);
        sc[n][e] = p;
        ps = __fadd_rn(ps, p);
      }
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 1));
    ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 2));
    l_r = __fadd_rn(__fmul_rn(l_r, corr), ps);
    m_r = m_safe;
    // p in bf16 as P . V's A fragments: k-step kk is the tile's rows
    // 16kk .. 16kk + 15 (rows 8..15 of the MMA are zero)
    unsigned pa[KV][4];
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      pa[kk][0] = dlt::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = 0u;
      pa[kk][2] = dlt::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = 0u;
    }
    // acc = acc * corr + P V, two 8-column groups at a time
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      float pv[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        unsigned b[4];
        dlt::ldmatrix_x4_trans(b, Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                      8 * (n + (lane >> 4)));
        dlt::mma_bf16(pv[0], pa[kk], b[0], b[1]);
        dlt::mma_bf16(pv[1], pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[n + u][e] = __fadd_rn(__fmul_rn(acc[n + u][e], corr), pv[u][e]);
    }
    __syncwarp();  // the slot is read before a later tile refills it
  }
  dlt::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // the warps' states over the ring's room, merged in warp order into the
  // CTA's (o, m, l)
  float* co = reinterpret_cast<float*>(smem);  // [MAX_G][HD]
  float* cm = co + MAX_G * HD;                 // [MAX_G]
  float* cl = cm + MAX_G;                      // [MAX_G]
  float* wo = cl + MAX_G;              // [W][MAX_G][HD]
  float* wm = wo + W * MAX_G * HD;     // [W][MAX_G]
  float* wl = wm + W * MAX_G;
  if (gid < g) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(wo + (warp * MAX_G + gid) * HD + 8 * n + 2 * tig) =
          make_float2(acc[n][0], acc[n][1]);
    if (tig == 0) {
      wm[warp * MAX_G + gid] = m_r;
      wl[warp * MAX_G + gid] = l_r;
    }
  }
  __syncthreads();
  for (int e = tid; e < g * HD; e += W * 32) {
    const int j = e / HD;
    float M = wm[j];
#pragma unroll
    for (int w = 1; w < W; ++w) M = fmaxf(M, wm[w * MAX_G + j]);
    float O = 0.0f, Lw = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = expf(wm[w * MAX_G + j] - M);
      const float os = __fmul_rn(wo[w * MAX_G * HD + e], f);
      const float ls = __fmul_rn(wl[w * MAX_G + j], f);
      O = w == 0 ? os : __fadd_rn(O, os);
      Lw = w == 0 ? ls : __fadd_rn(Lw, ls);
    }
    co[e] = O;
    if (e % HD == 0) {
      cm[j] = M;
      cl[j] = Lw;
    }
  }

  // the cluster's CTAs in rank order through distributed shared memory:
  // CTA `rank` writes its share of the g * HD outputs
  cluster.sync();
  const int n_el = g * HD;
  const int per = (n_el + C - 1) / C;
  const int e1 = min(n_el, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += W * 32) {
    const int j = e / HD;
    float mv[MAX_CLUSTER], ov[MAX_CLUSTER], lv[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {  // every remote read in flight before the merge
      if (c < C) {
        mv[c] = *cluster.map_shared_rank(cm + j, c);
        lv[c] = *cluster.map_shared_rank(cl + j, c);
        ov[c] = *cluster.map_shared_rank(co + e, c);
      }
    }
    float M = mv[0];
#pragma unroll
    for (int c = 1; c < MAX_CLUSTER; ++c)
      if (c < C) M = fmaxf(M, mv[c]);
    float O = 0.0f, Lc = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < C) {
        const float f = expf(mv[c] - M);
        const float os = __fmul_rn(ov[c], f);
        const float ls = __fmul_rn(lv[c], f);
        O = c == 0 ? os : __fadd_rn(O, os);
        Lc = c == 0 ? ls : __fadd_rn(Lc, ls);
      }
    }
    const float o = O / fmaxf(Lc, 1e-30f);
    const size_t idx = ((size_t)bi * h + (size_t)kvh * g) * HD + e;
    if (q_is_f32)
      reinterpret_cast<float*>(out)[idx] = o;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
  }
  cluster.sync();  // no CTA leaves while its state may be read
}

template <int HD>
cudaError_t launch_pure_read(const void* k, const void* v, int b, long long rows, int splits,
                             float* part, float* out, cudaStream_t s) {
  const long long chunk = (rows + splits - 1) / splits;
  pure_read_partial<HD><<<dim3(splits, b), READ_THREADS, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<const __nv_bfloat16*>(v),
      rows, chunk, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pure_read_combine<HD><<<b, COMBINE_THREADS, 0, s>>>(part, splits, out);
  return cudaGetLastError();
}

// One launch of P12: grid (cluster, b * n_kv) in clusters of `cluster` CTAs
// of W warps, each device's shared-memory and cluster-size opt-ins set once.
// `max_clusters`, when not null, receives how many such clusters the device
// can hold at once (cudaOccupancyMaxActiveClusters) instead of a launch.
template <int HD, int W, int TR, int ST>
cudaError_t launch_attention(const void* q, int q_is_f32, const void* k, const void* v, int b,
                             int n_kv, int g, int S, int cluster, int width, int visible,
                             float scale, void* out, cudaStream_t s, int* max_clusters) {
  using L = AttSmem<HD, W, TR, ST>;
  const auto kernel = grouped_decode_kernel<HD, W, TR, ST>;
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)(b * n_kv));
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, q, q_is_f32, reinterpret_cast<const __nv_bfloat16*>(k),
                         reinterpret_cast<const __nv_bfloat16*>(v), out, n_kv, g, S, width,
                         visible, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The (head_dim, warps, tile rows, ring depth) instances the plan names
// (probes/attention.py ATT_VARIANT); built with -DDLT_P12_SWEEP, every
// instance probes/p2_p12_ab.py --sweep chooses among, each within the 227
// KB of shared memory a CTA may hold (a 32-row tile is 9 KB at head_dim 64,
// 17 KB at 128).
#ifdef DLT_P12_SWEEP
#define DLT_P12_VARIANTS(X)                                                       \
  X(64, 4, 32, 2) X(64, 8, 32, 2) X(64, 8, 16, 3) X(64, 16, 16, 2) X(128, 4, 32, 2) \
  X(128, 8, 16, 2)
#else
#define DLT_P12_VARIANTS(X) X(64, 8, 32, 2) X(128, 8, 16, 2)
#endif

cudaError_t launch_variant(int hd, int warps, int tile, int stages, const void* q,
                           int q_is_f32, const void* k, const void* v, int b, int n_kv, int g,
                           int S, int cluster, int width, int visible, float scale, void* out,
                           cudaStream_t s, int* max_clusters) {
#define DLT_P12_CASE(HD, W, TR, ST)                                                          \
  if (hd == HD && warps == W && tile == TR && stages == ST)                                  \
    return launch_attention<HD, W, TR, ST>(q, q_is_f32, k, v, b, n_kv, g, S, cluster, width, \
                                           visible, scale, out, s, max_clusters);
  DLT_P12_VARIANTS(DLT_P12_CASE)
#undef DLT_P12_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// k, v [b, n_kv, S, hd] bf16, contiguous and 16-byte aligned; part [b,
// splits, hd] f32 scratch; out [b, 1, hd] f32.
extern "C" int pure_read(const void* k, const void* v, int b, int n_kv, int S, int hd,
                         int splits, void* part, void* out, void* stream) {
  if (b < 1 || n_kv < 1 || S < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long rows = (long long)n_kv * S;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = reinterpret_cast<float*>(part);
  float* o = reinterpret_cast<float*>(out);
  if (hd == 64) return (int)launch_pure_read<64>(k, v, b, rows, splits, p, o, s);
  if (hd == 128) return (int)launch_pure_read<128>(k, v, b, rows, splits, p, o, s);
  return (int)cudaErrorInvalidValue;
}

// q [b, n_kv * g, hd] f32 or bf16, contiguous; k, v [b, n_kv, S, hd] bf16,
// contiguous and 16-byte aligned; out [b, n_kv * g, hd] in q's dtype. The
// plan (probes/attention.py attention_plan): `cluster` CTAs a (row, kv
// head), `width` columns each (a multiple of warps * 32, the last CTA's
// range reaching S), `warps` warps a CTA, each walking its run in tiles of
// `tile` rows with `stages` tiles in its ring. With max_clusters not null,
// nothing launches: it receives how many of these clusters fit the device
// at once.
extern "C" int decode_attention(const void* q, int q_is_f32, const void* k, const void* v,
                                int b, int n_kv, int g, int S, int hd, int pos, int col0,
                                int cluster, int width, int warps, int tile, int stages,
                                float scale, void* out, int* max_clusters, void* stream) {
  if (b < 1 || n_kv < 1 || g < 1 || g > MAX_G || S < 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || warps < 1 || tile < 16 || width < 1 ||
      width % (warps * tile) != 0 ||
      (long long)cluster * width < S || (long long)(cluster - 1) * width >= S ||
      (long long)b * n_kv > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  // columns s < visible are visible: col0 + s <= pos
  const long long vis = (long long)pos - col0 + 1;
  const int visible = vis < 0 ? 0 : (vis > S ? S : (int)vis);
  return (int)launch_variant(hd, warps, tile, stages, q, q_is_f32, k, v, b, n_kv, g, S, cluster,
                             width, visible, scale, out, reinterpret_cast<cudaStream_t>(stream),
                             max_clusters);
}
