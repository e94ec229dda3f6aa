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
// P11's design (one launch a call, the merge in a fixed order inside it):
// the TPU kernel walks the cache in order on one core, carrying the sum in
// scratch; one CTA per row would give a handful of CTAs on 132 SMs. So a
// row's flattened [kv * S, hd] rows are cut into chunks of whole CTA
// iterations, as many as reach about 256 CTAs over the batch
// (probes/attention.py read_plan, the shape alone). A CTA of 8 warps
// loads every element, 16 bytes a thread, 4 rows' K and V vectors in
// flight, and adds each into its thread's f32 sums (a GPU drops a load
// whose value is unused, so a read that is not summed would not be a read;
// K and V are distinct buffers, as a cache has them); the CTA's threads of
// a column are summed in order through shared memory; a ticket finds the
// row's last CTA, which adds the partials in a fixed order (K5's merge)
// and resets the ticket. probes/attention.py pure_read_order_plain repeats
// the order bit for bit. probes/p4_p11_ab.py --sweep (NVIDIA H100 80GB
// HBM3, 700 W) chose the ticket over a row's splits as one thread-block
// cluster merged through distributed shared memory in rank order: 16 CTAs
// a row, the cluster's most, lost at S 1024 (hd 64, b 1: 7.92 against 4.86
// us cold) and streamed a long cache 5.5x slower (S 32768: 163.6 against
// 29.6 us); it replaced a second kernel's ordered combine.
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

constexpr int READ_THREADS = 256;      // P11's CTA: 8 warps
constexpr int READ_STAGE = 8192;       // floats of P11's shared memory: a merge pass's partials
constexpr int MAX_CLUSTER = 16;        // the non-portable cluster size
constexpr int MAX_G = 8;  // query heads a kv head: the MMA's rows 0..7 (8..15 stay zero)
constexpr float NEG_INF = -FLT_MAX;
constexpr int MAX_DEVICES = 64;  // shared-memory opt-ins are kept per device

// acc[i] += the 8 bf16 values of v, in order
__device__ __forceinline__ void add8(float* acc, const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] = __fadd_rn(acc[2 * i], f.x);
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], f.y);
  }
}

// P11's CTA: rows [r0, r1) of a batch row's flattened [rows, HD] K and V
// (kb, vb as 16-byte vectors) summed into cs[HD]. Thread (ty, tx) owns
// vector tx of rows r0 + ty, + RPI, .. and adds K then V of each row in
// turn into its 8 f32 sums, U rows' K and V loads in flight; then thread c
// < HD sums the RPI threads' column c in ty order (red: RPI * HD floats).
// Leaves cs written and red free after its last barrier.
template <int HD, int U>
__device__ __forceinline__ void read_rows(const uint4* __restrict__ kb,
                                          const uint4* __restrict__ vb, long long r0,
                                          long long r1, float* red, float* cs) {
  constexpr int VPR = HD / 8;              // 16-byte vectors a row
  constexpr int RPI = READ_THREADS / VPR;  // rows an iteration
  const int tx = threadIdx.x % VPR;
  const int ty = threadIdx.x / VPR;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  long long r = r0 + ty;
  for (; r + (U - 1) * RPI < r1; r += U * RPI) {
    uint4 a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = __ldcs(kb + (r + u * RPI) * VPR + tx);
      b[u] = __ldcs(vb + (r + u * RPI) * VPR + tx);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      add8(acc, a[u]);
      add8(acc, b[u]);
    }
  }
  for (; r < r1; r += RPI) {
    add8(acc, __ldcs(kb + r * VPR + tx));
    add8(acc, __ldcs(vb + r * VPR + tx));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[ty * HD + tx * 8 + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < HD) {
    float s = 0.0f;
#pragma unroll 8
    for (int y = 0; y < RPI; ++y) s = __fadd_rn(s, red[y * HD + threadIdx.x]);
    cs[threadIdx.x] = s;
  }
  __syncthreads();
}

// P11: grid (splits, b). CTA sp of row bi reads rows [sp * chunk, +chunk)
// and stores its sums in part[bi, sp, :]; a ticket finds the row's last
// CTA (thread 0's fence after the barrier makes the CTA's stores visible
// before its ticket, the last CTA's fence orders its reads after it), which
// adds the splits in a fixed order: lane y of a column (Y = READ_THREADS /
// HD lanes) sums splits y, y + Y, .. in turn, then the Y lane sums are
// added in lane order. The last CTA stages the partials through shared
// memory, STAGE floats a pass, every thread's loads of a pass in flight at
// once; it resets the ticket for the next call or graph replay.
template <int HD, int U>
__global__ void __launch_bounds__(READ_THREADS)
pure_read_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                 long long rows, long long chunk, float* __restrict__ part,
                 int* __restrict__ tickets, float* __restrict__ out) {
  constexpr int Y = READ_THREADS / HD;
  constexpr int CH = READ_STAGE / HD;                  // splits a pass, a multiple of Y
  constexpr int LOADS = READ_STAGE / 4 / READ_THREADS;  // a thread's float4s a pass
  __shared__ __align__(16) float stage[READ_STAGE];
  __shared__ float cs[HD];
  __shared__ bool s_last;
  const int splits = (int)gridDim.x;
  const int sp = (int)blockIdx.x;
  const int bi = (int)blockIdx.y;
  const int tid = (int)threadIdx.x;
  const size_t base = (size_t)bi * rows * HD;
  const long long r0 = sp * chunk;
  read_rows<HD, U>(reinterpret_cast<const uint4*>(k + base),
                   reinterpret_cast<const uint4*>(v + base), r0, min(r0 + chunk, rows), stage,
                   cs);
  if (splits == 1) {
    if (tid < HD) out[(size_t)bi * HD + tid] = cs[tid];
    return;
  }
  float* prow = part + (size_t)bi * splits * HD;
  if (tid < HD) prow[(size_t)sp * HD + tid] = cs[tid];
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(tickets + bi, 1) == splits - 1;
    if (last) __threadfence();
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  const int c = tid % HD;
  const int y = tid / HD;
  float s = 0.0f;
  for (int p0 = 0; p0 < splits; p0 += CH) {
    const int np = min(CH, splits - p0);
    const float4* src = reinterpret_cast<const float4*>(prow + (size_t)p0 * HD);
    float4* dst = reinterpret_cast<float4*>(stage);
    float4 t[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * READ_THREADS;
      if (4 * i < np * HD) t[j] = __ldcg(src + i);
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int i = tid + j * READ_THREADS;
      if (4 * i < np * HD) dst[i] = t[j];
    }
    __syncthreads();
    for (int i = y; i < np; i += Y) s = __fadd_rn(s, stage[i * HD + c]);
    __syncthreads();
  }
  stage[y * HD + c] = s;
  __syncthreads();
  if (y == 0) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < Y; ++j) t = __fadd_rn(t, stage[j * HD + c]);
    out[(size_t)bi * HD + c] = t;
  }
  if (tid == 0) tickets[bi] = 0;  // every split has arrived: ready for the next call
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

// One launch of P11 under its plan: grid (splits, b); part [b, splits, HD]
// and tickets [b], zero on entry and on exit, where splits > 1.
template <int HD, int U>
cudaError_t launch_pure_read(const void* k, const void* v, int b, long long rows, int splits,
                             long long chunk, float* part, int* tickets, float* out,
                             cudaStream_t s) {
  pure_read_kernel<HD, U><<<dim3(splits, b), READ_THREADS, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<const __nv_bfloat16*>(v), rows,
      chunk, part, tickets, out);
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

// The (head_dim, rows in flight) instances of P11 the plan names
// (probes/attention.py READ_UNROLL); built with -DDLT_P11_SWEEP, every
// instance probes/p4_p11_ab.py --sweep chooses among.
#ifdef DLT_P11_SWEEP
#define DLT_P11_VARIANTS(X) X(64, 4) X(64, 8) X(128, 4) X(128, 8)
#else
#define DLT_P11_VARIANTS(X) X(64, 4) X(128, 4)
#endif

// k, v [b, n_kv, S, hd] bf16, contiguous and 16-byte aligned; out [b, 1,
// hd] f32. The plan (probes/attention.py read_plan): `splits` CTAs a row,
// each of `chunk` rows of the row's flattened [n_kv * S, hd] K and V (the
// last may be shorter, none empty), `unroll` rows' loads in flight a
// thread; where splits > 1, part [b, splits, hd] f32 scratch (16-byte
// aligned) and tickets [b] int32, zero.
extern "C" int pure_read(const void* k, const void* v, int b, int n_kv, int S, int hd,
                         int splits, long long chunk, int unroll, void* part, void* tickets,
                         void* out, void* stream) {
  const long long rows = (long long)n_kv * S;
  if (b < 1 || b > 65535 || n_kv < 1 || S < 1 || splits < 1 || chunk < 1 ||
      (long long)splits * chunk < rows || (long long)(splits - 1) * chunk >= rows ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(part) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = reinterpret_cast<float*>(part);
  int* t = reinterpret_cast<int*>(tickets);
  float* o = reinterpret_cast<float*>(out);
#define DLT_P11_CASE(HD, U)                                                                   \
  if (hd == HD && unroll == U)                                                                \
    return (int)launch_pure_read<HD, U>(k, v, b, rows, splits, chunk, p, t, o, s);
  DLT_P11_VARIANTS(DLT_P11_CASE)
#undef DLT_P11_CASE
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
