// K3: causal GQA flash attention forward over the KV cache, from a scalar
// pos_start: o = softmax(q k^T * scale + causal) v, for a prefill chunk.
// B8: the same loop over ONE shard of a sequence-parallel cache, whose row 0
// sits at the global position col_offset, returning the unnormalized
// online-softmax triple (o, m, l) for the cross-shard combine.
//
// Replaces the JAX package's ops/pallas_attention.py flash_attention (:199),
// bodies _attend_block (:46) and _kernel (:103) (K3), and
// flash_attention_partial (:398), bodies _attend_block and _kernel_partial
// (:114) (B8).
//
// What bounds it on Hopper: memory. At prefill chunk sizes (t <= 32 query
// tokens against a cache view of S >= 256 rows) the K/V rows up to the
// causal limit are read once per (batch, kv head, query tile), and the
// flops per byte are ~2 * rows, far under the tensor cores' ratio. Between
// two and a few hundred 64-row tiles per (batch, kv head), so the latency of
// each tile and the number of SMs that stream them set the time.
//
// Design:
//   * one CTA per (batch * kv head, tile of 64 score rows, split). The g
//     query heads of a kv head fold into the rows as _attend_block folds
//     them: row R is token R / g, head kvh * g + R % g, position pos_start +
//     R / g.
//   * split-S to fill the card: the view's S rows are cut into `splits`
//     runs of `split_tiles` whole 64-row tiles, aligned on the shard's
//     rows, which are aligned on global columns (a shard is a multiple of
//     128 rows). The plan (ops/cuda_attention.py flash_plan) is a function
//     of the shapes alone (the view's tile count and the grid), as the JAX
//     kernel's grid is: a call's sums never depend on its position, so a
//     chunk run eagerly at a host position and replayed in a CUDA graph at
//     a device position gives the same bits, and B8 on a shard splits as K3
//     on a view of the shard's length. A CTA whose run lies wholly past its
//     rows' causal limit writes neutral partials (o = 0, m = NEG_INF, l = 0)
//     and exits: the combine adds exact zeros for it.
//   * K3's position comes by value or from the device (`pos_dev`, one int32
//     or int64 the CTA reads first): the JAX kernel's scalar-prefetch
//     `pos_start`, so a CUDA graph of a prefill chunk replays at any
//     position of its kv bucket. A one-row call may also name its cache row
//     on the device (`row_dev`, one int64 into a cache of `cache_b` rows):
//     a CUDA graph of one batch row's admission chunk reads that row in
//     place, at whatever row the buffer holds. A row outside the cache
//     reads row 0 with a NaN scale, so its output is NaN, never a read out
//     of bounds.
//   * with one split a CTA writes its result directly (one launch). With
//     more, each CTA writes its unnormalized (o, m, l) to a workspace the
//     wrapper allocated, and a second kernel combines the splits in split
//     order: M = max m_s, o = sum o_s e^(m_s - M), l alike; K3 then divides,
//     B8 writes the triple. K3 and B8 share every operation up to K3's
//     division, so on shard 0 (whose factor e^(m - M) is exactly 1, the other
//     shards adding exact zeros) the sp combine gives K3's bits.
//   * the cache is read IN PLACE through strides from its [b, S, n_kv, hd]
//     view of the stacked [L, b, S, n_kv, hd] cache: no transpose copy.
//     K and V tiles go through a two-slot ring in shared memory fed by
//     cp.async (16 bytes a thread): tile j + 1 streams in while tile j is
//     computed. A tile is loaded only while its first column col_offset +
//     j * 64 is at or before the CTA's causal limit.
//   * the FlashAttention-2 loop with everything in registers: each warp owns
//     16 score rows; Q's fragments are loaded once (ldmatrix); S = Q K^T
//     runs on mma.sync m16n8k16 bf16 into registers; the row max and row sum
//     combine the four lanes that share a row (two xor-shuffles); P is
//     rounded to bf16 in registers and is PV's A fragment as it stands; V's
//     B fragments come from ldmatrix.trans; O stays in registers.
//   * the online softmax in f32 exactly as _attend_block: masked scores are
//     NEG_INF, m is clamped to NEG_INF / 2 so fully masked rows stay finite,
//     P is cast to bf16 before PV while l sums the f32 p, and acc * corr +
//     pv and l * corr + sum(p) round separately (PV goes to a zeroed
//     fragment first). K3 ends by dividing by max(l, 1e-30).
//   * B8 writes acc (f32) as it stands, with m and l per row. A row that
//     sees no column of the shard gets o = 0, l = 0 and the m of the JAX
//     kernel: NEG_INF / 2 where the row's JAX query block (block_t tokens)
//     visits a KV block of the shard, else NEG_INF (its scratch init). A
//     CTA with nothing to load still writes.
//   * templated on head_dim 64 (Llama) and 128 (Qwen3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "async_mma.cuh"

namespace {

constexpr int ROWS = 64;   // score rows per CTA
constexpr int BS = 64;     // KV rows per tile
constexpr int WARPS = ROWS / 16;
constexpr int THREADS = WARPS * 32;
constexpr int SLOTS = 2;   // K/V ring depth
constexpr float NEG_INF = -FLT_MAX;
constexpr int MAX_DEVICES = 64;  // shared-memory opt-ins are kept per device
constexpr int COMBINE_THREADS = 256;

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;  // bf16 per row: ldmatrix rows hit distinct banks
  static constexpr size_t tile = (size_t)BS * LD * 2;
  static constexpr size_t q = (size_t)ROWS * LD * 2;
  static constexpr size_t total = q + 2 * SLOTS * tile;  // Q, then K and V slots
};

// K and V rows j * BS .. j * BS + BS - 1 of the view into one ring slot;
// rows past S read zeros
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                          const __nv_bfloat16* kbase,
                                          const __nv_bfloat16* vbase, long long kss, int j,
                                          int S, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int i = tid; i < BS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int s = j * BS + r;
    const bool in = s < S;
    const size_t off = in ? (size_t)s * kss + c : 0;
    dlt::cp_async16(ks + r * Smem<HD>::LD + c, kbase + off, in ? 16 : 0);
    dlt::cp_async16(vs + r * Smem<HD>::LD + c, vbase + off, in ? 16 : 0);
  }
}

// m of a B8 row that saw no column of the shard: the JAX kernel's
// NEG_INF / 2 where the row's query block visits a KV block of the shard,
// NEG_INF (its scratch init) where it visits none
__device__ __forceinline__ float blind_m(int tok, int pos_start, int col_offset, int block_t) {
  const int q_last = pos_start + (tok / block_t) * block_t + block_t - 1;
  return col_offset <= q_last ? NEG_INF / 2 : NEG_INF;
}

template <int HD, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const void* __restrict__ qp, int q_is_f32,
                           const __nv_bfloat16* __restrict__ kc,
                           const __nv_bfloat16* __restrict__ vc, long long ksb,
                           long long kss, long long ksh, float* __restrict__ o,
                           float* __restrict__ m_out, float* __restrict__ l_out,
                           float* __restrict__ o_ws, float* __restrict__ m_ws,
                           float* __restrict__ l_ws, int t, int S, int n_heads, int n_kv,
                           int pos_start, int col_offset, int block_t, float scale,
                           int split_tiles, int splits, const void* __restrict__ pos_dev,
                           int pos_i64, const long long* __restrict__ row_dev, int cache_b) {
  using L = Smem<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NO = HD / 8;   // 8-column groups of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Kr = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* Vr = reinterpret_cast<__nv_bfloat16*>(smem + L::q + SLOTS * L::tile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int g = n_heads / n_kv;
  const int bk = blockIdx.x;
  const int bi = bk / n_kv;
  const int kvh = bk % n_kv;
  const int row0 = blockIdx.y * ROWS;  // first score row of this tile
  long long cache_row = bi;  // the cache row this CTA reads
  if (row_dev != nullptr) {
    cache_row = *row_dev;
    if (cache_row < 0 || cache_row >= cache_b) {
      cache_row = 0;
      scale = __int_as_float(0x7fc00000);
    }
  }
  const int split = blockIdx.z;
  const int n_rows = t * g;
  if (pos_dev != nullptr)
    pos_start = pos_i64 ? (int)*reinterpret_cast<const long long*>(pos_dev)
                        : *reinterpret_cast<const int*>(pos_dev);

  // this CTA's tiles: its split's run, cut at its rows' causal limit
  const int last_row = min(row0 + ROWS, n_rows) - 1;
  const int last_pos = pos_start + last_row / g;
  const int kv_end = min(S, last_pos - col_offset + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + BS - 1) / BS : 0;
  const int j0 = split * split_tiles;
  const int j1 = min(n_tiles, j0 + split_tiles);
  if (splits > 1 && j0 >= j1) {
    // a run wholly past the causal limit: neutral partials for the combine
    for (int i = tid; i <= last_row - row0; i += THREADS) {
      const size_t ws_row = ((size_t)split * gridDim.x + bk) * n_rows + row0 + i;
      m_ws[ws_row] = NEG_INF;
      l_ws[ws_row] = 0.0f;
    }
    for (int i = tid; i < (last_row - row0 + 1) * (HD / 4); i += THREADS) {
      const size_t ws_row = ((size_t)split * gridDim.x + bk) * n_rows + row0 + i / (HD / 4);
      reinterpret_cast<float4*>(o_ws + ws_row * HD)[i % (HD / 4)] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }

  const __nv_bfloat16* kbase = kc + (size_t)cache_row * ksb + (size_t)kvh * ksh;
  const __nv_bfloat16* vbase = vc + (size_t)cache_row * ksb + (size_t)kvh * ksh;
  if (j0 < j1) load_tile<HD>(Kr, Vr, kbase, vbase, kss, j0, S, tid);
  dlt::cp_async_commit();

  // Q tile -> bf16 (the JAX wrapper casts q to the cache dtype): 8 values a
  // chunk, every load of a thread issued before its first store
  {
    constexpr int CH = HD / 8;                  // chunks a row
    constexpr int PER = ROWS * CH / THREADS;    // chunks a thread
    float4 v[PER][2];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      const int R = row0 + i / CH;
      v[u][0] = v[u][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (R >= n_rows) continue;
      const size_t idx =
          (((size_t)bi * t + R / g) * n_heads + kvh * g + R % g) * HD + (i % CH) * 8;
      if (q_is_f32) {
        const float4* src = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(qp) + idx);
        v[u][0] = src[0];
        v[u][1] = src[1];
      } else {  // 8 bf16 in the bits of v[u][0]
        v[u][0] = *reinterpret_cast<const float4*>(reinterpret_cast<const __nv_bfloat16*>(qp) + idx);
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      uint4 b = *reinterpret_cast<const uint4*>(&v[u][0]);
      if (q_is_f32) {
        const float4 a = v[u][0];
        const float4 c = v[u][1];
        b = make_uint4(dlt::pack_bf16x2(a.x, a.y), dlt::pack_bf16x2(a.z, a.w),
                       dlt::pack_bf16x2(c.x, c.y), dlt::pack_bf16x2(c.z, c.w));
      }
      *reinterpret_cast<uint4*>(Qs + (i / CH) * L::LD + (i % CH) * 8) = b;
    }
  }
  __syncthreads();

  const bool active = row0 + 16 * warp < n_rows;  // the warp has a real row
  unsigned qa[KS][4];
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      dlt::ldmatrix_x4(qa[kk], Qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::LD +
                                   16 * kk + 8 * (lane >> 4));
  }
  // rows gid and gid + 8 of the warp's 16: positions and running state
  const int R0 = row0 + 16 * warp + gid;
  const int pos_r[2] = {pos_start + R0 / g, pos_start + (R0 + 8) / g};
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.0f, 0.0f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = j0; j < j1; ++j) {
    const int slot = (j - j0) % SLOTS;
    if (j + 1 < j1)
      load_tile<HD>(Kr + (1 - slot) * (L::tile / 2), Vr + (1 - slot) * (L::tile / 2), kbase,
                    vbase, kss, j + 1, S, tid);
    dlt::cp_async_commit();
    dlt::cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();          // ... and everyone's
    if (active) {
      const __nv_bfloat16* Ks = Kr + slot * (L::tile / 2);
      const __nv_bfloat16* Vs = Vr + slot * (L::tile / 2);
      // S = Q K^T for the warp's 16 rows x 64 columns
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          unsigned b[4];
          dlt::ldmatrix_x4(b, Ks + (8 * (n + (lane >> 4)) + (lane & 7)) * L::LD + 16 * kk +
                                  8 * ((lane >> 3) & 1));
          dlt::mma_bf16(sc[n], qa[kk], b[0], b[1]);
          dlt::mma_bf16(sc[n + 1], qa[kk], b[2], b[3]);
        }
      }
      // online softmax over this tile, rows gid (h = 0) and gid + 8 (h = 1)
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * BS + 8 * n + 2 * tig + e;
            const bool ok = col_offset + c <= pos_r[h] && c < S;
            const float s = ok ? __fmul_rn(sc[n][2 * h + e], scale) : NEG_INF;
            sc[n][2 * h + e] = s;
            mx = fmaxf(mx, s);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_safe = fmaxf(fmaxf(mx, m_r[h]), NEG_INF / 2);
        corr[h] = expf(m_r[h] - m_safe);
        float ps = 0.0f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s = sc[n][2 * h + e];
            const float p = s == NEG_INF ? 0.0f : expf(s - m_safe);
            sc[n][2 * h + e] = p;
            ps = __fadd_rn(ps, p);
          }
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 1));
        ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, 2));
        l_r[h] = __fadd_rn(__fmul_rn(l_r[h], corr[h]), ps);
        m_r[h] = m_safe;
      }
      // P in bf16 as PV's A fragments: k-step kk is S columns 16kk..16kk+15
      unsigned pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = dlt::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
        pa[kk][1] = dlt::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
        pa[kk][2] = dlt::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[kk][3] = dlt::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
      // acc = acc * corr + P V, two 8-column groups of O at a time
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        float pv[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          unsigned b[4];
          dlt::ldmatrix_x4_trans(b, Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * L::LD +
                                        8 * (n + (lane >> 4)));
          dlt::mma_bf16(pv[0], pa[kk], b[0], b[1]);
          dlt::mma_bf16(pv[1], pa[kk], b[2], b[3]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n + u][e] = __fadd_rn(__fmul_rn(acc[n + u][e], corr[e >> 1]), pv[u][e]);
      }
    }
    __syncthreads();  // the slot is free for tile j + 2
  }
  dlt::cp_async_wait<0>();

  if (!active) return;
  const bool direct = splits == 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = R0 + 8 * h;
    if (R >= n_rows) continue;
    const int tok = R / g;
    const int head = kvh * g + R % g;
    const size_t row_idx = ((size_t)bi * t + tok) * n_heads + head;
    if (direct) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float2 v = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        if (!PARTIAL) {
          const float l = fmaxf(l_r[h], 1e-30f);
          v.x = v.x / l;
          v.y = v.y / l;
        }
        *reinterpret_cast<float2*>(o + row_idx * HD + 8 * n + 2 * tig) = v;
      }
      if (PARTIAL && tig == 0) {
        m_out[row_idx] = m_r[h] > NEG_INF / 2 ? m_r[h]
                                              : blind_m(tok, pos_start, col_offset, block_t);
        l_out[row_idx] = l_r[h];
      }
    } else {
      const size_t ws_row = ((size_t)split * gridDim.x + bk) * n_rows + R;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(o_ws + ws_row * HD + 8 * n + 2 * tig) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      if (tig == 0) {
        m_ws[ws_row] = m_r[h];
        l_ws[ws_row] = l_r[h];
      }
    }
  }
}

// The splits' triples of one (batch * kv head, score row), combined in split
// order; one thread an output element
template <int HD, bool PARTIAL>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_combine_kernel(const float* __restrict__ o_ws, const float* __restrict__ m_ws,
                     const float* __restrict__ l_ws, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out, int splits, int t,
                     int n_heads, int n_kv, int pos_start, int col_offset, int block_t,
                     const void* __restrict__ pos_dev, int pos_i64) {
  constexpr int RPB = COMBINE_THREADS / HD;  // rows a block
  const int g = n_heads / n_kv;
  const int n_rows = t * g;
  const int bk = blockIdx.x;
  const int BK = gridDim.x;
  const int R = blockIdx.y * RPB + threadIdx.x / HD;
  const int dd = threadIdx.x % HD;
  if (R >= n_rows) return;
  if (PARTIAL && pos_dev != nullptr)
    pos_start = pos_i64 ? (int)*reinterpret_cast<const long long*>(pos_dev)
                        : *reinterpret_cast<const int*>(pos_dev);
  float M = NEG_INF;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, m_ws[((size_t)s * BK + bk) * n_rows + R]);
  float acc = 0.0f;
  float l = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t ws_row = ((size_t)s * BK + bk) * n_rows + R;
    const float f = expf(m_ws[ws_row] - M);
    const float os = __fmul_rn(o_ws[ws_row * HD + dd], f);
    const float ls = __fmul_rn(l_ws[ws_row], f);
    acc = s == 0 ? os : __fadd_rn(acc, os);
    l = s == 0 ? ls : __fadd_rn(l, ls);
  }
  const int bi = bk / n_kv;
  const int tok = R / g;
  const size_t row_idx = ((size_t)bi * t + tok) * n_heads + (bk % n_kv) * g + R % g;
  if (PARTIAL) {
    o[row_idx * HD + dd] = acc;
    if (dd == 0) {
      m_out[row_idx] = M > NEG_INF / 2 ? M : blind_m(tok, pos_start, col_offset, block_t);
      l_out[row_idx] = l;
    }
  } else {
    o[row_idx * HD + dd] = acc / fmaxf(l, 1e-30f);
  }
}

template <int HD, bool PARTIAL>
cudaError_t launch(const void* q, int q_is_f32, const void* k, const void* v, long long ksb,
                   long long kss, long long ksh, void* o, void* m, void* l, void* o_ws,
                   void* m_ws, void* l_ws, int b, int t, int S, int n_heads, int n_kv,
                   int pos_start, int col_offset, int block_t, float scale, int split_tiles,
                   int splits, const void* pos_dev, int pos_i64, const long long* row_dev,
                   int cache_b, cudaStream_t stream) {
  const size_t smem = Smem<HD>::total;
  static bool raised[MAX_DEVICES] = {};  // the opt-in is per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(flash_attention_fwd_kernel<HD, PARTIAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  const int g = n_heads / n_kv;
  const int n_rows = t * g;
  dim3 grid(b * n_kv, (n_rows + ROWS - 1) / ROWS, splits);
  flash_attention_fwd_kernel<HD, PARTIAL><<<grid, THREADS, smem, stream>>>(
      q, q_is_f32, reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), ksb, kss, ksh, reinterpret_cast<float*>(o),
      reinterpret_cast<float*>(m), reinterpret_cast<float*>(l), reinterpret_cast<float*>(o_ws),
      reinterpret_cast<float*>(m_ws), reinterpret_cast<float*>(l_ws), t, S, n_heads, n_kv,
      pos_start, col_offset, block_t, scale, split_tiles, splits, pos_dev, pos_i64, row_dev,
      cache_b);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  constexpr int RPB = COMBINE_THREADS / HD;
  flash_combine_kernel<HD, PARTIAL>
      <<<dim3(b * n_kv, (n_rows + RPB - 1) / RPB), COMBINE_THREADS, 0, stream>>>(
          reinterpret_cast<const float*>(o_ws), reinterpret_cast<const float*>(m_ws),
          reinterpret_cast<const float*>(l_ws), reinterpret_cast<float*>(o),
          reinterpret_cast<float*>(m), reinterpret_cast<float*>(l), splits, t, n_heads, n_kv,
          pos_start, col_offset, block_t, pos_dev, pos_i64);
  return cudaGetLastError();
}

cudaError_t check_args(const void* q, const void* k, const void* v, long long ksb,
                       long long kss, long long ksh, int b, int t, int S, int n_heads, int n_kv,
                       int split_tiles, int splits, const void* o_ws, const void* m_ws,
                       const void* l_ws) {
  if (b < 1 || t < 1 || S < 1 || n_kv < 1 || n_heads % n_kv != 0 || split_tiles < 1 ||
      splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  if (splits > 1 && (o_ws == nullptr || m_ws == nullptr || l_ws == nullptr))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      (ksb | kss | ksh) % 8 != 0)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [b, t, n_heads, hd] f32 or bf16, contiguous; k, v: bf16 [b, S, n_kv, hd]
// views with unit stride on hd and element strides (ksb, kss, ksh), shared by
// k and v; o [b, t, n_heads, hd] f32, contiguous. The plan
// (ops/cuda_attention.py flash_plan): `splits` runs of `split_tiles` 64-row
// tiles; with splits > 1 the workspace o_ws [splits, b * n_kv, t * g, hd],
// m_ws and l_ws [splits, b * n_kv, t * g] f32 (else null).
static int k3(const void* q, int q_is_f32, const void* k, const void* v, long long ksb,
              long long kss, long long ksh, void* o, int b, int t, int S, int n_heads, int n_kv,
              int head_dim, int pos_start, const void* pos_dev, int pos_i64,
              const long long* row_dev, int cache_b, float scale, int split_tiles, int splits,
              void* o_ws, void* m_ws, void* l_ws, void* stream) {
  const cudaError_t bad = check_args(q, k, v, ksb, kss, ksh, b, t, S, n_heads, n_kv, split_tiles,
                                     splits, o_ws, m_ws, l_ws);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64, false>(q, q_is_f32, k, v, ksb, kss, ksh, o, nullptr, nullptr, o_ws,
                                  m_ws, l_ws, b, t, S, n_heads, n_kv, pos_start, 0, 1, scale,
                                  split_tiles, splits, pos_dev, pos_i64, row_dev, cache_b, s);
  if (head_dim == 128)
    return (int)launch<128, false>(q, q_is_f32, k, v, ksb, kss, ksh, o, nullptr, nullptr, o_ws,
                                   m_ws, l_ws, b, t, S, n_heads, n_kv, pos_start, 0, 1, scale,
                                   split_tiles, splits, pos_dev, pos_i64, row_dev, cache_b,
                                   s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_fwd(const void* q, int q_is_f32, const void* k, const void* v,
                                   long long ksb, long long kss, long long ksh, void* o, int b,
                                   int t, int S, int n_heads, int n_kv, int head_dim,
                                   int pos_start, float scale, int split_tiles, int splits,
                                   void* o_ws, void* m_ws, void* l_ws, void* stream) {
  return k3(q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv, head_dim, pos_start,
            nullptr, 0, nullptr, 0, scale, split_tiles, splits, o_ws, m_ws, l_ws, stream);
}

// K3 at a device position: as flash_attention_fwd, pos_start read on the
// device from `pos_dev` (one int64 where pos_i64, else one int32), so a
// captured launch replays at whatever position the buffer holds. The plan
// is the same shape-only one. `row_dev` (null, or one int64 on the device;
// then b is 1): the cache row the query reads, k and v holding `cache_b`
// rows at stride ksb.
extern "C" int flash_attention_fwd_dev(const void* q, int q_is_f32, const void* k,
                                       const void* v, long long ksb, long long kss,
                                       long long ksh, void* o, int b, int t, int S, int n_heads,
                                       int n_kv, int head_dim, const void* pos_dev, int pos_i64,
                                       const void* row_dev, int cache_b, float scale,
                                       int split_tiles, int splits, void* o_ws, void* m_ws,
                                       void* l_ws, void* stream) {
  if (pos_dev == nullptr || reinterpret_cast<uintptr_t>(pos_dev) % (pos_i64 ? 8 : 4) != 0)
    return (int)cudaErrorInvalidValue;
  if (row_dev != nullptr && (b != 1 || cache_b < 1 || reinterpret_cast<uintptr_t>(row_dev) % 8))
    return (int)cudaErrorInvalidValue;
  return k3(q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv, head_dim, 0, pos_dev,
            pos_i64, reinterpret_cast<const long long*>(row_dev), cache_b, scale, split_tiles,
            splits, o_ws, m_ws, l_ws, stream);
}

// B8: as flash_attention_fwd over one shard whose row 0 is the global
// position col_offset; o [b, t, n_heads, hd] f32 unnormalized, m and l
// [b, t, n_heads] f32, all contiguous; block_t: the JAX kernel's query block
// (min(512, t), halved until it divides t), which decides a row's m when it
// sees no column of the shard.
extern "C" int flash_attention_partial_fwd(const void* q, int q_is_f32, const void* k,
                                           const void* v, long long ksb, long long kss,
                                           long long ksh, void* o, void* m, void* l, int b,
                                           int t, int S, int n_heads, int n_kv, int head_dim,
                                           int pos_start, int col_offset, int block_t,
                                           float scale, int split_tiles, int splits,
                                           void* o_ws, void* m_ws, void* l_ws, void* stream) {
  const cudaError_t bad = check_args(q, k, v, ksb, kss, ksh, b, t, S, n_heads, n_kv, split_tiles,
                                     splits, o_ws, m_ws, l_ws);
  if (bad != cudaSuccess) return (int)bad;
  if (block_t < 1 || t % block_t != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64, true>(q, q_is_f32, k, v, ksb, kss, ksh, o, m, l, o_ws, m_ws, l_ws, b,
                                 t, S, n_heads, n_kv, pos_start, col_offset, block_t, scale,
                                 split_tiles, splits, nullptr, 0, nullptr, 0, s);
  if (head_dim == 128)
    return (int)launch<128, true>(q, q_is_f32, k, v, ksb, kss, ksh, o, m, l, o_ws, m_ws, l_ws,
                                  b, t, S, n_heads, n_kv, pos_start, col_offset, block_t, scale,
                                  split_tiles, splits, nullptr, 0, nullptr, 0, s);
  return (int)cudaErrorInvalidValue;
}
