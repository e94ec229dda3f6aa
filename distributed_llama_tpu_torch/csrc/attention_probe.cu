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
// S 1024 is 2.1 MB, which L2 holds.
//
// Design:
//   * the TPU kernels walk S in order on one core, carrying the sum or the
//     softmax state in scratch. On the card one CTA per (row, kv head) would
//     give 8 CTAs on 132 SMs at 1B width: it would measure occupancy, not
//     the floor. So both split S across CTAs: P11 into chunks of rows of the
//     flattened [kv * S, hd] cache, P12 into chunks of columns per (row, kv
//     head). Each CTA writes a partial (P11 a [hd] sum; P12 its (m, l, acc)
//     of the g query heads), and a second kernel combines the partials in a
//     fixed order: 1024 / hd lanes an output, each summing every (1024 /
//     hd)-th split in turn, then one lane adding the lane sums in turn (one
//     thread an output walking hundreds of partials waits on each load).
//     The split count is a function of the shape only, so the result does
//     not depend on scheduling.
//   * P11 loads every element, 16 bytes a thread, four rows in flight, and
//     adds each into the sum: a GPU drops a load whose value is unused, so
//     a read that is not summed would not be a read. K and V are distinct
//     buffers, as a cache has them (a second read of one buffer would come
//     from the 50 MB L2).
//   * P12 stages 64-row K and V tiles in shared memory, only up to the last
//     visible column; a thread computes whole scores from 16-byte rows, a
//     warp per query head runs the softmax of a tile, and a thread per
//     (head, feature) accumulates P . V. No TMA or wgmma: a simple first
//     kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int READ_THREADS = 256;
constexpr int ATT_THREADS = 128;
constexpr int COMBINE_THREADS = 1024;  // second passes: HD columns x (1024 / HD) lanes
constexpr int T = 64;  // KV rows per P12 tile
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

// P12's shared memory: q [g][HD] f32, K and V tiles [T][HD + 8] bf16 (the
// pad spreads 16-byte row reads over the banks), scores and bf16-rounded
// weights [g][T] f32, m / l / corr [g], acc [g][HD] f32.
template <int HD>
struct AttSmem {
  static constexpr int KLD = HD + 8;
  static size_t bytes(int g) {
    return (size_t)2 * T * KLD * 2 + (size_t)g * (2 * HD + 2 * T + 3) * 4;
  }
};

// P12, pass 1. grid (splits, b * n_kv): CTA (sp, bk) runs the online softmax
// of kv head bk % n_kv's g query heads over columns [sp * chunk, +chunk),
// cut at the last visible column, and writes (m, l, acc) to its partials.
template <int HD>
__global__ void __launch_bounds__(ATT_THREADS)
decode_attention_partial(const void* __restrict__ qp, int q_is_f32,
                         const __nv_bfloat16* __restrict__ kc,
                         const __nv_bfloat16* __restrict__ vc, int n_kv, int g, int S,
                         int chunk, int visible, float scale, float* __restrict__ m_part,
                         float* __restrict__ l_part, float* __restrict__ acc_part) {
  constexpr int KLD = AttSmem<HD>::KLD;
  constexpr int VEC = 8;  // bf16 a 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + T * KLD;
  float* q_s = reinterpret_cast<float*>(Vs + T * KLD);
  float* acc_s = q_s + g * HD;
  float* s_s = acc_s + g * HD;
  float* p_s = s_s + g * T;
  float* m_s = p_s + g * T;
  float* l_s = m_s + g;
  float* c_s = l_s + g;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sp = blockIdx.x;
  const int bk = blockIdx.y;
  const int bi = bk / n_kv;
  const int kvh = bk % n_kv;
  const int h = n_kv * g;

  for (int i = tid; i < g * HD; i += ATT_THREADS) {
    const size_t idx = ((size_t)bi * h + (size_t)kvh * g) * HD + i;
    // the JAX wrapper casts q to the cache's dtype
    const float val = q_is_f32 ? reinterpret_cast<const float*>(qp)[idx]
                               : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(qp)[idx]);
    q_s[i] = __bfloat162float(__float2bfloat16_rn(val));
    acc_s[i] = 0.0f;
  }
  for (int j = tid; j < g; j += ATT_THREADS) {
    m_s[j] = NEG_INF;
    l_s[j] = 0.0f;
  }

  const int c_begin = sp * chunk;
  const int c_end = min(min(c_begin + chunk, S), visible);  // columns < visible are visible
  const __nv_bfloat16* kb = kc + (size_t)bk * S * HD;
  const __nv_bfloat16* vb = vc + (size_t)bk * S * HD;

  for (int t0 = c_begin; t0 < c_end; t0 += T) {
    __syncthreads();  // the previous tile is consumed; q and state are set
    for (int i = tid; i < T * (HD / VEC); i += ATT_THREADS) {
      const int r = i / (HD / VEC);
      const int c = (i % (HD / VEC)) * VEC;
      uint4 k4 = make_uint4(0u, 0u, 0u, 0u), v4 = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < c_end) {
        k4 = *reinterpret_cast<const uint4*>(kb + (size_t)(t0 + r) * HD + c);
        v4 = *reinterpret_cast<const uint4*>(vb + (size_t)(t0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KLD + c]) = k4;
      *reinterpret_cast<uint4*>(&Vs[r * KLD + c]) = v4;
    }
    __syncthreads();

    // scores: one (head, row) a thread
    for (int i = tid; i < g * T; i += ATT_THREADS) {
      const int j = i / T;
      const int r = i % T;
      const float* qj = q_s + j * HD;
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < HD; c += VEC) {
        const uint4 k4 = *reinterpret_cast<const uint4*>(&Ks[r * KLD + c]);
        const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&k4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(kh[e]);
          dot = fmaf(qj[c + 2 * e], kf.x, dot);
          dot = fmaf(qj[c + 2 * e + 1], kf.y, dot);
        }
      }
      s_s[i] = t0 + r < c_end ? __fmul_rn(dot, scale) : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp a head, two columns a lane
    for (int j = warp; j < g; j += ATT_THREADS / 32) {
      const bool ok0 = t0 + lane < c_end;
      const bool ok1 = t0 + lane + 32 < c_end;
      const float s0 = s_s[j * T + lane];
      const float s1 = s_s[j * T + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[j];
      const float m_safe = fmaxf(fmaxf(mx, m_prev), NEG_INF / 2);
      const float corr = expf(m_prev - m_safe);
      const float p0 = ok0 ? expf(s0 - m_safe) : 0.0f;
      const float p1 = ok1 ? expf(s1 - m_safe) : 0.0f;
      float ps = __fadd_rn(p0, p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      p_s[j * T + lane] = __bfloat162float(__float2bfloat16_rn(p0));
      p_s[j * T + lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
      if (lane == 0) {
        l_s[j] = __fadd_rn(__fmul_rn(l_s[j], corr), ps);
        m_s[j] = m_safe;
        c_s[j] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V: one (head, feature) a thread
    for (int i = tid; i < g * HD; i += ATT_THREADS) {
      const int j = i / HD;
      const int c = i % HD;
      const float* pj = p_s + j * T;
      float pv = 0.0f;
#pragma unroll 8
      for (int r = 0; r < T; ++r) pv = fmaf(pj[r], __bfloat162float(Vs[r * KLD + c]), pv);
      acc_s[i] = __fadd_rn(__fmul_rn(acc_s[i], c_s[j]), pv);
    }
  }
  __syncthreads();

  const size_t slot = (size_t)bk * gridDim.x + sp;
  for (int i = tid; i < g * HD; i += ATT_THREADS) acc_part[slot * g * HD + i] = acc_s[i];
  for (int j = tid; j < g; j += ATT_THREADS) {
    m_part[slot * g + j] = m_s[j];
    l_part[slot * g + j] = l_s[j];
  }
}

// P12, pass 2. grid b * h, COMBINE_THREADS threads as (feature c, lane y):
// query head hh = bk * g + j combines its splits, o = sum_i acc_i e^(m_i - M)
// / max(sum_i l_i e^(m_i - M), 1e-30), M the largest m_i clamped to NEG_INF /
// 2. Lane y takes splits y, y + Y, ... in order; lane 0 adds the Y lane sums
// in order.
template <int HD>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_attention_combine(const float* __restrict__ m_part, const float* __restrict__ l_part,
                         const float* __restrict__ acc_part, int splits, int g,
                         void* __restrict__ out, int out_is_f32) {
  constexpr int Y = COMBINE_THREADS / HD;
  __shared__ float red_o[COMBINE_THREADS];
  __shared__ float red_l[COMBINE_THREADS];
  __shared__ float red_m[Y];
  const int hh = blockIdx.x;
  const int bk = hh / g;
  const int j = hh % g;
  const int c = threadIdx.x % HD;
  const int y = threadIdx.x / HD;
  const float* mp = m_part + (size_t)bk * splits * g + j;
  const float* lp = l_part + (size_t)bk * splits * g + j;
  const float* ap = acc_part + ((size_t)bk * splits * g + j) * HD + c;
  float m = NEG_INF;
  for (int sp = y; sp < splits; sp += Y) m = fmaxf(m, mp[(size_t)sp * g]);
  if (c == 0) red_m[y] = m;
  __syncthreads();
  float M = NEG_INF / 2;
  for (int i = 0; i < Y; ++i) M = fmaxf(M, red_m[i]);
  float L = 0.0f, O = 0.0f;
#pragma unroll 4
  for (int sp = y; sp < splits; sp += Y) {
    const float w = expf(mp[(size_t)sp * g] - M);
    L = __fadd_rn(L, __fmul_rn(lp[(size_t)sp * g], w));
    O = __fadd_rn(O, __fmul_rn(ap[(size_t)sp * g * HD], w));
  }
  red_o[threadIdx.x] = O;
  red_l[threadIdx.x] = L;
  __syncthreads();
  if (y != 0) return;
  float Lt = 0.0f, Ot = 0.0f;
  for (int i = 0; i < Y; ++i) {
    Lt = __fadd_rn(Lt, red_l[i * HD + c]);
    Ot = __fadd_rn(Ot, red_o[i * HD + c]);
  }
  const float o = Ot / fmaxf(Lt, 1e-30f);
  const size_t idx = (size_t)hh * HD + c;
  if (out_is_f32)
    reinterpret_cast<float*>(out)[idx] = o;
  else
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
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

template <int HD>
cudaError_t launch_attention(const void* q, int q_is_f32, const void* k, const void* v, int b,
                             int n_kv, int g, int S, int pos, int col0, int splits, float scale,
                             float* m_part, float* l_part, float* acc_part, void* out,
                             cudaStream_t s) {
  const size_t smem = AttSmem<HD>::bytes(g);
  // dynamic shared memory allowed so far on each device (48 KB unasked)
  static size_t raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > raised[dev]) {
    e = cudaFuncSetAttribute(decode_attention_partial<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    raised[dev] = smem;
  }
  // columns s < visible are visible: col0 + s <= pos
  const long long vis = (long long)pos - col0 + 1;
  const int visible = vis < 0 ? 0 : (vis > S ? S : (int)vis);
  const int chunk = ((S + splits - 1) / splits + T - 1) / T * T;
  decode_attention_partial<HD><<<dim3(splits, b * n_kv), ATT_THREADS, smem, s>>>(
      q, q_is_f32, reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), n_kv, g, S, chunk, visible, scale, m_part,
      l_part, acc_part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attention_combine<HD><<<b * n_kv * g, COMBINE_THREADS, 0, s>>>(
      m_part, l_part, acc_part, splits, g, out, q_is_f32);
  return cudaGetLastError();
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
// contiguous and 16-byte aligned; m_part, l_part [b * n_kv, splits, g] and
// acc_part [b * n_kv, splits, g, hd] f32 scratch; out [b, n_kv * g, hd] in
// q's dtype.
extern "C" int decode_attention(const void* q, int q_is_f32, const void* k, const void* v,
                                int b, int n_kv, int g, int S, int hd, int pos, int col0,
                                int splits, float scale, void* m_part, void* l_part,
                                void* acc_part, void* out, void* stream) {
  if (b < 1 || n_kv < 1 || g < 1 || S < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* mp = reinterpret_cast<float*>(m_part);
  float* lp = reinterpret_cast<float*>(l_part);
  float* ap = reinterpret_cast<float*>(acc_part);
  if (hd == 64)
    return (int)launch_attention<64>(q, q_is_f32, k, v, b, n_kv, g, S, pos, col0, splits, scale,
                                     mp, lp, ap, out, s);
  if (hd == 128)
    return (int)launch_attention<128>(q, q_is_f32, k, v, b, n_kv, g, S, pos, col0, splits,
                                      scale, mp, lp, ap, out, s);
  return (int)cudaErrorInvalidValue;
}
