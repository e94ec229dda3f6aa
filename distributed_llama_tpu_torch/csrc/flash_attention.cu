// K3: causal GQA flash attention forward over the KV cache, from a scalar
// pos_start: o = softmax(q k^T * scale + causal) v, for a prefill chunk.
//
// Replaces the JAX package's ops/pallas_attention.py flash_attention (:199),
// bodies _attend_block (:46) and _kernel (:103).
//
// What bounds it on Hopper: at prefill chunk sizes (t <= 32 query tokens
// against a cache view of S >= 256 rows), memory: the K/V rows up to the
// causal limit are read once per (batch, kv head, query tile), and the
// flops per byte are ~2 * rows, far under the tensor cores' ratio.
//
// Design:
//   * one CTA per (batch * kv head, tile of 64 score rows). The g query
//     heads of a kv head fold into the rows as _attend_block folds them:
//     row R is token R / g, head kvh * g + R % g, position pos_start + R / g.
//   * the cache is read IN PLACE through strides from its [b, S, n_kv, hd]
//     view of the stacked [L, b, S, n_kv, hd] cache: no transpose copy
//     (the JAX wrapper's _flash_operands makes XLA materialize one).
//   * KV tiles of 64 rows stream through shared memory only up to the
//     causal limit pos_start + (last token of the tile); later tiles are
//     never loaded.
//   * S = Q K^T and P V run on the tensor cores (WMMA bf16 m16n16k16, f32
//     accumulate); each warp owns 16 rows. The online softmax runs in f32
//     exactly as _attend_block: masked scores are NEG_INF, m is clamped to
//     NEG_INF / 2 so fully masked rows stay finite, P is cast to bf16
//     before PV, acc = acc * corr + pv and l = l * corr + sum(p) with
//     separate roundings, and the end divides by max(l, 1e-30).
//   * templated on head_dim 64 (Llama) and 128 (Qwen3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int ROWS = 64;   // score rows per CTA
constexpr int BS = 64;     // KV rows per tile
constexpr int WARPS = ROWS / 16;
constexpr float NEG_INF = -FLT_MAX;

template <int HD>
struct Smem {
  static constexpr int QLD = HD + 8;   // bf16 leading dims (multiples of 8)
  static constexpr int SLD = BS + 4;   // f32
  static constexpr int PLD = BS + 8;   // bf16
  static constexpr int OLD = HD + 4;   // f32
  static constexpr size_t q = (size_t)ROWS * QLD * 2;
  static constexpr size_t k = (size_t)BS * QLD * 2;
  static constexpr size_t v = (size_t)BS * QLD * 2;
  static constexpr size_t s = (size_t)ROWS * SLD * 4;
  static constexpr size_t p = (size_t)ROWS * PLD * 2;
  static constexpr size_t o = (size_t)ROWS * OLD * 4;
  static constexpr size_t stats = (size_t)3 * ROWS * 4;
  static constexpr size_t total = q + k + v + s + p + 2 * o + stats;
};

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_fwd_kernel(const void* __restrict__ qp, int q_is_f32,
                           const __nv_bfloat16* __restrict__ kc,
                           const __nv_bfloat16* __restrict__ vc, long long ksb,
                           long long kss, long long ksh, float* __restrict__ o, int t,
                           int S, int n_heads, int n_kv, int pos_start, float scale) {
  using L = Smem<HD>;
  extern __shared__ __align__(32) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::q + L::k);
  float* Ss = reinterpret_cast<float*>(smem + L::q + L::k + L::v);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::q + L::k + L::v + L::s);
  float* Os = reinterpret_cast<float*>(smem + L::q + L::k + L::v + L::s + L::p);
  float* PVs = Os + ROWS * L::OLD;
  float* m_s = PVs + ROWS * L::OLD;
  float* l_s = m_s + ROWS;
  float* c_s = l_s + ROWS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = n_heads / n_kv;
  const int bk = blockIdx.x;
  const int bi = bk / n_kv;
  const int kvh = bk % n_kv;
  const int row0 = blockIdx.y * ROWS;  // first score row of this tile
  const int n_rows = t * g;

  // Q tile -> bf16 (the JAX wrapper casts q to the cache dtype)
  for (int i = tid; i < ROWS * HD; i += WARPS * 32) {
    const int r = i / HD;
    const int dd = i % HD;
    const int R = row0 + r;
    float val = 0.0f;
    if (R < n_rows) {
      const int tok = R / g;
      const int head = kvh * g + R % g;
      const size_t idx = (((size_t)bi * t + tok) * n_heads + head) * HD + dd;
      val = q_is_f32 ? reinterpret_cast<const float*>(qp)[idx]
                     : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(qp)[idx]);
    }
    Qs[r * L::QLD + dd] = __float2bfloat16_rn(val);
  }
  for (int i = tid; i < ROWS * L::OLD; i += WARPS * 32) Os[i] = 0.0f;
  for (int i = tid; i < ROWS; i += WARPS * 32) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }

  // causal limit: the tile's last real token
  const int last_row = min(row0 + ROWS, n_rows) - 1;
  const int last_pos = pos_start + last_row / g;
  const int kv_end = min(S, last_pos + 1);
  const int n_tiles = (kv_end + BS - 1) / BS;

  const __nv_bfloat16* kbase = kc + (size_t)bi * ksb + (size_t)kvh * ksh;
  const __nv_bfloat16* vbase = vc + (size_t)bi * ksb + (size_t)kvh * ksh;
  constexpr int VEC = 8;  // bf16 per 16-byte load

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // previous tile's K/V fully consumed; Q/O init visible
    for (int i = tid; i < BS * (HD / VEC); i += WARPS * 32) {
      const int r = i / (HD / VEC);
      const int c = (i % (HD / VEC)) * VEC;
      const int s = j * BS + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (s < S) {
        kv4 = *reinterpret_cast<const uint4*>(kbase + (size_t)s * kss + c);
        vv4 = *reinterpret_cast<const uint4*>(vbase + (size_t)s * kss + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * L::QLD + c]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r * L::QLD + c]) = vv4;
    }
    __syncthreads();

    // scores for this warp's 16 rows: [16, BS] = Q_w [16, HD] . K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc[BS / 16];
#pragma unroll
      for (int n = 0; n < BS / 16; ++n) wmma::fill_fragment(sc[n], 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &Qs[(warp * 16) * L::QLD + kk * 16], L::QLD);
#pragma unroll
        for (int n = 0; n < BS / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr;
          wmma::load_matrix_sync(bfr, &Ks[(n * 16) * L::QLD + kk * 16], L::QLD);
          wmma::mma_sync(sc[n], a, bfr, sc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BS / 16; ++n)
        wmma::store_matrix_sync(&Ss[(warp * 16) * L::SLD + n * 16], sc[n], L::SLD,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (2 columns a lane)
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const int row_pos = pos_start + (row0 + r) / g;
      const int c0 = j * BS + lane;
      const int c1 = c0 + 32;
      const bool ok0 = c0 <= row_pos && c0 < S;
      const bool ok1 = c1 <= row_pos && c1 < S;
      const float s0 = ok0 ? __fmul_rn(Ss[r * L::SLD + lane], scale) : NEG_INF;
      const float s1 = ok1 ? __fmul_rn(Ss[r * L::SLD + lane + 32], scale) : NEG_INF;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_safe = fmaxf(fmaxf(mx, m_prev), NEG_INF / 2);
      const float corr = expf(m_prev - m_safe);
      const float p0 = ok0 ? expf(s0 - m_safe) : 0.0f;
      const float p1 = ok1 ? expf(s1 - m_safe) : 0.0f;
      float ps = __fadd_rn(p0, p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, off));
      Ps[r * L::PLD + lane] = __float2bfloat16_rn(p0);
      Ps[r * L::PLD + lane + 32] = __float2bfloat16_rn(p1);
      __syncwarp();
      if (lane == 0) {
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), ps);
        m_s[r] = m_safe;
        c_s[r] = corr;
      }
    }
    __syncwarp();

    // pv = P_w [16, BS] . V [BS, HD]
    {
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < BS / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr;
          wmma::load_matrix_sync(a, &Ps[(warp * 16) * L::PLD + kk * 16], L::PLD);
          wmma::load_matrix_sync(bfr, &Vs[(kk * 16) * L::QLD + n * 16], L::QLD);
          wmma::mma_sync(acc, a, bfr, acc);
        }
        wmma::store_matrix_sync(&PVs[(warp * 16) * L::OLD + n * 16], acc, L::OLD,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = warp * 16 + i / HD;
      const int dd = i % HD;
      float* a = &Os[r * L::OLD + dd];
      *a = __fadd_rn(__fmul_rn(*a, c_s[r]), PVs[r * L::OLD + dd]);
    }
  }
  __syncthreads();

  for (int i = tid; i < ROWS * HD; i += WARPS * 32) {
    const int r = i / HD;
    const int dd = i % HD;
    const int R = row0 + r;
    if (R >= n_rows) continue;
    const int tok = R / g;
    const int head = kvh * g + R % g;
    const float l = fmaxf(l_s[r], 1e-30f);
    o[(((size_t)bi * t + tok) * n_heads + head) * HD + dd] = Os[r * L::OLD + dd] / l;
  }
}

template <int HD>
cudaError_t launch(const void* q, int q_is_f32, const void* k, const void* v,
                   long long ksb, long long kss, long long ksh, void* o, int b,
                   int t, int S, int n_heads, int n_kv, int pos_start, float scale,
                   cudaStream_t stream) {
  const size_t smem = Smem<HD>::total;
  static bool raised = false;
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const int g = n_heads / n_kv;
  dim3 grid(b * n_kv, (t * g + ROWS - 1) / ROWS);
  flash_attention_fwd_kernel<HD><<<grid, WARPS * 32, smem, stream>>>(
      q, q_is_f32, reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), ksb, kss, ksh,
      reinterpret_cast<float*>(o), t, S, n_heads, n_kv, pos_start, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [b, t, n_heads, hd] f32 or bf16, contiguous; k, v: bf16 [b, S, n_kv, hd]
// views with unit stride on hd and element strides (ksb, kss, ksh), shared by
// k and v; o [b, t, n_heads, hd] f32, contiguous.
extern "C" int flash_attention_fwd(const void* q, int q_is_f32, const void* k,
                                   const void* v, long long ksb, long long kss,
                                   long long ksh, void* o, int b, int t, int S,
                                   int n_heads, int n_kv, int head_dim, int pos_start,
                                   float scale, void* stream) {
  if (b < 1 || t < 1 || S < 1 || n_kv < 1 || n_heads % n_kv != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      (ksb | kss | ksh) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv,
                           pos_start, scale, s);
  if (head_dim == 128)
    return (int)launch<128>(q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv,
                            pos_start, scale, s);
  return (int)cudaErrorInvalidValue;
}
