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
// int8 K and V (ps * h_kv * (hd + 4) bytes each, scales included) once per
// (row, kv head) and does ~4 * g * hd flops per byte pair: far below the
// tensor cores' ratio, so the bound is the bytes of the pages the causal
// limit needs.
//
// Design (right and simple first): one CTA of 4 warps per (row, kv head)
// and tile of 16 score rows (the g query heads of the kv head folded into
// the rows as the Pallas kernel folds them: row R is token R / g, head
// kvh * g + R % g). For each page: the page's K and V vectors of this kv
// head are dequantized into shared memory in f32; scores use one warp per
// token of the page (lanes split head_dim, a shuffle reduction per row);
// the online softmax and P . V use one warp per score row (lanes split the
// page's tokens, then head_dim), with the row's accumulator in registers.
// f32 CUDA-core math throughout. Split-K over pages (flash-decoding), int8
// tensor-core dots and TMA page loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int RT = 16;       // score rows per CTA
constexpr int PS_MAX = 64;   // largest page size the shared buffers hold
constexpr float NEG_INF = -FLT_MAX;
constexpr int MAX_DEVICES = 64;  // shared-memory opt-ins are kept per device

template <int HD>
size_t smem_bytes(int ps) {
  return sizeof(float) * ((size_t)RT * HD + 2 * (size_t)ps * HD + (size_t)RT * ps);
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
paged_attention_kernel(const void* __restrict__ qp, int q_is_f32,
                       const int8_t* __restrict__ kpool, const int8_t* __restrict__ vpool,
                       const float* __restrict__ kscale, const float* __restrict__ vscale,
                       const int* __restrict__ table, int table_stride,
                       const long long* __restrict__ pos_base, void* __restrict__ out,
                       int t, int n_heads, int n_kv, int ps, int n_read, int n_pages,
                       float scale) {
  constexpr int EPL = HD / 32;  // head_dim elements per lane
  constexpr int RPW = RT / WARPS;  // score rows per warp
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [RT][HD]
  float* ks = qs + RT * HD;      // [ps][HD]
  float* vs = ks + ps * HD;      // [ps][HD]
  float* sc = vs + ps * HD;      // [RT][ps] scores, then probabilities

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = n_heads / n_kv;
  const int bi = blockIdx.x / n_kv;
  const int kvh = blockIdx.x % n_kv;
  const int row0 = blockIdx.y * RT;
  const int n_rows = t * g;
  const long long pb = pos_base[bi];
  const long long last_pos = pb + t - 1;

  for (int i = tid; i < RT * HD; i += WARPS * 32) {
    const int r = i / HD;
    const int e = i % HD;
    const int R = row0 + r;
    float val = 0.0f;
    if (R < n_rows) {
      const size_t idx = (((size_t)bi * t + R / g) * n_heads + kvh * g + R % g) * HD + e;
      val = q_is_f32 ? reinterpret_cast<const float*>(qp)[idx]
                     : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(qp)[idx]);
    }
    qs[i] = val;
  }

  // per warp-owned row: running max, exp-sum, accumulator (replicated
  // across the warp's lanes; lane holds head_dim elements lane + 32 * j)
  float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[i][j] = 0.0f;
  }

  const size_t page_elems = (size_t)ps * n_kv * HD;
  for (int pi = 0; pi < n_read; ++pi) {
    if ((long long)pi * ps > last_pos) continue;  // uniform over the CTA
    int page = table[(size_t)bi * table_stride + pi];
    page = min(max(page, 0), n_pages - 1);
    __syncthreads();  // the previous page's K/V and probabilities are consumed
    const int8_t* kb = kpool + (size_t)page * page_elems;
    const int8_t* vb = vpool + (size_t)page * page_elems;
    const float* ksb = kscale + (size_t)page * ps * n_kv;
    const float* vsb = vscale + (size_t)page * ps * n_kv;
    for (int i = tid; i < ps * (HD / 4); i += WARPS * 32) {
      const int s = i / (HD / 4);
      const int c = (i % (HD / 4)) * 4;
      const size_t off = ((size_t)s * n_kv + kvh) * HD + c;
      const char4 k4 = *reinterpret_cast<const char4*>(kb + off);
      const char4 v4 = *reinterpret_cast<const char4*>(vb + off);
      const float kf = ksb[(size_t)s * n_kv + kvh];
      const float vf = vsb[(size_t)s * n_kv + kvh];
      float* kd = ks + s * HD + c;
      float* vd = vs + s * HD + c;
      kd[0] = __fmul_rn((float)k4.x, kf);
      kd[1] = __fmul_rn((float)k4.y, kf);
      kd[2] = __fmul_rn((float)k4.z, kf);
      kd[3] = __fmul_rn((float)k4.w, kf);
      vd[0] = __fmul_rn((float)v4.x, vf);
      vd[1] = __fmul_rn((float)v4.y, vf);
      vd[2] = __fmul_rn((float)v4.z, vf);
      vd[3] = __fmul_rn((float)v4.w, vf);
    }
    __syncthreads();

    // scores: warp w takes tokens w, w + 4, ...; every row of the tile
    for (int s = warp; s < ps; s += WARPS) {
      float kr[EPL];
#pragma unroll
      for (int j = 0; j < EPL; ++j) kr[j] = ks[s * HD + lane + 32 * j];
      const long long col = (long long)pi * ps + s;
      for (int r = 0; r < RT; ++r) {
        const int R = row0 + r;
        if (R >= n_rows) break;
        float d = 0.0f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) d = fmaf(qs[r * HD + lane + 32 * j], kr[j], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (lane == 0) sc[r * ps + s] = col <= pb + R / g ? __fmul_rn(d, scale) : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax and P . V: warp w owns rows w, w + 4, ...
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      const int R = row0 + r;
      if (R >= n_rows) continue;  // uniform over the warp
      const long long row_pos = pb + R / g;
      float mx = NEG_INF;
      for (int s = lane; s < ps; s += 32) mx = fmaxf(mx, sc[r * ps + s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_safe = fmaxf(fmaxf(mx, m[i]), NEG_INF / 2);
      const float corr = expf(m[i] - m_safe);
      float psum = 0.0f;
      for (int s = lane; s < ps; s += 32) {
        const long long col = (long long)pi * ps + s;
        const float p = col <= row_pos ? expf(sc[r * ps + s] - m_safe) : 0.0f;
        sc[r * ps + s] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      __syncwarp();
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), psum);
      m[i] = m_safe;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = lane + 32 * j;
        float pv = 0.0f;
        for (int s = 0; s < ps; ++s) pv = fmaf(sc[r * ps + s], vs[s * HD + e], pv);
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr), pv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    const int R = row0 + r;
    if (R >= n_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const size_t base = (((size_t)bi * t + R / g) * n_heads + kvh * g + R % g) * HD;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const float o = acc[i][j] / denom;
      const int e = lane + 32 * j;
      if (q_is_f32)
        reinterpret_cast<float*>(out)[base + e] = o;
      else
        reinterpret_cast<__nv_bfloat16*>(out)[base + e] = __float2bfloat16_rn(o);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, int q_is_f32, const int8_t* k, const int8_t* v,
                   const float* ks, const float* vs, const int* table, int table_stride,
                   const long long* pos_base, void* out, int b, int t, int n_heads, int n_kv,
                   int ps, int n_read, int n_pages, float scale, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {};  // the opt-in is per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(paged_attention_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<HD>(PS_MAX));
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  const int g = n_heads / n_kv;
  dim3 grid(b * n_kv, (t * g + RT - 1) / RT);
  paged_attention_kernel<HD><<<grid, WARPS * 32, smem_bytes<HD>(ps), stream>>>(
      q, q_is_f32, k, v, ks, vs, table, table_stride, pos_base, out, t, n_heads, n_kv, ps,
      n_read, n_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dlt_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [b, t, n_heads, hd] f32 or bf16, contiguous; k_pool, v_pool int8 [L,
// n_pages, ps, n_kv, hd] and k_scale, v_scale f32 [L, n_pages, ps, n_kv],
// all contiguous; table int32 [b, table_stride] (-1 = unmapped); pos_base
// int64 [b]; out [b, t, n_heads, hd] in q's dtype. The layer only offsets
// the pool pointers.
extern "C" int paged_attention_fwd(const void* q, int q_is_f32, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* table, int table_stride,
                                   const void* pos_base, void* out, int b, int t, int n_heads,
                                   int n_kv, int head_dim, int ps, int n_read, int n_pages,
                                   long long layer, float scale, void* stream) {
  if (b < 1 || t < 1 || n_kv < 1 || n_heads % n_kv != 0 || n_read < 1 || n_pages < 1 ||
      table_stride < n_read || ps < 1 || ps > PS_MAX || (ps & (ps - 1)) != 0 || t > ps)
    return (int)cudaErrorInvalidValue;
  const size_t layer_elems = (size_t)n_pages * ps * n_kv * head_dim;
  const size_t layer_scales = (size_t)n_pages * ps * n_kv;
  const int8_t* k = reinterpret_cast<const int8_t*>(k_pool) + (size_t)layer * layer_elems;
  const int8_t* v = reinterpret_cast<const int8_t*>(v_pool) + (size_t)layer * layer_elems;
  const float* ks = reinterpret_cast<const float*>(k_scale) + (size_t)layer * layer_scales;
  const float* vs = reinterpret_cast<const float*>(v_scale) + (size_t)layer * layer_scales;
  const int* tb = reinterpret_cast<const int*>(table);
  const long long* pb = reinterpret_cast<const long long*>(pos_base);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return (int)launch<64>(q, q_is_f32, k, v, ks, vs, tb, table_stride, pb, out, b, t,
                           n_heads, n_kv, ps, n_read, n_pages, scale, s);
  if (head_dim == 128)
    return (int)launch<128>(q, q_is_f32, k, v, ks, vs, tb, table_stride, pb, out, b, t,
                            n_heads, n_kv, ps, n_read, n_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}
