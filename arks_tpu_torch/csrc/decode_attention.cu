// Decode attention, one query token per slot, over each slot's valid KV
// prefix: the slot-contiguous cache [L, B, Hkv, S, D] and the paged pool
// [L, N, Hkv, P, D] through the slot's block table.
//
// Replaces two Pallas kernels, one entry point each:
//  - arks_ragged_decode_attention: arks_tpu/ops/pallas_attention.py
//    `_attn_kernel` (launched by `ragged_decode_attention`).  Slot b reads
//    positions [0, min(lengths[b], S)) of its stripe: a parked slot
//    (write index S, so lengths = S + 1) reads the whole stripe and nothing
//    past it, as the Pallas grid stops at S / block_s.
//  - arks_paged_decode_attention: arks_tpu/ops/paged_attention.py
//    `_paged_attn_kernel` (launched by `paged_decode_attention`).  Slot b
//    reads positions [0, lengths[b]) through pages tables[b, 0..]; pages
//    past its length are never touched (the TPU kernel skips their DMA and
//    zeroes their V buffers).
// Both are one kernel: the slot cache is a pool whose page is the whole
// stripe (P = S, N = B) and whose table is the identity (page b of slot b).
//
// What it computes is the reference's: for each (slot, KV head) the G
// query heads of that head attend the prefix; scores are f32 (q.k in f32,
// then * 1/sqrt(D), then, for an int8 cache, * the per-token k scale),
// the softmax is online with f32 m and l over 64-token tiles, p (times the
// per-token v scale of an int8 cache) is rounded to the V dtype (q's dtype
// for int8) before p.V, and the output is acc / (l + 1e-9) cast to q's
// dtype.  Rows at or past the length are never loaded, so no V row of an
// unwritten or skipped position reaches p.V.  A slot of length 0 gets a
// zero output (the reference's is garbage no one samples: every score of
// it is masked).
//
// Design.  One CTA per (slot, KV head), one warp per query head of its
// group (G <= 8), the K/V tile of 64 tokens in shared memory shared by the
// G warps (K rows padded by 16 bytes so the lane-per-token column reads
// are bank-conflict free).  An int8 tile is converted to q's dtype on the
// copy into shared memory (exact for |v| <= 127), its scales beside it.
//
// Bound on the H100: bytes.  Each (slot, KV head) reads its K and V prefix
// once (context x 128 x 2 B x 2 for bf16; half that plus 8 B of scales per
// token for int8) at 3.35 TB/s and does 2 flops per byte per query head —
// far below the ridge.  This first kernel is the simple, correct one:
// CUDA-core f32 FMAs, no copy/compute overlap and no split over the
// context, so a decode batch fills only B x Hkv CTAs (32 of 132 SMs at
// 8 slots x 4 KV heads); split-KV and cp.async/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // one warp per query head of the group
constexpr int kThreads = kWarps * 32;
constexpr int kKT = 64;              // KV tokens per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// p.astype(v.dtype): round to the V dtype, keep computing in f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 16 bytes of T -> 16/sizeof(T) floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    out[2 * u] = f.x;
    out[2 * u + 1] = f.y;
  }
}

// 16 int8 cache bytes -> 16 T at dst (16-byte aligned), exactly.
__device__ __forceinline__ void dequant16(const int8_t* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int u = 0; u < 16; u += 4)
    *reinterpret_cast<float4*>(dst + u) =
        make_float4((float)b[u], (float)b[u + 1], (float)b[u + 2],
                    (float)b[u + 3]);
}
__device__ __forceinline__ void dequant16(const int8_t* src,
                                          __nv_bfloat16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint4 out[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    h[u] = __floats2bfloat162_rn((float)b[2 * u], (float)b[2 * u + 1]);
  *reinterpret_cast<uint4*>(dst) = out[0];
  *reinterpret_cast<uint4*>(dst + 8) = out[1];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// KV is the cache's element type: T itself, or int8_t for an int8 cache.
// The shared-memory tiles hold T in both cases.
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * kWarps * D                // queries, f32
         + sizeof(T) * kKT * (D + 16 / sizeof(T))  // K tile, padded rows
         + sizeof(T) * kKT * D                     // V tile
         + sizeof(float) * kWarps * kKT            // per-warp p row
         + sizeof(float) * 2 * kKT;                // k and v scale tiles
}

// tables == NULL: the slot layout (page = S, n_pages = B, max_pages = 1,
// slot b's one page is b).
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, T* __restrict__ out,
    const KV* __restrict__ k_pool, const KV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    int hkv, int group, int page, int n_pages, int max_pages, int layer,
    float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KSTRIDE = D + VEC;
  constexpr int DPL = D / 32;   // output columns per lane
  constexpr int TPL = kKT / 32; // tile tokens per lane in the score pass

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool active = warp < group;
  const int64_t qrow = ((int64_t)b * hkv + h) * group;   // first of G rows
  // Clamp to the table's coverage: a parked slot's length is S + 1.
  const int len = min(lengths[b], max_pages * page);
  if (len <= 0) {
    if (active) {
      T* o = out + (qrow + warp) * D + lane * DPL;
#pragma unroll
      for (int a = 0; a < DPL; ++a) o[a] = from_float<T>(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* ks = reinterpret_cast<T*>(qs + kWarps * D);
  T* vs = ks + kKT * KSTRIDE;
  float* ps = reinterpret_cast<float*>(vs + kKT * D);
  float* kss = ps + kWarps * kKT;   // tile's k scales (int8 caches)
  float* vss = kss + kKT;

  for (int e = tid; e < group * D; e += kThreads) qs[e] = to_float(q[qrow * D + e]);

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int a = 0; a < DPL; ++a) acc[a] = 0.f;
  const float* qw = qs + warp * D;
  float* pw = ps + warp * kKT;
  const int last_page = (len - 1) / page;

  for (int p = 0; p <= last_page; ++p) {
    const int pg = tables ? tables[(int64_t)b * max_pages + p] : b;
    if (pg < 0 || pg >= n_pages) continue;   // a table entry outside the pool
    // The (layer, page, head) stripe: `page` rows of D and `page` scales.
    const int64_t stripe = ((int64_t)layer * n_pages + pg) * hkv + h;
    const int64_t base = stripe * page * D;
    for (int tok0 = 0; tok0 < page; tok0 += kKT) {
      const int kv0 = p * page + tok0;
      if (kv0 >= len) break;
      const int nt = min(min(kKT, page - tok0), len - kv0);
      __syncthreads();  // every warp is done with the previous tile
      if (QUANT) {
        for (int e = tid; e < nt * (D / 16); e += kThreads) {
          const int j = e / (D / 16);
          const int c = (e % (D / 16)) * 16;
          const int64_t src = base + (int64_t)(tok0 + j) * D + c;
          dequant16(reinterpret_cast<const int8_t*>(k_pool + src),
                    ks + j * KSTRIDE + c);
          dequant16(reinterpret_cast<const int8_t*>(v_pool + src),
                    vs + j * D + c);
        }
        for (int j = tid; j < kKT; j += kThreads) {
          const bool in = j < nt;
          kss[j] = in ? k_scale[stripe * page + tok0 + j] : 0.f;
          vss[j] = in ? v_scale[stripe * page + tok0 + j] : 0.f;
        }
      } else {
        for (int e = tid; e < nt * (D / VEC); e += kThreads) {
          const int j = e / (D / VEC);
          const int c = (e % (D / VEC)) * VEC;
          const int64_t src = base + (int64_t)(tok0 + j) * D + c;
          *reinterpret_cast<uint4*>(ks + j * KSTRIDE + c) =
              *reinterpret_cast<const uint4*>(
                  reinterpret_cast<const T*>(k_pool) + src);
          *reinterpret_cast<uint4*>(vs + j * D + c) =
              *reinterpret_cast<const uint4*>(
                  reinterpret_cast<const T*>(v_pool) + src);
        }
      }
      __syncthreads();
      if (!active) continue;
      float sc[TPL];
      float mc = kNegInf;
#pragma unroll
      for (int c = 0; c < TPL; ++c) {
        const int j = lane + 32 * c;
        float dot = 0.f;
        if (j < nt) {
          const T* kr = ks + j * KSTRIDE;
#pragma unroll
          for (int d = 0; d < D; d += VEC) {
            float kf[VEC];
            load16(kr + d, kf);
#pragma unroll
            for (int u = 0; u < VEC; ++u) dot = fmaf(qw[d + u], kf[u], dot);
          }
        }
        float sv = dot * scale;
        if (QUANT) sv *= kss[j];
        sc[c] = j < nt ? sv : kNegInf;
        mc = fmaxf(mc, sc[c]);
      }
      // The first tile holds position 0, so m is finite from here on and a
      // masked score's p is exactly 0.
      mc = warp_max(mc);
      const float m_next = fmaxf(m, mc);
      const float corr = expf(m - m_next);
      float lsum = 0.f;
#pragma unroll
      for (int c = 0; c < TPL; ++c) {
        const float pv = expf(sc[c] - m_next);
        lsum += pv;
        pw[lane + 32 * c] = round_to<T>(QUANT ? pv * vss[lane + 32 * c] : pv);
      }
      lsum = warp_sum(lsum);
      l = l * corr + lsum;
      m = m_next;
      __syncwarp();
#pragma unroll
      for (int a = 0; a < DPL; ++a) acc[a] *= corr;
      for (int j = 0; j < nt; ++j) {
        const float pj = pw[j];
        const T* vr = vs + j * D + lane * DPL;
#pragma unroll
        for (int a = 0; a < DPL; ++a) acc[a] = fmaf(pj, to_float(vr[a]), acc[a]);
      }
      __syncwarp();
    }
  }

  if (!active) return;
  T* o = out + (qrow + warp) * D + lane * DPL;
#pragma unroll
  for (int a = 0; a < DPL; ++a) o[a] = from_float<T>(acc[a] / (l + 1e-9f));
}

template <typename T, typename KV, int D>
int launch(const void* q, void* out, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* lengths, int n_slots, int hkv, int group, int page,
           int n_pages, int max_pages, int layer, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, KV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, KV, D><<<n_slots * hkv, kThreads, smem, stream>>>(
      (const T*)q, (T*)out, (const KV*)k_pool, (const KV*)v_pool, k_scale,
      v_scale, tables, lengths, hkv, group, page, n_pages, max_pages, layer,
      scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, void* out, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* lengths, int n_slots, int n_heads, int hkv,
             int head_dim, int page, int n_pages, int max_pages, int layer,
             float scale, int dtype, int quant, void* stream) {
  if (n_slots <= 0) return 0;
  if (hkv <= 0 || n_heads % hkv != 0 || n_heads / hkv > kWarps ||
      page <= 0 || (quant && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  const int group = n_heads / hkv;
  const cudaStream_t st = (cudaStream_t)stream;
#define ARKS_ARGS                                                             \
  q, out, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,       \
      (const int*)tables, (const int*)lengths, n_slots, hkv, group, page,     \
      n_pages, max_pages, layer, scale, st
  if (dtype == 1 && head_dim == 128)
    return quant ? launch<__nv_bfloat16, int8_t, 128>(ARKS_ARGS)
                 : launch<__nv_bfloat16, __nv_bfloat16, 128>(ARKS_ARGS);
  if (dtype == 1 && head_dim == 64)
    return quant ? launch<__nv_bfloat16, int8_t, 64>(ARKS_ARGS)
                 : launch<__nv_bfloat16, __nv_bfloat16, 64>(ARKS_ARGS);
  if (dtype == 0 && head_dim == 128)
    return quant ? launch<float, int8_t, 128>(ARKS_ARGS)
                 : launch<float, float, 128>(ARKS_ARGS);
  if (dtype == 0 && head_dim == 64)
    return quant ? launch<float, int8_t, 64>(ARKS_ARGS)
                 : launch<float, float, 64>(ARKS_ARGS);
#undef ARKS_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q / out [B, Hkv, G, D] of dtype (0 = float32, 1 = bfloat16); caches
// [L, B, Hkv, S, D] of q's dtype (quant 0, scales NULL) or int8 (quant 1)
// with f32 scales [L, B, Hkv, S]; lengths [B] int32.  head_dim 64 or 128,
// G = n_heads / hkv <= 8; the wrapper checks all of these and raises.
int arks_ragged_decode_attention(const void* q, void* out, const void* k_cache,
                                 const void* v_cache, const void* k_scale,
                                 const void* v_scale, const void* lengths,
                                 int n_slots, int n_heads, int hkv,
                                 int head_dim, int max_len, int layer,
                                 float scale, int dtype, int quant,
                                 void* stream) {
  return dispatch(q, out, k_cache, v_cache, k_scale, v_scale, nullptr,
                  lengths, n_slots, n_heads, hkv, head_dim, max_len, n_slots,
                  1, layer, scale, dtype, quant, stream);
}

// As above over the paged pool [L, N, Hkv, P, D] (scales [L, N, Hkv, P])
// through tables [B, max_pages] int32; lengths past max_pages * P clamp.
int arks_paged_decode_attention(const void* q, void* out, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* lengths, int n_slots, int n_heads,
                                int hkv, int head_dim, int page, int n_pages,
                                int max_pages, int layer, float scale,
                                int dtype, int quant, void* stream) {
  if (!tables) return (int)cudaErrorInvalidValue;
  return dispatch(q, out, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                  n_slots, n_heads, hkv, head_dim, page, n_pages, max_pages,
                  layer, scale, dtype, quant, stream);
}

}  // extern "C"
