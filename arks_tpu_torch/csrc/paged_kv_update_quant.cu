// In-place quantize-and-write of K/V rows into an int8 or int4 paged pool,
// through the per-token block table.
//
// Replaces the Pallas kernel arks_tpu/ops/paged_attention.py
// `_paged_update_quant_kernel` (launched by `paged_kv_update_quant`) and
// fuses the `quantize_kv` its wrapper runs before it.  Token t's rows
// k_new[t] / v_new[t] ([Hkv, D], f32 or bf16) are quantized per
// (token, head) over D, exactly as the reference computes it:
//   scale = max(amax * (1 / qmax), 1e-8),  q = clip(rint(x / scale), -qmax, qmax)
// with qmax 127 for an int8 pool and 7 for an int4 pool.  The reference
// writes amax / qmax, but it runs under jit, where XLA multiplies by the
// f32 reciprocal of the constant instead; x / scale is an IEEE division
// (the build has no --use_fast_math), the rounding half-to-even (rintf),
// and bf16 inputs convert to f32 exactly before the amax.  The values land at
//   (layer, page = tables[t, idx / P], head, offset = idx % P),  idx = write_idx[t],
// and the f32 scale at the same (layer, page, head, offset) of its stripe.
// A row whose idx is >= MaxP * P (the padding / inactive-lane sentinel) or
// negative is dropped, as is a table entry outside [0, N).
//
// Pool formats (the reference's bytes): an int8 pool is [L, N, Hkv, P, D];
// an int4 pool is [L, N, Hkv, P/2, D] with token 2t in the low nibble and
// 2t+1 in the high nibble of byte row t.
//
// Design.  One warp per (token, KV head): the lanes reduce amax over D
// with shuffles, then each lane quantizes 4 consecutive columns and
// stores them as one 32-bit word.  The TPU kernel's aligned-chunk
// read-modify-write (a workaround for sublane tiles) is gone: the GPU
// store is byte-addressable.
//
// The int4 pair hazard.  Positions 2t and 2t+1 of one prefill chunk share
// a byte row, and their warps run in parallel in no order (the reference
// is safe only because its loop is sequential).  Each lane therefore
// merges its nibbles into the 32-bit word that holds them with two
// atomics: atomicAnd clears this token's nibble of each of the 4 bytes,
// atomicOr sets it.  Two pair-mates touch disjoint nibbles, so every
// interleaving of their four atomics leaves both values; the other nibble
// of a byte whose mate is not in the dispatch keeps the pool's old value,
// as the reference's merge does.  (One thread owning both tokens of a byte
// would need the tokens grouped by pairs; two parity launches would double
// the launch cost, which dominates at decode.)
//
// Bound on the H100: bytes.  A decode step reads T * Hkv * D * 2 input
// elements and writes T * Hkv * (D + 4) * 2 bytes (int8) — tens of KB per
// layer — far under a microsecond of HBM time at 3.35 TB/s, so the launch
// dominates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // (token, head) rows per block

// 4 consecutive elements -> 4 floats (exact for bf16).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) paged_kv_update_quant_kernel(
    int8_t* __restrict__ k_pool, int8_t* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ write_idx, const int* __restrict__ tables,
    int n_tokens, int hkv, int head_dim, int max_pages, int n_pages, int page,
    bool nibbles, int layer) {
  const int row_id = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row_id >= n_tokens * hkv) return;
  const int t = row_id / hkv;
  const int h = row_id % hkv;
  const int idx = write_idx[t];
  if (idx < 0 || idx >= max_pages * page) return;          // dropped row
  const int pg = tables[(int64_t)t * max_pages + idx / page];
  if (pg < 0 || pg >= n_pages) return;
  const int off = idx % page;
  // (layer, page, head) stripe: `page` scales, `rows` byte rows of D.
  const int64_t stripe = ((int64_t)layer * n_pages + pg) * hkv + h;
  const int rows = nibbles ? page / 2 : page;
  const int64_t dst = (stripe * rows + (nibbles ? off / 2 : off)) * head_dim;
  const int64_t src = ((int64_t)t * hkv + h) * head_dim;
  const float qmax = nibbles ? 7.f : 127.f;
  const float inv_qmax = __fdiv_rn(1.f, qmax);
  const int words = head_dim / 4;
  const int shift = (off & 1) * 4;  // int4: this token's nibble

  for (int kv = 0; kv < 2; ++kv) {
    const T* x = (kv ? v_new : k_new) + src;
    int8_t* pool = kv ? v_pool : k_pool;
    float amax = 0.f;
    for (int w = lane; w < words; w += 32) {
      float f[4];
      load4(x + 4 * w, f);
#pragma unroll
      for (int u = 0; u < 4; ++u) amax = fmaxf(amax, fabsf(f[u]));
    }
    amax = warp_max(amax);
    const float scale = fmaxf(__fmul_rn(amax, inv_qmax), 1e-8f);
    for (int w = lane; w < words; w += 32) {
      float f[4];
      load4(x + 4 * w, f);
      uint32_t bytes = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float r = fminf(fmaxf(rintf(__fdiv_rn(f[u], scale)), -qmax), qmax);
        const uint32_t b = (uint32_t)(int)r & (nibbles ? 0x0Fu : 0xFFu);
        bytes |= b << (8 * u);
      }
      uint32_t* word = reinterpret_cast<uint32_t*>(pool + dst + 4 * w);
      if (nibbles) {
        atomicAnd(word, ~(0x0F0F0F0Fu << shift));
        atomicOr(word, bytes << shift);
      } else {
        *word = bytes;
      }
    }
    if (lane == 0) (kv ? v_scale : k_scale)[stripe * page + off] = scale;
  }
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (k_new / v_new).  Pools int8, scales
// f32, head_dim % 4 == 0, every pointer 16-byte aligned; nibbles != 0 for
// an int4 pool (page even).  The wrapper checks all of these and raises.
int arks_paged_kv_update_quant(void* k_pool, void* v_pool, void* k_scale,
                               void* v_scale, const void* k_new,
                               const void* v_new, const void* write_idx,
                               const void* tables, int n_tokens, int hkv,
                               int head_dim, int max_pages, int n_pages,
                               int page, int nibbles, int layer, int dtype,
                               void* stream) {
  if (n_tokens <= 0 || hkv <= 0) return 0;
  if (head_dim <= 0 || head_dim % 4 != 0 || page <= 0 || (nibbles && page % 2))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_tokens * hkv + kWarps - 1) / kWarps;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    paged_kv_update_quant_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        (int8_t*)k_pool, (int8_t*)v_pool, (float*)k_scale, (float*)v_scale,
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (const int*)write_idx, (const int*)tables, n_tokens, hkv, head_dim,
        max_pages, n_pages, page, nibbles != 0, layer);
  } else if (dtype == 0) {
    paged_kv_update_quant_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        (int8_t*)k_pool, (int8_t*)v_pool, (float*)k_scale, (float*)v_scale,
        (const float*)k_new, (const float*)v_new, (const int*)write_idx,
        (const int*)tables, n_tokens, hkv, head_dim, max_pages, n_pages, page,
        nibbles != 0, layer);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
