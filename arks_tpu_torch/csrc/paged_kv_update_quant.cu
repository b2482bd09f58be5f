// In-place quantize-and-write of K/V rows into an int8 or int4 paged pool,
// through the per-token block table or a destination resolved once per
// step.
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
// negative is dropped, as is a table entry outside [0, N).  With `dst`
// (the step's `paged_write_rows`: page * P + offset per token, -1 =
// dropped, the same for every layer) the kernel reads that one int
// instead of write_idx and the table entry, as the reference reads its
// scalar-prefetched indices from SMEM; the layer offset is added here, in
// int64.
//
// Pool formats (the reference's bytes): an int8 pool is [L, N, Hkv, P, D];
// an int4 pool is [L, N, Hkv, P/2, D] with token 2t in the low nibble and
// 2t+1 in the high nibble of byte row t.
//
// Bound on the H100: bytes, but far from them (a mixed batch moves about
// a megabyte: 0.28 us at 3.35 TB/s).  What costs is the chain of
// dependent memory trips and the launch.  Design: one block per token,
// one warp per (head, K or V) row — 2 x Hkv warps (Qwen2.5-7B: 8, Mixtral:
// 16; past 32 the warps loop).  Each warp issues its row load right after
// the token's destination load (the row's address depends only on t and
// h, so the two trips overlap), holds the row in registers (at most 4
// words of 4 elements a lane: D <= 512), takes the amax with one shuffle
// reduce and quantizes from the registers — the row is read once — while
// the destination is still in flight.  Then one 32-bit store per word and
// one scale store per row.  One dependent trip with `dst` (two without:
// write_idx, then the table entry).  The TPU kernel's aligned-chunk
// read-modify-write (a workaround for sublane tiles) is gone: the GPU
// store is byte-addressable.
//
// The int4 pair hazard.  Positions 2t and 2t+1 of one prefill chunk share
// a byte row, and their blocks run in parallel in no order (the reference
// is safe only because its loop is sequential).  Each lane therefore
// merges its nibbles into the 32-bit word that holds them with two
// atomics: atomicAnd clears this token's nibble of each of the 4 bytes,
// atomicOr sets it.  Two pair-mates touch disjoint nibbles, so every
// interleaving of their four atomics leaves both values; the other nibble
// of a byte whose mate is not in the dispatch keeps the pool's old value,
// as the reference's merge does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWordsPerLane = 4;   // 4 elements a word: D <= 4 * 32 * 4
constexpr int kMaxWarps = 32;

// 4 consecutive elements -> 4 floats (exact for bf16).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
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

// The token's (page, offset) from what the block loaded first — its pool
// row `dst[t]`, or its write index and then the table entry; false when
// the row is dropped.
__device__ __forceinline__ bool resolve(int first, bool has_dst,
                                        const int* __restrict__ tables,
                                        int t, int max_pages, int n_pages,
                                        int page, int* pg, int* off) {
  if (has_dst) {
    if (first < 0 || (int64_t)first >= (int64_t)n_pages * page) return false;
    *pg = first / page;
    *off = first - *pg * page;
    return true;
  }
  if (first < 0 || first >= max_pages * page) return false;
  *pg = __ldg(tables + (int64_t)t * max_pages + first / page);
  *off = first % page;
  return *pg >= 0 && *pg < n_pages;
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) paged_kv_update_quant_kernel(
    int8_t* __restrict__ k_pool, int8_t* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ dst, const int* __restrict__ write_idx,
    const int* __restrict__ tables, int hkv, int head_dim, int max_pages,
    int n_pages, int page, bool nibbles, int layer) {
  const int t = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const bool has_dst = dst != nullptr;
  const int first = __ldg((has_dst ? dst : write_idx) + t);
  const float qmax = nibbles ? 7.f : 127.f;
  const float inv_qmax = __fdiv_rn(1.f, qmax);
  const int words = head_dim / 4;
  int pg = 0, off = 0;
  bool resolved = false;
  // Row r: K of head r for r < hkv, else V of head r - hkv.
  for (int r = threadIdx.x / 32; r < 2 * hkv; r += blockDim.x / 32) {
    const bool is_v = r >= hkv;
    const int h = is_v ? r - hkv : r;
    const T* x = (is_v ? v_new : k_new) + ((int64_t)t * hkv + h) * head_dim;
    float f[kWordsPerLane][4];
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int w = lane + 32 * k;
      if (w < words) {
        load4(x + 4 * w, f[k]);
#pragma unroll
        for (int u = 0; u < 4; ++u) amax = fmaxf(amax, fabsf(f[k][u]));
      }
    }
    amax = warp_max(amax);
    const float scale = fmaxf(__fmul_rn(amax, inv_qmax), 1e-8f);
    uint32_t q[kWordsPerLane];
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      q[k] = 0;
      if (lane + 32 * k < words) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = fminf(fmaxf(rintf(__fdiv_rn(f[k][u], scale)), -qmax),
                                qmax);
          q[k] |= ((uint32_t)(int)v & (nibbles ? 0x0Fu : 0xFFu)) << (8 * u);
        }
      }
    }
    if (!resolved) {     // the token's destination, the same for every row
      if (!resolve(first, has_dst, tables, t, max_pages, n_pages, page, &pg,
                   &off))
        return;                                            // dropped row
      resolved = true;
    }
    // (layer, page, head) stripe: `page` scales, `rows` byte rows of D.
    const int64_t stripe = ((int64_t)layer * n_pages + pg) * hkv + h;
    const int rows = nibbles ? page / 2 : page;
    int8_t* out = (is_v ? v_pool : k_pool)
                  + (stripe * rows + (nibbles ? off / 2 : off)) * head_dim;
    const int shift = (off & 1) * 4;  // int4: this token's nibble
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int w = lane + 32 * k;
      if (w < words) {
        uint32_t* word = reinterpret_cast<uint32_t*>(out + 4 * w);
        if (nibbles) {
          atomicAnd(word, ~(0x0F0F0F0Fu << shift));
          atomicOr(word, q[k] << shift);
        } else {
          *word = q[k];
        }
      }
    }
    if (lane == 0) (is_v ? v_scale : k_scale)[stripe * page + off] = scale;
  }
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (k_new / v_new).  Pools int8, scales
// f32, head_dim % 4 == 0 and <= 512, every pointer 16-byte aligned;
// nibbles != 0 for an int4 pool (page even).  dst [T] int32 (page * P +
// offset in token units, -1 = dropped) or NULL, when the kernel resolves
// write_idx [T] through tables [T, max_pages] itself.  The wrapper checks
// all of these and raises.
int arks_paged_kv_update_quant(void* k_pool, void* v_pool, void* k_scale,
                               void* v_scale, const void* k_new,
                               const void* v_new, const void* dst,
                               const void* write_idx, const void* tables,
                               int n_tokens, int hkv, int head_dim,
                               int max_pages, int n_pages, int page,
                               int nibbles, int layer, int dtype,
                               void* stream) {
  if (n_tokens <= 0 || hkv <= 0) return 0;
  if (head_dim <= 0 || head_dim % 4 != 0 || head_dim > 4 * 32 * kWordsPerLane
      || page <= 0 || (nibbles && page % 2) ||
      (dst == nullptr && (write_idx == nullptr || tables == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int warps = 2 * hkv < kMaxWarps ? 2 * hkv : kMaxWarps;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    paged_kv_update_quant_kernel<__nv_bfloat16><<<n_tokens, warps * 32, 0, st>>>(
        (int8_t*)k_pool, (int8_t*)v_pool, (float*)k_scale, (float*)v_scale,
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (const int*)dst, (const int*)write_idx, (const int*)tables, hkv,
        head_dim, max_pages, n_pages, page, nibbles != 0, layer);
  } else if (dtype == 0) {
    paged_kv_update_quant_kernel<float><<<n_tokens, warps * 32, 0, st>>>(
        (int8_t*)k_pool, (int8_t*)v_pool, (float*)k_scale, (float*)v_scale,
        (const float*)k_new, (const float*)v_new, (const int*)dst,
        (const int*)write_idx, (const int*)tables, hkv, head_dim, max_pages,
        n_pages, page, nibbles != 0, layer);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
