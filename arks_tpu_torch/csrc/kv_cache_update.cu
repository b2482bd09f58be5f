// In-place K/V row writes into the slot-contiguous decode cache
// [L, B, Hkv, S, D]: one row per slot at its write index, unquantized or
// quantized per token to int8 with f32 scales [L, B, Hkv, S].
//
// Replaces two Pallas kernels of arks_tpu/ops/pallas_attention.py:
//  - `_update_kernel` (launched by `kv_cache_update`): slot b writes
//    k_new[b] / v_new[b] ([Hkv, D], in the cache dtype, or f32 rows into
//    a bf16 cache rounded to nearest even on the way, as astype does) at
//    (layer, b, head, write_idx[b]);
//  - `_update_quant_kernel` (launched by `kv_cache_update_quant`), fused
//    with the `quantize_kv` (qmax 127) its wrapper runs first:
//      scale = max(amax * (1 / 127), 1e-8),  q = clip(rint(x / scale), -127, 127)
//    bit for bit what the reference computes under jit (XLA multiplies by
//    the f32 reciprocal of qmax; x / scale is an IEEE division — the build
//    has no --use_fast_math; rintf rounds half to even; bf16 rows convert
//    to f32 exactly before the amax).  The scale lands at
//    (layer, b, head, write_idx[b]) of its stripe.
// A slot whose write index is >= S (the parked-slot sentinel) or negative
// writes nothing, as the Pallas kernels' pl.when(idx < S) guard.
//
// Design.  One block per (slot, KV head) for the plain write, copying the
// K and V rows with 16-byte vector loads and stores; one warp per (slot,
// KV head) for the quantized write, reducing amax with shuffles and storing
// 4 int8 columns per lane as one 32-bit word.  The TPU kernels'
// read-modify-write of an aligned chunk of 16 (bf16) or 32 (int8) rows and
// 128 scales (a sublane / lane tiling workaround) is gone: the GPU store
// is byte-addressable.
//
// Bound on the H100: bytes.  A decode step writes B * Hkv rows of D
// elements for K and for V (8 x 4 x 128 x 2 B x 2 = 16 KB in bf16) — far
// under a microsecond of HBM time at 3.35 TB/s, so the launch dominates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // (slot, head) rows per block, quantized write

// Vector i of a new row: 16 bytes as they are, or (NARROW) 8 f32 values
// rounded to 8 bf16.
template <bool NARROW>
__device__ __forceinline__ uint4 row_vec(const uint4* row, int i) {
  if (!NARROW) return row[i];
  const float4 a = reinterpret_cast<const float4*>(row)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(row)[2 * i + 1];
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return out;
}

template <bool NARROW>
__global__ void kv_cache_update_kernel(uint4* __restrict__ k_cache,
                                       uint4* __restrict__ v_cache,
                                       const uint4* __restrict__ k_new,
                                       const uint4* __restrict__ v_new,
                                       const int* __restrict__ write_idx,
                                       int n_slots, int hkv, int max_len,
                                       int vecs_per_row, int layer) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int idx = write_idx[b];
  if (idx < 0 || idx >= max_len) return;                  // dropped row
  const int64_t row =
      (((int64_t)layer * n_slots + b) * hkv + h) * max_len + idx;
  const int64_t src = ((int64_t)b * hkv + h) * vecs_per_row * (NARROW ? 2 : 1);
  for (int i = threadIdx.x; i < 2 * vecs_per_row; i += blockDim.x) {
    if (i < vecs_per_row) {
      k_cache[row * vecs_per_row + i] = row_vec<NARROW>(k_new + src, i);
    } else {
      const int j = i - vecs_per_row;
      v_cache[row * vecs_per_row + j] = row_vec<NARROW>(v_new + src, j);
    }
  }
}

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
__global__ void __launch_bounds__(kWarps * 32) kv_cache_update_quant_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ write_idx, int n_slots, int hkv, int head_dim,
    int max_len, int layer) {
  const int row_id = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row_id >= n_slots * hkv) return;
  const int b = row_id / hkv;
  const int h = row_id % hkv;
  const int idx = write_idx[b];
  if (idx < 0 || idx >= max_len) return;                  // dropped row
  // (layer, slot, head) stripe: `max_len` scales, `max_len` rows of D.
  const int64_t stripe = ((int64_t)layer * n_slots + b) * hkv + h;
  const int64_t dst = (stripe * max_len + idx) * head_dim;
  const int64_t src = (int64_t)row_id * head_dim;
  const float qmax = 127.f;
  const float inv_qmax = __fdiv_rn(1.f, qmax);
  const int words = head_dim / 4;

  for (int kv = 0; kv < 2; ++kv) {
    const T* x = (kv ? v_new : k_new) + src;
    int8_t* cache = kv ? v_cache : k_cache;
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
        bytes |= ((uint32_t)(int)r & 0xFFu) << (8 * u);
      }
      *reinterpret_cast<uint32_t*>(cache + dst + 4 * w) = bytes;
    }
    if (lane == 0) (kv ? v_scale : k_scale)[stripe * max_len + idx] = scale;
  }
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes = D * sizeof(cache dtype); must be a multiple of 16 and every
// pointer 16-byte aligned (the wrapper checks both).  narrow = 1: the new
// rows are f32 and the caches bf16.
int arks_kv_cache_update(void* k_cache, void* v_cache, const void* k_new,
                         const void* v_new, const void* write_idx,
                         int n_slots, int hkv, int max_len, int row_bytes,
                         int layer, int narrow, void* stream) {
  if (n_slots <= 0 || hkv <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  int threads = 2 * vecs;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dim3 grid(n_slots, hkv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (narrow)
    kv_cache_update_kernel<true><<<grid, threads, 0, st>>>(
        (uint4*)k_cache, (uint4*)v_cache, (const uint4*)k_new,
        (const uint4*)v_new, (const int*)write_idx, n_slots, hkv, max_len,
        vecs, layer);
  else
    kv_cache_update_kernel<false><<<grid, threads, 0, st>>>(
        (uint4*)k_cache, (uint4*)v_cache, (const uint4*)k_new,
        (const uint4*)v_new, (const int*)write_idx, n_slots, hkv, max_len,
        vecs, layer);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (k_new / v_new).  Caches int8, scales
// f32, head_dim % 4 == 0, every pointer 16-byte aligned (the wrapper
// checks all of these and raises).
int arks_kv_cache_update_quant(void* k_cache, void* v_cache, void* k_scale,
                               void* v_scale, const void* k_new,
                               const void* v_new, const void* write_idx,
                               int n_slots, int hkv, int head_dim,
                               int max_len, int layer, int dtype,
                               void* stream) {
  if (n_slots <= 0 || hkv <= 0) return 0;
  if (head_dim <= 0 || head_dim % 4 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_slots * hkv + kWarps - 1) / kWarps;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    kv_cache_update_quant_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        (int8_t*)k_cache, (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (const int*)write_idx, n_slots, hkv, head_dim, max_len, layer);
  } else if (dtype == 0) {
    kv_cache_update_quant_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        (int8_t*)k_cache, (int8_t*)v_cache, (float*)k_scale, (float*)v_scale,
        (const float*)k_new, (const float*)v_new, (const int*)write_idx,
        n_slots, hkv, head_dim, max_len, layer);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
