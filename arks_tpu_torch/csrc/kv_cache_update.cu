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
// Bound on the H100: bytes, but far from them.  A decode step writes
// B * Hkv rows of D elements for K and for V (Qwen2.5-7B, 8 slots, bf16:
// 8 x 4 x 128 x 2 B x 2 = 16 KB) — hundredths of a microsecond of HBM
// time at 3.35 TB/s.  What costs is the chain of dependent work before
// the first store, and the launch.  Design: one block per slot covers all
// its Hkv x {K, V} rows, as a 2-D block of (row part, row): K rows first,
// then V rows.  Past 1024 threads (32 warps for the quantized write) the
// rows spill into more blocks of the slot along grid y, never into a loop.
//  - Plain write: a thread per 16-byte cache vector (Qwen2.5-7B bf16:
//    16 x 8 = 128 threads; Mixtral-8x7B, Hkv 8: 256).  Each thread starts
//    its row load (the address depends only on the slot, row and vector)
//    right beside the write-index load and holds the vector in registers,
//    so the only dependent trip is write index -> store (`ld_now`).
//  - Quantized write: a warp per (head, K or V) row — 2 x Hkv warps (8
//    for Qwen, 16 for Mixtral), K and V in parallel.  Each warp loads its
//    row into registers once (at most kWordsPerLane words of 4 elements a
//    lane: D <= 512) beside the index load, takes the amax with one
//    shuffle reduce and quantizes from the registers while the index is in
//    flight, then stores one 32-bit word of 4 int8 columns a lane and the
//    scale from lane 0.
// Everything but the index — the row's stripe in the cache, with the
// layer offset in int64 — is computed before the index is read, so the
// index's arrival leaves one multiply-add and the stores; a row whose
// index drops skips its stores.  On the H100 this loop-free 2-D form
// measured faster than a 1-D block that loops over its vectors or warps
// and works out its row after the index (PERF.md).  The TPU
// kernels' read-modify-write of an aligned chunk of 16 (bf16) or 32
// (int8) rows and 128 scales (a sublane / lane tiling workaround) is gone:
// the GPU store is byte-addressable.
//
// Launch arguments come packed, as one block of int64 that the wrapper
// builds with struct.pack (SlotWriteArgs, SlotQuantWriteArgs): one ctypes
// argument instead of a dozen converted one by one.  These writes run
// once per layer of every decode step, so their host cost counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWordsPerLane = 4;   // 4 elements a word: D <= 4 * 32 * 4
constexpr int kMaxWarps = 32;

// A 16-byte load that stays where it is written.  A plain __ldg whose value feeds
// only a store behind the write-index check is sunk below that check by
// ptxas (the SASS then waits for the index before it asks for the row); a
// volatile load may not be made conditional, so it stays ahead of the
// branch and the row and the index are in flight together.
__device__ __forceinline__ uint4 ld_now(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Vector i of a slot's new rows: 16 bytes as they are, or (NARROW) 8 f32
// values rounded to 8 bf16.
template <bool NARROW>
__device__ __forceinline__ uint4 row_vec(const uint4* rows, int i) {
  if (!NARROW) return ld_now(rows + i);
  const uint4 a = ld_now(rows + 2 * i);
  const uint4 b = ld_now(rows + 2 * i + 1);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
  h[0] = __floats2bfloat162_rn(__uint_as_float(a.x), __uint_as_float(a.y));
  h[1] = __floats2bfloat162_rn(__uint_as_float(a.z), __uint_as_float(a.w));
  h[2] = __floats2bfloat162_rn(__uint_as_float(b.x), __uint_as_float(b.y));
  h[3] = __floats2bfloat162_rn(__uint_as_float(b.z), __uint_as_float(b.w));
  return out;
}

// Thread (j, y) of block (b, z) copies vector j of row r = z * blockDim.y
// + y of slot b: K of head r for r < hkv, else V of head r - hkv.
template <bool NARROW>
__global__ void kv_cache_update_kernel(uint4* __restrict__ k_cache,
                                       uint4* __restrict__ v_cache,
                                       const uint4* __restrict__ k_new,
                                       const uint4* __restrict__ v_new,
                                       const int* __restrict__ write_idx,
                                       int n_slots, int hkv, int max_len,
                                       int layer) {
  const int b = blockIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= 2 * hkv) return;
  const int idx = __ldg(write_idx + b);
  const int vecs = blockDim.x;
  const int j = threadIdx.x;
  const bool is_v = r >= hkv;
  const int h = is_v ? r - hkv : r;
  const int64_t src = ((int64_t)b * hkv + h) * vecs * (NARROW ? 2 : 1);
  const uint4 v = row_vec<NARROW>((is_v ? v_new : k_new) + src, j);
  // (layer, slot, head) stripe of `max_len` rows of `vecs` vectors.
  uint4* stripe = (is_v ? v_cache : k_cache)
                  + (((int64_t)layer * n_slots + b) * hkv + h) * max_len * vecs;
  if ((unsigned)idx < (unsigned)max_len)                 // else dropped
    stripe[(int64_t)idx * vecs + j] = v;
}

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

// Warp y of block (b, z) quantizes and writes row r = z * blockDim.y + y
// of slot b: K of head r for r < hkv, else V of head r - hkv.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32) kv_cache_update_quant_kernel(
    int8_t* __restrict__ k_cache, int8_t* __restrict__ v_cache,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ write_idx, int n_slots, int hkv, int head_dim,
    int max_len, int layer) {
  constexpr float kQmax = 127.f;
  constexpr float kInvQmax = 1.f / kQmax;  // f32, rounded to nearest
  const int b = blockIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= 2 * hkv) return;
  const int idx = __ldg(write_idx + b);
  const int lane = threadIdx.x;
  const int words = head_dim / 4;
  const bool is_v = r >= hkv;
  const int h = is_v ? r - hkv : r;
  const T* x = (is_v ? v_new : k_new) + ((int64_t)b * hkv + h) * head_dim;
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
  const float scale = fmaxf(__fmul_rn(amax, kInvQmax), 1e-8f);
  uint32_t q[kWordsPerLane];
#pragma unroll
  for (int k = 0; k < kWordsPerLane; ++k) {
    q[k] = 0;
    if (lane + 32 * k < words) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = fminf(fmaxf(rintf(__fdiv_rn(f[k][u], scale)), -kQmax),
                              kQmax);
        q[k] |= ((uint32_t)(int)v & 0xFFu) << (8 * u);
      }
    }
  }
  // (layer, slot, head) stripe: `max_len` scales, `max_len` rows of D.
  const int64_t stripe = ((int64_t)layer * n_slots + b) * hkv + h;
  uint32_t* out = reinterpret_cast<uint32_t*>(is_v ? v_cache : k_cache)
                  + stripe * max_len * words;
  float* scales = (is_v ? v_scale : k_scale) + stripe * max_len;
  if ((unsigned)idx >= (unsigned)max_len) return;        // dropped row
  out += (int64_t)idx * words;
#pragma unroll
  for (int k = 0; k < kWordsPerLane; ++k) {
    const int w = lane + 32 * k;
    if (w < words) out[w] = q[k];
  }
  if (lane == 0) scales[idx] = scale;
}

}  // namespace

extern "C" {

// The launch arguments, as the wrapper packs them: every field an int64
// (struct.Struct("12q") and ("14q")), so the layout has no padding.
// Pointers are device addresses; the stream is a cudaStream_t.
struct SlotWriteArgs {
  int64_t k_cache, v_cache, k_new, v_new, write_idx;
  int64_t n_slots, hkv, max_len, row_bytes, layer, narrow, stream;
};

struct SlotQuantWriteArgs {
  int64_t k_cache, v_cache, k_scale, v_scale, k_new, v_new, write_idx;
  int64_t n_slots, hkv, head_dim, max_len, layer, dtype, stream;
};

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes = D * sizeof(cache dtype); must be a multiple of 16 and every
// pointer 16-byte aligned (the wrapper checks both).  narrow = 1: the new
// rows are f32 and the caches bf16.
int arks_kv_cache_update(const SlotWriteArgs* a) {
  if (a->n_slots <= 0 || a->hkv <= 0) return 0;
  if (a->row_bytes <= 0 || a->row_bytes % 16 != 0 ||
      a->row_bytes / 16 > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int vecs = (int)(a->row_bytes / 16);
  const int rows = (int)(2 * a->hkv);
  const int per_block = rows < kMaxThreads / vecs ? rows : kMaxThreads / vecs;
  const dim3 grid((unsigned)a->n_slots, (rows + per_block - 1) / per_block);
  const dim3 block(vecs, per_block);
  const cudaStream_t st = (cudaStream_t)a->stream;
  const int n = (int)a->n_slots, hkv = (int)a->hkv, s = (int)a->max_len;
  const int layer = (int)a->layer;
  if (a->narrow)
    kv_cache_update_kernel<true><<<grid, block, 0, st>>>(
        (uint4*)a->k_cache, (uint4*)a->v_cache, (const uint4*)a->k_new,
        (const uint4*)a->v_new, (const int*)a->write_idx, n, hkv, s, layer);
  else
    kv_cache_update_kernel<false><<<grid, block, 0, st>>>(
        (uint4*)a->k_cache, (uint4*)a->v_cache, (const uint4*)a->k_new,
        (const uint4*)a->v_new, (const int*)a->write_idx, n, hkv, s, layer);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (k_new / v_new).  Caches int8, scales
// f32, head_dim % 4 == 0 and <= 512, every pointer 16-byte aligned (the
// wrapper checks all of these and raises).
int arks_kv_cache_update_quant(const SlotQuantWriteArgs* a) {
  if (a->n_slots <= 0 || a->hkv <= 0) return 0;
  if (a->head_dim <= 0 || a->head_dim % 4 != 0 ||
      a->head_dim > 4 * 32 * kWordsPerLane)
    return (int)cudaErrorInvalidValue;
  const int rows = (int)(2 * a->hkv);
  const int warps = rows < kMaxWarps ? rows : kMaxWarps;
  const dim3 grid((unsigned)a->n_slots, (rows + warps - 1) / warps);
  const dim3 block(32, warps);
  const cudaStream_t st = (cudaStream_t)a->stream;
  const int n = (int)a->n_slots, hkv = (int)a->hkv, d = (int)a->head_dim;
  const int s = (int)a->max_len, layer = (int)a->layer;
  if (a->dtype == 1) {
    kv_cache_update_quant_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (int8_t*)a->k_cache, (int8_t*)a->v_cache, (float*)a->k_scale,
        (float*)a->v_scale, (const __nv_bfloat16*)a->k_new,
        (const __nv_bfloat16*)a->v_new, (const int*)a->write_idx, n, hkv, d,
        s, layer);
  } else if (a->dtype == 0) {
    kv_cache_update_quant_kernel<float><<<grid, block, 0, st>>>(
        (int8_t*)a->k_cache, (int8_t*)a->v_cache, (float*)a->k_scale,
        (float*)a->v_scale, (const float*)a->k_new, (const float*)a->v_new,
        (const int*)a->write_idx, n, hkv, d, s, layer);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
