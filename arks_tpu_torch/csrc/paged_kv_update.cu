// In-place paged KV row write: one K row and one V row per token, through
// the per-token block table.
//
// Replaces the Pallas kernel arks_tpu/ops/paged_attention.py
// `_paged_update_kernel` (launched by `paged_kv_update`).  Token t writes
// k_new[t] / v_new[t] ([Hkv, D]) at pool row
//   (layer, page = tables[t, idx / P], head, offset = idx % P),  idx = write_idx[t].
// A row whose idx is >= MaxP * P (the padding / inactive-lane sentinel) or
// negative is dropped, as is a table entry outside [0, N) — the Pallas
// kernel's pl.when guard, plus a bounds check it relied on the DMA engine
// for.
//
// Bound on the H100: bytes.  A decode step moves T * Hkv * D * 2 (K and V)
// elements in and the same out — a few KB per layer at decode (8 tokens x
// 4 heads x 128 x bf16 x 2 = 16 KB), i.e. far under a microsecond of HBM
// time at 3.35 TB/s, so launch latency dominates.  The TPU kernel's
// aligned-chunk read-modify-write (a sublane-packing workaround) is gone:
// the GPU store is byte-addressable, so each (token, head) block copies
// its rows with 16-byte vector loads and stores, K and V in one launch.
// The kernel copies pool rows of row_bytes; with `narrow` the new rows
// are f32 and the pool bf16 (an f32 engine over a bf16 pool), and each
// 16-byte pool vector is rounded from two f32 vectors with
// round-to-nearest-even, as the reference's astype does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__global__ void paged_kv_update_kernel(uint4* __restrict__ k_pool,
                                       uint4* __restrict__ v_pool,
                                       const uint4* __restrict__ k_new,
                                       const uint4* __restrict__ v_new,
                                       const int* __restrict__ write_idx,
                                       const int* __restrict__ tables,
                                       int hkv, int max_pages, int n_pages,
                                       int page, int vecs_per_row, int layer) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int idx = write_idx[t];
  if (idx < 0 || idx >= max_pages * page) return;          // dropped row
  const int pg = tables[(int64_t)t * max_pages + idx / page];
  if (pg < 0 || pg >= n_pages) return;
  const int off = idx % page;
  const int64_t row = (((int64_t)layer * n_pages + pg) * hkv + h) * page + off;
  // A new row holds vecs_per_row pool vectors (twice as many 16-byte
  // vectors of f32 when narrowing).
  const int64_t src = ((int64_t)t * hkv + h) * vecs_per_row * (NARROW ? 2 : 1);
  for (int i = threadIdx.x; i < 2 * vecs_per_row; i += blockDim.x) {
    if (i < vecs_per_row) {
      k_pool[row * vecs_per_row + i] = row_vec<NARROW>(k_new + src, i);
    } else {
      const int j = i - vecs_per_row;
      v_pool[row * vecs_per_row + j] = row_vec<NARROW>(v_new + src, j);
    }
  }
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes = D * sizeof(pool dtype); must be a multiple of 16 and every
// pointer 16-byte aligned (the wrapper checks both).  narrow = 1: the new
// rows are f32 and the pools bf16.
int arks_paged_kv_update(void* k_pool, void* v_pool, const void* k_new,
                         const void* v_new, const void* write_idx,
                         const void* tables, int n_tokens, int hkv,
                         int max_pages, int n_pages, int page, int row_bytes,
                         int layer, int narrow, void* stream) {
  if (n_tokens <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  int threads = 2 * vecs;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  dim3 grid(n_tokens, hkv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (narrow)
    paged_kv_update_kernel<true><<<grid, threads, 0, st>>>(
        (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
        (const uint4*)v_new, (const int*)write_idx, (const int*)tables, hkv,
        max_pages, n_pages, page, vecs, layer);
  else
    paged_kv_update_kernel<false><<<grid, threads, 0, st>>>(
        (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
        (const uint4*)v_new, (const int*)write_idx, (const int*)tables, hkv,
        max_pages, n_pages, page, vecs, layer);
  return (int)cudaGetLastError();
}

}  // extern "C"
