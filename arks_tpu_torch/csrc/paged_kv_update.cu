// In-place paged KV row write: one K row and one V row per token, through
// the per-token block table or a destination resolved once per step.
//
// Replaces the Pallas kernel arks_tpu/ops/paged_attention.py
// `_paged_update_kernel` (launched by `paged_kv_update`).  Token t writes
// k_new[t] / v_new[t] ([Hkv, D]) at pool row
//   (layer, page = tables[t, idx / P], head, offset = idx % P),  idx = write_idx[t].
// A row whose idx is >= MaxP * P (the padding / inactive-lane sentinel) or
// negative is dropped, as is a table entry outside [0, N) — the Pallas
// kernel's pl.when guard, plus a bounds check it relied on the DMA engine
// for.  With `dst` (the step's `paged_write_rows`: page * P + offset per
// token, -1 = dropped, the same for every layer) the kernel reads that one
// int instead of write_idx and the table entry; the layer offset is added
// here, in int64.  `dst` is the counterpart of the reference's
// scalar-prefetched indices, which its kernel reads from SMEM for free.
//
// Bound on the H100: bytes, but far from them.  A mixed batch moves about
// a megabyte (0.37 us of HBM time at 3.35 TB/s); what costs is the chain of
// dependent memory trips before the first store and the launch itself.
// Design: one block per token covers all its Hkv x {K, V} rows, one thread
// per 16-byte pool vector (Qwen2.5-7B bf16: 4 x 2 x 16 = 128 threads).
// Every thread issues its row load right after the destination load —
// the row's address depends only on (t, h), so the two trips overlap —
// and holds the vector in registers until the destination resolves: one
// dependent trip with `dst` (two without: write_idx, then the table
// entry), then the stores.  The TPU kernel's aligned-chunk
// read-modify-write (a sublane-packing workaround) is gone: the GPU store
// is byte-addressable.  With `narrow` the new rows are f32 and the pool
// bf16 (an f32 engine over a bf16 pool): each 16-byte pool vector is
// rounded from two f32 vectors with round-to-nearest-even, as the
// reference's astype does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// Vector i of a token's new rows: 16 bytes as they are, or (NARROW) 8 f32
// values rounded to 8 bf16.
template <bool NARROW>
__device__ __forceinline__ uint4 row_vec(const uint4* rows, int64_t i) {
  if (!NARROW) return __ldg(rows + i);
  const float4 a = __ldg(reinterpret_cast<const float4*>(rows) + 2 * i);
  const float4 b = __ldg(reinterpret_cast<const float4*>(rows) + 2 * i + 1);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
  h[0] = __floats2bfloat162_rn(a.x, a.y);
  h[1] = __floats2bfloat162_rn(a.z, a.w);
  h[2] = __floats2bfloat162_rn(b.x, b.y);
  h[3] = __floats2bfloat162_rn(b.z, b.w);
  return out;
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

// Thread i of block t copies pool vector i of the token's rows: K rows
// first (head-major, `vecs` vectors each), then V.
template <bool NARROW>
__global__ void paged_kv_update_kernel(uint4* __restrict__ k_pool,
                                       uint4* __restrict__ v_pool,
                                       const uint4* __restrict__ k_new,
                                       const uint4* __restrict__ v_new,
                                       const int* __restrict__ dst,
                                       const int* __restrict__ write_idx,
                                       const int* __restrict__ tables,
                                       int hkv, int max_pages, int n_pages,
                                       int page, int vecs, int layer) {
  const int t = blockIdx.x;
  const bool has_dst = dst != nullptr;
  const int first = __ldg((has_dst ? dst : write_idx) + t);
  const int per_kv = hkv * vecs;          // pool vectors of K (and of V)
  const int64_t src = (int64_t)t * per_kv;
  int i = threadIdx.x;
  uint4 v = make_uint4(0, 0, 0, 0);
  if (i < 2 * per_kv)
    v = i < per_kv ? row_vec<NARROW>(k_new + src * (NARROW ? 2 : 1), i)
                   : row_vec<NARROW>(v_new + src * (NARROW ? 2 : 1), i - per_kv);
  int pg, off;
  if (!resolve(first, has_dst, tables, t, max_pages, n_pages, page, &pg, &off))
    return;                                                // dropped row
  // Pool row (layer, pg, head 0, off) in vectors; head h adds h * page rows.
  const int64_t row0 = ((((int64_t)layer * n_pages + pg) * hkv) * page + off)
                       * vecs;
  for (; i < 2 * per_kv; i += blockDim.x) {
    if (i >= (int)blockDim.x)              // past the first pass: load now
      v = i < per_kv ? row_vec<NARROW>(k_new + src * (NARROW ? 2 : 1), i)
                     : row_vec<NARROW>(v_new + src * (NARROW ? 2 : 1),
                                       i - per_kv);
    const bool is_v = i >= per_kv;
    const int r = is_v ? i - per_kv : i;
    const int h = r / vecs;
    const int j = r - h * vecs;
    (is_v ? v_pool : k_pool)[row0 + (int64_t)h * page * vecs + j] = v;
  }
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes = D * sizeof(pool dtype); must be a multiple of 16 and every
// pointer 16-byte aligned (the wrapper checks both).  narrow = 1: the new
// rows are f32 and the pools bf16.  dst [T] int32 (page * P + offset, -1 =
// dropped) or NULL, when the kernel resolves write_idx [T] through tables
// [T, max_pages] itself.
int arks_paged_kv_update(void* k_pool, void* v_pool, const void* k_new,
                         const void* v_new, const void* dst,
                         const void* write_idx, const void* tables,
                         int n_tokens, int hkv, int max_pages, int n_pages,
                         int page, int row_bytes, int layer, int narrow,
                         void* stream) {
  if (n_tokens <= 0 || hkv <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0 || page <= 0 ||
      (dst == nullptr && (write_idx == nullptr || tables == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  const int64_t total = 2LL * hkv * vecs;
  int threads = (int)((total + 31) / 32 * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (narrow)
    paged_kv_update_kernel<true><<<n_tokens, threads, 0, st>>>(
        (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
        (const uint4*)v_new, (const int*)dst, (const int*)write_idx,
        (const int*)tables, hkv, max_pages, n_pages, page, vecs, layer);
  else
    paged_kv_update_kernel<false><<<n_tokens, threads, 0, st>>>(
        (uint4*)k_pool, (uint4*)v_pool, (const uint4*)k_new,
        (const uint4*)v_new, (const int*)dst, (const int*)write_idx,
        (const int*)tables, hkv, max_pages, n_pages, page, vecs, layer);
  return (int)cudaGetLastError();
}

}  // extern "C"
