// Ragged mixed prefill+decode attention over the paged KV pool.
//
// Replaces the Pallas kernel arks_tpu/ops/paged_attention.py
// `_paged_mixed_ragged_kernel` (body `_mixed_softmax_block`, launched by
// `paged_mixed_attention`) for bf16/f32, int8 and int4 pools, without
// carried state or span bounds.  What it computes is the reference's: for
// every work item (sequence s, KV head h, q-block qb) of
// `build_mixed_work_list`, the G query heads x block_q query rows of that
// q-block attend causally — row i (global position pos_start[s] +
// qb*block_q + i) sees pool positions [0, that position] through s's
// block-table pages.  Scores are f32 (q.k in f32, then * 1/sqrt(D), then,
// for a quantized pool, * the per-token k scale), masked positions get
// -1e30, the softmax is online with f32 m and l, p (times the per-token v
// scale of a quantized pool) is rounded to q's dtype before p.V (as the
// reference does), and the output is acc / (l + 1e-9) cast to q's dtype.
// Padding items (pages == 0) return at once.
//
// Two entries share the kernel.  `arks_paged_mixed_attention` walks the
// ragged work list (replaces `_paged_mixed_ragged_kernel`);
// `arks_paged_mixed_attention_dense` (ARKS_MIXED_GRID=dense) launches one
// CTA per (sequence, KV head, q-block) of the whole (S, num_qb) grid and
// replaces the dense-grid Pallas kernel `_paged_mixed_kernel`
// (arks_tpu/ops/paged_attention.py:675).  A dense CTA computes its item's
// causal page count as the work list does; a CTA whose q-block lies past
// its lane's q_len (an idle lane, or a short chunk) returns at once, and
// pages past the causal bound are never walked, as in the ragged walk — so
// every valid row is bit-identical between the two launches.
//
// Quantized page streams: the tile copy into shared memory dequantizes
// the values to q's dtype — exact, for |v| <= 127 — so the compute loops
// are the bf16/f32 ones and convert each K/V element once per tile, not
// once per warp and query row.  An int4 page [P/2, D] of packed bytes
// (token 2t in the low nibble, 2t+1 in the high one) is unpacked on that
// copy — sign extension by two arithmetic shifts, interleaved back to token
// order — so a 64-token tile reads 32 packed rows.  The f32 scale stripes
// of the tile's tokens ride into shared memory beside it.
//
// Layout differences from the TPU kernel, none of them numerical:
//  - One CTA per item with head_group = 1 (one KV head): the G = H/Hkv
//    query heads of that KV head share every K/V tile in shared memory,
//    one warp per query head (G <= 8).
//  - q is read straight from the flat [T, H, D] token batch through
//    seq_q_start and the output written straight back to [T, H, D]; the
//    reference's per-lane gather/scatter around the kernel is gone (it
//    survives only in the plain PyTorch version).
//  - The page loop walks 64-token tiles and stops at the item's causal
//    end: tiles past it are fully masked, and a fully masked tile adds
//    exactly zero once the first tile (which holds position 0) has set m.
//
// Bound on the H100: bytes at decode, where each (sequence, KV head) reads
// its K and V prefix once (context x 128 x 2 B x 2 per head for bf16, half
// that plus 8 B of scales per token for int8, a quarter for int4) at
// 3.35 TB/s and does a few flops per byte — far below the 295 flop/byte
// ridge.  Prefill chunks raise the intensity to ~G x block_q rows per K/V
// element.  This first kernel is the simple, correct one: CUDA-core f32
// FMAs, 16-byte tile loads into shared memory (K rows padded by 16 bytes
// so the lane-per-token column reads are bank-conflict free), no
// copy/compute overlap, no split-KV.  Decode batches therefore fill only
// S x Hkv CTAs (32 of 132 SMs at 8 lanes x 4 KV heads); wgmma/TMA and
// split-KV are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // one warp per query head of the group
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 8;               // most query rows per item (block_q <= kBQ)
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
// 16 integer values -> 16 T at dst (16-byte aligned), exactly.
__device__ __forceinline__ void put16(const int* v, float* dst) {
#pragma unroll
  for (int u = 0; u < 16; u += 4)
    *reinterpret_cast<float4*>(dst + u) =
        make_float4((float)v[u], (float)v[u + 1], (float)v[u + 2],
                    (float)v[u + 3]);
}
__device__ __forceinline__ void put16(const int* v, __nv_bfloat16* dst) {
  uint4 out[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    h[u] = __floats2bfloat162_rn((float)v[2 * u], (float)v[2 * u + 1]);
  *reinterpret_cast<uint4*>(dst) = out[0];
  *reinterpret_cast<uint4*>(dst + 8) = out[1];
}

// 16 int8 pool bytes -> 16 T.
template <typename T>
__device__ __forceinline__ void dequant16(const int8_t* src, T* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  int v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) v[u] = b[u];
  put16(v, dst);
}

// 16 packed int4 bytes -> the 16 values of the even token (low nibbles)
// and of the odd token (high nibbles), sign-extended, as T.
template <typename T>
__device__ __forceinline__ void unpack16(const int8_t* src, T* even, T* odd) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  int lo[16], hi[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int w = b[u];
    lo[u] = (int)((unsigned)w << 28) >> 28;
    hi[u] = w >> 4;
  }
  put16(lo, even);
  put16(hi, odd);
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

// KV is the pool's element type: T itself, or int8_t for an int8 pool
// (INT4 = false) and an int4 pool (INT4 = true, packed pairs of int8_t).
// The shared-memory tiles hold T in every case.
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * kWarps * kBQ * D          // queries, f32
         + sizeof(T) * kKT * (D + 16 / sizeof(T))  // K tile, padded rows
         + sizeof(T) * kKT * D                     // V tile
         + sizeof(float) * kWarps * kKT            // per-warp p row
         + sizeof(float) * 2 * kKT;                // k and v scale tiles
}

template <typename T, typename KV, bool INT4, int D>
__global__ void __launch_bounds__(kThreads) mixed_attention_kernel(
    const T* __restrict__ q, T* __restrict__ out,
    const KV* __restrict__ k_pool, const KV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ tables,
    const int* __restrict__ pos_start, const int* __restrict__ q_start,
    const int* __restrict__ q_len, const int* __restrict__ wl_seq,
    const int* __restrict__ wl_head, const int* __restrict__ wl_qb,
    const int* __restrict__ wl_plo, const int* __restrict__ wl_pages,
    int num_qb, int n_heads, int hkv, int page, int n_pages, int max_pages,
    int layer, int block_q, float scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KSTRIDE = D + VEC;
  constexpr int DPL = D / 32;   // output columns per lane
  constexpr int TPL = kKT / 32; // tile tokens per lane in the score pass

  const int item = blockIdx.x;
  int s, h, q_lo, npages, plo;
  if (wl_seq != nullptr) {      // ragged: the work list's item
    npages = wl_pages[item];
    plo = wl_plo[item];
    if (npages <= plo) return;  // padding item
    s = wl_seq[item];
    h = wl_head[item];
    q_lo = wl_qb[item] * block_q;
  } else {                      // dense: item = (s * hkv + h) * num_qb + qb
    s = item / (hkv * num_qb);
    h = (item / num_qb) % hkv;
    q_lo = (item % num_qb) * block_q;
    if (q_lo >= q_len[s]) return;  // idle lane or q-block past q_len
    const int end = pos_start[s] + min(q_lo + block_q, q_len[s]);
    npages = min((end + page - 1) / page, max_pages);
    plo = 0;
  }
  const int G = n_heads / hkv;
  const int rows = min(block_q, q_len[s] - q_lo);
  if (rows <= 0) return;
  const int pos0 = pos_start[s] + q_lo;  // global position of row 0
  const int t0 = q_start[s] + q_lo;      // flat token index of row 0
  const int kv_end = pos0 + rows;        // causal end over the item's rows

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* ks = reinterpret_cast<T*>(qs + kWarps * kBQ * D);
  T* vs = ks + kKT * KSTRIDE;
  float* ps = reinterpret_cast<float*>(vs + kKT * D);
  float* kss = ps + kWarps * kKT;   // tile's k scales (quantized pools)
  float* vss = kss + kKT;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Query rows (g, i) of this item, row-major [g][i][D], zero past `rows`.
  for (int e = tid; e < G * kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, g = r / kBQ, i = r % kBQ;
    qs[e] = i < rows
                ? to_float(q[((int64_t)(t0 + i) * n_heads + h * G + g) * D + d])
                : 0.f;
  }

  float m[kBQ], l[kBQ], acc[kBQ][DPL];
#pragma unroll
  for (int i = 0; i < kBQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < DPL; ++a) acc[i][a] = 0.f;
  }
  const bool active = warp < G;
  const float* qw = qs + warp * kBQ * D;
  float* pw = ps + warp * kKT;

  for (int p = plo; p < npages; ++p) {
    const int pg = tables[(int64_t)s * max_pages + p];
    // The (layer, page, head) stripe: `page` scales, `rows` rows of D.
    const int64_t stripe = ((int64_t)layer * n_pages + pg) * hkv + h;
    const int64_t base = stripe * (INT4 ? page / 2 : page) * D;
    for (int tok0 = 0; tok0 < page; tok0 += kKT) {
      const int kv0 = p * page + tok0;
      if (kv0 >= kv_end) break;
      const int nt = min(kKT, page - tok0);
      __syncthreads();  // every warp is done with the previous tile
      if (INT4) {
        // nt is even (page and kKT are): nt / 2 packed rows.
        for (int e = tid; e < (nt / 2) * (D / 16); e += kThreads) {
          const int r = e / (D / 16);
          const int c = (e % (D / 16)) * 16;
          const int64_t src = base + (int64_t)(tok0 / 2 + r) * D + c;
          unpack16(reinterpret_cast<const int8_t*>(k_pool + src),
                   ks + 2 * r * KSTRIDE + c, ks + (2 * r + 1) * KSTRIDE + c);
          unpack16(reinterpret_cast<const int8_t*>(v_pool + src),
                   vs + 2 * r * D + c, vs + (2 * r + 1) * D + c);
        }
      } else if (QUANT) {
        for (int e = tid; e < nt * (D / 16); e += kThreads) {
          const int j = e / (D / 16);
          const int c = (e % (D / 16)) * 16;
          const int64_t src = base + (int64_t)(tok0 + j) * D + c;
          dequant16(reinterpret_cast<const int8_t*>(k_pool + src),
                    ks + j * KSTRIDE + c);
          dequant16(reinterpret_cast<const int8_t*>(v_pool + src),
                    vs + j * D + c);
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
      if (QUANT) {
        for (int j = tid; j < kKT; j += kThreads) {
          const bool in = j < nt;
          kss[j] = in ? k_scale[stripe * page + tok0 + j] : 0.f;
          vss[j] = in ? v_scale[stripe * page + tok0 + j] : 0.f;
        }
      }
      __syncthreads();
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < kBQ; ++i) {
        if (i >= rows) break;
        const int qpos = pos0 + i;
        const float* qr = qw + i * D;
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
              for (int u = 0; u < VEC; ++u) dot = fmaf(qr[d + u], kf[u], dot);
            }
          }
          float sv = dot * scale;
          if (QUANT) sv *= kss[j];
          sc[c] = (j < nt && kv0 + j <= qpos) ? sv : kNegInf;
          mc = fmaxf(mc, sc[c]);
        }
        mc = warp_max(mc);
        const float m_next = fmaxf(m[i], mc);
        const float corr = expf(m[i] - m_next);
        float lsum = 0.f;
#pragma unroll
        for (int c = 0; c < TPL; ++c) {
          const float pv = expf(sc[c] - m_next);
          lsum += pv;
          pw[lane + 32 * c] = round_to<T>(QUANT ? pv * vss[lane + 32 * c] : pv);
        }
        lsum = warp_sum(lsum);
        l[i] = l[i] * corr + lsum;
        m[i] = m_next;
        __syncwarp();
#pragma unroll
        for (int a = 0; a < DPL; ++a) acc[i][a] *= corr;
        for (int j = 0; j < nt; ++j) {
          const float pj = pw[j];
          const T* vr = vs + j * D + lane * DPL;
#pragma unroll
          for (int a = 0; a < DPL; ++a) acc[i][a] = fmaf(pj, to_float(vr[a]), acc[i][a]);
        }
        __syncwarp();
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < kBQ; ++i) {
    if (i >= rows) break;
    T* o = out + ((int64_t)(t0 + i) * n_heads + h * G + warp) * D + lane * DPL;
#pragma unroll
    for (int a = 0; a < DPL; ++a) o[a] = from_float<T>(acc[i][a] / (l[i] + 1e-9f));
  }
}

template <typename T, typename KV, bool INT4, int D>
int launch(const void* q, void* out, const void* k_pool, const void* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* pos_start, const int* q_start, const int* q_len,
           const int* wl_seq, const int* wl_head, const int* wl_qb,
           const int* wl_plo, const int* wl_pages, int n_items, int num_qb,
           int n_heads, int hkv, int page, int n_pages, int max_pages,
           int layer, int block_q, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      mixed_attention_kernel<T, KV, INT4, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mixed_attention_kernel<T, KV, INT4, D><<<n_items, kThreads, smem, stream>>>(
      (const T*)q, (T*)out, (const KV*)k_pool, (const KV*)v_pool, k_scale,
      v_scale, tables, pos_start, q_start, q_len, wl_seq, wl_head, wl_qb,
      wl_plo, wl_pages, num_qb, n_heads, hkv, page, n_pages, max_pages, layer,
      block_q, scale);
  return (int)cudaGetLastError();
}

// One head dim, one q dtype: pick the pool's stream.
template <typename T, int D, typename... A>
int launch_kv(int kv_mode, A... args) {
  if (kv_mode == 0) return launch<T, T, false, D>(args...);
  if (kv_mode == 1) return launch<T, int8_t, false, D>(args...);
  if (kv_mode == 2) return launch<T, int8_t, true, D>(args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16 (q and out share it).  kv_mode: 0 =
// pools of q's dtype (scales NULL), 1 = int8 pools, 2 = int4 pools (both
// with f32 scales [L, N, Hkv, page], page even).  head_dim 64 or 128,
// G = n_heads / hkv <= 8, 1 <= block_q <= 8; the wrappers check all of
// these (and raise) before they get here.
static int dispatch(const void* q, void* out, const void* k_pool,
                    const void* v_pool, const void* k_scale,
                    const void* v_scale, const void* tables,
                    const void* pos_start, const void* q_start,
                    const void* q_len, const void* wl_seq,
                    const void* wl_head, const void* wl_qb,
                    const void* wl_plo, const void* wl_pages, int n_items,
                    int num_qb, int n_heads, int hkv, int head_dim, int page,
                    int n_pages, int max_pages, int layer, int block_q,
                    float scale, int dtype, int kv_mode, void* stream) {
  if (n_items <= 0) return 0;
  if (block_q < 1 || block_q > kBQ || hkv <= 0 || n_heads % hkv != 0 ||
      n_heads / hkv > kWarps || (kv_mode != 0 && (!k_scale || !v_scale)) ||
      (kv_mode == 2 && page % 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define ARKS_ARGS                                                             \
  kv_mode, q, out, k_pool, v_pool, (const float*)k_scale,                     \
      (const float*)v_scale, (const int*)tables, (const int*)pos_start,       \
      (const int*)q_start, (const int*)q_len, (const int*)wl_seq,             \
      (const int*)wl_head, (const int*)wl_qb, (const int*)wl_plo,             \
      (const int*)wl_pages, n_items, num_qb, n_heads, hkv, page, n_pages,     \
      max_pages, layer, block_q, scale, st
  if (dtype == 1 && head_dim == 128) return launch_kv<__nv_bfloat16, 128>(ARKS_ARGS);
  if (dtype == 1 && head_dim == 64) return launch_kv<__nv_bfloat16, 64>(ARKS_ARGS);
  if (dtype == 0 && head_dim == 128) return launch_kv<float, 128>(ARKS_ARGS);
  if (dtype == 0 && head_dim == 64) return launch_kv<float, 64>(ARKS_ARGS);
#undef ARKS_ARGS
  return (int)cudaErrorInvalidValue;
}

// The ragged launch: one CTA per work-list item (n_items of them).
int arks_paged_mixed_attention(
    const void* q, void* out, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos_start, const void* q_start, const void* q_len,
    const void* wl_seq, const void* wl_head, const void* wl_qb,
    const void* wl_plo, const void* wl_pages, int n_items, int n_heads,
    int hkv, int head_dim, int page, int n_pages, int max_pages, int layer,
    int block_q, float scale, int dtype, int kv_mode, void* stream) {
  if (!wl_seq || !wl_head || !wl_qb || !wl_plo || !wl_pages)
    return (int)cudaErrorInvalidValue;
  return dispatch(q, out, k_pool, v_pool, k_scale, v_scale, tables,
                  pos_start, q_start, q_len, wl_seq, wl_head, wl_qb, wl_plo,
                  wl_pages, n_items, 0, n_heads, hkv, head_dim, page, n_pages,
                  max_pages, layer, block_q, scale, dtype, kv_mode, stream);
}

// The dense launch: one CTA per (sequence, KV head, q-block) of the
// (n_seqs, num_qb) grid; no work list.
int arks_paged_mixed_attention_dense(
    const void* q, void* out, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos_start, const void* q_start, const void* q_len,
    int n_seqs, int num_qb, int n_heads, int hkv, int head_dim, int page,
    int n_pages, int max_pages, int layer, int block_q, float scale,
    int dtype, int kv_mode, void* stream) {
  if (num_qb <= 0) return n_seqs <= 0 ? 0 : (int)cudaErrorInvalidValue;
  return dispatch(q, out, k_pool, v_pool, k_scale, v_scale, tables,
                  pos_start, q_start, q_len, nullptr, nullptr, nullptr,
                  nullptr, nullptr, n_seqs * hkv * num_qb, num_qb, n_heads,
                  hkv, head_dim, page, n_pages, max_pages, layer, block_q,
                  scale, dtype, kv_mode, stream);
}

}  // extern "C"
