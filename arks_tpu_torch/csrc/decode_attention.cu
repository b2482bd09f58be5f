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
// the softmax is online in f32, p (times the per-token v scale of an int8
// cache) is rounded to the V dtype (q's dtype for int8) before p.V, and
// the output is acc / (l + 1e-9) cast to q's dtype.  Rows at or past the
// length are never loaded, so no V row of an unwritten or skipped
// position reaches p.V.  A slot of length 0 gets a zero output (the
// reference's is garbage no one samples: every score of it is masked).
//
// Bound on the H100: bytes.  Each (slot, KV head) reads its K and V prefix
// once (context x D x 2 B x 2 for bf16; half that plus 8 B of scales per
// token for int8) at 3.35 TB/s and does 2 flops per byte per query head —
// far below the ridge.  At a decode batch of 8 slots x 4 KV heads the
// whole batch is 14-23 MB, a few microseconds, so what matters is filling
// the card and keeping loads in flight.
//
// Design: split-KV.  The grid is (slot x KV head, piece): each CTA takes
// one piece of kSplit = 256 positions (one page of the served pool, 256
// rows of a stripe) and exits at once when the piece starts at or past its
// slot's length, so the grid comes from shapes (ceil(coverage / 256)
// pieces) with no host sync on the lengths.  A CTA writes its partial
// (m, l, acc[D]) in f32 per query head to a workspace; a second launch
// (decode_attention_combine_kernel) rescales the pieces by exp(m_i - M),
// divides by the sum of l_i exp(m_i - M) + 1e-9 and writes zeros for a
// length of 0.  At 8 slots of lengths up to 4096, 184 CTAs work where one
// CTA per (slot, KV head) gave 32.
//
// bf16 (the served path, decode_attention_split_kernel): 4 warps; the
// piece streams in tiles of 64 positions through two shared-memory
// buffers filled by cp.async (the next tile lands while the current one is
// reduced; rows past the length are zero-filled, never read).  The G query
// rows of the KV head are padded to 16 and the products run on the tensor
// cores: each warp takes 16 positions of a tile, q.k^T as mma.sync
// m16n8k16 bf16 -> f32 from ldmatrix fragments of Q and K, its own online
// softmax (m and l per row, kept across tiles), then p.V with p's f32
// accumulator fragments reused as the bf16 A operand and V read by
// ldmatrix.trans.  The 4 warps' states merge in shared memory at the end
// of the piece.  An int8 tile lands as bytes and is converted to bf16 in
// shared memory (exact for |v| <= 127), its scales beside it.
//
// f32 (parity runs, and an f32 engine over a bf16 cache;
// decode_attention_f32_kernel): the same pieces on CUDA cores, one warp per
// query head (G <= 8), tiles of 64 positions.  A bf16 cache under f32 q is
// widened to f32 on the copy into shared memory, as the reference casts
// its tiles to q's dtype, and p stays f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSplit = 256;          // positions per split-KV piece
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of f32 -> 4 floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// 16 cache bytes -> f32 at dst: 4 floats copied, or 8 bf16 widened.
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    dst[2 * u] = f.x;
    dst[2 * u + 1] = f.y;
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

// An int8 cache's 16 bytes -> 16 floats (the int8 path converts them
// this way; the overload keeps the f32 kernel's copy generic).
__device__ __forceinline__ void widen16(const int8_t* src, float* dst) {
  dequant16(src, dst);
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

// The pool row of position `pos` of slot b, or -1 when its table entry
// lies outside the pool.  tables == NULL: the slot layout (page = S,
// n_pages = B, slot b's one page is b).
__device__ __forceinline__ int64_t pool_row(const int* tables, int b, int h,
                                            int pos, int hkv, int page,
                                            int n_pages, int max_pages,
                                            int layer) {
  const int pg = tables ? tables[(int64_t)b * max_pages + pos / page] : b;
  if (pg < 0 || pg >= n_pages) return -1;
  return (((int64_t)layer * n_pages + pg) * hkv + h) * page + pos % page;
}

// The partials of one piece: [B, Hkv, splits, G, D + 2] f32, acc[D] then
// m and l.
template <typename F>
__device__ __forceinline__ F* partial(F* ws, int bh, int split, int n_splits,
                                      int group, int r, int d) {
  return ws + (((int64_t)bh * n_splits + split) * group + r) * (d + 2);
}

// ---------------------------------------------------------------------------
// bf16: split-KV on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTW = 4;               // warps; each takes 16 positions a tile
constexpr int kTT = 16 * kTW;        // positions per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cp.async of `bytes` (4 or 16) with the rest zero-filled: src_bytes 0
// reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory of the bf16 kernel: Q [16][D + 8] bf16, two buffers of
// (K tile, V tile) [kTT][D + 8] bf16 (rows padded by 16 bytes: ldmatrix
// reads them without bank conflicts), and for an int8 cache two buffers of
// raw (K, V) bytes [kTT][D] and of (k, v) scales [kTT]; then a valid flag
// per position of each buffer.
template <typename KV, int D>
struct SplitSmem {
  static constexpr int kRS = D + 8;
  static constexpr int kTile = kTT * kRS;              // bf16 elements
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr size_t kQ = sizeof(__nv_bfloat16) * 16 * kRS;
  static constexpr size_t kKV = sizeof(__nv_bfloat16) * 4 * kTile;
  static constexpr size_t kRaw = kQuant ? 4 * kTT * D : 0;
  static constexpr size_t kScales = kQuant ? sizeof(float) * 4 * kTT : 0;
  static constexpr size_t kFlags = sizeof(int) * 2 * kTT;
  static constexpr size_t kBytes = kQ + kKV + kRaw + kScales + kFlags;
  // The end-of-piece merge reuses the K/V buffers: acc [4][16][D] and
  // m, l [4][16] f32.
  static_assert(sizeof(float) * kTW * 16 * (D + 2) <= kKV, "merge space");
};

template <typename KV, int D>
__global__ void __launch_bounds__(kTW * 32) decode_attention_split_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ ws, int hkv,
    int group, int page, int n_pages, int max_pages, int layer, float scale,
    int n_splits) {
  using S = SplitSmem<KV, D>;
  using bf16 = __nv_bfloat16;
  constexpr int RS = S::kRS;
  constexpr bool QUANT = S::kQuant;
  constexpr int CPR = D * (int)sizeof(KV) / 16;   // 16-byte chunks a row

  const int bh = blockIdx.x;
  const int b = bh / hkv, h = bh % hkv;
  const int split = blockIdx.y;
  // Clamp to the table's coverage: a parked slot's length is S + 1.
  const int len = min(lengths[b], max_pages * page);
  const int s0 = split * kSplit;
  if (s0 >= len) return;          // the combine reads pieces below len
  const int s_end = min(len, s0 + kSplit);
  const int n_tiles = (s_end - s0 + kTT - 1) / kTT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kv = reinterpret_cast<bf16*>(smem + S::kQ);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + S::kQ + S::kKV);
  float* scl = reinterpret_cast<float*>(smem + S::kQ + S::kKV + S::kRaw);
  int* flags = reinterpret_cast<int*>(smem + S::kQ + S::kKV + S::kRaw +
                                      S::kScales);

  // Q rows of the group, padded with zero rows to 16.
  const int64_t qrow = (int64_t)bh * group;
  for (int e = tid; e < 16 * (D / 8); e += kTW * 32) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < group) v = *reinterpret_cast<const uint4*>(q + (qrow + r) * D + c);
    *reinterpret_cast<uint4*>(qs + r * RS + c) = v;
  }

  // Queue the loads of tile t into buffer buf: rows past the piece's end
  // or in a page outside the pool are zero-filled and flagged invalid.
  auto issue = [&](int t, int buf) {
    const int base = s0 + t * kTT;
    for (int e = tid; e < kTT * CPR; e += kTW * 32) {
      const int j = e / CPR, c = e % CPR;
      const int pos = base + j;
      const int64_t row = pos < s_end ? pool_row(tables, b, h, pos, hkv, page,
                                                 n_pages, max_pages, layer)
                                      : -1;
      const int64_t off =
          (row < 0 ? 0 : row) * D * (int64_t)sizeof(KV) + c * 16;
      const char* ksrc = reinterpret_cast<const char*>(k_pool) + off;
      const char* vsrc = reinterpret_cast<const char*>(v_pool) + off;
      const int n = row < 0 ? 0 : 16;
      if (QUANT) {
        int8_t* dst = raw + (buf * 2) * kTT * D + j * D + c * 16;
        cp_async16(dst, ksrc, n);
        cp_async16(dst + kTT * D, vsrc, n);
      } else {
        bf16* dst = kv + (buf * 2) * S::kTile + j * RS + c * 8;
        cp_async16(dst, ksrc, n);
        cp_async16(dst + S::kTile, vsrc, n);
      }
      if (c == 0) {
        flags[buf * kTT + j] = row >= 0;
        if (QUANT) {
          const int64_t r0 = row < 0 ? 0 : row;
          cp_async4(scl + (buf * 2) * kTT + j, k_scale + r0, row < 0 ? 0 : 4);
          cp_async4(scl + (buf * 2 + 1) * kTT + j, v_scale + r0,
                    row < 0 ? 0 : 4);
        }
      }
    }
    cp_async_commit();
  };

  issue(0, 0);

  const int g4 = lane >> 2, t4 = lane & 3;
  uint32_t qf[D / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g4, g4 + 8
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) o[n][u] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      issue(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8);
    }
    bf16* ks = kv + (buf * 2) * S::kTile;
    bf16* vs = ks + S::kTile;
    if (QUANT) {   // the landed bytes -> bf16 tiles, exactly
      const int8_t* rk = raw + (buf * 2) * kTT * D;
      for (int e = tid; e < 2 * kTT * (D / 16); e += kTW * 32) {
        const int which = e / (kTT * (D / 16));
        const int j = (e / (D / 16)) % kTT, c = (e % (D / 16)) * 16;
        dequant16(rk + which * kTT * D + j * D + c,
                  (which ? vs : ks) + j * RS + c);
      }
      __syncthreads();
    }
    const float* kss = scl + (buf * 2) * kTT;
    const float* vss = kss + kTT;
    const int* ok = flags + buf * kTT;
    const int j0 = warp * 16;                  // this warp's positions

    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[n][u] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t r[4];
      ldsm_x4(r, ks + (j0 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], qf[kk], r[0], r[1]);
      mma_bf16(sc[1], qf[kk], r[2], r[3]);
    }
    // Fragment (n, u): position j0 + 8n + 2 t4 + (u & 1), row g4 + 8 (u >> 1).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 8 * n + 2 * t4 + (u & 1);
        float v = sc[n][u] * scale;
        if (QUANT) v *= kss[j];
        sc[n][u] = ok[j] ? v : kNegInf;
        mx[u >> 1] = fmaxf(mx[u >> 1], sc[n][u]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_next);
      m[r] = m_next;
    }
    float ls[2] = {0.f, 0.f};
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float pv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 8 * n + 2 * t4 + (u & 1);
        const float e = ok[j] ? expf(sc[n][u] - m[u >> 1]) : 0.f;
        ls[u >> 1] += e;
        pv[u] = QUANT ? e * vss[j] : e;
      }
      pa[2 * n] = pack_bf16x2(pv[0], pv[1]);       // row g4
      pa[2 * n + 1] = pack_bf16x2(pv[2], pv[3]);   // row g4 + 8
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
      ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
      l[r] = l[r] * corr[r] + ls[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t r[4];
      ldsm_x4_trans(r, vs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                           dn * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dn], pa, r[0], r[1]);
      mma_bf16(o[2 * dn + 1], pa, r[2], r[3]);
    }
    __syncthreads();   // every warp is done with buf before it is refilled
  }

  // Merge the 4 warps' states of this piece, then write its partials.
  float* macc = reinterpret_cast<float*>(kv);        // [kTW][16][D]
  float* mm = macc + kTW * 16 * D;                   // [kTW][16]
  float* ml = mm + kTW * 16;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      macc[(warp * 16 + g4 + 8 * (u >> 1)) * D + 8 * n + 2 * t4 + (u & 1)] =
          o[n][u];
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mm[warp * 16 + g4 + 8 * r] = m[r];
      ml[warp * 16 + g4 + 8 * r] = l[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < group * D; e += kTW * 32) {
    const int r = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kTW; ++w) mx = fmaxf(mx, mm[w * 16 + r]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kTW; ++w) {
      const float f = expf(mm[w * 16 + r] - mx);
      acc += macc[(w * 16 + r) * D + d] * f;
      lsum += ml[w * 16 + r] * f;
    }
    float* out = partial(ws, bh, split, n_splits, group, r, D);
    out[d] = acc;
    if (d == 0) {
      out[D] = mx;
      out[D + 1] = lsum;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores (parity runs)
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;            // one warp per query head of the group
constexpr int kThreads = kWarps * 32;
constexpr int kKT = 64;              // KV tokens per shared-memory tile

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * kWarps * D                // queries
         + sizeof(float) * kKT * (D + 4)           // K tile, padded rows
         + sizeof(float) * kKT * D                 // V tile
         + sizeof(float) * kWarps * kKT            // per-warp p row
         + sizeof(float) * 2 * kKT;                // k and v scale tiles
}

// KV is the cache's element type: float itself, bf16 (widened), or int8_t
// for an int8 cache; the shared-memory tiles hold f32 in every case.  One CTA per
// (slot, KV head, piece), as the bf16 kernel, writing the same partials.
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_f32_kernel(
    const float* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ ws, int hkv,
    int group, int page, int n_pages, int max_pages, int layer, float scale,
    int n_splits) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = 4;
  constexpr int KSTRIDE = D + VEC;
  constexpr int DPL = D / 32;   // output columns per lane
  constexpr int TPL = kKT / 32; // tile tokens per lane in the score pass

  const int bh = blockIdx.x;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool active = warp < group;
  const int64_t qrow = (int64_t)bh * group;   // first of G rows
  const int len = min(lengths[b], max_pages * page);
  const int s0 = split * kSplit;
  if (s0 >= len) return;
  const int s_end = min(len, s0 + kSplit);

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kWarps * D;
  float* vs = ks + kKT * KSTRIDE;
  float* ps = vs + kKT * D;
  float* kss = ps + kWarps * kKT;   // tile's k scales (int8 caches)
  float* vss = kss + kKT;

  for (int e = tid; e < group * D; e += kThreads) qs[e] = q[qrow * D + e];

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int a = 0; a < DPL; ++a) acc[a] = 0.f;
  const float* qw = qs + warp * D;
  float* pw = ps + warp * kKT;

  for (int kv0 = s0; kv0 < s_end;) {
    const int tok0 = kv0 % page;
    const int nt = min(min(kKT, page - tok0), s_end - kv0);
    const int64_t row0 = pool_row(tables, b, h, kv0, hkv, page, n_pages,
                                  max_pages, layer);
    kv0 += nt;
    if (row0 < 0) continue;   // a table entry outside the pool
    const int64_t base = row0 * D;
    __syncthreads();  // every warp is done with the previous tile
    if (QUANT) {
      for (int e = tid; e < nt * (D / 16); e += kThreads) {
        const int j = e / (D / 16);
        const int c = (e % (D / 16)) * 16;
        const int64_t src = base + (int64_t)j * D + c;
        dequant16(reinterpret_cast<const int8_t*>(k_pool + src),
                  ks + j * KSTRIDE + c);
        dequant16(reinterpret_cast<const int8_t*>(v_pool + src),
                  vs + j * D + c);
      }
      for (int j = tid; j < kKT; j += kThreads) {
        const bool in = j < nt;
        kss[j] = in ? k_scale[row0 + j] : 0.f;
        vss[j] = in ? v_scale[row0 + j] : 0.f;
      }
    } else {
      constexpr int CV = 16 / sizeof(KV);     // cache elements per 16 bytes
      for (int e = tid; e < nt * (D / CV); e += kThreads) {
        const int j = e / (D / CV);
        const int c = (e % (D / CV)) * CV;
        const int64_t src = base + (int64_t)j * D + c;
        widen16(k_pool + src, ks + j * KSTRIDE + c);
        widen16(v_pool + src, vs + j * D + c);
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
        const float* kr = ks + j * KSTRIDE;
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
    mc = warp_max(mc);
    const float m_next = fmaxf(m, mc);
    const float corr = expf(m - m_next);
    float lsum = 0.f;
#pragma unroll
    for (int c = 0; c < TPL; ++c) {
      const int j = lane + 32 * c;
      const float pv = j < nt ? expf(sc[c] - m_next) : 0.f;
      lsum += pv;
      pw[j] = QUANT ? pv * vss[j] : pv;
    }
    lsum = warp_sum(lsum);
    l = l * corr + lsum;
    m = m_next;
    __syncwarp();
#pragma unroll
    for (int a = 0; a < DPL; ++a) acc[a] *= corr;
    for (int j = 0; j < nt; ++j) {
      const float pj = pw[j];
      const float* vr = vs + j * D + lane * DPL;
#pragma unroll
      for (int a = 0; a < DPL; ++a) acc[a] = fmaf(pj, vr[a], acc[a]);
    }
    __syncwarp();
  }

  if (!active) return;
  float* out = partial(ws, bh, split, n_splits, group, warp, D);
#pragma unroll
  for (int a = 0; a < DPL; ++a) out[lane * DPL + a] = acc[a];
  if (lane == 0) {
    out[D] = m;
    out[D + 1] = l;
  }
}

// ---------------------------------------------------------------------------
// The combine: one CTA per (slot, KV head), one warp per query head
// ---------------------------------------------------------------------------

constexpr int kCombineThreads = 32 * 8;   // G <= 8
constexpr int kMaxDPL = 4;                // head_dim <= 128: 4 columns a lane

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine_kernel(const float* __restrict__ ws,
                                const int* __restrict__ lengths,
                                T* __restrict__ out, int hkv, int group,
                                int head_dim, int cover, int n_splits) {
  const int bh = blockIdx.x, r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (r >= group) return;
  const int len = min(lengths[bh / hkv], cover);
  const int n = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  T* o = out + ((int64_t)bh * group + r) * head_dim;
  // The pieces' maxima and sums, a lane per piece.
  float mx = kNegInf;
  for (int s = lane; s < n; s += 32)
    mx = fmaxf(mx, partial(ws, bh, s, n_splits, group, r, head_dim)[head_dim]);
  mx = warp_max(mx);
  float lsum = 0.f;
  for (int s = lane; s < n; s += 32) {
    const float* p = partial(ws, bh, s, n_splits, group, r, head_dim);
    lsum += p[head_dim + 1] * expf(p[head_dim] - mx);
  }
  lsum = warp_sum(lsum);
  float acc[kMaxDPL] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n; ++s) {
    const float* p = partial(ws, bh, s, n_splits, group, r, head_dim);
    const float f = expf(p[head_dim] - mx);
#pragma unroll
    for (int a = 0; a < kMaxDPL; ++a)
      if (lane + 32 * a < head_dim) acc[a] += p[lane + 32 * a] * f;
  }
#pragma unroll
  for (int a = 0; a < kMaxDPL; ++a)
    if (lane + 32 * a < head_dim)
      o[lane + 32 * a] = from_float<T>(n > 0 ? acc[a] / (lsum + 1e-9f) : 0.f);
}

template <typename T>
int launch_combine(const float* ws, const int* lengths, void* out, int nbh,
                   int hkv, int group, int head_dim, int cover, int n_splits,
                   cudaStream_t stream) {
  decode_attention_combine_kernel<T><<<nbh, kCombineThreads, 0, stream>>>(
      ws, lengths, (T*)out, hkv, group, head_dim, cover, n_splits);
  return (int)cudaGetLastError();
}

// kv: 0 = a cache of q's dtype, 1 = int8, 2 = bf16 under f32 q.
template <int KVM, int D>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale, const int* tables,
                 const int* lengths, float* ws, dim3 grid, int hkv, int group,
                 int page, int n_pages, int max_pages, int layer, float scale,
                 int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    using K = typename std::conditional<KVM == 1, int8_t, bf16>::type;
    constexpr size_t smem = SplitSmem<K, D>::kBytes;
    if (KVM == 2) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split_kernel<K, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_attention_split_kernel<K, D><<<grid, kTW * 32, smem, stream>>>(
        (const bf16*)q, (const K*)k_pool, (const K*)v_pool, k_scale, v_scale,
        tables, lengths, ws, hkv, group, page, n_pages, max_pages, layer,
        scale, (int)grid.y);
  } else {
    using K = typename std::conditional<
        KVM == 1, int8_t,
        typename std::conditional<KVM == 2, __nv_bfloat16, float>::type>::type;
    constexpr size_t smem = f32_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_f32_kernel<K, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_attention_f32_kernel<K, D><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const K*)k_pool, (const K*)v_pool, k_scale, v_scale,
        tables, lengths, ws, hkv, group, page, n_pages, max_pages, layer,
        scale, (int)grid.y);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* q, void* out, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* lengths, void* ws, int n_slots, int n_heads, int hkv,
             int head_dim, int page, int n_pages, int max_pages, int layer,
             float scale, int dtype, int quant, void* stream) {
  if (n_slots <= 0) return 0;
  if (hkv <= 0 || n_heads % hkv != 0 || n_heads / hkv > kWarps ||
      page <= 0 || max_pages <= 0 || ws == nullptr ||
      (dtype != 0 && dtype != 1) || quant < 0 || quant > 2 ||
      (quant == 1 && (!k_scale || !v_scale)) || (quant == 2 && dtype != 0))
    return (int)cudaErrorInvalidValue;
  const int group = n_heads / hkv;
  const int cover = max_pages * page;
  const dim3 grid(n_slots * hkv, (cover + kSplit - 1) / kSplit);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* tb = (const int*)tables;
  const int* ln = (const int*)lengths;
  float* w = (float*)ws;
  int err;
#define ARKS_ARGS                                                             \
  q, k_pool, v_pool, ks, vs, tb, ln, w, grid, hkv, group, page, n_pages,      \
      max_pages, layer, scale, dtype, st
  if (head_dim == 128)
    err = quant == 1 ? launch_split<1, 128>(ARKS_ARGS)
          : quant == 2 ? launch_split<2, 128>(ARKS_ARGS)
                       : launch_split<0, 128>(ARKS_ARGS);
  else if (head_dim == 64)
    err = quant == 1 ? launch_split<1, 64>(ARKS_ARGS)
          : quant == 2 ? launch_split<2, 64>(ARKS_ARGS)
                       : launch_split<0, 64>(ARKS_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef ARKS_ARGS
  if (err != 0) return err;
  const int nbh = n_slots * hkv;
  return dtype == 1 ? launch_combine<__nv_bfloat16>(w, ln, out, nbh, hkv,
                                                    group, head_dim, cover,
                                                    (int)grid.y, st)
                    : launch_combine<float>(w, ln, out, nbh, hkv, group,
                                            head_dim, cover, (int)grid.y, st);
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q / out [B, Hkv, G, D] of dtype (0 = float32, 1 = bfloat16); caches
// [L, B, Hkv, S, D] of q's dtype (quant 0, scales NULL), int8 (quant 1)
// with f32 scales [L, B, Hkv, S], or bf16 under f32 q (quant 2); lengths [B] int32; ws the f32 partials
// [B, Hkv, ceil(S / 256), G, D + 2].  head_dim 64 or 128, G = n_heads /
// hkv <= 8; the wrapper checks all of these and raises.
int arks_ragged_decode_attention(const void* q, void* out, const void* k_cache,
                                 const void* v_cache, const void* k_scale,
                                 const void* v_scale, const void* lengths,
                                 void* ws, int n_slots, int n_heads, int hkv,
                                 int head_dim, int max_len, int layer,
                                 float scale, int dtype, int quant,
                                 void* stream) {
  return dispatch(q, out, k_cache, v_cache, k_scale, v_scale, nullptr,
                  lengths, ws, n_slots, n_heads, hkv, head_dim, max_len,
                  n_slots, 1, layer, scale, dtype, quant, stream);
}

// As above over the paged pool [L, N, Hkv, P, D] (scales [L, N, Hkv, P])
// through tables [B, max_pages] int32; lengths past max_pages * P clamp;
// ws [B, Hkv, ceil(max_pages * P / 256), G, D + 2].
int arks_paged_decode_attention(const void* q, void* out, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* tables,
                                const void* lengths, void* ws, int n_slots,
                                int n_heads, int hkv, int head_dim, int page,
                                int n_pages, int max_pages, int layer,
                                float scale, int dtype, int quant,
                                void* stream) {
  if (!tables) return (int)cudaErrorInvalidValue;
  return dispatch(q, out, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                  ws, n_slots, n_heads, hkv, head_dim, page, n_pages,
                  max_pages, layer, scale, dtype, quant, stream);
}

}  // extern "C"
