// Block-sparse grouped matmul for the MoE experts, with the int8 / int4
// weight dequant fused.
//
// Replaces the Pallas kernel arks_tpu/ops/moe_kernel.py:81 `_gm_kernel`
// (launched by `grouped_matmul`).  What it computes is the reference's:
// xs [Tp, K] holds expert-sorted rows, each expert's group padded with zero
// rows to a multiple of 128 (`pad_groups`), so row tile i (128 rows)
// belongs to expert block_expert[i]; out[tile] = xs[tile] @ w[expert]:
//  - raw weights (w [X, K, N] of xs's dtype): the product, f32 accumulate;
//  - int8 (w [X, K, N] int8, scale [X, N] f32): the product of xs with
//    the int8 values (exact in bf16), then acc * scale[expert, n] in f32;
//  - int4 (w [X, K/2, N] int8, rows 2i / 2i+1 in the low / high nibble;
//    scale [X, K/G, N] f32): each weight dequantized IN xs's DTYPE,
//    dtype(q) * dtype(gs) rounded to that dtype (the reference's
//    `w.astype(x.dtype) * gs.astype(x.dtype)`), then the product.
// The output is cast to xs's dtype.  The CTA reads its tile's expert from
// block_expert on the device (no Pallas grid carried over).  Tiles at or
// past rows_used[0] (the padded groups' end) hold only zero rows: they
// write zeros without a product — the same bytes the product gives.  N is
// masked at the tile edge (N % 16 == 0); K runs in steps of 32 and an int4
// group holds whole steps (G % 32 == 0).
//
// Bound on the H100 at Mixtral-8x7B (one mixed step: 264 tokens x top-2 =
// 528 routed rows over 8 experts): bytes.  Every expert is routed, so each
// launch streams all 8 experts' weights once: 470 MB int8 per 4096 x 14336
// matrix (140 us at 3.35 TB/s), about half that for int4, twice for bf16;
// the products are 2 x 528 x 4096 x 14336 = 62 GFLOP (63 us at 989
// TFLOP/s).  So the kernel must read each weight byte once and keep the
// tensor cores fed, never run the FMA pipes over ~1,000 real rows.
//
// Design (bf16 activations, the served path): one CTA per 128 x 128
// output tile, 8 warps as 2 (rows) x 4 (columns), each warp 64 x 32 of
// mma.sync m16n8k16 bf16 -> f32.  K steps of 32: the next step's xs and
// weight bytes are loaded into registers while the tensor cores work on
// the current step in shared memory (double-buffered), then converted to
// bf16 on the store into shared memory — int8 exactly, int4 with its
// group scale (one group per step) — so the inner loop is the plain bf16
// one.  A tile's expert weights [K, 128 columns] are read once per row
// tile; at Mixtral nearly every expert has a single row tile, so the
// weights cross HBM about once.  Fragments come from shared memory by
// ldmatrix (.trans for the k-major weight tile), rows padded by 16 bytes
// so neither load has bank conflicts.  wgmma, TMA and a persistent
// schedule are later work.
//
// f32 activations (parity runs only): a CUDA-core kernel with the same
// tile walk, 64 x 64 tiles, 4 x 4 outputs per thread, f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // rows per expert tile (block_t)
constexpr int kThreads = 256;
enum { kRaw = 0, kInt8 = 1, kInt4 = 2 };

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kAS = kBK + 8;   // xs tile row stride (bf16): 80 B
constexpr int kBS = kBN + 8;   // weight tile row stride (bf16): 272 B

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

// int4 dequant in bf16: bf16(q) * bf16(gs), rounded to bf16.  q is a small
// integer (exact in bf16) and the product of two bf16 values is exact in
// f32, so one rounding of the f32 product is the bf16 multiply.
__device__ __forceinline__ float deq4_bf16(int q, float gs_bf16) {
  return __bfloat162float(__float2bfloat16_rn((float)q * gs_bf16));
}

// Weight bytes of one K step held in registers between the global load and
// the shared-memory store.
struct WStage {
  uint4 v[2];
  float gs[8];
};

template <int MODE>
__device__ __forceinline__ void load_w_bf16(WStage& st, const void* w,
                                            const float* scale, int e, int k0,
                                            int n0, int K, int N, int group,
                                            int tid) {
  if (MODE == kRaw) {            // 32 rows x 16 chunks of 8 bf16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 4, c = (q & 15) * 8;
      st.v[i] = make_uint4(0, 0, 0, 0);
      if (n0 + c < N)
        st.v[i] = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const __nv_bfloat16*>(w) +
            ((int64_t)e * K + k0 + r) * N + n0 + c);
    }
  } else if (MODE == kInt8) {    // 32 rows x 8 chunks of 16 bytes
    const int r = tid >> 3, c = (tid & 7) * 16;
    st.v[0] = make_uint4(0, 0, 0, 0);
    if (n0 + c < N)
      st.v[0] = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const int8_t*>(w) +
          ((int64_t)e * K + k0 + r) * N + n0 + c);
  } else {                       // 16 packed rows x 16 chunks of 8 bytes
    const int r = tid >> 4, c = (tid & 15) * 8;
    st.v[0] = make_uint4(0, 0, 0, 0);
    if (n0 + c < N) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const int8_t*>(w) +
          ((int64_t)e * (K / 2) + k0 / 2 + r) * N + n0 + c);
      st.v[0].x = b.x;
      st.v[0].y = b.y;
      const float* g =
          scale + ((int64_t)e * (K / group) + k0 / group) * N + n0 + c;
      const float4 g0 = *reinterpret_cast<const float4*>(g);
      const float4 g1 = *reinterpret_cast<const float4*>(g + 4);
      st.gs[0] = g0.x; st.gs[1] = g0.y; st.gs[2] = g0.z; st.gs[3] = g0.w;
      st.gs[4] = g1.x; st.gs[5] = g1.y; st.gs[6] = g1.z; st.gs[7] = g1.w;
    }
  }
}

template <int MODE>
__device__ __forceinline__ void store_w_bf16(const WStage& st,
                                             __nv_bfloat16* bs, int tid) {
  if (MODE == kRaw) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 4, c = (q & 15) * 8;
      *reinterpret_cast<uint4*>(bs + r * kBS + c) = st.v[i];
    }
  } else if (MODE == kInt8) {
    const int r = tid >> 3, c = (tid & 7) * 16;
    const int8_t* b = reinterpret_cast<const int8_t*>(&st.v[0]);
    uint4 o[2];
    uint32_t* ow = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      ow[u] = pack_bf16x2((float)b[2 * u], (float)b[2 * u + 1]);
    *reinterpret_cast<uint4*>(bs + r * kBS + c) = o[0];
    *reinterpret_cast<uint4*>(bs + r * kBS + c + 8) = o[1];
  } else {
    const int r = tid >> 4, c = (tid & 15) * 8;
    const int8_t* b = reinterpret_cast<const int8_t*>(&st.v[0]);
    uint4 even, odd;
    uint32_t* ew = reinterpret_cast<uint32_t*>(&even);
    uint32_t* ow = reinterpret_cast<uint32_t*>(&odd);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float lo[2], hi[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int byte = b[2 * u + j];
        const float g = __bfloat162float(__float2bfloat16_rn(st.gs[2 * u + j]));
        lo[j] = deq4_bf16((int)((unsigned)byte << 28) >> 28, g);
        hi[j] = deq4_bf16(byte >> 4, g);
      }
      ew[u] = pack_bf16x2(lo[0], lo[1]);
      ow[u] = pack_bf16x2(hi[0], hi[1]);
    }
    *reinterpret_cast<uint4*>(bs + (2 * r) * kBS + c) = even;
    *reinterpret_cast<uint4*>(bs + (2 * r + 1) * kBS + c) = odd;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) grouped_matmul_bf16_kernel(
    const __nv_bfloat16* __restrict__ xs, const void* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ block_expert,
    const int* __restrict__ rows_used, __nv_bfloat16* __restrict__ out,
    int K, int N, int group) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kTile * kAS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kBS];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kTile;
  if (rows_used != nullptr && m0 >= rows_used[0]) {
    // Only zero rows here: write the zeros the product would give.
    for (int q = tid; q < kTile * (kBN / 8); q += kThreads) {
      const int r = q / (kBN / 8), c = (q % (kBN / 8)) * 8;
      if (n0 + c < N)
        *reinterpret_cast<uint4*>(out + (int64_t)(m0 + r) * N + n0 + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int e = block_expert[blockIdx.y];
  const int warp = tid >> 5, lane = tid & 31;
  const int wm0 = (warp >> 2) * 64;   // warp's rows in the tile
  const int wn0 = (warp & 3) * 32;    // warp's columns in the tile

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mi][ni][u] = 0.f;

  uint4 a_st[2];
  WStage w_st;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // 128 rows x 4 chunks of 8 bf16
      const int q = tid + i * kThreads;
      const int r = q >> 2, c = (q & 3) * 8;
      a_st[i] = *reinterpret_cast<const uint4*>(
          xs + (int64_t)(m0 + r) * K + k0 + c);
    }
    load_w_bf16<MODE>(w_st, w, scale, e, k0, n0, K, N, group, tid);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 2, c = (q & 3) * 8;
      *reinterpret_cast<uint4*>(&As[buf][r * kAS + c]) = a_st[i];
    }
    store_w_bf16<MODE>(w_st, Bs[buf], tid);
  };

  const int steps = K / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], &As[buf][(wm0 + mi * 16 + (lane & 15)) * kAS + kk +
                                (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, &Bs[buf][(kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      kBS + wn0 + nj * 16 + (lane >> 4) * 8]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn0 + ni * 8 + 2 * t;
    if (col >= N) continue;
    float s0 = 1.f, s1 = 1.f;
    if (MODE == kInt8) {
      s0 = scale[(int64_t)e * N + col];
      s1 = scale[(int64_t)e * N + col + 1];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = m0 + wm0 + mi * 16 + g;
      const float* c = acc[mi][ni];
      __nv_bfloat162 lo = __floats2bfloat162_rn(c[0] * s0, c[1] * s1);
      __nv_bfloat162 hi = __floats2bfloat162_rn(c[2] * s0, c[3] * s1);
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * N + col) = lo;
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(row + 8) * N + col) =
          hi;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores (parity runs)
// ---------------------------------------------------------------------------

constexpr int kFB = 64;   // f32 tile rows and columns
constexpr int kFK = 16;   // f32 K step

template <int MODE>
__global__ void __launch_bounds__(kThreads) grouped_matmul_f32_kernel(
    const float* __restrict__ xs, const void* __restrict__ w,
    const float* __restrict__ scale, const int* __restrict__ block_expert,
    const int* __restrict__ rows_used, float* __restrict__ out, int K, int N,
    int group) {
  __shared__ float As[kFK][kFB + 4];   // [k][row]
  __shared__ float Bs[kFK][kFB + 4];   // [k][column]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kFB;
  const int m0 = blockIdx.y * kFB;
  if (rows_used != nullptr && m0 >= rows_used[0]) {
    for (int q = tid; q < kFB * (kFB / 4); q += kThreads) {
      const int r = q / (kFB / 4), c = (q % (kFB / 4)) * 4;
      if (n0 + c < N)
        *reinterpret_cast<float4*>(out + (int64_t)(m0 + r) * N + n0 + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int e = block_expert[m0 / kTile];
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    {  // xs: 64 rows x 16 k, one float4 per thread
      const int r = tid >> 2, c = (tid & 3) * 4;
      const float4 a =
          *reinterpret_cast<const float4*>(xs + (int64_t)(m0 + r) * K + k0 + c);
      As[c][r] = a.x; As[c + 1][r] = a.y; As[c + 2][r] = a.z; As[c + 3][r] = a.w;
    }
    if (MODE == kInt4) {   // 8 packed rows x 32 pairs of columns
      const int r = tid >> 5, c = (tid & 31) * 2;
      float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};
      if (n0 + c < N) {
        const int8_t* b = reinterpret_cast<const int8_t*>(w) +
                          ((int64_t)e * (K / 2) + k0 / 2 + r) * N + n0 + c;
        const float* g =
            scale + ((int64_t)e * (K / group) + k0 / group) * N + n0 + c;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int byte = b[j];
          lo[j] = (float)((int)((unsigned)byte << 28) >> 28) * g[j];
          hi[j] = (float)(byte >> 4) * g[j];
        }
      }
      Bs[2 * r][c] = lo[0]; Bs[2 * r][c + 1] = lo[1];
      Bs[2 * r + 1][c] = hi[0]; Bs[2 * r + 1][c + 1] = hi[1];
    } else {               // 16 rows x 16 chunks of 4 columns
      const int r = tid >> 4, c = (tid & 15) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (n0 + c < N) {
        const int64_t off = ((int64_t)e * K + k0 + r) * N + n0 + c;
        if (MODE == kRaw) {
          const float4 f = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(w) + off);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
          const char4 q = *reinterpret_cast<const char4*>(
              reinterpret_cast<const int8_t*>(w) + off);
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[r][c + j] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int col = n0 + tx * 4;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (MODE == kInt8) {
      const float* s = scale + (int64_t)e * N + col;
      o.x *= s[0]; o.y *= s[1]; o.z *= s[2]; o.w *= s[3];
    }
    *reinterpret_cast<float4*>(out + (int64_t)(m0 + ty * 4 + i) * N + col) = o;
  }
}

template <int MODE>
int launch(const void* xs, const void* w, const float* scale,
           const int* block_expert, const int* rows_used, void* out, int tp,
           int K, int N, int group, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((N + kBN - 1) / kBN, tp / kTile);
    grouped_matmul_bf16_kernel<MODE><<<grid, kThreads, 0, stream>>>(
        (const __nv_bfloat16*)xs, w, scale, block_expert, rows_used,
        (__nv_bfloat16*)out, K, N, group);
  } else {
    const dim3 grid((N + kFB - 1) / kFB, tp / kFB);
    grouped_matmul_f32_kernel<MODE><<<grid, kThreads, 0, stream>>>(
        (const float*)xs, w, scale, block_expert, rows_used, (float*)out, K,
        N, group);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xs [tp, k] (dtype 0 = float32, 1 = bfloat16; out [tp, n] the same), w by
// mode: 0 = [nx, k, n] of xs's dtype (scale NULL), 1 = int8 [nx, k, n] with
// scale [nx, n] f32, 2 = packed int4 [nx, k/2, n] with scale [nx, k/group,
// n] f32.  block_expert [tp / 128] int32; rows_used NULL or [1] int32.
// tp % 128 == 0, k % 32 == 0, n % 16 == 0, and for int4 group % 32 == 0
// dividing k; the wrapper checks all of these (and raises) first.
int arks_grouped_matmul(const void* xs, const void* w, const void* scale,
                        const void* block_expert, const void* rows_used,
                        void* out, int tp, int k, int n, int nx, int group,
                        int mode, int dtype, void* stream) {
  if (tp <= 0 || n <= 0) return 0;
  if (tp % kTile || k <= 0 || k % kBK || n % 16 || nx <= 0 ||
      (dtype != 0 && dtype != 1) || (mode != kRaw && scale == nullptr) ||
      (mode == kInt4 && (group <= 0 || group % kBK || k % group)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const int* be = (const int*)block_expert;
  const int* ru = (const int*)rows_used;
  if (mode == kRaw)
    return launch<kRaw>(xs, w, sc, be, ru, out, tp, k, n, group, dtype, st);
  if (mode == kInt8)
    return launch<kInt8>(xs, w, sc, be, ru, out, tp, k, n, group, dtype, st);
  if (mode == kInt4)
    return launch<kInt4>(xs, w, sc, be, ru, out, tp, k, n, group, dtype, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
