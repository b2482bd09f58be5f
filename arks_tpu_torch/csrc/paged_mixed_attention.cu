// Ragged mixed prefill+decode attention over the paged KV pool, split-KV.
//
// Replaces the Pallas kernel arks_tpu/ops/paged_attention.py
// `_paged_mixed_ragged_kernel` (body `_mixed_softmax_block`, launched by
// `paged_mixed_attention`) for bf16/f32, int8 and int4 pools, with its page
// span (`page_lo`/`page_hi`, folded into the work list) and its carried and
// emitted online-softmax state.  What it computes is the reference's: for
// every work item (sequence s, KV head h, q-block qb) of
// `build_mixed_work_list`, the G query heads x rows query rows of that
// q-block attend causally — row i (global position pos_start[s] +
// qb*block_q + i) sees the pool positions of its span [plo*P, pages*P) up
// to that position, through s's block-table pages.  Scores are f32 (q.k in
// f32, then * 1/sqrt(D), then, for a quantized pool, * the per-token k
// scale), masked positions get -1e30 and p = 0, the softmax is online with
// f32 m and l, p (times the per-token v scale of a quantized pool) is
// rounded to q's dtype before p.V, and the output is acc / (l + 1e-9) in
// q's dtype — or, with emit_state, the raw f32 (m, l, acc) of every row;
// with carry_state the fold starts from the given state instead of
// (-1e30, 0, 0).  A pool of another dtype than q (a bf16 pool under f32 q)
// is widened to q's dtype on its way into shared memory, as the reference
// casts its tiles (`astype(q.dtype)`).
//
// Two entries share the kernels.  `arks_paged_mixed_attention` walks the
// ragged work list (replaces `_paged_mixed_ragged_kernel`);
// `arks_paged_mixed_attention_dense` (ARKS_MIXED_GRID=dense) walks the
// whole (S, Hkv, num_qb) rectangle and replaces the dense-grid Pallas
// kernel `_paged_mixed_kernel` (arks_tpu/ops/paged_attention.py:675).  A
// dense item finds its causal page count as the work list does; an item
// whose q-block lies past its lane's q_len has no pieces.  Both launches
// cut items into the same pieces and fold them the same way, so every
// valid row is bit-identical between the two.
//
// Design.  Bound on the H100: bytes at decode (each (sequence, KV head)
// reads its K/V prefix once at 3.35 TB/s and does ~G flops per byte, far
// under the 295 flop/byte ridge); prefill chunks raise the intensity to
// G x block_q rows per K/V element, so their q-blocks want the tensor
// cores.
//  - Split-KV pieces.  An item's span is cut into pieces of one page
//    (256 positions at most; a larger page gives page/256 pieces).  A
//    piece computes its own (m, l, acc) in f32 over its positions from
//    (-1e30, 0, 0).  The launch's wrapper lays the pieces out on the
//    device, with no host sync: per item the inclusive prefix sum of piece
//    counts (pcum) and the base row of its partials (pbase), and per piece
//    its item (pitem), so the list of items keeps its fixed length and the
//    grid its fixed size.  The grid is persistent (one CTA per SM for the
//    bf16 kernel): CTA b takes pieces b, b + gridDim, ... in item order.
//    A second launch, the combine (one CTA per item and 32 of its rows),
//    folds each item's pieces in page order — a LEFT fold, state =
//    fold(state, piece) with state starting at the carried state or
//    (-1e30, 0, 0) — and writes the normalized output or the raw state.  An item of one piece with no
//    state in or out is folded and written by its piece (the same fold
//    function, so the bytes are those the combine would write).  Because
//    spans start and end on page boundaries and the fold is a left fold,
//    a span [0, k) emitting state and [k, end) carrying it give the single
//    call's bytes.  At phase 3's lengths the 8 decode lanes alone are ~150
//    pieces over 4 KV heads, where one CTA per (lane, head) gave 32.
//  - Tensor cores (bf16 q): mma.sync m16n8k16 bf16 -> f32.  An item's G
//    query heads x its REAL query rows are packed into the M dimension
//    (row r = i * G + g), so a decode lane costs one m16 tile (G <= 8 rows
//    padded to 16) and a 32-row q-block of G = 7 fourteen.  16 warps; each
//    owns one m16 tile and a slice of every chunk's positions (a tile
//    with few row tiles splits each chunk's 128 positions over up to 8
//    warps; their states merge in a tree through shared memory at the end
//    of the piece).  Q, K and V come to the tensor cores by ldmatrix from
//    shared memory whose rows are padded by 16 bytes (no bank conflicts);
//    p's f32 accumulator fragments are reused as the bf16 A operand of
//    p.V and V is read by ldmatrix.trans.  A warp steps through its
//    positions 16 at a time; steps past the tile's last causal position
//    are skipped.
//  - cp.async double buffering: a piece streams in chunks of 128
//    positions; chunk c + 1's copies are in flight while chunk c is
//    reduced.  An int8 / int4 chunk lands as raw bytes beside its f32
//    scales and is dequantized (int4 unpacked: sign extension by two
//    arithmetic shifts, pairs back to token order) into the bf16 tile,
//    exactly (|v| <= 127).  Rows past the piece's causal end are
//    zero-filled, never read from the pool.
//  - f32 q (parity runs, and an f32 engine over a bf16 pool): the same
//    pieces and fold on CUDA-core f32 FMAs (TF32 would change the numbers
//    the f32 tests hold), 8 warps, one query row per warp at a time (8
//    rows per warp per pass of 64 rows), K/V chunks of 64 positions widened
//    to f32 on the copy into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPiece = 256;     // most positions per split-KV piece
constexpr int kBQ = 32;         // most query rows per item (block_q <= kBQ)
constexpr int kMaxG = 8;        // most query heads per KV head
constexpr float kNegInf = -1e30f;

// Pool streams: the pool holds q's dtype, int8, packed int4, or bf16 under
// f32 q (widened on the copy).
enum { kSame = 0, kInt8 = 1, kInt4 = 2, kBf16Pool = 3 };

// Everything a launch reads and writes.  Work list pointers are NULL on
// the dense grid; carry and emit pointers are NULL unless used.
struct Args {
  const void* q;
  void* out;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* pos_start;
  const int* q_start;
  const int* q_len;
  const int* wl_seq;
  const int* wl_head;
  const int* wl_qb;
  const int* wl_plo;
  const int* wl_pages;
  const int* pcum;      // [n_items] inclusive prefix sum of piece counts
  const int* pbase;     // [n_items] first partial row / G of each item
  const int* pitem;     // [max pieces] the item of each piece
  float* ws;            // partials [ws_rows, D + 4] f32: acc, m, l, pad
  const float* carry_m;    // [T, H]
  const float* carry_l;    // [T, H]
  const float* carry_acc;  // [T, H, D]
  float* emit_m;
  float* emit_l;
  float* emit_acc;
  int64_t ws_rows;
  int n_items, num_qb, n_heads, hkv, page, n_pages, max_pages, layer,
      block_q;
  float scale;
};

// One work item as a launch sees it.
struct Item {
  int s, h, q_lo, rows, plo, npages;
};

// Item i of the ragged list or of the dense rectangle; false for a
// padding item (pages == 0) or an idle q-block.
__device__ __forceinline__ bool load_item(const Args& a, int i, Item& it) {
  if (a.wl_seq != nullptr) {
    it.npages = a.wl_pages[i];
    if (it.npages <= 0) return false;
    it.s = a.wl_seq[i];
    it.h = a.wl_head[i];
    it.q_lo = a.wl_qb[i] * a.block_q;
    it.plo = a.wl_plo[i];
  } else {
    it.s = i / (a.hkv * a.num_qb);
    it.h = (i / a.num_qb) % a.hkv;
    it.q_lo = (i % a.num_qb) * a.block_q;
    it.plo = 0;
  }
  it.rows = min(a.block_q, a.q_len[it.s] - it.q_lo);
  if (it.rows <= 0) return false;
  if (a.wl_seq == nullptr) {
    const int end = a.pos_start[it.s] + it.q_lo + it.rows;
    it.npages = min((end + a.page - 1) / a.page, a.max_pages);
  }
  return true;
}

__device__ __forceinline__ int piece_count(const Args& a, int i) {
  return a.pcum[i] - (i > 0 ? a.pcum[i - 1] : 0);
}

// The fold of two online-softmax states: (m, l) becomes the merged state
// and a, b the weights of the old acc and of the incoming one.  Explicit
// roundings (no contraction the compiler could place differently at two
// call sites), so every fold of the same states gives the same bits.
__device__ __forceinline__ void fold_ml(float& m, float& l, float mp,
                                        float lp, float& a, float& b) {
  const float mx = fmaxf(m, mp);
  a = expf(m - mx);
  b = expf(mp - mx);
  l = __fmaf_rn(lp, b, __fmul_rn(l, a));
  m = mx;
}

__device__ __forceinline__ float fold_acc(float acc, float accp, float a,
                                          float b) {
  return __fmaf_rn(accp, b, __fmul_rn(acc, a));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row r of an item's piece state goes to its flat (token, head) row.
__device__ __forceinline__ int64_t flat_row(const Args& a, const Item& it,
                                            int G, int r) {
  const int t = a.q_start[it.s] + it.q_lo + r / G;
  return (int64_t)t * a.n_heads + it.h * G + r % G;
}

// Where a piece's state goes: its partial row, or (one piece, no state
// in or out) the folded, normalized output.
__device__ __forceinline__ float* partial_row(const Args& a, int item, int k,
                                              int R, int G, int r, int D) {
  const int64_t row = (int64_t)G * a.pbase[item] + (int64_t)k * R + r;
  return a.ws + row * (D + 4);
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCH = 128;        // positions per shared-memory chunk

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

// cp.async of 16 (or 4) bytes, the rest zero-filled: src_bytes 0 reads
// nothing and writes zeros.
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

// 16 int values -> 16 bf16 at dst (16-byte aligned), exactly.
__device__ __forceinline__ void put16(const int* v, bf16* dst) {
  uint4 out[2];
  uint32_t* w = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    w[u] = pack_bf16x2((float)v[2 * u], (float)v[2 * u + 1]);
  *reinterpret_cast<uint4*>(dst) = out[0];
  *reinterpret_cast<uint4*>(dst + 8) = out[1];
}
__device__ __forceinline__ void put16(const int* v, float* dst) {
#pragma unroll
  for (int u = 0; u < 16; u += 4)
    *reinterpret_cast<float4*>(dst + u) =
        make_float4((float)v[u], (float)v[u + 1], (float)v[u + 2],
                    (float)v[u + 3]);
}

// 16 int8 bytes -> 16 values.
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
// and of the odd token (high nibbles), sign-extended.
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

// Shared memory of the bf16 kernel: the item's Q rows [256][D + 8] bf16;
// then the K and V chunk tiles [kCH][D + 8] bf16 (two buffers of each for
// a bf16 pool, filled by cp.async; one of each for a quantized pool, whose
// raw bytes [kCH (int4: kCH / 2)][D] and f32 scales [kCH] land in two
// buffers beside them).  The end-of-piece merge of warp states
// [8][16][D + 4] f32 reuses the chunk region.
template <int D, int KVM>
struct TcSmem {
  static constexpr int kRS = D + 8;
  static constexpr int kTileElems = kCH * kRS;
  static constexpr int kBufs = KVM == kSame ? 2 : 1;
  static constexpr int kRawRows = KVM == kInt4 ? kCH / 2 : kCH;
  static constexpr size_t kQ = sizeof(bf16) * kMaxG * kBQ * kRS;
  static constexpr size_t kTiles = sizeof(bf16) * 2 * kBufs * kTileElems;
  static constexpr size_t kRaw = KVM == kSame ? 0 : 2 * 2 * kRawRows * D;
  static constexpr size_t kScales = KVM == kSame ? 0 : sizeof(float) * 2 * 2 * kCH;
  static constexpr size_t kMerge = sizeof(float) * 8 * 16 * (D + 4);
  static constexpr size_t kChunks = kTiles + kRaw + kScales;
  static constexpr size_t kBytes = kQ + (kChunks > kMerge ? kChunks : kMerge);
  static_assert(kBytes <= 232448, "shared memory of one block");
};

template <int D, int KVM>
__global__ void __launch_bounds__(kThreads, 1)
mixed_attention_tc_kernel(const Args a, int state_mode) {
  using S = TcSmem<D, KVM>;
  constexpr int RS = S::kRS;
  constexpr bool QUANT = KVM != kSame;
  constexpr bool INT4 = KVM == kInt4;
  constexpr int ROWB = D * (QUANT ? 1 : 2);    // pool bytes of one row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int G = a.n_heads / a.hkv;
  const int ppp = a.page > kPiece ? a.page / kPiece : 1;
  const int plen = a.page > kPiece ? kPiece : a.page;
  const int prow = INT4 ? a.page / 2 : a.page;   // pool rows of a page
  const int total = a.pcum[a.n_items - 1];

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  unsigned char* chunks = smem + S::kQ;
  bf16* tiles = reinterpret_cast<bf16*>(chunks);
  int8_t* raw = reinterpret_cast<int8_t*>(chunks + S::kTiles);
  float* scl = reinterpret_cast<float*>(chunks + S::kTiles + S::kRaw);
  float* merge = reinterpret_cast<float*>(chunks);

  for (int j = blockIdx.x; j < total; j += gridDim.x) {
    const int item = a.pitem[j];
    Item it;
    load_item(a, item, it);    // a piece's item is real
    const int count = piece_count(a, item);
    const int k = j - (a.pcum[item] - count);
    const int p = it.plo + k / ppp;
    const int start = p * a.page + (k % ppp) * plen;   // first position
    const int pos0 = a.pos_start[it.s] + it.q_lo;      // row 0's position
    const int kv_end = pos0 + it.rows;
    const int pg = a.tables[(int64_t)it.s * a.max_pages + p];
    const bool in_pool = pg >= 0 && pg < a.n_pages;
    const int n_pos = in_pool ? min(plen, kv_end - start) : 0;
    const int R = G * it.rows;                 // rows of the piece
    const int n_mt = (R + 15) >> 4;            // m16 row tiles
    const int npow = n_mt <= 1 ? 1 : n_mt <= 2 ? 2 : n_mt <= 4 ? 4
                   : n_mt <= 8 ? 8 : 16;
    const int nsl = min(8, 16 / npow);         // position slices per tile
    const int rt = warp / nsl, sl = warp % nsl;
    const bool active = rt < n_mt;
    const int64_t stripe = ((int64_t)a.layer * a.n_pages + (in_pool ? pg : 0))
                           * a.hkv + it.h;
    const int off0 = start - p * a.page;       // piece start in its page
    const bool direct = count == 1 && state_mode == 0;
    if (G * (int64_t)(a.pbase[item] + (int64_t)count * it.rows) > a.ws_rows)
      asm volatile("trap;\n");
    const int n_chunks = n_pos > 0 ? (n_pos + kCH - 1) / kCH : 0;

    __syncthreads();   // the previous piece is done with shared memory
    // Queue chunk c's copies: positions [c kCH, c kCH + lim) of the
    // piece, zero-filled from n_pos on.
    auto fetch = [&](int c, int buf) {
      const int base = c * kCH;
      const int n = min(kCH, n_pos - base);
      const int lim = (n + 15) & ~15;
      const int rows_ld = INT4 ? lim / 2 : lim;
      const char* kp = reinterpret_cast<const char*>(a.k_pool);
      const char* vp = reinterpret_cast<const char*>(a.v_pool);
      constexpr int CPR = ROWB / 16;           // 16-byte copies per row
      for (int e = tid; e < rows_ld * CPR; e += kThreads) {
        const int r = e / CPR, cc = e % CPR;
        // Pool row of chunk row r (int4: packed rows hold two positions).
        const int prow_i = INT4 ? (off0 + base) / 2 + r : off0 + base + r;
        const int live = INT4 ? (2 * r < n) : (r < n);
        const int64_t off = (stripe * prow + prow_i) * (int64_t)ROWB + cc * 16;
        const int bytes = live ? 16 : 0;
        if (QUANT) {
          int8_t* dst = raw + (buf * 2) * S::kRawRows * D + r * D + cc * 16;
          cp_async16(dst, kp + (live ? off : 0), bytes);
          cp_async16(dst + S::kRawRows * D, vp + (live ? off : 0), bytes);
        } else {
          bf16* dst = tiles + (buf * 2) * S::kTileElems + r * RS + cc * 8;
          cp_async16(dst, kp + (live ? off : 0), bytes);
          cp_async16(dst + S::kTileElems, vp + (live ? off : 0), bytes);
        }
      }
      if (QUANT) {
        for (int r = tid; r < lim; r += kThreads) {
          const int64_t si = stripe * a.page + off0 + base + r;
          const int bytes = r < n ? 4 : 0;
          cp_async4(scl + (buf * 2) * kCH + r, a.k_scale + (r < n ? si : 0),
                    bytes);
          cp_async4(scl + (buf * 2 + 1) * kCH + r,
                    a.v_scale + (r < n ? si : 0), bytes);
        }
      }
      cp_async_commit();
    };

    if (n_chunks > 0) fetch(0, 0);
    // Q rows [0, 16 n_mt), zero past R (plain loads; the first chunk's
    // copies are already in flight).
    {
      const bf16* q = reinterpret_cast<const bf16*>(a.q);
      for (int e = tid; e < n_mt * 16 * (D / 8); e += kThreads) {
        const int r = e / (D / 8), c = (e % (D / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < R)
          v = *reinterpret_cast<const uint4*>(q + flat_row(a, it, G, r) * D + c);
        *reinterpret_cast<uint4*>(qs + r * RS + c) = v;
      }
    }

    // This warp's rows: tile rt, rows g4 and g4 + 8; their positions.
    int qp[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = rt * 16 + g4 + 8 * u;
      qp[u] = r < R ? pos0 + r / G : -1;
    }
    const int r_last = min(R, rt * 16 + 16) - 1;
    const int qp_tile = active ? pos0 + r_last / G : -1;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[n][u] = 0.f;
    const int sw = kCH / nsl;                 // positions per slice

    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < n_chunks) {
        fetch(c + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int n = min(kCH, n_pos - c * kCH);
      bf16* ks = tiles + (QUANT ? 0 : buf * 2 * S::kTileElems);
      bf16* vs = ks + S::kTileElems;
      if (QUANT) {   // the landed bytes -> the bf16 tiles, exactly
        const int lim = (n + 15) & ~15;
        const int8_t* rk = raw + (buf * 2) * S::kRawRows * D;
        const int8_t* rv = rk + S::kRawRows * D;
        if (INT4) {
          for (int e = tid; e < 2 * (lim / 2) * (D / 16); e += kThreads) {
            const int which = e / ((lim / 2) * (D / 16));
            const int r = (e / (D / 16)) % (lim / 2), cc = (e % (D / 16)) * 16;
            bf16* dst = which ? vs : ks;
            unpack16((which ? rv : rk) + r * D + cc, dst + 2 * r * RS + cc,
                     dst + (2 * r + 1) * RS + cc);
          }
        } else {
          for (int e = tid; e < 2 * lim * (D / 16); e += kThreads) {
            const int which = e / (lim * (D / 16));
            const int r = (e / (D / 16)) % lim, cc = (e % (D / 16)) * 16;
            dequant16((which ? rv : rk) + r * D + cc,
                      (which ? vs : ks) + r * RS + cc);
          }
        }
        __syncthreads();
      }
      const float* kss = scl + (buf * 2) * kCH;
      const float* vss = kss + kCH;
      const int cpos = start + c * kCH;       // position of chunk row 0
      if (active) {
        for (int j0 = sl * sw; j0 < (sl + 1) * sw; j0 += 16) {
          if (j0 >= n || cpos + j0 > qp_tile) break;
          float sc[2][4];
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int u = 0; u < 4; ++u) sc[nn][u] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qa[4], kb[4];
            ldsm_x4(qa, qs + (rt * 16 + (lane & 15)) * RS + kk * 16 +
                            (lane >> 4) * 8);
            ldsm_x4(kb, ks + (j0 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(sc[0], qa, kb[0], kb[1]);
            mma_bf16(sc[1], qa, kb[2], kb[3]);
          }
          // Fragment (nn, u): position j0 + 8 nn + 2 t4 + (u & 1), row
          // g4 + 8 (u >> 1).
          float mx[2] = {kNegInf, kNegInf};
          bool ok[2][4];
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int jj = j0 + 8 * nn + 2 * t4 + (u & 1);
              ok[nn][u] = jj < n && cpos + jj <= qp[u >> 1];
              float v = sc[nn][u] * a.scale;
              if (QUANT) v *= kss[jj];
              sc[nn][u] = ok[nn][u] ? v : kNegInf;
              mx[u >> 1] = fmaxf(mx[u >> 1], sc[nn][u]);
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
          // p = exp(s - m) where visible, 0 elsewhere, times the v scale.
          float ls[2] = {0.f, 0.f};
          uint32_t pa[4];
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            float pv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int jj = j0 + 8 * nn + 2 * t4 + (u & 1);
              const float e = ok[nn][u] ? expf(sc[nn][u] - m[u >> 1]) : 0.f;
              ls[u >> 1] += e;
              pv[u] = QUANT ? e * vss[jj] : e;
            }
            pa[2 * nn] = pack_bf16x2(pv[0], pv[1]);       // row g4
            pa[2 * nn + 1] = pack_bf16x2(pv[2], pv[3]);   // row g4 + 8
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
            ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
            l[r] = l[r] * corr[r] + ls[r];
          }
#pragma unroll
          for (int nn = 0; nn < D / 8; ++nn) {
            o[nn][0] *= corr[0]; o[nn][1] *= corr[0];
            o[nn][2] *= corr[1]; o[nn][3] *= corr[1];
          }
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t r[4];
            ldsm_x4_trans(r, vs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      RS + dn * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * dn], pa, r[0], r[1]);
            mma_bf16(o[2 * dn + 1], pa, r[2], r[3]);
          }
        }
      }
      __syncthreads();   // every warp is done with the chunk's buffers
    }

    // Merge the position slices of each row tile, a tree in shared
    // memory: in round h, slice sl (sl % 2h == h) hands its state to
    // slice sl - h.
    for (int hh = 1; hh < nsl; hh *= 2) {
      const int wi = rt * (nsl / (2 * hh)) + sl / (2 * hh);
      float* slot = merge + (int64_t)wi * 16 * (D + 4);
      if (active && sl % (2 * hh) == hh) {
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
          *reinterpret_cast<float2*>(slot + g4 * (D + 4) + 8 * nn + 2 * t4) =
              make_float2(o[nn][0], o[nn][1]);
          *reinterpret_cast<float2*>(slot + (g4 + 8) * (D + 4) + 8 * nn +
                                     2 * t4) = make_float2(o[nn][2], o[nn][3]);
        }
        if (t4 == 0) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            slot[(g4 + 8 * u) * (D + 4) + D] = m[u];
            slot[(g4 + 8 * u) * (D + 4) + D + 1] = l[u];
          }
        }
      }
      __syncthreads();
      if (active && sl % (2 * hh) == 0) {
        float fa[2], fb[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* row = slot + (g4 + 8 * u) * (D + 4);
          fold_ml(m[u], l[u], row[D], row[D + 1], fa[u], fb[u]);
        }
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn) {
          const float2 x = *reinterpret_cast<const float2*>(
              slot + g4 * (D + 4) + 8 * nn + 2 * t4);
          const float2 y = *reinterpret_cast<const float2*>(
              slot + (g4 + 8) * (D + 4) + 8 * nn + 2 * t4);
          o[nn][0] = fold_acc(o[nn][0], x.x, fa[0], fb[0]);
          o[nn][1] = fold_acc(o[nn][1], x.y, fa[0], fb[0]);
          o[nn][2] = fold_acc(o[nn][2], y.x, fa[1], fb[1]);
          o[nn][3] = fold_acc(o[nn][3], y.y, fa[1], fb[1]);
        }
      }
      __syncthreads();
    }

    // The first position slice of each row tile holds the piece's state:
    // its partial rows, or, for a lone piece, the folded and normalized
    // output.
    if (active && sl == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = rt * 16 + g4 + 8 * u;
        if (r >= R) continue;
        if (direct) {
          float mm = kNegInf, ll = 0.f, fa, fb;
          fold_ml(mm, ll, m[u], l[u], fa, fb);
          const float inv = ll + 1e-9f;
          bf16* out = reinterpret_cast<bf16*>(a.out) + flat_row(a, it, G, r) * D;
#pragma unroll
          for (int nn = 0; nn < D / 8; ++nn) {
            const float x0 = fold_acc(0.f, o[nn][2 * u], fa, fb) / inv;
            const float x1 = fold_acc(0.f, o[nn][2 * u + 1], fa, fb) / inv;
            *reinterpret_cast<uint32_t*>(out + 8 * nn + 2 * t4) =
                pack_bf16x2(x0, x1);
          }
        } else {
          float* row = partial_row(a, item, k, R, G, r, D);
#pragma unroll
          for (int nn = 0; nn < D / 8; ++nn)
            *reinterpret_cast<float2*>(row + 8 * nn + 2 * t4) =
                make_float2(o[nn][2 * u], o[nn][2 * u + 1]);
          if (t4 == 0) {
            row[D] = m[u];
            row[D + 1] = l[u];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 q: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;
constexpr int kFRows = 8;                 // rows per warp per pass
constexpr int kFPass = kFWarps * kFRows;  // rows per pass
constexpr int kKT = 64;                   // positions per tile

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * kFPass * D              // the pass's query rows
         + sizeof(float) * kKT * (D + 4)         // K tile, padded rows
         + sizeof(float) * kKT * D               // V tile
         + sizeof(float) * kFWarps * kKT         // per-warp p row
         + sizeof(float) * 2 * kKT;              // k and v scale tiles
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

// 16 bytes of f32 -> 4 floats; 16 bytes of bf16 -> 8 floats at dst.
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(const bf16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    dst[2 * u] = f.x;
    dst[2 * u + 1] = f.y;
  }
}

// An int8 pool's 16 bytes -> 16 floats (the quantized paths convert them
// this way; the overload keeps the plain copy generic).
__device__ __forceinline__ void widen16(const int8_t* src, float* dst) {
  dequant16(src, dst);
}

// KV: float (an f32 pool), bf16 (widened), int8_t (int8, or packed int4
// with INT4).
template <typename KV, bool INT4, int D>
__global__ void __launch_bounds__(kFThreads) mixed_attention_f32_kernel(
    const Args a, int state_mode) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int VEC = 16 / sizeof(KV);       // pool elements per 16 bytes
  constexpr int KSTRIDE = D + 4;
  constexpr int DPL = D / 32;                // output columns per lane
  constexpr int TPL = kKT / 32;              // tile positions per lane
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.n_heads / a.hkv;
  const int ppp = a.page > kPiece ? a.page / kPiece : 1;
  const int plen = a.page > kPiece ? kPiece : a.page;
  const int prow = INT4 ? a.page / 2 : a.page;
  const int total = a.pcum[a.n_items - 1];

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kFPass * D;
  float* vs = ks + kKT * KSTRIDE;
  float* ps = vs + kKT * D;
  float* kss = ps + kFWarps * kKT;
  float* vss = kss + kKT;
  float* pw = ps + warp * kKT;
  const float* q = reinterpret_cast<const float*>(a.q);

  for (int j = blockIdx.x; j < total; j += gridDim.x) {
    const int item = a.pitem[j];
    Item it;
    load_item(a, item, it);
    const int count = piece_count(a, item);
    const int k = j - (a.pcum[item] - count);
    const int p = it.plo + k / ppp;
    const int start = p * a.page + (k % ppp) * plen;
    const int pos0 = a.pos_start[it.s] + it.q_lo;
    const int kv_end = pos0 + it.rows;
    const int pg = a.tables[(int64_t)it.s * a.max_pages + p];
    const bool in_pool = pg >= 0 && pg < a.n_pages;
    const int n_pos = in_pool ? min(plen, kv_end - start) : 0;
    const int R = G * it.rows;
    const int64_t stripe = ((int64_t)a.layer * a.n_pages + (in_pool ? pg : 0))
                           * a.hkv + it.h;
    const int off0 = start - p * a.page;
    const bool direct = count == 1 && state_mode == 0;
    if (G * (int64_t)(a.pbase[item] + (int64_t)count * it.rows) > a.ws_rows)
      asm volatile("trap;\n");

    for (int r0 = 0; r0 < R; r0 += kFPass) {
      __syncthreads();   // the previous pass is done with shared memory
      for (int e = tid; e < kFPass * D; e += kFThreads) {
        const int r = r0 + e / D, d = e % D;
        qs[e] = r < R ? q[flat_row(a, it, G, r) * D + d] : 0.f;
      }
      float m[kFRows], l[kFRows], acc[kFRows][DPL];
      int qp[kFRows];
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const int r = r0 + warp * kFRows + i;
        qp[i] = r < R ? pos0 + r / G : -1;
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
      }
      for (int t0 = 0; t0 < n_pos; t0 += kKT) {
        const int nt = min(kKT, n_pos - t0);
        const int pos_t = start + t0;
        __syncthreads();   // every warp is done with the previous tile
        if (INT4) {
          const int8_t* kp = reinterpret_cast<const int8_t*>(a.k_pool);
          const int8_t* vp = reinterpret_cast<const int8_t*>(a.v_pool);
          for (int e = tid; e < ((nt + 1) / 2) * (D / 16); e += kFThreads) {
            const int r = e / (D / 16), c = (e % (D / 16)) * 16;
            const int64_t src =
                (stripe * prow + (off0 + t0) / 2 + r) * (int64_t)D + c;
            unpack16(kp + src, ks + 2 * r * KSTRIDE + c,
                     ks + (2 * r + 1) * KSTRIDE + c);
            unpack16(vp + src, vs + 2 * r * D + c, vs + (2 * r + 1) * D + c);
          }
        } else if (QUANT) {
          const int8_t* kp = reinterpret_cast<const int8_t*>(a.k_pool);
          const int8_t* vp = reinterpret_cast<const int8_t*>(a.v_pool);
          for (int e = tid; e < nt * (D / 16); e += kFThreads) {
            const int r = e / (D / 16), c = (e % (D / 16)) * 16;
            const int64_t src = (stripe * prow + off0 + t0 + r) * (int64_t)D + c;
            dequant16(kp + src, ks + r * KSTRIDE + c);
            dequant16(vp + src, vs + r * D + c);
          }
        } else {
          const KV* kp = reinterpret_cast<const KV*>(a.k_pool);
          const KV* vp = reinterpret_cast<const KV*>(a.v_pool);
          for (int e = tid; e < nt * (D / VEC); e += kFThreads) {
            const int r = e / (D / VEC), c = (e % (D / VEC)) * VEC;
            const int64_t src = (stripe * prow + off0 + t0 + r) * (int64_t)D + c;
            widen16(kp + src, ks + r * KSTRIDE + c);
            widen16(vp + src, vs + r * D + c);
          }
        }
        if (QUANT) {
          for (int r = tid; r < kKT; r += kFThreads) {
            const bool in = r < nt;
            const int64_t si = stripe * a.page + off0 + t0 + r;
            kss[r] = in ? a.k_scale[si] : 0.f;
            vss[r] = in ? a.v_scale[si] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kFRows; ++i) {
          if (qp[i] < pos_t) continue;   // the row sees none of the tile
          const float* qr = qs + (warp * kFRows + i) * D;
          float sc[TPL];
          bool ok[TPL];
          float mc = kNegInf;
#pragma unroll
          for (int c = 0; c < TPL; ++c) {
            const int jj = lane + 32 * c;
            ok[c] = jj < nt && pos_t + jj <= qp[i];
            float dot = 0.f;
            if (jj < nt) {
              const float* kr = ks + jj * KSTRIDE;
#pragma unroll
              for (int d = 0; d < D; d += 4) {
                const float4 kf = *reinterpret_cast<const float4*>(kr + d);
                dot = fmaf(qr[d], kf.x, dot);
                dot = fmaf(qr[d + 1], kf.y, dot);
                dot = fmaf(qr[d + 2], kf.z, dot);
                dot = fmaf(qr[d + 3], kf.w, dot);
              }
            }
            float v = dot * a.scale;
            if (QUANT) v *= kss[jj];
            sc[c] = ok[c] ? v : kNegInf;
            mc = fmaxf(mc, sc[c]);
          }
          mc = warp_max(mc);
          const float m_next = fmaxf(m[i], mc);
          const float corr = expf(m[i] - m_next);
          float lsum = 0.f;
#pragma unroll
          for (int c = 0; c < TPL; ++c) {
            const int jj = lane + 32 * c;
            const float e = ok[c] ? expf(sc[c] - m_next) : 0.f;
            lsum += e;
            pw[jj] = QUANT ? e * vss[jj] : e;
          }
          lsum = warp_sum(lsum);
          l[i] = l[i] * corr + lsum;
          m[i] = m_next;
          __syncwarp();
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
          for (int jj = 0; jj < nt; ++jj) {
            const float pj = pw[jj];
            const float* vr = vs + jj * D + lane * DPL;
#pragma unroll
            for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pj, vr[c], acc[i][c]);
          }
          __syncwarp();
        }
      }
#pragma unroll
      for (int i = 0; i < kFRows; ++i) {
        const int r = r0 + warp * kFRows + i;
        if (r >= R) break;
        if (direct) {
          float mm = kNegInf, ll = 0.f, fa, fb;
          fold_ml(mm, ll, m[i], l[i], fa, fb);
          float* out = reinterpret_cast<float*>(a.out) +
                       flat_row(a, it, G, r) * D + lane * DPL;
#pragma unroll
          for (int c = 0; c < DPL; ++c)
            out[c] = fold_acc(0.f, acc[i][c], fa, fb) / (ll + 1e-9f);
        } else {
          float* row = partial_row(a, item, k, R, G, r, D);
#pragma unroll
          for (int c = 0; c < DPL; ++c) row[lane * DPL + c] = acc[i][c];
          if (lane == 0) {
            row[D] = m[i];
            row[D + 1] = l[i];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The combine: one CTA per item, the left fold of its pieces in page order
// ---------------------------------------------------------------------------

constexpr int kCThreads = 256;
constexpr int kCRows = 32;      // rows per combine CTA

// Grid (item, row block): CTA (i, y) folds rows [32 y, 32 y + 32) of item
// i, loading up to four pieces' partials ahead of their folds.
template <typename T, int D>
__global__ void __launch_bounds__(kCThreads) mixed_attention_combine_kernel(
    const Args a, int state_mode) {
  const int item = blockIdx.x;
  Item it;
  if (!load_item(a, item, it)) return;
  const int count = piece_count(a, item);
  if (count == 1 && state_mode == 0) return;   // written by its piece
  const bool carry = state_mode & 1, emit = state_mode & 2;
  const int G = a.n_heads / a.hkv;
  const int R = G * it.rows;
  const int r0 = blockIdx.y * kCRows;
  if (r0 >= R) return;
  const int nr = min(kCRows, R - r0);
  for (int e = threadIdx.x; e < nr * (D / 4); e += kCThreads) {
    const int r = r0 + e / (D / 4), c = (e % (D / 4)) * 4;
    const int64_t fr = flat_row(a, it, G, r);
    float m = kNegInf, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (carry) {
      m = a.carry_m[fr];
      l = a.carry_l[fr];
      acc = *reinterpret_cast<const float4*>(a.carry_acc + fr * D + c);
    }
    for (int k0 = 0; k0 < count; k0 += 4) {
      float4 x[4];
      float mp[4], lp[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k0 + u < count) {
          const float* row = partial_row(a, item, k0 + u, R, G, r, D);
          x[u] = *reinterpret_cast<const float4*>(row + c);
          mp[u] = row[D];
          lp[u] = row[D + 1];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k0 + u < count) {
          float fa, fb;
          fold_ml(m, l, mp[u], lp[u], fa, fb);
          acc.x = fold_acc(acc.x, x[u].x, fa, fb);
          acc.y = fold_acc(acc.y, x[u].y, fa, fb);
          acc.z = fold_acc(acc.z, x[u].z, fa, fb);
          acc.w = fold_acc(acc.w, x[u].w, fa, fb);
        }
      }
    }
    if (emit) {
      *reinterpret_cast<float4*>(a.emit_acc + fr * D + c) = acc;
      if (c == 0) {
        a.emit_m[fr] = m;
        a.emit_l[fr] = l;
      }
    } else {
      const float inv = l + 1e-9f;
      T* o = reinterpret_cast<T*>(a.out) + fr * D + c;
      o[0] = from_float<T>(acc.x / inv);
      o[1] = from_float<T>(acc.y / inv);
      o[2] = from_float<T>(acc.z / inv);
      o[3] = from_float<T>(acc.w / inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// A persistent grid: as many CTAs as fit on the card at once (per_sm of
// the kernel, looked up once per instance), no more than the pieces the
// launch can have.
template <typename K>
int grid_for(K kernel, int threads, size_t smem, int64_t max_pieces,
             int* per_sm) {
  if (*per_sm == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                     smem) != cudaSuccess ||
       *per_sm <= 0))
    *per_sm = 1;
  const int64_t g = (int64_t)sm_count() * *per_sm;
  return (int)(max_pieces < g ? max_pieces : g);
}

template <int D, int KVM>
int launch_tc(const Args& a, int state_mode, int64_t max_pieces,
              cudaStream_t st) {
  using S = TcSmem<D, KVM>;
  auto kern = mixed_attention_tc_kernel<D, KVM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
  if (err != cudaSuccess) return (int)err;
  static int per_sm = 0;
  const int grid = grid_for(kern, kThreads, S::kBytes, max_pieces, &per_sm);
  if (grid > 0) kern<<<grid, kThreads, S::kBytes, st>>>(a, state_mode);
  return (int)cudaGetLastError();
}

template <typename KV, bool INT4, int D>
int launch_f32(const Args& a, int state_mode, int64_t max_pieces,
               cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<D>();
  auto kern = mixed_attention_f32_kernel<KV, INT4, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  static int per_sm = 0;
  const int grid = grid_for(kern, kFThreads, smem, max_pieces, &per_sm);
  if (grid > 0) kern<<<grid, kFThreads, smem, st>>>(a, state_mode);
  return (int)cudaGetLastError();
}

template <int D>
int launch_pieces(const Args& a, int dtype, int kv_mode, int state_mode,
                  int64_t max_pieces, cudaStream_t st) {
  if (dtype == 1) {
    if (kv_mode == kSame) return launch_tc<D, kSame>(a, state_mode, max_pieces, st);
    if (kv_mode == kInt8) return launch_tc<D, kInt8>(a, state_mode, max_pieces, st);
    if (kv_mode == kInt4) return launch_tc<D, kInt4>(a, state_mode, max_pieces, st);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_mode == kSame) return launch_f32<float, false, D>(a, state_mode, max_pieces, st);
  if (kv_mode == kBf16Pool) return launch_f32<bf16, false, D>(a, state_mode, max_pieces, st);
  if (kv_mode == kInt8) return launch_f32<int8_t, false, D>(a, state_mode, max_pieces, st);
  if (kv_mode == kInt4) return launch_f32<int8_t, true, D>(a, state_mode, max_pieces, st);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_all(const Args& a, int dtype, int kv_mode, int state_mode,
               cudaStream_t st) {
  const int ppp = a.page > kPiece ? a.page / kPiece : 1;
  const int64_t max_pieces = (int64_t)a.n_items * a.max_pages * ppp;
  int err = launch_pieces<D>(a, dtype, kv_mode, state_mode, max_pieces, st);
  if (err != 0) return err;
  // Row blocks of the widest item: G x block_q rows.
  const int G = a.n_heads / a.hkv;
  const dim3 grid(a.n_items, (G * a.block_q + kCRows - 1) / kCRows);
  if (dtype == 1)
    mixed_attention_combine_kernel<bf16, D><<<grid, kCThreads, 0, st>>>(
        a, state_mode);
  else
    mixed_attention_combine_kernel<float, D><<<grid, kCThreads, 0, st>>>(
        a, state_mode);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q, and out when written).  kv_mode:
// kSame = pools of q's dtype (scales NULL), kInt8 / kInt4 = quantized
// pools with f32 scales [L, N, Hkv, page], kBf16Pool = bf16 pools under
// f32 q.  head_dim 64 or 128, G = n_heads / hkv <= 8, 1 <= block_q <= 32,
// page <= 256 or a multiple of 256 (even for int4).  state_mode: bit 0
// carry, bit 1 emit.  The wrappers check all of these (and raise) first.
int run(Args a, int head_dim, int dtype, int kv_mode, int state_mode,
        void* stream) {
  if (a.n_items <= 0) return 0;
  const bool quant = kv_mode == kInt8 || kv_mode == kInt4;
  if (a.block_q < 1 || a.block_q > kBQ || a.hkv <= 0 ||
      a.n_heads % a.hkv != 0 || a.n_heads / a.hkv > kMaxG ||
      (quant && (!a.k_scale || !a.v_scale)) ||
      (kv_mode == kInt4 && a.page % 2) || a.page <= 0 ||
      (a.page > kPiece && a.page % kPiece) || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && kv_mode == kBf16Pool) || !a.pcum || !a.pbase ||
      !a.pitem || !a.ws || ((state_mode & 1) && (!a.carry_m || !a.carry_l ||
                                     !a.carry_acc)) ||
      ((state_mode & 2) && (!a.emit_m || !a.emit_l || !a.emit_acc)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (head_dim == 128) return launch_all<128>(a, dtype, kv_mode, state_mode, st);
  if (head_dim == 64) return launch_all<64>(a, dtype, kv_mode, state_mode, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, void* out, const void* k_pool,
               const void* v_pool, const void* k_scale, const void* v_scale,
               const void* tables, const void* pos_start,
               const void* q_start, const void* q_len, const void* pcum,
               const void* pbase, const void* pitem, void* ws,
               int64_t ws_rows, int n_items,
               int num_qb, int n_heads, int hkv, int page, int n_pages,
               int max_pages, int layer, int block_q, float scale) {
  Args a = {};
  a.q = q;
  a.out = out;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = (const float*)k_scale;
  a.v_scale = (const float*)v_scale;
  a.tables = (const int*)tables;
  a.pos_start = (const int*)pos_start;
  a.q_start = (const int*)q_start;
  a.q_len = (const int*)q_len;
  a.pcum = (const int*)pcum;
  a.pbase = (const int*)pbase;
  a.pitem = (const int*)pitem;
  a.ws = (float*)ws;
  a.ws_rows = ws_rows;
  a.n_items = n_items;
  a.num_qb = num_qb;
  a.n_heads = n_heads;
  a.hkv = hkv;
  a.page = page;
  a.n_pages = n_pages;
  a.max_pages = max_pages;
  a.layer = layer;
  a.block_q = block_q;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The ragged launch over the work list (n_items entries, padding items with
// pages 0).  pcum / pbase [n_items] and pitem [n_items * max_pages * pieces
// per page] int32 lay out its pieces; ws holds
// ws_rows partial rows of head_dim + 4 f32.  carry_* (state_mode bit 0) and
// emit_* (bit 1) are the flat state [T, H] (m, l) and [T, H, D] (acc), f32;
// with emit the output is not written.
int arks_paged_mixed_attention(
    const void* q, void* out, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos_start, const void* q_start, const void* q_len,
    const void* wl_seq, const void* wl_head, const void* wl_qb,
    const void* wl_plo, const void* wl_pages, const void* pcum,
    const void* pbase, const void* pitem, void* ws, int64_t ws_rows,
    const void* carry_m,
    const void* carry_l, const void* carry_acc, void* emit_m, void* emit_l,
    void* emit_acc, int n_items, int n_heads, int hkv, int head_dim,
    int page, int n_pages, int max_pages, int layer, int block_q,
    float scale, int dtype, int kv_mode, int state_mode, void* stream) {
  if (!wl_seq || !wl_head || !wl_qb || !wl_plo || !wl_pages)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, out, k_pool, v_pool, k_scale, v_scale, tables,
                     pos_start, q_start, q_len, pcum, pbase, pitem, ws,
                     ws_rows, n_items, 0, n_heads, hkv, page, n_pages,
                     max_pages,
                     layer, block_q, scale);
  a.wl_seq = (const int*)wl_seq;
  a.wl_head = (const int*)wl_head;
  a.wl_qb = (const int*)wl_qb;
  a.wl_plo = (const int*)wl_plo;
  a.wl_pages = (const int*)wl_pages;
  a.carry_m = (const float*)carry_m;
  a.carry_l = (const float*)carry_l;
  a.carry_acc = (const float*)carry_acc;
  a.emit_m = (float*)emit_m;
  a.emit_l = (float*)emit_l;
  a.emit_acc = (float*)emit_acc;
  return run(a, head_dim, dtype, kv_mode, state_mode, stream);
}

// The dense launch over the (n_seqs, hkv, num_qb) rectangle, item
// (s * hkv + h) * num_qb + qb; pcum / pbase / pitem as above.  No
// spans and no state (the wrapper refuses them, as the reference does).
int arks_paged_mixed_attention_dense(
    const void* q, void* out, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* pos_start, const void* q_start, const void* q_len,
    const void* pcum, const void* pbase, const void* pitem, void* ws,
    int64_t ws_rows, int n_seqs, int num_qb, int n_heads, int hkv, int head_dim, int page,
    int n_pages, int max_pages, int layer, int block_q, float scale,
    int dtype, int kv_mode, void* stream) {
  if (num_qb <= 0) return n_seqs <= 0 ? 0 : (int)cudaErrorInvalidValue;
  Args a = make_args(q, out, k_pool, v_pool, k_scale, v_scale, tables,
                     pos_start, q_start, q_len, pcum, pbase, pitem, ws,
                     ws_rows, n_seqs * hkv * num_qb, num_qb, n_heads, hkv, page,
                     n_pages, max_pages, layer, block_q, scale);
  return run(a, head_dim, dtype, kv_mode, 0, stream);
}

}  // extern "C"
