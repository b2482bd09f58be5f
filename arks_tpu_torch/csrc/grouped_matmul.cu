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
// block_expert on the device (no Pallas grid carried over).  A tile's real
// rows are its first tile_rows[i] (a group fills its slot from the front;
// the rest are zero rows); without tile_rows, tiles at or past
// rows_used[0] hold only zero rows.  Rows known to be zero are written as
// zeros without a product — the same values the product gives.  N is
// masked at the tile edge (N % 16 == 0).
//
// Bound on the H100 at Mixtral-8x7B (one mixed step: 264 tokens x top-2 =
// 528 routed rows over 8 experts): bytes.  Each launch streams the routed
// experts' weights once: 411 MB int8 for 7 routed experts of a 4096 x
// 14336 matrix (123 us at 3.35 TB/s), about half that for int4, twice for
// bf16; the products are 2 x 528 x 4096 x 14336 = 62 GFLOP (63 us at 989
// TFLOP/s).  A decode step routes 16 rows, so every tile holds 1-4 real
// rows and the launch is all weight bytes.
//
// Design (bf16 activations, the served path;
// grouped_matmul_wgmma_kernel): one CTA per 128 x 256 output tile, two
// consumer warpgroups (64 rows each) and one producer warp.  The producer
// keeps a ring of 3-5 stages of 64 K values in flight with TMA
// (cp.async.bulk.tensor, mbarrier completion): the tile's real xs rows
// (64-row boxes, then 8-row boxes up to the last real row; 128-byte
// swizzle) and the raw weight bytes [64 k, 256 n] (int4: [32 packed rows,
// 256 n] and its groups' scale rows).  The consumers turn a landed raw
// stage into the bf16 B tile [256 n, 64 k] in shared memory — int8
// exactly (byte -> 2^23 + b float -> bf16), int4 nibbles into bf16
// 128 + u with bf16x2 subtract and multiply by the group scale (one
// rounding), bf16 by a byte permute — written in wgmma's K-major
// 128-byte-swizzled layout; that pass overlaps the tensor cores' work on
// the previous stage.  Each warpgroup then runs wgmma.mma_async
// m64n256k16 (bf16 -> f32 in registers) over its xs rows and the B tile.
// Per weight byte the xs tile is read half as often as with 128 columns.
// A tile with at most 64 real rows multiplies one 64-row block; the other
// warpgroup writes zeros, as the epilogue does for rows past the real
// ones (never loaded).  int8's per-channel scale multiplies the f32
// accumulator in the epilogue.  Measured on the H100 (PERF.md): deeper
// rings, separate xs and weight rings, and a producer warpgroup with
// setmaxnreg were no faster; the int8/int4 weight stream (256-byte rows
// per box) reaches 55-65% of the memory rate, bf16 (512-byte rows) 84%.
// The TMA descriptors are encoded on the host per launch through
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (the
// library is loaded by ctypes and not linked to libcuda).  Any K (a
// multiple of 8, the 16-byte row alignment TMA needs): the last stage's
// xs columns past K arrive as TMA's zero fill and its weight rows past K
// are zeroed by the dequant pass.  An int4 group below 64 (32, say) puts
// two groups in one stage: a kernel instance of its own (kInt4s) carries
// two scale rows a stage and each 8-k chunk takes its own; groups of 64
// and more keep the one-row instance.
//
// f32 activations (parity runs only): a CUDA-core kernel, 64 x 64 tiles,
// 4 x 4 outputs per thread, f32 FMAs, K in steps of 16 (zero past K).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // rows per expert tile (block_t)
constexpr int kThreads = 256;
enum { kRaw = 0, kInt8 = 1, kInt4 = 2 };
// The bf16 kernel's instance for int4 groups below 64 (two groups, and two
// scale rows, per stage); groups of 64 and more keep kInt4's one row.
constexpr int kInt4s = 3;
__host__ __device__ constexpr bool is_int4(int mode) { return mode == kInt4 || mode == kInt4s; }

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA and an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kBN = 256;                 // columns per CTA
constexpr int kBK = 64;                  // K per stage: one 128-byte row
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kWThreads = kConsumers + 32;   // and the producer warp

// Shared memory: two bf16 B tiles, then a ring of stages, each holding
// 64 K of the tile's xs rows (room for two 64-row boxes, 1024-byte aligned
// for the swizzle) and of the raw weight bytes, then the barriers.  Deeper
// rings measured no faster on the H100.
template <int MODE>
struct GmCfg {
  static constexpr int kStages = MODE == kRaw ? 3 : MODE == kInt8 ? 4 : 5;
  static constexpr int kABlock = 64 * kBK * 2;             // one 64-row box
  static constexpr int kABytes = 2 * kABlock;
  static constexpr int kWRows = is_int4(MODE) ? kBK / 2 : kBK;
  static constexpr int kWBytes = kWRows * kBN * (MODE == kRaw ? 2 : 1);
  static constexpr int kSRows = MODE == kInt4s ? 2 : MODE == kInt4 ? 1 : 0;
  static constexpr int kSBytes = kSRows * kBN * 4;
  static constexpr int kStageBytes = kABytes + kWBytes + kSBytes;
  static constexpr int kBBytes = kBN * kBK * 2;            // bf16 B tile
  // 1 KB of slack aligns the base to the 128-byte swizzle's 1024 bytes.
  static constexpr int kSmem =
      1024 + 2 * kBBytes + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kStageBytes % 1024 == 0, "stages keep 1024-byte alignment");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that never completes traps: a launch fault, never a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (spins == (1u << 26)) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The byte offset of bf16 element (row, k) of such a tile (k < 64).
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2;
}

__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// int8 byte `j` of w -> the float of its value, exactly: the byte biased to
// unsigned in the mantissa of 2^23, then 2^23 + 128 taken off.
__device__ __forceinline__ float i8_to_f32(uint32_t w, int j) {
  const uint32_t f = __byte_perm(w, 0x4B000000u, 0x7650u | j) ^ 0x80u;
  return __uint_as_float(f) - 8388736.0f;
}

// Consumer thread `ct` (0..255) turns the landed raw weight stage into the
// bf16 B tile [256 n][64 k]: 4 columns (n = 4 (ct % 64) + j) x 16 k
// (k = 16 (ct / 64) + ...), two 16-byte chunks per column.  The column
// order is rotated by lane so the 8 lanes of a store phase hit 8 distinct
// swizzled chunks.
//
// TAIL (the stage holding K's end): raw rows at or past `valid` (the
// stage's weight rows inside K) read as zero, so a K tail multiplies zeros
// whatever lies past the expert's rows; every other stage runs without
// the check.
// An int4 stage carries the scale row of its first group and, for a group
// below 64, the next one's, which starts at stage-relative k `split` (64
// when none does); each 8-k chunk takes its own.
template <int MODE, bool TAIL>
__device__ __forceinline__ void dequant_stage(const unsigned char* raw,
                                              const float* gscale,
                                              unsigned char* bt, int ct,
                                              int valid, int split) {
  const int ng = ct & 63, kq = ct >> 6, rot = (ct & 31) >> 1;
  if (MODE == kInt8) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = *reinterpret_cast<const uint32_t*>(
            raw + (16 * kq + 8 * c + k) * kBN + 4 * ng);
      if (TAIL) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (16 * kq + 8 * c + k >= valid) w[k] = 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = (j + rot) & 3, n = 4 * ng + jj;
        uint4 v;
        uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vw[u] = pack_bf16x2(i8_to_f32(w[2 * u], jj),
                              i8_to_f32(w[2 * u + 1], jj));
        *reinterpret_cast<uint4*>(bt + swz(n, 16 * kq + 8 * c)) = v;
      }
    }
  } else if (is_int4(MODE)) {
    uint32_t w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(raw + (8 * kq + r) * kBN +
                                                4 * ng);
    if (TAIL) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (8 * kq + r >= valid) w[r] = 0u;
    }
    // The group of each 8-k chunk: the stage's first, or (kInt4s, a group
    // below 64) the next; kq is warp-uniform, so is the branch.
    const bool next[2] = {MODE == kInt4s && 16 * kq >= split,
                          MODE == kInt4s && 16 * kq + 8 >= split};
    const float4 ga = *reinterpret_cast<const float4*>(gscale + 4 * ng);
    float4 gb = ga;
    if (next[1])
      gb = *reinterpret_cast<const float4*>(gscale + kBN + 4 * ng);
    const __nv_bfloat162 bias = as_bf16x2(0x43084308u);   // 136, 136
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = (j + rot) & 3, n = 4 * ng + jj;
      const float fa = jj == 0 ? ga.x : jj == 1 ? ga.y : jj == 2 ? ga.z : ga.w;
      const __nv_bfloat162 gsa = __bfloat162bfloat162(__float2bfloat16_rn(fa));
      __nv_bfloat162 gsb = gsa;
      if (next[1]) {
        const float fb =
            jj == 0 ? gb.x : jj == 1 ? gb.y : jj == 2 ? gb.z : gb.w;
        gsb = __bfloat162bfloat162(__float2bfloat16_rn(fb));
      }
      const uint32_t sel = jj | ((jj + 4) << 4);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const __nv_bfloat162 gs = next[c] ? gsb : gsa;
        // Byte jj of packed rows 4c..4c+3: k = 16 kq + 8c + 0..7.
        const uint32_t t = __byte_perm(
            __byte_perm(w[4 * c], w[4 * c + 1], sel),
            __byte_perm(w[4 * c + 2], w[4 * c + 3], sel), 0x5410u);
        const uint32_t lo = (t & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t hi = ((t >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        uint4 v;
        uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // bf16 128 + (q + 8) in both halves: (k even, k odd) of pair u.
          const uint32_t x =
              (__byte_perm(lo, hi, u | ((u + 4) << 8)) & 0x00FF00FFu) |
              0x43004300u;
          vw[u] = as_u32(__hmul2(__hsub2(as_bf16x2(x), bias), gs));
        }
        *reinterpret_cast<uint4*>(bt + swz(n, 16 * kq + 8 * c)) = v;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint2 w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = *reinterpret_cast<const uint2*>(
            raw + (16 * kq + 8 * c + k) * kBN * 2 + 8 * ng);
      if (TAIL) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (16 * kq + 8 * c + k >= valid) w[k] = make_uint2(0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = (j + rot) & 3, n = 4 * ng + jj;
        const uint32_t sel = (jj & 1) ? 0x7632u : 0x5410u;
        uint4 v;
        uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint2 a = w[2 * u], b = w[2 * u + 1];
          vw[u] = __byte_perm(jj < 2 ? a.x : a.y, jj < 2 ? b.x : b.y, sel);
        }
        *reinterpret_cast<uint4*>(bt + swz(n, 16 * kq + 8 * c)) = v;
      }
    }
  }
}

// The consumer warpgroups' mainloop and epilogue.  ACTIVE (a warpgroup
// with real rows) is a template argument, so the path that issues wgmma
// holds each stage's issue, commit and wait in straight-line code: no
// accumulator register is touched between them and none of them sits
// under a data-dependent branch (either would make ptxas serialize wgmma).
template <int MODE>
struct Consumer {
  using C = GmCfg<MODE>;
  unsigned char* ring;
  unsigned char* btile;
  uint64_t* full;
  uint64_t* empty;
  int steps, tid, wg, rows, w_rows, group;

  // Wait for stage s, turn its weights into the bf16 B tile s % 2.
  __device__ __forceinline__ void dequant(int s) const {
    mbar_wait(&full[s % C::kStages], (s / C::kStages) & 1);
    const unsigned char* w =
        ring + (s % C::kStages) * C::kStageBytes + C::kABytes;
    int split = kBK;
    if (MODE == kInt4s) {
      const int r = s * kBK % group;   // the stage's offset in its group
      split = group - r < kBK ? group - r : kBK;
    }
    const float* gs = reinterpret_cast<const float*>(w + C::kWBytes);
    unsigned char* bt = btile + (s & 1) * C::kBBytes;
    const int valid = w_rows - s * C::kWRows;
    if (valid < C::kWRows)   // the stage holding K's end
      dequant_stage<MODE, true>(w, gs, bt, tid, valid, split);
    else
      dequant_stage<MODE, false>(w, gs, bt, tid, valid, split);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  template <bool ACTIVE>
  __device__ __forceinline__ void run(const float* scale, int e,
                                      __nv_bfloat16* out, int m0, int n0,
                                      int N) const {
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    dequant(0);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int s = 0; s < steps; ++s) {
      if (ACTIVE) {
        const uint64_t da = smem_desc(ring + (s % C::kStages) *
                                      C::kStageBytes + wg * C::kABlock);
        const uint64_t db = smem_desc(btile + (s & 1) * C::kBBytes);
#pragma unroll
        for (int i = 0; i < 128; ++i) fence_operand(d[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)   // +32 bytes along K per step
          wgmma_m64n256k16(d, da + 2 * k, db + 2 * k, s > 0 || k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      // Stage s+1's weights become bf16 while the tensor cores run stage
      // s; tile (s+1) % 2 was last read by wgmma(s-1), done before the
      // previous barrier.
      if (s + 1 < steps) dequant(s + 1);
      if (ACTIVE) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 128; ++i) fence_operand(d[i]);
      }
      if ((tid & 127) == 0) mbar_arrive(&empty[s % C::kStages]);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }

    // Fragment i of warp w holds rows 16 (w % 4) + g (+ 8) and columns
    // 8 (i / 4) + 2 t (+ 1) of the warpgroup's 64 x 256 block.  Rows at or
    // past the tile's real rows were not loaded (their shared memory is
    // stale) and come out as zeros.  Every lane reads its fragments; only
    // the stores are predicated.
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + g;
    const bool live0 = r0 < rows, live1 = r0 + 8 < rows;
    const int64_t row = m0 + r0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = n0 + 8 * i + 2 * t;
      const bool in = col < N;
      float s0 = 1.f, s1 = 1.f;
      if (MODE == kInt8 && in) {
        const float2 sc =
            *reinterpret_cast<const float2*>(scale + (int64_t)e * N + col);
        s0 = sc.x;
        s1 = sc.y;
      }
      const uint32_t lo = pack_bf16x2(live0 ? d[4 * i] * s0 : 0.f,
                                      live0 ? d[4 * i + 1] * s1 : 0.f);
      const uint32_t hi = pack_bf16x2(live1 ? d[4 * i + 2] * s0 : 0.f,
                                      live1 ? d[4 * i + 3] * s1 : 0.f);
      if (in) {
        *reinterpret_cast<uint32_t*>(out + row * N + col) = lo;
        *reinterpret_cast<uint32_t*>(out + (row + 8) * N + col) = hi;
      }
    }
  }
};

template <int MODE>
__global__ void __launch_bounds__(kWThreads, 1) grouped_matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap xs_map,
    const __grid_constant__ CUtensorMap xs8_map,
    const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap s_map,
    const float* __restrict__ scale, const int* __restrict__ block_expert,
    const int* __restrict__ rows_used, const int* __restrict__ tile_rows,
    __nv_bfloat16* __restrict__ out, int K, int N, int group) {
  using C = GmCfg<MODE>;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int tile = blockIdx.y, m0 = tile * kTile;
  // Broadcast within the warp: the compiler then knows every branch on
  // these values is warp-uniform, and keeps wgmma unserialized.
  const int rows = __shfl_sync(
      0xffffffffu,
      tile_rows ? min(max(tile_rows[tile], 0), kTile)
                : (rows_used && m0 >= rows_used[0]) ? 0 : kTile, 0);
  const int mblocks = rows <= 0 ? 0 : rows <= 64 ? 1 : 2;
  if (mblocks == 0) {
    // Only zero rows here: write the zeros the product would give.
    for (int q = tid; q < kTile * (kBN / 8); q += kWThreads) {
      const int r = q / (kBN / 8), c = (q % (kBN / 8)) * 8;
      if (n0 + c < N)
        *reinterpret_cast<uint4*>(out + (int64_t)(m0 + r) * N + n0 + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  unsigned char* btile = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = btile + 2 * C::kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages *
                                               C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int e = block_expert[tile];
  // K past the last full stage: TMA fills xs columns past K with zeros and
  // the dequant zeroes weight rows past it.
  const int steps = (K + kBK - 1) / kBK;
  const int w_rows = is_int4(MODE) ? K / 2 : K;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring full.  Only the tile's real xs
    // rows are loaded: whole 64-row boxes, then 8-row boxes up to the
    // last real row.
    if ((tid & 31) == 0) {
      const int w_row0 = e * (is_int4(MODE) ? K / 2 : K);
      const int full64 = rows / 64, small = (rows % 64 + 7) / 8;
      const int tx = (64 * full64 + 8 * small) * kBK * 2 + C::kWBytes +
                     C::kSBytes;
      for (int s = 0; s < steps; ++s) {
        const int slot = s % C::kStages;
        if (s >= C::kStages) mbar_wait(&empty[slot], (s / C::kStages - 1) & 1);
        unsigned char* st = ring + slot * C::kStageBytes;
        mbar_expect_tx(&full[slot], tx);
        for (int mb = 0; mb < full64; ++mb)
          tma_load_2d(st + mb * C::kABlock, &xs_map, &full[slot], s * kBK,
                      m0 + 64 * mb);
        for (int j = 0; j < small; ++j)
          tma_load_2d(st + (64 * full64 + 8 * j) * kBK * 2, &xs8_map,
                      &full[slot], s * kBK, m0 + 64 * full64 + 8 * j);
        tma_load_2d(st + C::kABytes, &w_map, &full[slot], n0,
                    w_row0 + s * C::kWRows);
        if (is_int4(MODE))   // kSRows rows from the stage's first group
          tma_load_2d(st + C::kABytes + C::kWBytes, &s_map, &full[slot], n0,
                      e * (K / group) + s * kBK / group);
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows [64 wg, 64 wg + 64) when they
  // hold real rows; an idle warpgroup dequantizes and writes zeros.
  const int wg = warp >> 2;
  const Consumer<MODE> c{ring, btile, full, empty, steps, tid, wg, rows,
                         w_rows, group > 0 ? group : 1};
  if (wg < mblocks)
    c.template run<true>(scale, e, out, m0, n0, N);
  else
    c.template run<false>(scale, e, out, m0, n0, N);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major map of `rows` x `cols` elements, boxes of box_rows x
// box_cols.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
              const void* ptr, uint64_t rows, uint64_t cols, int box_rows,
              int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
int launch_wgmma(const void* xs, const void* w, const float* scale,
                 const int* block_expert, const int* rows_used,
                 const int* tile_rows, void* out, int tp, int K, int N,
                 int nx, int group, cudaStream_t stream) {
  using C = GmCfg<MODE>;
  CUtensorMap xs_map, xs8_map, w_map, s_map;
  const int w_rows = is_int4(MODE) ? K / 2 : K;
  bool ok = make_map(&xs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs, tp, K,
                     64, kBK, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&xs8_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xs, tp, K,
                     8, kBK, CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&w_map, MODE == kRaw ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                     MODE == kRaw ? 2 : 1, w, (uint64_t)nx * w_rows, N,
                     C::kWRows, kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  s_map = w_map;
  if (ok && is_int4(MODE))
    ok = make_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale,
                  (uint64_t)nx * (K / group), N, C::kSRows, kBN,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_matmul_wgmma_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, tp / kTile);
  grouped_matmul_wgmma_kernel<MODE><<<grid, kWThreads, C::kSmem, stream>>>(
      xs_map, xs8_map, w_map, s_map, scale, block_expert, rows_used,
      tile_rows,
      (__nv_bfloat16*)out, K, N, group);
  return (int)cudaGetLastError();
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
    {  // xs: 64 rows x 16 k, four per thread, zero past K
      const int r = tid >> 2, c = (tid & 3) * 4;
      const float* src = xs + (int64_t)(m0 + r) * K + k0 + c;
      float a[4];
      if ((K & 3) == 0 && k0 + c < K) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = k0 + c + u < K ? src[u] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) As[c + u][r] = a[u];
    }
    if (MODE == kInt4) {   // 8 packed rows x 32 pairs of columns
      const int r = tid >> 5, c = (tid & 31) * 2;
      float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};
      if (n0 + c < N && k0 / 2 + r < K / 2) {
        const int8_t* b = reinterpret_cast<const int8_t*>(w) +
                          ((int64_t)e * (K / 2) + k0 / 2 + r) * N + n0 + c;
        const float* g = scale +
            ((int64_t)e * (K / group) + (k0 + 2 * r) / group) * N + n0 + c;
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
      if (n0 + c < N && k0 + r < K) {
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
           const int* block_expert, const int* rows_used,
           const int* tile_rows, void* out, int tp, int K, int N, int nx,
           int group, int dtype, cudaStream_t stream) {
  if (dtype == 1 && MODE == kInt4 && group % kBK)   // two groups a stage
    return launch_wgmma<kInt4s>(xs, w, scale, block_expert, rows_used,
                                tile_rows, out, tp, K, N, nx, group, stream);
  if (dtype == 1)
    return launch_wgmma<MODE>(xs, w, scale, block_expert, rows_used,
                              tile_rows, out, tp, K, N, nx, group, stream);
  const dim3 grid((N + kFB - 1) / kFB, tp / kFB);
  grouped_matmul_f32_kernel<MODE><<<grid, kThreads, 0, stream>>>(
      (const float*)xs, w, scale, block_expert, rows_used, (float*)out, K, N,
      group);
  return (int)cudaGetLastError();
}

// Whether every 64-wide K stage of an int4 weight spans two groups at most
// (the scale rows one stage of the bf16 kernel carries).
bool stages_fit(int k, int group) {
  for (int k0 = 0; k0 < k; k0 += kBK)
    if (((k0 + kBK < k ? k0 + kBK : k) - 1) / group - k0 / group > 1)
      return false;
  return true;
}

}  // namespace

extern "C" {

const char* arks_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xs [tp, k] (dtype 0 = float32, 1 = bfloat16; out [tp, n] the same), w by
// mode: 0 = [nx, k, n] of xs's dtype (scale NULL), 1 = int8 [nx, k, n] with
// scale [nx, n] f32, 2 = packed int4 [nx, k/2, n] with scale [nx, k/group,
// n] f32.  block_expert [tp / 128] int32; rows_used NULL or [1] int32;
// tile_rows NULL or [tp / 128] int32 (bf16 only; the f32 kernel reads
// rows_used).  tp % 128 == 0, n % 16 == 0, any k (a multiple of 8 for bf16:
// the rows of a TMA tensor are 16-byte aligned); an int4 group divides k,
// is even (f32) or a multiple of 8 whose 64-wide stages span two groups at
// most (bf16).  The wrapper checks all of these (and raises) first.
int arks_grouped_matmul(const void* xs, const void* w, const void* scale,
                        const void* block_expert, const void* rows_used,
                        const void* tile_rows, void* out, int tp, int k,
                        int n, int nx, int group, int mode, int dtype,
                        void* stream) {
  if (tp <= 0 || n <= 0) return 0;
  if (tp % kTile || k <= 0 || (dtype == 1 && k % 8) || n % 16 || nx <= 0 ||
      (dtype != 0 && dtype != 1) || (mode != kRaw && scale == nullptr) ||
      (mode == kInt4 &&
       (group <= 0 || k % group || k % 2 || group % (dtype == 1 ? 8 : 2) ||
        (dtype == 1 && !stages_fit(k, group)))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  const int* be = (const int*)block_expert;
  const int* ru = (const int*)rows_used;
  const int* tr = (const int*)tile_rows;
  if (mode == kRaw)
    return launch<kRaw>(xs, w, sc, be, ru, tr, out, tp, k, n, nx, group,
                        dtype, st);
  if (mode == kInt8)
    return launch<kInt8>(xs, w, sc, be, ru, tr, out, tp, k, n, nx, group,
                         dtype, st);
  if (mode == kInt4)
    return launch<kInt4>(xs, w, sc, be, ru, tr, out, tp, k, n, nx, group,
                         dtype, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
