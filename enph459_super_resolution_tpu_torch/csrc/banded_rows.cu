// Banded row apply on Hopper (sm_90a):
//
//   out[z, row0_b + r, w] = sum_k bands[b, k, r] * x[z, start_b + k, w]
//   for r < rows_b, k < win, start_b + k < n_in.
//
// One template, instantiated for each band kind that a matmul precision
// (ops/opmatrix.py MM_PRECISIONS) or a band store gives the row applies:
//
// * float32 bands (strict f32, the default band store; HIGHEST): f32 FMA on
//   the CUDA cores -- no tensor cores, no TF32 and no 3xTF32, which the
//   strict mode's parity contract forbids.
// * bfloat16 bands (the bf16 band store; DEFAULT / BF16_BF16_F32): bf16 x
//   bf16 products on the tensor cores (mma.sync m16n8k16) summed in f32.
//   x is rounded to bf16 (nearest even) as it enters the product, as the
//   reference's bf16 einsum with preferred_element_type=float32 does
//   (opmatrix.py BandedOp.row_apply); the band is exact as stored.
//   Products of two bf16 values are exact, so only the order of the f32
//   sum differs from the plain version.  BF16_BF16_BF16 is the same
//   product with the result rounded to bf16 in the epilogue (the sum stays
//   f32: a departure from the preset's bf16 accumulator).
// * split bands, bf16 parts (BF16_BF16_F32_X3 / HIGH, _X6, _X9): the
//   float32 bands come pre-split into P bf16 arrays, part 0 = bf16(b) and
//   part p = bf16(b - parts before it), each in the k-major layout; x is
//   split the same way in registers, and each k16 step issues one mma.sync
//   per pair of parts (p, q) with p + q <= S into one f32 accumulator.
//   X3: P = 2, S = 1 (hi*hi, hi*lo, lo*hi; the dropped lo*lo and x's bits
//   past its two halves are ~2^-16 of |b|*|x|, the 3-pass split XLA runs
//   for HIGH); X6: P = 3, S = 2 (the six products whose part indices sum
//   to <= 2, ~2^-24); X9: P = 3, all nine.  All three take those products
//   on the span walk (below).
// * tf32 bands (TF32_TF32_F32, _X3): mma.sync m16n8k8 .tf32 summed in f32.
//   The bands are stored as f32 already rounded to tf32 (nearest, ties away
//   from zero); x is rounded in registers by cvt.rna.tf32.f32, the same
//   rule.  _X3 splits both into two tf32 parts, hi = tf32(v) and lo =
//   tf32(v - hi), and sums hi*hi + hi*lo + lo*hi, on the span walk (TF32's
//   one pass over the whole block window).  Products of two tf32 values
//   (11-bit significands) are exact in f32.
// * f16 bands (F16_F16_F32, F16_F16_F16): mma.sync m16n8k16 .f16 summed in
//   f32, x rounded to f16 (nearest even) in registers; F16_F16_F16 rounds
//   the result to f16 in the epilogue (JAX's CPU backend: f16 operands, a
//   wide sum, an f16 result).  Band entries below 6.1e-5 are f16
//   subnormals, below 6e-8 zero, in the plain version too.
// * f64 (F64_F64_F64): float32 bands and x widened to f64 in registers,
//   products and sums on the f64 tensor cores (mma.sync m16n8k8 .f64, DMMA),
//   the result rounded to f32.  Products of two f32 values are exact in
//   f64, so only the order of the f64 sum differs from the plain version.
// Every instantiation writes float32.
//
// Replaces the TPU kernel enph459_super_resolution_tpu/ops/pallas_kernels.py
// `_row_kernel` (launched by `_banded_row_pallas`) and the reference's
// row einsums at the other precisions: every row apply of the banded
// classical solve (ops/opmatrix.py BandedOp.row_apply).  Operands come from
// ops/banded_rows.py `pack_banded`, which stores each band block k-major,
// [n_blk][win][128], so a window chunk is one contiguous run.
//
// What bounds it.  At the flagship size (LR 1536x2048 -> HR 3072x4096) the
// forward row operator does 2*1536*293*4096 = 3.65 GFLOP over its 128-row
// block windows (0.489 GFLOP over the bands' nonzeros) and moves ~84 MB
// (read the 3072x4096 HR image, write 1536x4096).  Over the nonzeros every
// instantiation is bound by bytes (0.023 ms), f64 too: its 0.489 GFLOP at
// the DMMA rate (67 TFLOP/s; plain f64 FMA reaches about half) take 0.0073
// ms.  The split kinds do P(P+1)/2 .. P^2 tensor-core products of the same
// work, still under the bytes over the nonzeros (X9's nine at bf16's 989
// TFLOP/s take 0.0045 ms), but not over the block windows: X9 0.035 ms,
// TF32_X3's three at tf32's 494.7 TFLOP/s 0.022 ms.  That is why the
// splits walk spans.
//
// Design.  What the TPU kernel spent its code on (HBM-pinned operands,
// scalar-prefetched window starts, hand double-buffered DMA, 8-aligned
// starts and W % 256) has no counterpart here.  One CUDA block computes a
// 128-row x BN-column output tile of one band block b for one batch index
// z, reading its own window start, first output row and row count.  It
// walks the window in K-chunks of 16 rows through a 4-stage ring in shared
// memory filled by cp.async (16-byte copies; 4-byte ones where W % 4 != 0),
// so the loads of the next three chunks overlap the products of this one;
// rows past n_in and columns past W are zero-filled by the copy.
// * float32: the band chunk [16][128] and the x chunk [16][128] are plain
//   copies; each of the 256 threads accumulates an 8 x 8 register tile with
//   fmaf, without a spill (125 registers on the 16-byte path, so two blocks
//   share an SM; 145 on the 4-byte one).  The 384-block fwd_r grid is then
//   1.45 waves of 264.  Grids of whole waves measured slower on the card:
//   one block per SM (a 7-stage ring, 2.91 waves of 132) and 96-column
//   tiles (1.95 waves of 264) cost more per block than the partial wave.
// * The span walk (f64, X3, X6, X9, TF32_X3; banded_rows_span_kernel): a
//   block walks its 128 rows as 8 row sub-tiles of 16, each only over the
//   steps of the window rows that hold its nonzeros (RowPack.spans, from
//   the host, rounded out to whole steps).  Lane s of every warp holds sub-tile s's
//   span; the block visits only the chunks some sub-tile meets, a ballot
//   per chunk says which sub-tiles it meets (only their band rows are
//   copied, every part's) and one per step which sub-tiles take it.  At
//   fwd_r a sub-tile spans ~72 of the block's 293 window rows.  Warps split
//   the columns, not the rows: the sub-tiles a chunk meets sit on the
//   band's diagonal, so a split of rows would leave warps idle.  Each
//   warp keeps one accumulator per sub-tile and n8 tile.  Skipped steps
//   hold only zero band entries, and a live step sums as the whole-window
//   tile would, so on finite x the result is that of the whole window, bit
//   for bit.  Three step bodies:
//   - f64: k8 steps (two a chunk), 64-column tiles (BN = 64); warp w owns
//     columns 8w .. 8w+7, one m16n8 f64 accumulator per sub-tile (64
//     registers).  1.86x the nonzeros' products at fwd_r (0.91 GFLOP)
//     instead of 7.5x.  A fragments (band, k-major, row stride 136 floats)
//     and B fragments (x, row stride 72) are f32 reads, conflict-free,
//     widened to f64 in registers.  Why m16n8k8: on the card it took less
//     time at fwd_r, bwd_r and in the F64 solve than m8n8k4 on 8-row
//     sub-tiles, though those form fewer products (1.43x the nonzeros at
//     fwd_r).  Other variants were tried without keeping their times; none
//     is settled either way (PERF.md).
//   - the bf16 splits X3, X6, X9: one m16n8k16 step a chunk, 128-column
//     tiles; warp w owns columns 16w .. 16w+15 (two n8 tiles), 8 x 2 f32
//     accumulators.  x is split once a chunk and serves every sub-tile;
//     per live sub-tile one ldmatrix.trans per part, then the pairs (p, q)
//     in the whole-window tile's order.  2.08x the nonzeros' products at
//     fwd_r instead of 7.8x.
//   - the tf32 split TF32_X3: m16n8k8 in k8 steps (two a chunk, F64's
//     steps and fragment layout), the bf16 splits' 128-column tiles and
//     accumulators.  x is split once a step and serves every sub-tile; per
//     live sub-tile and part one A fragment (four f32 reads), then the
//     pairs (p, q) in the whole-window tile's order (Tf32Frag).  1.86x the
//     nonzeros' products at fwd_r instead of 7.5x.
// * 16-bit bands (bf16, f16) over the whole window: each of the 8
//   warps computes 64 rows x 32 columns with mma.sync m16n8k16.  A comes
//   from the k-major band chunk by ldmatrix.trans (row stride 272 B: the 8
//   rows of one matrix fall in distinct banks; the span walk reads it
//   alike); B is read from the f32 x chunk (row stride 132 floats:
//   conflict-free) and rounded into 16-bit pairs in registers.
// * tf32 bands (TF32) over the whole window: the same warp tiles with
//   mma.sync m16n8k8, two k8 steps a chunk; A fragments are 32-bit elements
//   read straight from the k-major f32 band chunk (row stride 136 floats),
//   B from the x chunk (row stride 136 floats), both conflict-free; the
//   tf32 split step reads them alike.
// The ragged edges are masked (columns >= W, window rows >= n_in, rows >=
// rows_b), so every shape runs on the kernel.  Compile without
// --use_fast_math.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;       // rows of a band block (banded_rows.py ROWS)
constexpr int BK = 16;        // window rows per chunk (banded_rows.py K_CHUNK)
constexpr int STAGES = 4;     // depth of the cp.async ring
constexpr int THREADS = 256;
constexpr int MAX_GRID_Z = 65535;
constexpr int MAX_PARTS = 3;
// The span walk's row sub-tiles (banded_rows.py SUB_ROWS); the window rows
// of one step are its step body's KS (Kind.span_k there).
constexpr int SUB = 16;
constexpr int NSUB = BM / SUB;  // sub-tiles of a band block

// How a tensor-core kind rounds its f32 sum before the store.
enum Round { kRoundF32 = 0, kRoundBf16 = 1, kRoundF16 = 2 };

// Band kinds.  float: f32 FMA.  F64: f32 bands, DMMA.  Mma<E, P, S, R>:
// tensor-core products of element type E (__nv_bfloat16, __half or Tf32)
// over P band parts, the pairs of parts (p, q) with p + q <= S, the result
// rounded by R.
struct F64 {};
struct Tf32 {};  // float storage holding tf32 values
template <typename E, int P, int S, int R_>
struct Mma {
  static constexpr int R = R_;
};

using Bf16 = Mma<__nv_bfloat16, 1, 0, kRoundF32>;
using Bf16Out = Mma<__nv_bfloat16, 1, 0, kRoundBf16>;
using SplitX3 = Mma<__nv_bfloat16, 2, 1, kRoundF32>;
using SplitX6 = Mma<__nv_bfloat16, 3, 2, kRoundF32>;
using SplitX9 = Mma<__nv_bfloat16, 3, 4, kRoundF32>;
using Tf32x1 = Mma<Tf32, 1, 0, kRoundF32>;
using Tf32x3 = Mma<Tf32, 2, 1, kRoundF32>;
using F16 = Mma<__half, 1, 0, kRoundF32>;
using F16Out = Mma<__half, 1, 0, kRoundF16>;

// Shared-memory layout of one stage for a band kind: PARTS band chunks
// [BK][AS] of Elem (k-major) and the x chunk [BK][XS] float32; BN output
// columns per CUDA block.
template <typename Kind>
struct Stage;
template <>
struct Stage<float> {
  using Elem = float;
  static constexpr int PARTS = 1;
  static constexpr int AS = BM;  // float4 reads of 8 rows: no padding needed
  static constexpr int BN = 128;
  static constexpr int XS = BN + 4;
  static constexpr int MIN_BLOCKS = 1;
};
template <>
struct Stage<F64> {
  using Elem = float;
  static constexpr int PARTS = 1;
  // fragment reads of rows t and columns g: t * 8 + g covers the 32 banks
  static constexpr int AS = BM + 8;
  static constexpr int BN = 64;
  static constexpr int XS = BN + 8;
  static constexpr int MIN_BLOCKS = 2;
};
template <typename E, int P, int S, int R>
struct Stage<Mma<E, P, S, R>> {
  using Elem = std::conditional_t<std::is_same_v<E, Tf32>, float, E>;
  static constexpr int PARTS = P;
  // 16-bit: 272-byte rows for ldmatrix.trans; tf32: 136 floats, so the
  // fragment reads of rows t and t + 4 fall in distinct banks
  static constexpr int AS = BM + 8;
  static constexpr int BN = 128;
  static constexpr int XS = sizeof(Elem) == 4 ? BN + 8 : BN + 4;
  static constexpr int MIN_BLOCKS = 2;
};

template <typename Kind>
__host__ __device__ constexpr int part_bytes() {
  return BK * Stage<Kind>::AS *
         static_cast<int>(sizeof(typename Stage<Kind>::Elem));
}
template <typename Kind>
__host__ __device__ constexpr int a_bytes() {
  return Stage<Kind>::PARTS * part_bytes<Kind>();
}
template <typename Kind>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<Kind>() + BK * Stage<Kind>::XS * 4;
}

// The band arrays of one launch: PARTS of them, each [n_blk][win][BM].
template <typename Elem>
struct Parts {
  const Elem* p[MAX_PARTS];
};

// Two floats as a 16-bit pair, `a` in the low half (nearest even), and back.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  return mma_bf16::pack_bf16x2(a, b);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return mma_bf16::unpack_bf16x2(v);
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

// Two floats split into P 16-bit pairs: part 0 = round(v), part p =
// round(v - parts before it); each difference is exact in f32.
template <typename E, int P>
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (&out)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p] = pack2<E>(a, b);
    if (p + 1 < P) {
      const float2 h = unpack2<E>(out[p]);
      a -= h.x;
      b -= h.y;
    }
  }
}

// A float rounded to tf32 (nearest, ties away from zero), as f32 bits.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

template <int P>
__device__ __forceinline__ void split_tf32(float v, uint32_t (&out)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p] = to_tf32(v);
    if (p + 1 < P) v -= __uint_as_float(out[p]);
  }
}

// d += A * B for one m16n8k16 tile of f16 operands, f32 accumulator (the
// fragment layout of mma_bf16.cuh).
__device__ __forceinline__ void mma_16816_f16(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename E>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<E, __half>)
    mma_16816_f16(d, a, b0, b1);
  else
    mma_bf16::mma_16816(d, a, b0, b1);
}

// d += A * B for one m16n8k8 tile of tf32 operands, f32 accumulator.  For
// lane l, g = l / 4 and t = l % 4: a0 = A[g][t], a1 = A[g+8][t], a2 =
// A[g][t+4], a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; C as m16n8k16.
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int R>
__device__ __forceinline__ float round_out(float v) {
  if constexpr (R == kRoundBf16)
    return __bfloat162float(__float2bfloat16_rn(v));
  if constexpr (R == kRoundF16) return __half2float(__float2half_rn(v));
  return v;
}

struct Block {
  const float* xz;
  int start, w0, n_in, W;
};

// cp.async window chunk `kc` of x (rows past n_in and columns past W
// zero-filled) into a stage's x chunk [BK][XS].
template <typename Kind, bool kVec>
__device__ __forceinline__ void load_x(float* xs, const Block& bl, int kc,
                                       int tid) {
  using namespace mma_bf16;
  constexpr int BN = Stage<Kind>::BN;
  constexpr int XS = Stage<Kind>::XS;
  const int xr0 = bl.start + kc * BK;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (BN / 4);
      const int c = (e % (BN / 4)) * 4;
      const bool in = xr0 + k < bl.n_in && bl.w0 + c < bl.W;
      const float* p =
          in ? bl.xz + static_cast<size_t>(xr0 + k) * bl.W + bl.w0 + c : bl.xz;
      cp_async16(xs + k * XS + c, p, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / BN;
      const int c = e % BN;
      const bool in = xr0 + k < bl.n_in && bl.w0 + c < bl.W;
      const float* p =
          in ? bl.xz + static_cast<size_t>(xr0 + k) * bl.W + bl.w0 + c : bl.xz;
      cp_async4(xs + k * XS + c, p, in ? 4 : 0);
    }
  }
}

// cp.async window chunk `kc` of every band part and of x into one ring
// stage.
template <typename Kind, bool kVec>
__device__ __forceinline__ void load_chunk(
    char* stage, const Parts<typename Stage<Kind>::Elem>& band,
    const Block& bl, int kc, int tid) {
  using namespace mma_bf16;
  using Elem = typename Stage<Kind>::Elem;
  constexpr int PER16 = 16 / static_cast<int>(sizeof(Elem));
  constexpr int PIECES = BK * BM / PER16;
  constexpr int AS = Stage<Kind>::AS;
#pragma unroll
  for (int p = 0; p < Stage<Kind>::PARTS; ++p) {
    const Elem* src = band.p[p] + static_cast<size_t>(kc) * BK * BM;
    Elem* as = reinterpret_cast<Elem*>(stage + p * part_bytes<Kind>());
#pragma unroll
    for (int i = 0; i < PIECES / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (BM / PER16);
      const int c = (e % (BM / PER16)) * PER16;
      cp_async16(as + k * AS + c, src + k * BM + c, 16);
    }
  }
  load_x<Kind, kVec>(reinterpret_cast<float*>(stage + a_bytes<Kind>()), bl,
                     kc, tid);
}

// float32 bands: thread (ty, tx) owns rows ty*8 .. +7 and columns
// tx*4 .. +3 and 64 + tx*4 .. +3.
struct FmaTile {
  static constexpr int XS = Stage<float>::XS;
  float acc[8][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const char* stage, int tid) {
    const float* as = reinterpret_cast<const float*>(stage);
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<float>());
    const int ty = tid / 16;
    const int tx = tid % 16;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * BM + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + k * BM + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(xs + k * XS + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(xs + k * XS + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <bool kVec>
  __device__ __forceinline__ void store(float* oz, int row0, int nrow, int w0,
                                        int W, int tid) const {
    const int ty = tid / 16;
    const int tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r >= nrow) break;
      float* orow = oz + static_cast<size_t>(row0 + r) * W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = w0 + h * 64 + tx * 4;
        if (kVec) {
          if (c < W)
            *reinterpret_cast<float4*>(orow + c) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < W) orow[c + j] = acc[i][4 * h + j];
        }
      }
    }
  }
};

// Two results into columns c, c + 1 of an output row (those below W).
template <bool kVec>
__device__ __forceinline__ void store_pair(float* orow, int c, int W, float v0,
                                           float v1) {
  if (kVec) {
    if (c < W) *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
  } else {
    if (c < W) orow[c] = v0;
    if (c + 1 < W) orow[c + 1] = v1;
  }
}

// The tensor-core tiles: warp (wm, wn) = (warp % 2, warp / 2) owns rows
// wm*64 .. +63 (4 m16 tiles) and columns wn*32 .. +31 (4 n8 tiles); the C
// fragments are stored after rounding by R.
template <int R>
struct MmaAcc {
  float acc[4][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  }

  template <bool kVec>
  __device__ __forceinline__ void store(float* oz, int row0, int nrow, int w0,
                                        int W, int tid) const {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp & 1) * 64 + mt * 16 + g + 8 * h;
        if (r >= nrow) continue;
        float* orow = oz + static_cast<size_t>(row0 + r) * W;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          store_pair<kVec>(orow, w0 + (warp >> 1) * 32 + nt * 8 + 2 * q, W,
                           round_out<R>(acc[mt][nt][2 * h]),
                           round_out<R>(acc[mt][nt][2 * h + 1]));
      }
  }
};

// A k16 step of a 16-bit kind Mma<E, P, S, R> (the whole-window tile and
// the span walk's split step both take their products here, so both sum
// in one order).  A lane's x for NT n8 tiles, the first at column `col` of
// the stage's x chunk (the lane's g included), as 16-bit pairs along k
// split into P parts: b[nt][0] = rows 2q, 2q+1; b[nt][1] = rows 2q+8, 2q+9.
template <typename Kind, int NT>
struct Mma16Frag;
template <typename E, int P, int S, int R, int NT>
struct Mma16Frag<Mma<E, P, S, R>, NT> {
  using Kind = Mma<E, P, S, R>;
  static constexpr int AS = Stage<Kind>::AS;
  static constexpr int XS = Stage<Kind>::XS;
  uint32_t b[NT][2][P];

  __device__ __forceinline__ Mma16Frag(const float* col, int q) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt, col += 8) {
      split_pair<E, P>(col[(2 * q) * XS], col[(2 * q + 1) * XS], b[nt][0]);
      split_pair<E, P>(col[(2 * q + 8) * XS], col[(2 * q + 9) * XS],
                       b[nt][1]);
    }
  }

  // ldmatrix.trans addresses: lanes 8m..8m+7 address matrix m, k rows
  // (m / 2) * 8 + lane % 8 at band rows +(m % 2) * 8 of an m16 tile
  static __device__ __forceinline__ int a_offset(int lane) {
    return ((lane & 7) + (lane >> 4) * 8) * AS + ((lane >> 3) & 1) * 8;
  }

  // acc += the m16 tile at `aoff` (a_offset + its first band row) times x:
  // per band part p its A fragments, then the x parts q with p + q <= S,
  // each over the NT n8 tiles
  __device__ __forceinline__ void products(float (&acc)[NT][4],
                                           const char* stage,
                                           int aoff) const {
    using namespace mma_bf16;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const E* as = reinterpret_cast<const E*>(stage + p * part_bytes<Kind>());
      uint32_t a[4];
      ldmatrix_x4_trans(a, as + aoff);
#pragma unroll
      for (int qq = 0; qq < P; ++qq) {
        if (p + qq > S) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma16<E>(acc[nt], a, b[nt][0][qq], b[nt][1][qq]);
      }
    }
  }
};

// 16-bit band kinds over the whole window (bf16, f16): mma.sync
// m16n8k16.
template <typename Kind>
struct Mma16Tile : MmaAcc<Kind::R> {
  __device__ __forceinline__ void step(const char* stage, int tid) {
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<Kind>());
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp & 1;
    const int wn = warp >> 1;
    const Mma16Frag<Kind, 4> x(xs + wn * 32 + (lane >> 2), lane & 3);
    const int aoff = x.a_offset(lane) + wm * 64;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      x.products(this->acc[mt], stage, aoff + mt * 16);
  }
};

// A k8 step of a tf32 kind Mma<Tf32, P, S, R> (the whole-window tile and
// the span walk's tf32 step both take their products here, so both sum in
// one order).  A lane's x for NT n8 tiles, the first at `col` (the x chunk
// at the step's window row t and the lane's column g), split into P tf32
// parts: b[nt][0] = window row t, b[nt][1] = row t + 4.
template <typename Kind, int NT>
struct Tf32Frag;
template <int P, int S, int R, int NT>
struct Tf32Frag<Mma<Tf32, P, S, R>, NT> {
  using Kind = Mma<Tf32, P, S, R>;
  static constexpr int AS = Stage<Kind>::AS;
  static constexpr int XS = Stage<Kind>::XS;
  uint32_t b[NT][2][P];

  __device__ __forceinline__ explicit Tf32Frag(const float* col) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt, col += 8) {
      split_tf32<P>(col[0], b[nt][0]);
      split_tf32<P>(col[4 * XS], b[nt][1]);
    }
  }

  // acc += the m16 tile whose A fragment starts `aoff` floats into each
  // band part's chunk (the step's window row t, the tile's band row g): per
  // band part p its A fragment, then the x parts q with p + q <= S, each
  // over the NT n8 tiles
  __device__ __forceinline__ void products(float (&acc)[NT][4],
                                           const char* stage,
                                           int aoff) const {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t* ap = reinterpret_cast<const uint32_t*>(
                               stage + p * part_bytes<Kind>()) + aoff;
      const uint32_t a[4] = {ap[0], ap[8], ap[4 * AS], ap[4 * AS + 8]};
#pragma unroll
      for (int qq = 0; qq < P; ++qq) {
        if (p + qq > S) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_1688_tf32(acc[nt], a, b[nt][0][qq], b[nt][1][qq]);
      }
    }
  }
};

// tf32 band kinds over the whole window (TF32): mma.sync m16n8k8, two k8
// steps per chunk.
template <int P, int S, int R>
struct Tf32Tile : MmaAcc<R> {
  using Kind = Mma<Tf32, P, S, R>;
  static constexpr int AS = Stage<Kind>::AS;
  static constexpr int XS = Stage<Kind>::XS;

  __device__ __forceinline__ void step(const char* stage, int tid) {
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<Kind>());
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp & 1;
    const int wn = warp >> 1;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      const Tf32Frag<Kind, 4> x(xs + (k0 + t) * XS + wn * 32 + g);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        x.products(this->acc[mt], stage,
                   (k0 + t) * AS + wm * 64 + mt * 16 + g);
    }
  }
};

template <typename Kind>
struct TileOf;
template <>
struct TileOf<float> {
  using type = FmaTile;
};
template <typename E, int P, int S, int R>
struct TileOf<Mma<E, P, S, R>> {
  using type = Mma16Tile<Mma<E, P, S, R>>;
};
template <int P, int S, int R>
struct TileOf<Mma<Tf32, P, S, R>> {
  using type = Tf32Tile<P, S, R>;
};

template <typename Kind, bool kVec>
__global__ void __launch_bounds__(THREADS, Stage<Kind>::MIN_BLOCKS)
banded_rows_kernel(const Parts<typename Stage<Kind>::Elem> bands,
                   const int* __restrict__ starts,
                   const int* __restrict__ out_row0,
                   const int* __restrict__ rows,
                   const float* __restrict__ x, float* __restrict__ out,
                   int win, int n_in, int n_out, int W, int z0) {
  using namespace mma_bf16;
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.x;
  const size_t z = static_cast<size_t>(blockIdx.z) + z0;
  const Block bl = {x + z * n_in * W, starts[b],
                    static_cast<int>(blockIdx.y) * Stage<Kind>::BN, n_in, W};
  Parts<typename Stage<Kind>::Elem> band = bands;
#pragma unroll
  for (int p = 0; p < Stage<Kind>::PARTS; ++p)
    band.p[p] += static_cast<size_t>(b) * win * BM;
  const int tid = threadIdx.x;
  const int nk = win / BK;

  typename TileOf<Kind>::type tile;
  tile.zero();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_chunk<Kind, kVec>(smem + s * stage_bytes<Kind>(), band, bl, s,
                             tid);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    // chunk kc has landed for every thread, and every thread is done with
    // the stage of chunk kc - 1, which is refilled next
    __syncthreads();
    const int next = kc + STAGES - 1;
    if (next < nk)
      load_chunk<Kind, kVec>(smem + (next % STAGES) * stage_bytes<Kind>(),
                             band, bl, next, tid);
    cp_async_commit();
    tile.step(smem + (kc % STAGES) * stage_bytes<Kind>(), tid);
  }
  tile.template store<kVec>(out + z * n_out * W, out_row0[b], rows[b], bl.w0,
                            W, tid);
}

// d += A * B for one m16n8k8 tile of f64 operands (DMMA).  For lane l,
// g = l / 4 and t = l % 4: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; d0, d1 = D[g][2t .. 2t+1],
// d2, d3 = D[g+8][2t .. 2t+1].
__device__ __forceinline__ void dmma_1688(double (&d)[4], const double (&a)[4],
                                          const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A span kind's chunk: every part's band rows of the sub-tiles in `live`
// (bit s: rows 16s .. 16s+15), and x.  The other sub-tiles' rows of the
// stage keep what an earlier chunk left there; no step of this chunk reads
// them.
template <typename Kind, bool kVec>
__device__ __forceinline__ void load_span_chunk(
    char* stage, const Parts<typename Stage<Kind>::Elem>& band,
    const Block& bl, int kc, unsigned live, int tid) {
  using namespace mma_bf16;
  using Elem = typename Stage<Kind>::Elem;
  constexpr int AS = Stage<Kind>::AS;
  constexpr int PER16 = 16 / static_cast<int>(sizeof(Elem));
  constexpr int PER_SUB = SUB / PER16;  // 16-byte pieces of a sub-tile's row
#pragma unroll
  for (int p = 0; p < Stage<Kind>::PARTS; ++p) {
    const Elem* src = band.p[p] + static_cast<size_t>(kc) * BK * BM;
    Elem* as = reinterpret_cast<Elem*>(stage + p * part_bytes<Kind>());
#pragma unroll
    for (int i = 0; i < BK * NSUB * PER_SUB / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (NSUB * PER_SUB);
      const int sub = (e / PER_SUB) % NSUB;
      const int c = sub * SUB + (e % PER_SUB) * PER16;
      if ((live >> sub) & 1) cp_async16(as + k * AS + c, src + k * BM + c, 16);
    }
  }
  load_x<Kind, kVec>(reinterpret_cast<float*>(stage + a_bytes<Kind>()), bl,
                     kc, tid);
}

// The span walk's step bodies.  Each holds a warp's accumulators, one per
// row sub-tile (and n8 tile), and takes a chunk's steps: `on[j]` bit s says
// sub-tile s takes step j (window rows KS*j .. KS*j + KS - 1 of the chunk),
// `any` is their union.  Three bodies: F64's k8 DMMA step, the bf16
// splits' k16 step and the tf32 split's k8 step (F64's fragment layout).

// f64 bands on DMMA: warp w computes columns 8w .. 8w+7 of the 128 x 64
// tile as 8 m16n8 accumulators, one per row sub-tile, in k8 steps.
struct F64Step {
  using Kind = F64;
  static constexpr int KS = 8;
  static constexpr int STEPS = BK / KS;
  static constexpr int AS = Stage<F64>::AS;
  static constexpr int XS = Stage<F64>::XS;
  double acc[NSUB][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[s][q] = 0.0;
  }

  __device__ __forceinline__ void chunk(const char* stage,
                                        const unsigned (&on)[STEPS],
                                        unsigned any, int lane, int warp) {
    const int g = lane >> 2;
    const int t = lane & 3;
    const float* as = reinterpret_cast<const float*>(stage) + t * AS + g;
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<F64>()) +
                      t * XS + warp * 8 + g;
    double bx[STEPS][2];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      bx[j][0] = xs[KS * j * XS];
      bx[j][1] = xs[(KS * j + 4) * XS];
    }
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
      if (!((any >> s) & 1)) continue;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        if (!((on[j] >> s) & 1)) continue;
        const float* a0 = as + KS * j * AS + s * SUB;
        const double a[4] = {a0[0], a0[8], a0[4 * AS], a0[4 * AS + 8]};
        dmma_1688(acc[s], a, bx[j]);
      }
    }
  }

  template <bool kVec>
  __device__ __forceinline__ void store(float* orow0, int nrow, int w0, int W,
                                        int lane, int warp) const {
    const int g = lane >> 2;
    const int c = w0 + warp * 8 + 2 * (lane & 3);
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = s * SUB + g + 8 * h;
        if (r >= nrow) continue;
        store_pair<kVec>(orow0 + static_cast<size_t>(r) * W, c, W,
                         static_cast<float>(acc[s][2 * h]),
                         static_cast<float>(acc[s][2 * h + 1]));
      }
  }
};

// The 128-column step bodies' accumulators: warp w computes columns 16w ..
// 16w+15 of the 128 x 128 tile as 8 x 2 m16n8 f32 accumulators, one per
// row sub-tile and n8 tile, stored after rounding by R.
template <int R>
struct SubTileAcc {
  float acc[NSUB][2][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][nt][q] = 0.f;
  }

  template <bool kVec>
  __device__ __forceinline__ void store(float* orow0, int nrow, int w0, int W,
                                        int lane, int warp) const {
    const int g = lane >> 2;
    const int c = w0 + warp * 16 + 2 * (lane & 3);
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = s * SUB + g + 8 * h;
        if (r >= nrow) continue;
        float* orow = orow0 + static_cast<size_t>(r) * W;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          store_pair<kVec>(orow, c + nt * 8, W,
                           round_out<R>(acc[s][nt][2 * h]),
                           round_out<R>(acc[s][nt][2 * h + 1]));
      }
  }
};

// 16-bit split bands on mma.sync m16n8k16, one step a chunk, each
// sub-tile's products those of Mma16Tile (Mma16Frag).
template <typename K>
struct Mma16Step : SubTileAcc<K::R> {
  using Kind = K;
  static constexpr int KS = BK;
  static constexpr int STEPS = 1;

  __device__ __forceinline__ void chunk(const char* stage,
                                        const unsigned (&on)[STEPS],
                                        unsigned, int lane, int warp) {
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<Kind>());
    // x is split once and serves every sub-tile
    const Mma16Frag<Kind, 2> x(xs + warp * 16 + (lane >> 2), lane & 3);
    const int aoff = x.a_offset(lane);
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
      if ((on[0] >> s) & 1) x.products(this->acc[s], stage, aoff + s * SUB);
  }
};

// tf32 split bands on mma.sync m16n8k8, in k8 steps (two a chunk), each
// sub-tile's products those of Tf32Tile (Tf32Frag).
template <int P, int S, int R>
struct Tf32Step : SubTileAcc<R> {
  using Kind = Mma<Tf32, P, S, R>;
  static constexpr int KS = 8;
  static constexpr int STEPS = BK / KS;
  static constexpr int AS = Stage<Kind>::AS;
  static constexpr int XS = Stage<Kind>::XS;

  __device__ __forceinline__ void chunk(const char* stage,
                                        const unsigned (&on)[STEPS],
                                        unsigned, int lane, int warp) {
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<Kind>());
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      if (!on[j]) continue;
      // x is split once a step and serves every sub-tile that takes it
      const Tf32Frag<Kind, 2> x(xs + (KS * j + t) * XS + warp * 16 + g);
#pragma unroll
      for (int s = 0; s < NSUB; ++s)
        if ((on[j] >> s) & 1)
          x.products(this->acc[s], stage, (KS * j + t) * AS + s * SUB + g);
    }
  }
};

// The kinds that run on the span walk, and their step bodies.
template <typename Kind>
struct SpanStep {
  using type = void;
};
template <>
struct SpanStep<F64> {
  using type = F64Step;
};
template <>
struct SpanStep<SplitX3> {
  using type = Mma16Step<SplitX3>;
};
template <>
struct SpanStep<SplitX6> {
  using type = Mma16Step<SplitX6>;
};
template <>
struct SpanStep<SplitX9> {
  using type = Mma16Step<SplitX9>;
};
template <>
struct SpanStep<Tf32x3> {
  using type = Tf32Step<2, 1, kRoundF32>;
};
template <typename Kind>
constexpr bool kSpans = !std::is_void_v<typename SpanStep<Kind>::type>;

// The span walk: one CUDA block per 128-row band block, BN-column tile and
// batch index; each row sub-tile takes the steps inside its span (rounded
// out to whole steps of Step::KS rows), all others skip.
template <typename Step, bool kVec>
__global__ void __launch_bounds__(THREADS,
                                  Stage<typename Step::Kind>::MIN_BLOCKS)
banded_rows_span_kernel(
    const Parts<typename Stage<typename Step::Kind>::Elem> bands,
    const int2* __restrict__ spans, const int* __restrict__ starts,
    const int* __restrict__ out_row0, const int* __restrict__ rows,
    const float* __restrict__ x, float* __restrict__ out, int win, int n_in,
    int n_out, int W, int z0) {
  using namespace mma_bf16;
  using Kind = typename Step::Kind;
  constexpr int KS = Step::KS;
  constexpr int SB = stage_bytes<Kind>();
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.x;
  const size_t z = static_cast<size_t>(blockIdx.z) + z0;
  const Block bl = {x + z * n_in * W, starts[b],
                    static_cast<int>(blockIdx.y) * Stage<Kind>::BN, n_in, W};
  Parts<typename Stage<Kind>::Elem> band = bands;
#pragma unroll
  for (int p = 0; p < Stage<Kind>::PARTS; ++p)
    band.p[p] += static_cast<size_t>(b) * win * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // lane s < NSUB holds sub-tile s's span, widened to whole steps
  int lo = 0, hi = 0;
  if (lane < NSUB) {
    const int2 sp = spans[b * NSUB + lane];
    lo = sp.x / KS * KS;
    hi = (sp.y + KS - 1) / KS * KS;
  }
  // the chunks that some sub-tile meets
  const int first = __reduce_min_sync(~0u, lo < hi ? lo : win) / BK;
  const int end = (__reduce_max_sync(~0u, hi) + BK - 1) / BK;
  const int nk = end > first ? end - first : 0;
  auto live = [&](int kc) {
    return __ballot_sync(~0u, lo < (kc + 1) * BK && hi > kc * BK);
  };

  Step step;
  step.zero();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_span_chunk<Kind, kVec>(smem + s * SB, band, bl, first + s,
                                  live(first + s), tid);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    // chunk i has landed for every thread, and every thread is done with
    // the stage of chunk i - 1, which is refilled next
    __syncthreads();
    const int next = i + STAGES - 1;
    if (next < nk)
      load_span_chunk<Kind, kVec>(smem + (next % STAGES) * SB, band, bl,
                                  first + next, live(first + next), tid);
    cp_async_commit();
    // on[j] bit s: sub-tile s takes step j (window rows kb + KS*j .. +KS-1)
    const int kb = (first + i) * BK;
    unsigned on[Step::STEPS];
    unsigned any = 0;
#pragma unroll
    for (int j = 0; j < Step::STEPS; ++j) {
      on[j] = __ballot_sync(~0u, lo <= kb + KS * j && kb + KS * j < hi);
      any |= on[j];
    }
    step.chunk(smem + (i % STAGES) * SB, on, any, lane, warp);
  }
  step.template store<kVec>(
      out + z * n_out * W + static_cast<size_t>(out_row0[b]) * W, rows[b],
      bl.w0, W, lane, warp);
}

// Launch `kernel`, Kind's instantiation, over band blocks x column tiles x
// batch (in slices of MAX_GRID_Z) with its leading arguments `args`, then
// win, n_in, n_out, W and the slice's first batch index.
template <typename Kind, typename Kernel, typename... Args>
int launch_grid(Kernel kernel, int n_blk, int win, int n_in, int n_out, int W,
                int batch, cudaStream_t s, Args... args) {
  constexpr int smem = STAGES * stage_bytes<Kind>();
  constexpr int BN = Stage<Kind>::BN;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = batch - z0 < MAX_GRID_Z ? batch - z0 : MAX_GRID_Z;
    const dim3 grid(n_blk, (W + BN - 1) / BN, nz);
    kernel<<<grid, THREADS, smem, s>>>(args..., win, n_in, n_out, W, z0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename Kind, bool kVec>
int launch_kind(const Parts<typename Stage<Kind>::Elem>& bands,
                const int2* spans, const int* starts, const int* out_row0,
                const int* rows, const float* x, float* out, int n_blk,
                int win, int n_in, int n_out, int W, int batch,
                cudaStream_t s) {
  if constexpr (kSpans<Kind>)
    return launch_grid<Kind>(
        banded_rows_span_kernel<typename SpanStep<Kind>::type, kVec>, n_blk,
        win, n_in, n_out, W, batch, s, bands, spans, starts, out_row0, rows,
        x, out);
  else
    return launch_grid<Kind>(banded_rows_kernel<Kind, kVec>, n_blk, win, n_in,
                             n_out, W, batch, s, bands, starts, out_row0,
                             rows, x, out);
}

// `spans` (n_blk x NSUB int2, 8-byte aligned) is read by the span kinds
// alone, which refuse to launch without it.
template <typename Kind>
int launch(const typename Stage<Kind>::Elem* const* parts, const int* starts,
           const int* out_row0, const int* rows, const float* x, float* out,
           int n_blk, int win, int n_in, int n_out, int W, int batch,
           void* stream, const int* spans = nullptr) {
  if (n_blk <= 0 || win <= 0 || win % BK != 0 || n_in <= 0 || n_out <= 0 ||
      W <= 0 || batch <= 0 || (kSpans<Kind> && spans == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(spans) & 7) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  Parts<typename Stage<Kind>::Elem> bands = {};
  for (int p = 0; p < Stage<Kind>::PARTS; ++p) {
    if ((reinterpret_cast<uintptr_t>(parts[p]) & 15) != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    bands.p[p] = parts[p];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* sp = reinterpret_cast<const int2*>(spans);
  // 16-byte copies and stores need every row of x and out 16-byte aligned
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return vec ? launch_kind<Kind, true>(bands, sp, starts, out_row0, rows, x,
                                       out, n_blk, win, n_in, n_out, W, batch,
                                       s)
             : launch_kind<Kind, false>(bands, sp, starts, out_row0, rows, x,
                                        out, n_blk, win, n_in, n_out, W,
                                        batch, s);
}

}  // namespace

// Launch the kernel on `stream` for a [batch, n_in, W] input and a
// [batch, n_out, W] output (both contiguous float32); `starts`, `out_row0`
// and `rows` hold n_blk int32 each; each band array is n_blk x win x 128
// (k-major, 16-byte aligned): float32 (banded_rows_launch, _f64_launch;
// tf32-rounded for _tf32_launch), bfloat16 (_bf16_launch,
// _bf16out_launch), float16 (_f16_launch, _f16out_launch), or the parts of
// split bands in order, hi first: two bfloat16 arrays (_x3_launch), three
// (_x6_launch, _x9_launch) or two tf32-rounded float32 arrays
// (_tf32x3_launch).  The span kinds' entry points (_f64_launch,
// _x3_launch, _x6_launch, _x9_launch, _tf32x3_launch) take the sub-tiles'
// spans after the bands:
// n_blk x 8 int32 pairs (RowPack.spans, 8-byte aligned, not null).  Each
// returns cudaGetLastError() after the launch (0 on success).
#define BANDED_ROWS_ARGS                                                   \
  const int *starts, const int *out_row0, const int *rows, const float *x, \
      float *out, int n_blk, int win, int n_in, int n_out, int W, int batch, \
      void *stream
#define BANDED_ROWS_PASS \
  starts, out_row0, rows, x, out, n_blk, win, n_in, n_out, W, batch, stream

extern "C" int banded_rows_launch(const float* bands, BANDED_ROWS_ARGS) {
  const float* parts[] = {bands};
  return launch<float>(parts, BANDED_ROWS_PASS);
}

extern "C" int banded_rows_bf16_launch(
    const __nv_bfloat16* bands, BANDED_ROWS_ARGS) {
  const __nv_bfloat16* parts[] = {bands};
  return launch<Bf16>(parts, BANDED_ROWS_PASS);
}

extern "C" int banded_rows_bf16out_launch(
    const __nv_bfloat16* bands, BANDED_ROWS_ARGS) {
  const __nv_bfloat16* parts[] = {bands};
  return launch<Bf16Out>(parts, BANDED_ROWS_PASS);
}

extern "C" int banded_rows_x3_launch(
    const __nv_bfloat16* hi, const __nv_bfloat16* lo, const int* spans,
    BANDED_ROWS_ARGS) {
  const __nv_bfloat16* parts[] = {hi, lo};
  return launch<SplitX3>(parts, BANDED_ROWS_PASS, spans);
}

extern "C" int banded_rows_x6_launch(
    const __nv_bfloat16* hi, const __nv_bfloat16* mid, const __nv_bfloat16* lo,
    const int* spans, BANDED_ROWS_ARGS) {
  const __nv_bfloat16* parts[] = {hi, mid, lo};
  return launch<SplitX6>(parts, BANDED_ROWS_PASS, spans);
}

extern "C" int banded_rows_x9_launch(
    const __nv_bfloat16* hi, const __nv_bfloat16* mid, const __nv_bfloat16* lo,
    const int* spans, BANDED_ROWS_ARGS) {
  const __nv_bfloat16* parts[] = {hi, mid, lo};
  return launch<SplitX9>(parts, BANDED_ROWS_PASS, spans);
}

extern "C" int banded_rows_tf32_launch(const float* bands, BANDED_ROWS_ARGS) {
  const float* parts[] = {bands};
  return launch<Tf32x1>(parts, BANDED_ROWS_PASS);
}

extern "C" int banded_rows_tf32x3_launch(
    const float* hi, const float* lo, const int* spans, BANDED_ROWS_ARGS) {
  const float* parts[] = {hi, lo};
  return launch<Tf32x3>(parts, BANDED_ROWS_PASS, spans);
}

extern "C" int banded_rows_f16_launch(const __half* bands, BANDED_ROWS_ARGS) {
  const __half* parts[] = {bands};
  return launch<F16>(parts, BANDED_ROWS_PASS);
}

extern "C" int banded_rows_f16out_launch(
    const __half* bands, BANDED_ROWS_ARGS) {
  const __half* parts[] = {bands};
  return launch<F16Out>(parts, BANDED_ROWS_PASS);
}

extern "C" int banded_rows_f64_launch(const float* bands, const int* spans,
                                      BANDED_ROWS_ARGS) {
  const float* parts[] = {bands};
  return launch<F64>(parts, BANDED_ROWS_PASS, spans);
}
