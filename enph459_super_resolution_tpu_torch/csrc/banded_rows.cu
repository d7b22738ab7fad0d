// Banded row apply on Hopper (sm_90a):
//
//   out[z, row0_b + r, w] = sum_k bands[b, k, r] * x[z, start_b + k, w]
//   for r < rows_b, k < win, start_b + k < n_in.
//
// Three instantiations of one template: float32 bands (strict f32, the
// default band store), bfloat16 bands (the bf16 band store, and float32
// bands at mm_precision DEFAULT) and float32 bands split into bf16 halves
// (mm_precision HIGH / BF16_BF16_F32_X3).
//
// * float32 bands: f32 FMA on the CUDA cores -- no tensor cores, no TF32
//   and no 3xTF32, which the strict mode's parity contract forbids.
// * bfloat16 bands: bf16 x bf16 products on the tensor cores (mma.sync
//   m16n8k16) summed in f32.  x is rounded to bf16 (nearest even) as it
//   enters the product, as the reference's bf16 einsum with
//   preferred_element_type=float32 does (opmatrix.py BandedOp.row_apply);
//   the band is exact as stored.  Products of two bf16 values are exact, so
//   only the order of the f32 sum differs from the plain version.
// * split (X3): the float32 bands come pre-split as two bf16 arrays, hi =
//   bf16(b) and lo = bf16(b - hi), each in the k-major layout (together the
//   bytes of the f32 bands); x is split the same way in registers, and each
//   k16 step issues three mma.sync into one f32 accumulator: hi*hi, hi*lo
//   and lo*hi.  The dropped lo*lo term and x's bits past its two halves are
//   ~2^-16 of |b|*|x| per product: the 3-pass split XLA runs for HIGH.
// All three write float32.
//
// Replaces the TPU kernel enph459_super_resolution_tpu/ops/pallas_kernels.py
// `_row_kernel` (launched by `_banded_row_pallas`) and the reference's bf16
// row einsum: every row apply of the banded classical solve
// (ops/opmatrix.py BandedOp.row_apply).  Operands come from
// ops/banded_rows.py `pack_banded`, which stores each band block k-major,
// [n_blk][win][128], so a window chunk is one contiguous run.
//
// What bounds it.  At the flagship size (LR 1536x2048 -> HR 3072x4096) the
// forward row operator does 2*1536*293*4096 = 3.65 GFLOP over ~84 MB
// (read the 3072x4096 HR image with ~1.14x window overlap, write 1536x4096),
// ~43 FLOP/B.  On the float32 CUDA cores it is bound by operations, at
// SMs x 128 FMA/clk x 2 x SM clock (~67 TFLOP/s on an H100 SXM at 700 W):
// 0.055 ms.  With bf16 bands on the tensor cores (989 TFLOP/s) it is bound
// by bytes: 0.023 ms.  The split runs three bf16 products of the same work
// (0.011 ms of tensor-core time) over the same bytes: 0.023 ms, bytes.
//
// Design.  What the TPU kernel spent its code on (HBM-pinned operands,
// scalar-prefetched window starts, hand double-buffered DMA, 8-aligned
// starts and W % 256) has no counterpart here.  One CUDA block computes a
// 128-row x 128-column output tile of one band block b for one batch index
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
// * bfloat16: each of the 8 warps computes 64 rows x 32 columns with
//   mma.sync m16n8k16.  A comes from the k-major band chunk by
//   ldmatrix.trans (row stride 272 B: the 8 rows of one matrix fall in
//   distinct banks); B is read from the f32 x chunk (row stride 132 floats:
//   conflict-free) and rounded to bf16 pairs in registers.
// * split: as bfloat16, with a hi and a lo band chunk in each stage and x
//   split into hi and lo pairs; per m16 tile the A fragments of hi, then of
//   lo, each over the warp's four n8 tiles.
// The ragged edges are masked (columns >= W, window rows >= n_in, rows >=
// rows_b), so every shape runs on the kernel.  Compile without
// --use_fast_math.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;       // rows of a band block (banded_rows.py ROWS)
constexpr int BN = 128;       // output columns per CUDA block
constexpr int BK = 16;        // window rows per chunk (banded_rows.py K_CHUNK)
constexpr int STAGES = 4;     // depth of the cp.async ring
constexpr int THREADS = 256;
constexpr int XS = BN + 4;    // row stride of a staged x chunk, in floats
constexpr int MAX_GRID_Z = 65535;

// The split instantiation's tag: float32 bands stored as bf16 hi and lo.
struct Split {};

// Shared-memory layout of one stage for a band kind: PARTS band chunks
// [BK][AS] of Elem (k-major) and the x chunk [BK][XS] float32.
template <typename Kind>
struct Stage;
template <>
struct Stage<float> {
  using Elem = float;
  static constexpr int PARTS = 1;
  static constexpr int AS = BM;  // float4 reads of 8 rows: no padding needed
  static constexpr int MIN_BLOCKS = 1;
};
template <>
struct Stage<__nv_bfloat16> {
  using Elem = __nv_bfloat16;
  static constexpr int PARTS = 1;
  static constexpr int AS = BM + 8;  // 272-byte rows for ldmatrix.trans
  static constexpr int MIN_BLOCKS = 2;
};
template <>
struct Stage<Split> {
  using Elem = __nv_bfloat16;
  static constexpr int PARTS = 2;  // hi, then lo
  static constexpr int AS = BM + 8;
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
  return a_bytes<Kind>() + BK * XS * 4;
}

// Two floats split into bf16 pairs, `a` in the low halves: hi = bf16(v)
// and lo = bf16(v - hi), both nearest even (v - hi is exact in f32).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  using namespace mma_bf16;
  hi = pack_bf16x2(a, b);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(a - h.x, b - h.y);
}

struct Block {
  const float* xz;
  int start, w0, n_in, W;
};

// cp.async window chunk `kc` of the band (of both halves for the split) and
// of x into one ring stage.
template <typename Kind, bool kVec>
__device__ __forceinline__ void load_chunk(
    char* stage, const typename Stage<Kind>::Elem* __restrict__ band,
    const typename Stage<Kind>::Elem* __restrict__ band_lo, const Block& bl,
    int kc, int tid) {
  using namespace mma_bf16;
  using Elem = typename Stage<Kind>::Elem;
  constexpr int PER16 = 16 / static_cast<int>(sizeof(Elem));
  constexpr int PIECES = BK * BM / PER16;
  constexpr int AS = Stage<Kind>::AS;
#pragma unroll
  for (int p = 0; p < Stage<Kind>::PARTS; ++p) {
    const Elem* src =
        (p == 0 ? band : band_lo) + static_cast<size_t>(kc) * BK * BM;
    Elem* as = reinterpret_cast<Elem*>(stage + p * part_bytes<Kind>());
#pragma unroll
    for (int i = 0; i < PIECES / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / (BM / PER16);
      const int c = (e % (BM / PER16)) * PER16;
      cp_async16(as + k * AS + c, src + k * BM + c, 16);
    }
  }
  float* xs = reinterpret_cast<float*>(stage + a_bytes<Kind>());
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

// float32 bands: thread (ty, tx) owns rows ty*8 .. +7 and columns
// tx*4 .. +3 and 64 + tx*4 .. +3.
struct FmaTile {
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

// bfloat16 or split bands: warp (wm, wn) = (warp % 2, warp / 2) owns rows
// wm*64 .. +63 (4 m16 tiles) and columns wn*32 .. +31 (4 n8 tiles).
template <typename Kind>
struct MmaTile {
  static constexpr bool kSplit = Stage<Kind>::PARTS == 2;

  float acc[4][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  }

  __device__ __forceinline__ void step(const char* stage, int tid) {
    using namespace mma_bf16;
    constexpr int AS = Stage<Kind>::AS;
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(stage);
    const __nv_bfloat16* as_lo =
        reinterpret_cast<const __nv_bfloat16*>(stage + part_bytes<Kind>());
    const float* xs = reinterpret_cast<const float*>(stage + a_bytes<Kind>());
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp & 1;
    const int wn = warp >> 1;
    const int g = lane >> 2;
    const int q = lane & 3;
    // x as bf16 pairs along k: b0 = rows 2q, 2q+1; b1 = rows 2q+8, 2q+9
    // (split: hi pairs in b, lo pairs in bl)
    uint32_t b[4][2], bl[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* col = xs + wn * 32 + nt * 8 + g;
      if (kSplit) {
        split_bf16x2(col[(2 * q) * XS], col[(2 * q + 1) * XS], b[nt][0],
                     bl[nt][0]);
        split_bf16x2(col[(2 * q + 8) * XS], col[(2 * q + 9) * XS], b[nt][1],
                     bl[nt][1]);
      } else {
        b[nt][0] = pack_bf16x2(col[(2 * q) * XS], col[(2 * q + 1) * XS]);
        b[nt][1] = pack_bf16x2(col[(2 * q + 8) * XS], col[(2 * q + 9) * XS]);
      }
    }
    // lanes 8m..8m+7 address matrix m: k rows (m / 2) * 8 + lane % 8 at
    // band rows +(m % 2) * 8 of the m16 tile
    const int krow = (lane & 7) + (lane >> 4) * 8;
    const int rsub = ((lane >> 3) & 1) * 8;
    const int aoff = krow * AS + wm * 64 + rsub;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, as + aoff + mt * 16);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      if (kSplit) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], a, bl[nt][0], bl[nt][1]);
        ldmatrix_x4_trans(a, as_lo + aoff + mt * 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
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
        for (int nt = 0; nt < 4; ++nt) {
          const int c = w0 + (warp >> 1) * 32 + nt * 8 + 2 * q;
          if (kVec) {
            if (c < W)
              *reinterpret_cast<float2*>(orow + c) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          } else {
            if (c < W) orow[c] = acc[mt][nt][2 * h];
            if (c + 1 < W) orow[c + 1] = acc[mt][nt][2 * h + 1];
          }
        }
      }
  }
};

template <typename Kind>
struct TileOf {
  using type = MmaTile<Kind>;
};
template <>
struct TileOf<float> {
  using type = FmaTile;
};

template <typename Kind, bool kVec>
__global__ void __launch_bounds__(THREADS, Stage<Kind>::MIN_BLOCKS)
banded_rows_kernel(const typename Stage<Kind>::Elem* __restrict__ bands,
                   const typename Stage<Kind>::Elem* __restrict__ bands_lo,
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
                    static_cast<int>(blockIdx.y) * BN, n_in, W};
  using Elem = typename Stage<Kind>::Elem;
  const Elem* band = bands + static_cast<size_t>(b) * win * BM;
  const Elem* band_lo =
      Stage<Kind>::PARTS == 2 ? bands_lo + static_cast<size_t>(b) * win * BM
                              : nullptr;
  const int tid = threadIdx.x;
  const int nk = win / BK;

  typename TileOf<Kind>::type tile;
  tile.zero();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_chunk<Kind, kVec>(smem + s * stage_bytes<Kind>(), band, band_lo,
                             bl, s, tid);
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
                             band, band_lo, bl, next, tid);
    cp_async_commit();
    tile.step(smem + (kc % STAGES) * stage_bytes<Kind>(), tid);
  }
  tile.template store<kVec>(out + z * n_out * W, out_row0[b], rows[b], bl.w0,
                            W, tid);
}

template <typename Kind, bool kVec>
int launch_kind(const typename Stage<Kind>::Elem* bands,
                const typename Stage<Kind>::Elem* bands_lo, const int* starts,
                const int* out_row0, const int* rows, const float* x,
                float* out, int n_blk, int win, int n_in, int n_out, int W,
                int batch, cudaStream_t s) {
  constexpr int smem = STAGES * stage_bytes<Kind>();
  auto kernel = banded_rows_kernel<Kind, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = batch - z0 < MAX_GRID_Z ? batch - z0 : MAX_GRID_Z;
    const dim3 grid(n_blk, (W + BN - 1) / BN, nz);
    kernel<<<grid, THREADS, smem, s>>>(bands, bands_lo, starts, out_row0,
                                       rows, x, out, win, n_in, n_out, W, z0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename Kind>
int launch(const typename Stage<Kind>::Elem* bands,
           const typename Stage<Kind>::Elem* bands_lo, const int* starts,
           const int* out_row0, const int* rows, const float* x, float* out,
           int n_blk, int win, int n_in, int n_out, int W, int batch,
           void* stream) {
  if (n_blk <= 0 || win <= 0 || win % BK != 0 || n_in <= 0 || n_out <= 0 ||
      W <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(bands) & 15) != 0 ||
      (Stage<Kind>::PARTS == 2 &&
       (reinterpret_cast<uintptr_t>(bands_lo) & 15) != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies and stores need every row of x and out 16-byte aligned
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return vec ? launch_kind<Kind, true>(bands, bands_lo, starts, out_row0,
                                       rows, x, out, n_blk, win, n_in, n_out,
                                       W, batch, s)
             : launch_kind<Kind, false>(bands, bands_lo, starts, out_row0,
                                        rows, x, out, n_blk, win, n_in, n_out,
                                        W, batch, s);
}

}  // namespace

// Launch the kernel on `stream` for a [batch, n_in, W] input and a
// [batch, n_out, W] output (both contiguous float32); `starts`, `out_row0`
// and `rows` hold n_blk int32 each, `bands` n_blk x win x 128 (k-major,
// 16-byte aligned) float32 (banded_rows_launch) or bfloat16
// (banded_rows_bf16_launch), or two such bfloat16 arrays, the hi and lo
// halves of float32 bands (banded_rows_x3_launch).  Each returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int banded_rows_launch(const float* bands, const int* starts,
                                  const int* out_row0, const int* rows,
                                  const float* x, float* out, int n_blk,
                                  int win, int n_in, int n_out, int W,
                                  int batch, void* stream) {
  return launch<float>(bands, nullptr, starts, out_row0, rows, x, out, n_blk,
                       win, n_in, n_out, W, batch, stream);
}

extern "C" int banded_rows_bf16_launch(const __nv_bfloat16* bands,
                                       const int* starts, const int* out_row0,
                                       const int* rows, const float* x,
                                       float* out, int n_blk, int win,
                                       int n_in, int n_out, int W, int batch,
                                       void* stream) {
  return launch<__nv_bfloat16>(bands, nullptr, starts, out_row0, rows, x, out,
                               n_blk, win, n_in, n_out, W, batch, stream);
}

extern "C" int banded_rows_x3_launch(const __nv_bfloat16* bands_hi,
                                     const __nv_bfloat16* bands_lo,
                                     const int* starts, const int* out_row0,
                                     const int* rows, const float* x,
                                     float* out, int n_blk, int win, int n_in,
                                     int n_out, int W, int batch,
                                     void* stream) {
  return launch<Split>(bands_hi, bands_lo, starts, out_row0, rows, x, out,
                       n_blk, win, n_in, n_out, W, batch, stream);
}
