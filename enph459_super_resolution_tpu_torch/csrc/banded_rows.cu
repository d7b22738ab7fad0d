// Banded row apply on Hopper (sm_90a):
//
//   out[z, row0_b + r, w] = sum_k bands[b, r, k] * x[z, start_b + k, w]
//   for r < rows_b, k < win, start_b + k < n_in.
//
// Two instantiations of one template: float32 bands (strict f32, the
// default band store) and bfloat16 bands (the bf16 band store).  With bf16
// bands the kernel rounds x to bf16 (nearest even) as it stages it, as the
// reference's bf16 einsum does (opmatrix.py BandedOp.row_apply); a product
// of two bf16 values is exact in f32, so both instantiations accumulate with
// the same f32 FMA and write float32.
//
// Replaces the TPU kernel enph459_super_resolution_tpu/ops/pallas_kernels.py
// `_row_kernel` (launched by `_banded_row_pallas`) and the reference's bf16
// row einsum: every row apply of the banded classical solve
// (ops/opmatrix.py BandedOp.row_apply).  Operands come from
// ops/banded_rows.py `pack_banded`.
//
// What bounds it.  At the flagship size (LR 1536x2048 -> HR 3072x4096) the
// forward row operator does 2*1536*293*4096 = 3.65 GFLOP over ~84 MB
// (read the 3072x4096 HR image with ~1.14x window overlap, write 1536x4096),
// ~43 FLOP/B: on float32 CUDA cores (no tensor cores, no TF32 -- strict f32
// is the contract) it is bound by operations, at
// SMs x 128 FMA/clk x 2 x SM clock (~67 TFLOP/s on an H100 SXM at 700 W).
// The bf16 instantiation halves the band bytes only; it runs the same f32
// FMA, so it is bound by the same rate (bf16 tensor cores: a later PR).
//
// Design.  What the TPU kernel spent its code on (HBM-pinned operands,
// scalar-prefetched window starts, hand double-buffered DMA, 8-aligned
// starts and W % 256) has no counterpart here.  One CUDA block computes a
// 128-row x 128-column output tile of one band block b for one batch index
// z, reading its own window start, first output row and row count.  It
// walks the window in K-chunks of 16 rows: the band chunk (stored
// transposed) and the x chunk go through shared memory, and each of the 256
// threads accumulates an 8x8 register tile with fmaf.  The ragged edges are
// masked here (columns >= W, window rows >= n_in, rows >= rows_b), so every
// shape runs on the kernel.  Compile without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // rows of a band block (banded_rows.py ROWS)
constexpr int BN = 128;       // output columns per CUDA block
constexpr int BK = 16;        // window rows per chunk (banded_rows.py K_CHUNK)
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int APAD = 4;       // keeps the transposed band stores spread over banks
constexpr int MAX_GRID_Z = 65535;

__device__ __forceinline__ float band_value(float v) { return v; }
__device__ __forceinline__ float band_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x as the band type's product sees it: itself for f32 bands, rounded to
// bf16 for bf16 bands.
template <typename BandT>
__device__ __forceinline__ float stage_x(float v) {
  return v;
}
template <>
__device__ __forceinline__ float stage_x<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename BandT>
__global__ void __launch_bounds__(THREADS, 2)
banded_rows_kernel(const BandT* __restrict__ bands,
                   const int* __restrict__ starts,
                   const int* __restrict__ out_row0,
                   const int* __restrict__ rows,
                   const float* __restrict__ x, float* __restrict__ out,
                   int win, int n_in, int n_out, int W, int z0) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // band chunk, k-major
  __shared__ __align__(16) float Bs[BK][BN];         // x chunk

  const int b = blockIdx.x;
  const int w0 = blockIdx.y * BN;
  const size_t z = static_cast<size_t>(blockIdx.z) + z0;
  const int start = starts[b];
  const int row0 = out_row0[b];
  const int nrow = rows[b];
  const BandT* band = bands + static_cast<size_t>(b) * BM * win;
  const float* xz = x + z * n_in * W;
  float* oz = out + z * n_out * W;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // output rows ty*8 .. ty*8+7
  const int tx = tid % 16;  // output cols tx*4 .. +3 and 64+tx*4 .. +3

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < win; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int k = e % BK;
      As[k][r] = band_value(band[static_cast<size_t>(r) * win + k0 + k]);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / BN;
      const int c = e % BN;
      const int xr = start + k0 + k;
      const int xc = w0 + c;
      Bs[k][c] = (xr < n_in && xc < W)
                     ? stage_x<BandT>(xz[static_cast<size_t>(xr) * W + xc])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= nrow) break;
    float* orow = oz + static_cast<size_t>(row0 + r) * W;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = w0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < W) orow[c] = acc[i][j];
    }
  }
}

template <typename BandT>
int launch(const BandT* bands, const int* starts, const int* out_row0,
           const int* rows, const float* x, float* out, int n_blk, int win,
           int n_in, int n_out, int W, int batch, void* stream) {
  if (n_blk <= 0 || win <= 0 || win % BK != 0 || n_in <= 0 || n_out <= 0 ||
      W <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int z0 = 0; z0 < batch; z0 += MAX_GRID_Z) {
    const int nz = batch - z0 < MAX_GRID_Z ? batch - z0 : MAX_GRID_Z;
    const dim3 grid(n_blk, (W + BN - 1) / BN, nz);
    banded_rows_kernel<BandT><<<grid, THREADS, 0, s>>>(
        bands, starts, out_row0, rows, x, out, win, n_in, n_out, W, z0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// Launch the kernel on `stream` for a [batch, n_in, W] input and a
// [batch, n_out, W] output (both contiguous float32); `starts`, `out_row0`
// and `rows` hold n_blk int32 each, `bands` n_blk x 128 x win float32
// (banded_rows_launch) or bfloat16 (banded_rows_bf16_launch).  Each returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int banded_rows_launch(const float* bands, const int* starts,
                                  const int* out_row0, const int* rows,
                                  const float* x, float* out, int n_blk,
                                  int win, int n_in, int n_out, int W,
                                  int batch, void* stream) {
  return launch(bands, starts, out_row0, rows, x, out, n_blk, win, n_in,
                n_out, W, batch, stream);
}

extern "C" int banded_rows_bf16_launch(const __nv_bfloat16* bands,
                                       const int* starts, const int* out_row0,
                                       const int* rows, const float* x,
                                       float* out, int n_blk, int win,
                                       int n_in, int n_out, int W, int batch,
                                       void* stream) {
  return launch(bands, starts, out_row0, rows, x, out, n_blk, win, n_in,
                n_out, W, batch, stream);
}
