// One conv layer of the EDSR residual trunk on Hopper (sm_90a):
//
//   acc[b, y, x, o] = sum_{dy, dx, i} in[b, y+dy-1, x+dx-1, i] * w[3*dy+dx, i, o]
//   relu epilogue:  out = act(max(acc + bias[o], 0))
//   skip epilogue:  out = act(act(res_scale * (acc + bias[o])) + skip[b, y, x, o])
//
// with 64 input and 64 output channels, NHWC activations, and 'SAME' zero
// padding: pixels outside the image read as 0.  act() rounds to the
// activation type (identity for float32).  A residual block is two launches,
// relu then skip (skip = the block's input); a relu_only chain is relu
// launches only.  Two kernels, one per activation type:
//
// * float32: f32 FMA on the CUDA cores (no tensor cores, no TF32, no
//   --use_fast_math);
// * bfloat16 activations and weights: bf16 x bf16 products on the tensor
//   cores (mma.sync m16n8k16), exact in f32 and summed in f32, as the
//   reference's bf16 dot with preferred_element_type=float32.  Only the
//   order of the 576-term f32 sum differs from the plain version.
//
// Replaces the TPU kernel enph459_super_resolution_tpu/ops/pallas_trunk.py
// `_trunk_kernel` (launched by `_trunk_call` through
// `fused_resblocks_packed`), computing what it is meant to compute, the
// flax ResBlock chain of models/common.py.  Operands come from
// ops/trunk.py `pack_trunk`: per conv, w [9 taps][64 in][64 out] in the
// activation type and bias [64] float32.
//
// What bounds it.  One EDSR trunk conv at [8, 256, 256, 64] is
// 2*9*64*64*524288 = 38.7 GFLOP over 134 MB (bf16) or 268 MB (f32) of
// activations in and out (one more tensor with the skip).  On the f32 CUDA
// cores (SMs x 128 FMA/clk, ~67 TFLOP/s at 700 W) that is ~0.58 ms, bound
// by operations.  On the bf16 tensor cores (989 TFLOP/s dense) the
// operations take 0.039 ms and the bytes 0.040 ms (0.060 ms with the skip):
// the two bounds meet.
//
// Design, float32.  The TPU kernel keeps a band of a half-split,
// zero-bordered, flattened image in VMEM and masks each conv's output by
// position; none of that carries over.  One CUDA block computes a 16 x 16
// pixel x 64 channel output tile of one image.  It stages the input tile
// with its 1-pixel halo, all 64 channels, as f32 in shared memory (pixel
// stride 65, so the pixels a warp reads fall in distinct banks), loading
// zeros outside the image by integer index tests -- that is the 'SAME'
// padding, at every conv.  The nine 64 x 64 tap matrices stream through
// shared memory one at a time.  Each of the 256 threads accumulates 8 pixels
// of a row x 8 output channels in f32 registers.
//
// Design, bfloat16: an implicit GEMM per 16 x 16 pixel output tile, M = 256
// pixels, N = 64 output channels, K = 9 taps x 64 input channels = 576.
// * All nine 64 x 64 bf16 tap matrices (73,728 B) are loaded once per CTA
//   and stay in shared memory.
// * The grid is persistent, one CTA per SM (189,440 B of shared memory),
//   walking the tiles of every image in order.  While a tile computes, the
//   next tile's input and its 1-pixel halo (18 x 18 x 64 bf16, 41,472 B) are
//   copied into the other of two buffers with cp.async; pixels outside the
//   image are zero-filled by the copy itself (source size 0), by integer
//   tests.
// * Each of the 8 warps computes four output rows (4 x m16) x 32 channels
//   (4 x n8) with mma.sync m16n8k16 from ldmatrix fragments: A is the
//   staged pixels shifted by the tap (each lane addresses its own pixel row,
//   so the halo's 18-pixel row stride and the tap shift cost nothing), B the
//   tap matrix through ldmatrix.trans.  For each tap column dx and 16 input
//   channels the A fragments of the 6 staged rows are loaded once and serve
//   the column's three taps (dy shifts the row): 12 ldmatrix per 48 MMAs,
//   against 18 for a warp of 2 rows x 64 channels taken tap by tap.
//   Rows of 128 B (64 channels) are stored with their eight 16-byte chunks
//   XOR-swizzled by the row index, so the 8 rows an ldmatrix reads fall in
//   distinct banks.  wgmma was not taken: its shared-memory descriptors
//   need uniformly strided 8-row groups on swizzle-aligned bases, which the
//   tap-shifted 16-pixel rows of an 18-pixel-wide halo do not give.
// * Epilogue in f32 registers with the f32 kernel's rounding points
//   (__fadd_rn / __fmul_rn, then bf16 round to nearest even); each warp
//   writes its 64 pixels x 32 channels to a private, swizzled 4 KB slice of
//   shared memory, then stores them as 16-byte vectors.  The skip is read
//   in the same 16-byte pieces before the tile's products, so its latency
//   hides behind them.
// Ragged tile edges are masked at the store, so any H, W >= 1 and any batch
// run on either kernel.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int C = 64;          // features in and out (trunk.py FEATURES)
constexpr int TH = 16;         // output rows per tile (trunk.py TILE_H)
constexpr int TW = 16;         // output columns per tile (trunk.py TILE_W)
constexpr int HH = TH + 2;     // staged rows, with the halo
constexpr int HW = TW + 2;     // staged columns, with the halo
constexpr int THREADS = 256;

// ---- float32: f32 FMA on the CUDA cores --------------------------------

constexpr int PS = C + 1;      // pixel stride of the staged tile, in floats
constexpr int PX = 8;          // pixels of one row per thread
constexpr int CQ = 4;          // channels per quarter: 4*cg.. and 32+4*cg..
constexpr int MAX_GRID_Y = 65535;
constexpr int SMEM_BYTES =
    static_cast<int>(sizeof(float)) * (HH * HW * PS + C * C);  // 100,624

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kSkip>
__global__ void __launch_bounds__(THREADS, 2)
trunk_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ skip, float* __restrict__ out,
                  int H, int W, int tiles_w, float res_scale, int b0) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [HH * HW pixels][PS]
  float* ws = smem + HH * HW * PS;  // one tap: [C in][C out]

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (static_cast<size_t>(blockIdx.y) + b0) * H * W;

  // The input tile and its halo; outside the image, zeros.
  for (int e = tid; e < HH * HW * (C / 4); e += THREADS) {
    const int p = e / (C / 4);
    const int c = (e % (C / 4)) * 4;
    const int gy = y0 - 1 + p / HW;
    const int gx = x0 - 1 + p % HW;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      load4(x + (img + static_cast<size_t>(gy) * W + gx) * C + c, v);
    float* d = xs + p * PS + c;
    d[0] = v[0];
    d[1] = v[1];
    d[2] = v[2];
    d[3] = v[3];
  }

  const int cg = tid % 8;  // output channels 4*cg .. +3 and 32 + 4*cg .. +3
  const int pg = tid / 8;  // pixels: row pg / 2, columns (pg % 2) * 8 .. +7
  const int r = pg / 2;
  const int c0 = (pg % 2) * PX;

  float acc[PX][2 * CQ];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < 2 * CQ; ++k) acc[j][k] = 0.f;

  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the staging, or the last tap's reads of ws, are done
    const float* wt = w + static_cast<size_t>(t) * C * C;
    for (int e = tid * 4; e < C * C; e += THREADS * 4) {
      float v[4];
      load4(wt + e, v);
      store4(ws + e, v);
    }
    __syncthreads();
    const float* xp = xs + ((r + t / 3) * HW + c0 + t % 3) * PS;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      float a[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) a[j] = xp[j * PS + ci];
      const float4 w0 = *reinterpret_cast<const float4*>(ws + ci * C + 4 * cg);
      const float4 w1 =
          *reinterpret_cast<const float4*>(ws + ci * C + 32 + 4 * cg);
      const float wv[2 * CQ] = {w0.x, w0.y, w0.z, w0.w,
                                w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < 2 * CQ; ++k)
          acc[j][k] = fmaf(a[j], wv[k], acc[j][k]);
    }
  }

  const int oy = y0 + r;
  if (oy >= H) return;
  float bv[2 * CQ];
#pragma unroll
  for (int k = 0; k < 2 * CQ; ++k) bv[k] = bias[(k / CQ) * 32 + 4 * cg + k % CQ];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = x0 + c0 + j;
    if (ox >= W) break;
    const size_t o = (img + static_cast<size_t>(oy) * W + ox) * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = h * 32 + 4 * cg;
      float v[4];
#pragma unroll
      for (int k = 0; k < CQ; ++k) v[k] = __fadd_rn(acc[j][h * CQ + k], bv[h * CQ + k]);
      if (kSkip) {
        float s[4];
        load4(skip + o + co, s);
#pragma unroll
        for (int k = 0; k < CQ; ++k)
          v[k] = __fadd_rn(__fmul_rn(v[k], res_scale), s[k]);
      } else {
#pragma unroll
        for (int k = 0; k < CQ; ++k) v[k] = fmaxf(v[k], 0.f);
      }
      store4(out + o + co, v);
    }
  }
}

template <bool kSkip>
int launch_f32(const float* x, const float* w, const float* bias,
               const float* skip, float* out, int batch, int H, int W,
               float res_scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      trunk_conv_kernel<kSkip>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles =
      static_cast<long long>(tiles_w) * ((H + TH - 1) / TH);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (int b0 = 0; b0 < batch; b0 += MAX_GRID_Y) {
    const int nb = batch - b0 < MAX_GRID_Y ? batch - b0 : MAX_GRID_Y;
    const dim3 grid(static_cast<unsigned int>(tiles), nb);
    trunk_conv_kernel<kSkip><<<grid, THREADS, SMEM_BYTES, s>>>(
        x, w, bias, skip, out, H, W, tiles_w, res_scale, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// ---- bfloat16: mma.sync on the tensor cores ----------------------------

constexpr int ROW_BYTES = C * 2;                // 64 bf16: a pixel or a tap row
constexpr int W_BYTES = 9 * C * ROW_BYTES;      // 73,728: the nine tap matrices
constexpr int HALO_BYTES = HH * HW * ROW_BYTES; // 41,472: one staged input tile
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ROWS = 4;                    // output rows per warp
constexpr int WARP_CH = C / 2;                  // output channels per warp
constexpr int NT = WARP_CH / 8;                 // n8 tiles per warp
static_assert(WARPS == (TH / WARP_ROWS) * (C / WARP_CH), "warp layout");
constexpr int OUT_BYTES = WARP_ROWS * TW * WARP_CH * 2;  // 4,096 per warp
constexpr int MMA_SMEM_BYTES = W_BYTES + 2 * HALO_BYTES + WARPS * OUT_BYTES;

// Byte offset of 16-byte chunk `c` (channels 8c..8c+7) of 128-byte row `r`:
// the chunk index is XORed with r % 8, so the 8 consecutive rows one
// ldmatrix reads hit distinct banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// Two bf16 pairs added in f32 and rounded back to bf16 (nearest even).
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = mma_bf16::unpack_bf16x2(a);
  const float2 fb = mma_bf16::unpack_bf16x2(b);
  return mma_bf16::pack_bf16x2(__fadd_rn(fa.x, fb.x), __fadd_rn(fa.y, fb.y));
}

// Byte offset of 16-byte chunk `c` (of 4) of pixel `px` in a warp's output
// slice (64-byte rows): the chunk is XORed with (px / 2) % 4, so the 8
// pixels one store instruction writes hit distinct banks.
__device__ __forceinline__ int out_swz(int px, int c) {
  return px * WARP_CH * 2 + ((c ^ ((px >> 1) & 3)) << 4);
}

struct Tile {
  size_t img;  // first pixel of the image
  int y0, x0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_w, int tiles_img,
                                        int H, int W) {
  const int b = t / tiles_img;
  const int r = t % tiles_img;
  return {static_cast<size_t>(b) * H * W, (r / tiles_w) * TH,
          (r % tiles_w) * TW};
}

// cp.async the tile's input with its halo into `dst`: one 16-byte chunk per
// thread per step, 8 threads per pixel; zeros outside the image.
__device__ __forceinline__ void stage_halo(char* dst,
                                           const __nv_bfloat16* __restrict__ x,
                                           const Tile& tl, int H, int W,
                                           int tid) {
  for (int e = tid; e < HH * HW * 8; e += THREADS) {
    const int p = e >> 3;
    const int c = e & 7;
    const int gy = tl.y0 - 1 + p / HW;
    const int gx = tl.x0 - 1 + p % HW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src =
        in ? x + (tl.img + static_cast<size_t>(gy) * W + gx) * C + c * 8 : x;
    mma_bf16::cp_async16(dst + swz(p, c), src, in ? 16 : 0);
  }
}

template <bool kSkip>
__global__ void __launch_bounds__(THREADS, 1)
trunk_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ skip,
                      __nv_bfloat16* __restrict__ out, int H, int W,
                      int tiles_w, int tiles_img, int n_tiles,
                      float res_scale) {
  using namespace mma_bf16;
  extern __shared__ __align__(128) char mma_smem[];
  char* ws = mma_smem;                     // [9 * 64 rows][128 B]
  char* halo = mma_smem + W_BYTES;         // 2 x [18 * 18 pixels][128 B]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this warp's output slice: [64 pixels][64 B]
  char* os = mma_smem + W_BYTES + 2 * HALO_BYTES + warp * OUT_BYTES;

  // The weights, once; then the first tile's input.
  for (int e = tid; e < 9 * C * 8; e += THREADS)
    cp_async16(ws + swz(e >> 3, e & 7), w + e * 8, 16);
  int t = blockIdx.x;
  if (t < n_tiles)
    stage_halo(halo, x, tile_of(t, tiles_w, tiles_img, H, W), H, W, tid);
  cp_async_commit();

  // This lane's accumulator columns: channels wc*32 + nt*8 + 2*(lane%4)
  // + {0, 1}; this warp's rows: wr*4 .. wr*4 + 3 of the tile.
  const int wr = warp >> 1;
  const int wc = warp & 1;
  const int g = lane >> 2;
  const int q = lane & 3;
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bv[nt][0] = bias[wc * WARP_CH + nt * 8 + 2 * q];
    bv[nt][1] = bias[wc * WARP_CH + nt * 8 + 2 * q + 1];
  }
  // ldmatrix row addressing: lanes 8m..8m+7 give the rows of matrix m.
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: pixel; B: k row
  const int lchunk = lane >> 4;                          // +0 / +1 chunk

  for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
    const Tile tl = tile_of(t, tiles_w, tiles_img, H, W);
    cp_async_wait<0>();
    // This tile's input has landed for every thread, and every warp is done
    // with the other buffer (the last tile's), which is staged next.
    __syncthreads();
    const char* hs = halo + (it & 1) * HALO_BYTES;
    if (t + static_cast<int>(gridDim.x) < n_tiles)
      stage_halo(halo + ((it + 1) & 1) * HALO_BYTES, x,
                 tile_of(t + gridDim.x, tiles_w, tiles_img, H, W), H, W, tid);
    cp_async_commit();

    // Output chunk k of this lane (see the store below): pixel px of the
    // warp's 4 x 16, 16-byte chunk c of its 32 channels.
    constexpr int CHUNKS = WARP_ROWS * TW * (WARP_CH / 8) / 32;  // 8
    // The skip of those chunks, loaded now so that its latency hides
    // behind the products.
    uint4 sk[CHUNKS];
    if (kSkip) {
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int e = k * 32 + lane;
        const int oy = tl.y0 + wr * WARP_ROWS + (e >> 2) / TW;
        const int ox = tl.x0 + (e >> 2) % TW;
        sk[k] = make_uint4(0u, 0u, 0u, 0u);
        if (oy < H && ox < W)
          sk[k] = *reinterpret_cast<const uint4*>(
              skip + (tl.img + static_cast<size_t>(oy) * W + ox) * C +
              wc * WARP_CH + (e & 3) * 8);
      }
    }

    float acc[WARP_ROWS][NT][4];
#pragma unroll
    for (int mi = 0; mi < WARP_ROWS; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nt][k] = 0.f;

    // Per tap column dx and 16 input channels: the A fragments of the 6
    // staged rows the warp's 4 output rows read (row mi + dy for tap
    // (dy, dx)), then the three taps' B fragments.
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t a[WARP_ROWS + 2][4];
#pragma unroll
        for (int hr = 0; hr < WARP_ROWS + 2; ++hr)
          ldmatrix_x4(a[hr], hs + swz((wr * WARP_ROWS + hr) * HW + lrow + dx,
                                      kc * 2 + lchunk));
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const char* wt = ws + (dy * 3 + dx) * C * ROW_BYTES;
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];  // b0, b1 of n-tile 2np, then of n-tile 2np + 1
            ldmatrix_x4_trans(
                b, wt + swz(kc * 16 + lrow, wc * NT + np * 2 + lchunk));
#pragma unroll
            for (int mi = 0; mi < WARP_ROWS; ++mi) {
              mma_16816(acc[mi][2 * np], a[mi + dy], b[0], b[1]);
              mma_16816(acc[mi][2 * np + 1], a[mi + dy], b[2], b[3]);
            }
          }
        }
      }
    }

    // Epilogue: bias and relu, or bias, res_scale and its rounding, in f32;
    // bf16 into this warp's slice of shared memory, pixel-major.
#pragma unroll
    for (int mi = 0; mi < WARP_ROWS; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = mi * TW + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float v0 = __fadd_rn(acc[mi][nt][2 * h], bv[nt][0]);
          float v1 = __fadd_rn(acc[mi][nt][2 * h + 1], bv[nt][1]);
          if (kSkip) {
            v0 = __fmul_rn(v0, res_scale);
            v1 = __fmul_rn(v1, res_scale);
          } else {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<uint32_t*>(os + out_swz(px, nt) + 4 * q) =
              pack_bf16x2(v0, v1);
        }
      }
    __syncwarp();
    // Then 16 bytes (8 channels) per lane and step, 4 lanes per pixel.
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int e = k * 32 + lane;
      const int px = e >> 2;
      const int c = e & 3;
      const int oy = tl.y0 + wr * WARP_ROWS + px / TW;
      const int ox = tl.x0 + px % TW;
      if (oy < H && ox < W) {
        const size_t o = (tl.img + static_cast<size_t>(oy) * W + ox) * C +
                         wc * WARP_CH + c * 8;
        uint4 v = *reinterpret_cast<const uint4*>(os + out_swz(px, c));
        if (kSkip) {
          v.x = add_bf16x2(v.x, sk[k].x);
          v.y = add_bf16x2(v.y, sk[k].y);
          v.z = add_bf16x2(v.z, sk[k].z);
          v.w = add_bf16x2(v.w, sk[k].w);
        }
        *reinterpret_cast<uint4*>(out + o) = v;
      }
    }
    __syncwarp();  // the slice is rewritten by the next tile
  }
}

template <bool kSkip>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const float* bias, const __nv_bfloat16* skip,
                __nv_bfloat16* out, int batch, int H, int W, float res_scale,
                cudaStream_t s) {
  auto kernel = trunk_conv_mma_kernel<kSkip>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_w = (W + TW - 1) / TW;
  const long long tiles_img = tiles_w * ((H + TH - 1) / TH);
  const long long n_tiles = tiles_img * batch;
  if (n_tiles > INT_MAX / 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, MMA_SMEM_BYTES)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(n_tiles < resident ? n_tiles : resident);
  kernel<<<grid, THREADS, MMA_SMEM_BYTES, s>>>(
      x, w, bias, skip, out, H, W, static_cast<int>(tiles_w),
      static_cast<int>(tiles_img), static_cast<int>(n_tiles), res_scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_args(int batch, int H, int W, int skip_mode, const void* skip) {
  return batch <= 0 || H <= 0 || W <= 0 || (skip_mode != 0 && skip_mode != 1) ||
         (skip_mode == 1 && skip == nullptr);
}

}  // namespace

// Launch one trunk conv on `stream`: x, skip and out are contiguous
// [batch, H, W, 64] (float32 for trunk_conv_launch, bfloat16 for
// trunk_conv_bf16_launch), w is [9, 64, 64] of the same type, bias [64]
// float32; the bfloat16 kernel takes 16-byte aligned x, w, skip and out.
// skip_mode 0 is the relu epilogue (skip unused, may be null), 1 the
// residual one.  Each returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int trunk_conv_launch(const float* x, const float* w,
                                 const float* bias, const float* skip,
                                 float* out, int batch, int H, int W,
                                 int skip_mode, float res_scale,
                                 void* stream) {
  if (bad_args(batch, H, W, skip_mode, skip))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return skip_mode
             ? launch_f32<true>(x, w, bias, skip, out, batch, H, W,
                                res_scale, s)
             : launch_f32<false>(x, w, bias, skip, out, batch, H, W,
                                 res_scale, s);
}

extern "C" int trunk_conv_bf16_launch(const __nv_bfloat16* x,
                                      const __nv_bfloat16* w,
                                      const float* bias,
                                      const __nv_bfloat16* skip,
                                      __nv_bfloat16* out, int batch, int H,
                                      int W, int skip_mode, float res_scale,
                                      void* stream) {
  if (bad_args(batch, H, W, skip_mode, skip))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(w) || !aligned16(out) ||
      (skip_mode == 1 && !aligned16(skip)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return skip_mode
             ? launch_bf16<true>(x, w, bias, skip, out, batch, H, W, res_scale,
                                 s)
             : launch_bf16<false>(x, w, bias, skip, out, batch, H, W,
                                  res_scale, s);
}
