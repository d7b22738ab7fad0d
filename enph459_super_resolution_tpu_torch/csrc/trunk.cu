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
// launches only.  Two instantiations: float32 (f32 FMA only: no tensor
// cores, no TF32, and no --use_fast_math), and bfloat16 activations and
// weights, whose products are exact in f32 and summed with the same f32 FMA,
// as the reference's bf16 dot with preferred_element_type=float32.
//
// Replaces the TPU kernel enph459_super_resolution_tpu/ops/pallas_trunk.py
// `_trunk_kernel` (launched by `_trunk_call` through
// `fused_resblocks_packed`), computing what it is meant to compute, the
// flax ResBlock chain of models/common.py.  Operands come from
// ops/trunk.py `pack_trunk`: per conv, w [9 taps][64 in][64 out] in the
// activation type and bias [64] float32.
//
// What bounds it.  One EDSR trunk conv at [8, 256, 256, 64] is
// 2*9*64*64*524288 = 38.7 GFLOP over 67 MB (bf16) or 134 MB (f32) of
// activations in and out: ~290-580 FLOP/B, bound by operations on either
// route.  On the f32 CUDA cores (SMs x 128 FMA/clk, ~67 TFLOP/s at 700 W)
// that is ~0.58 ms; the bf16 tensor cores would take ~0.04 ms.  This first
// kernel runs f32 FMA for both types; wgmma and TMA are a later PR's work.
//
// Design.  The TPU kernel keeps a band of a half-split, zero-bordered,
// flattened image in VMEM and masks each conv's output by position; none of
// that carries over.  Here one CUDA block computes a 16 x 16 pixel x 64
// channel output tile of one image.  It stages the input tile with its
// 1-pixel halo, all 64 channels, as f32 in shared memory (pixel stride 65,
// so the pixels a warp reads fall in distinct banks), loading zeros outside
// the image by integer index tests -- that is the 'SAME' padding, at every
// conv.  The nine 64 x 64 tap matrices stream through shared memory one at
// a time.  Each of the 256 threads accumulates 8 pixels of a row x 8 output
// channels in f32 registers.  Ragged tile edges are masked, so any H, W >= 1
// and any batch run on the kernel.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;          // features in and out (trunk.py FEATURES)
constexpr int TH = 16;         // output rows per CUDA block (trunk.py TILE_H)
constexpr int TW = 16;         // output columns per CUDA block (trunk.py TILE_W)
constexpr int HH = TH + 2;     // staged rows, with the halo
constexpr int HW = TW + 2;     // staged columns, with the halo
constexpr int PS = C + 1;      // pixel stride of the staged tile, in floats
constexpr int THREADS = 256;   // 32 pixel groups x 8 channel groups
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

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rounds each value to bf16, nearest even
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned int*>(&a);
  q.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// a value as the activation type stores it
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kSkip>
__global__ void __launch_bounds__(THREADS, 2)
trunk_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ skip,
                  T* __restrict__ out, int H, int W, int tiles_w,
                  float res_scale, int b0) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [HH * HW pixels][PS]
  float* ws = smem + HH * HW * PS;  // one tap: [C in][C out]

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const size_t img = (static_cast<size_t>(blockIdx.y) + b0) * H * W;

  // The input tile and its halo, as f32; outside the image, zeros.
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
    const T* wt = w + static_cast<size_t>(t) * C * C;
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
          v[k] = __fadd_rn(round_to<T>(__fmul_rn(v[k], res_scale)), s[k]);
      } else {
#pragma unroll
        for (int k = 0; k < CQ; ++k) v[k] = fmaxf(v[k], 0.f);
      }
      store4(out + o + co, v);
    }
  }
}

template <typename T, bool kSkip>
int launch_mode(const T* x, const T* w, const float* bias, const T* skip,
                T* out, int batch, int H, int W, float res_scale,
                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      trunk_conv_kernel<T, kSkip>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles =
      static_cast<long long>(tiles_w) * ((H + TH - 1) / TH);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (int b0 = 0; b0 < batch; b0 += MAX_GRID_Y) {
    const int nb = batch - b0 < MAX_GRID_Y ? batch - b0 : MAX_GRID_Y;
    const dim3 grid(static_cast<unsigned int>(tiles), nb);
    trunk_conv_kernel<T, kSkip><<<grid, THREADS, SMEM_BYTES, s>>>(
        x, w, bias, skip, out, H, W, tiles_w, res_scale, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int launch(const T* x, const T* w, const float* bias, const T* skip, T* out,
           int batch, int H, int W, int skip_mode, float res_scale,
           void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || (skip_mode != 0 && skip_mode != 1) ||
      (skip_mode == 1 && skip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return skip_mode ? launch_mode<T, true>(x, w, bias, skip, out, batch, H, W,
                                          res_scale, s)
                   : launch_mode<T, false>(x, w, bias, skip, out, batch, H, W,
                                           res_scale, s);
}

}  // namespace

// Launch one trunk conv on `stream`: x, skip and out are contiguous
// [batch, H, W, 64] (float32 for trunk_conv_launch, bfloat16 for
// trunk_conv_bf16_launch), w is [9, 64, 64] of the same type, bias [64]
// float32.  skip_mode 0 is the relu epilogue (skip unused, may be null),
// 1 the residual one.  Each returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int trunk_conv_launch(const float* x, const float* w,
                                 const float* bias, const float* skip,
                                 float* out, int batch, int H, int W,
                                 int skip_mode, float res_scale,
                                 void* stream) {
  return launch(x, w, bias, skip, out, batch, H, W, skip_mode, res_scale,
                stream);
}

extern "C" int trunk_conv_bf16_launch(const __nv_bfloat16* x,
                                      const __nv_bfloat16* w,
                                      const float* bias,
                                      const __nv_bfloat16* skip,
                                      __nv_bfloat16* out, int batch, int H,
                                      int W, int skip_mode, float res_scale,
                                      void* stream) {
  return launch(x, w, bias, skip, out, batch, H, W, skip_mode, res_scale,
                stream);
}
