// Fused whole-iteration IBP on Hopper (sm_90a): the forward error (K2) and
// the back-projection update (K3) of every frame, each in one launch.
//
//   K2  err[f] = lr[f] - sum_{(f,u,c)} (bandr[u] @ hr) @ bandc[c]^T
//   K3  hr'    = clip(hr + scale * sum_{(f,u,c)} (bandr[u] @ err[f]) @ bandc[c]^T)
//
// Replace the TPU kernels enph459_super_resolution_tpu/ops/pallas_fused_ibp.py
// `_fwd_body` (K2, launched by `_fwd_call`) and `_bwd_body` (K3, launched by
// `_bwd_call`).  Operands come from ops/fused_ibp.py: row operators packed
// as bandr [nb, n_u, blk_r, win_r] with one window start per row block (sr),
// column operators transposed as bandc [nt, n_c, win_c, tile_c] with one
// window start per column tile (sc), deduplicated by content, plus a plan
// that lists for each row product (input image, row operator) the column
// operators and outputs that consume it.
//
// Two band types, one template: float32 bands run strict f32 (CUDA-core
// FMA only: no tensor cores, no TF32, no --use_fast_math).  bfloat16 bands
// run the reference's bf16 dots: the input window is rounded to bf16, each
// row product ys is rounded to bf16 before its column product, and the
// exact bf16 x bf16 products are summed with f32 FMA; lr and err are bf16
// then, hr and the update stay f32.
//
// What bounds it.  At LR 1536x2048 -> HR 3072x4096 with 5 frames and 3
// unique row operators, K2's dense-window work is ~2 * 7.3 G FMA and K3's
// ~2 * 6.3 G: at f32 that is bound by the CUDA cores (SMs x 128 FMA/clk,
// ~67 TFLOP/s at 700 W), not by the ~0.2 GB each launch must move.  With
// bf16 bands the bound is the bytes (the bf16 tensor cores would do the
// work in microseconds); this first kernel still runs f32 FMA on the bf16
// values, which is exact but leaves the tensor cores idle (a later PR).
//
// Design.  The TPU grid walks (column tile, row block) in order and keeps a
// 304 x 768 f32 HR window (934 KB) in VMEM, double-buffered by hand; that
// fits no SM.  Here every CUDA block is independent and owns a 64 x 64
// output tile (BM x TN) of one row block and one column tile.  It keeps the
// row operator's block (64 x win_r, as f32) in shared memory and streams the
// input window through shared memory in chunks of KC intermediate columns.
// For each chunk it forms the row product ys (64 x KC) once per (input,
// row operator) -- the deduplication the TPU kernel does per grid step --
// and at once adds ys @ bandc[chunk] into the register tile of every output
// that uses it.  Neither ys nor the LR-space intermediate reaches device
// memory.  K2 keeps one 4x4 register tile per thread for each frame
// (NOUT = frames, a template argument); K3 one, with the update and the
// clip in its epilogue.  Blocks and tiles of any multiple of 64 (the
// port's 64/64 pack, the TPU's 128/256 pack) map onto the same grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output rows per CUDA block (fused_ibp.py ROWS)
constexpr int TN = 64;        // output columns per CUDA block (fused_ibp.py COLS)
constexpr int KC = 32;        // intermediate columns per chunk
constexpr int BMP = BM + 4;   // padded row stride of the k-major tiles
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MAX_OUT = 8;    // frames of one K2 launch (fused_ibp.py MAX_FRAMES)
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// An operand as the band type's product sees it: itself with f32 bands,
// rounded to bf16 (nearest even) with bf16 bands.
template <typename BandT>
__device__ __forceinline__ float as_operand(float v) {
  return v;
}
template <>
__device__ __forceinline__ float as_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename BandT>
struct Ops {
  const BandT* bandr;  // [nb, n_u, blk_r, win_r]
  const int* sr;       // [nb] first input row of each row block's window
  const BandT* bandc;  // [nt, n_c, win_c, tile_c]
  const int* sc;       // [nt] first input column of each tile's window
  int n_u, blk_r, win_r, n_c, win_c, tile_c;
  const int* groups;   // [n_groups, 4]: input, row op, first consumer, end
  const int* cons;     // [n_cons, 2]: column op, output
  int n_groups;
  int src_rows, src_cols;  // one input image
};

size_t smem_bytes(int win_r) {
  return sizeof(float) *
         (static_cast<size_t>(win_r) * BMP + static_cast<size_t>(win_r) * KC +
          KC * BMP + KC * TN);
}

// Accumulates into acc[o] (rows zr..zr+3, columns zc..zc+3 of this block's
// tile, zr = (tid / 16) * 4, zc = (tid % 16) * 4) every term of the plan.
template <typename BandT, typename SrcT, int NOUT>
__device__ __forceinline__ void mainloop(float (&acc)[NOUT][4][4],
                                         const Ops<BandT>& p,
                                         const SrcT* __restrict__ src, int b,
                                         int r_off, int j, int c_off) {
  extern __shared__ __align__(16) float smem[];
  float* br_s = smem;                      // [win_r][BMP] row op, k-major
  float* xs_s = br_s + p.win_r * BMP;      // [win_r][KC] input chunk
  float* ys_s = xs_s + p.win_r * KC;       // [KC][BMP] row product, k-major
  float* bc_s = ys_s + KC * BMP;           // [KC][TN] column op chunk

  const int tid = threadIdx.x;
  const int yr = (tid % 16) * 4;  // row product: rows yr..yr+3
  const int yc = (tid / 16) * 2;  //              columns yc, yc+1
  const int zr = (tid / 16) * 4;
  const int zc = (tid % 16) * 4;
  const int row0 = p.sr[b];
  const int col0 = p.sc[j];
  const size_t plane = static_cast<size_t>(p.src_rows) * p.src_cols;

  for (int g = 0; g < p.n_groups; ++g) {
    const int in = p.groups[4 * g];
    const int u = p.groups[4 * g + 1];
    const int q0 = p.groups[4 * g + 2];
    const int q1 = p.groups[4 * g + 3];
    const BandT* br = p.bandr +
        ((static_cast<size_t>(b) * p.n_u + u) * p.blk_r + r_off) * p.win_r;
    const SrcT* x = src + in * plane;

    __syncthreads();  // the previous group's readers of br_s are done
    for (int e = tid; e < BM * p.win_r; e += THREADS) {
      const int r = e / p.win_r;
      const int k = e % p.win_r;
      br_s[k * BMP + r] = to_f32(br[static_cast<size_t>(r) * p.win_r + k]);
    }

    for (int kc = 0; kc < p.win_c; kc += KC) {
      for (int e = tid; e < p.win_r * KC; e += THREADS) {
        const int k = e / KC;
        const int cc = e % KC;
        const int xr = row0 + k;
        const int xc = col0 + kc + cc;
        xs_s[e] = (xr < p.src_rows && xc < p.src_cols && kc + cc < p.win_c)
                      ? as_operand<BandT>(
                            to_f32(x[static_cast<size_t>(xr) * p.src_cols + xc]))
                      : 0.f;
      }
      __syncthreads();  // br_s and xs_s ready

      float y[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i][0] = y[i][1] = 0.f;
      for (int k = 0; k < p.win_r; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&br_s[k * BMP + yr]);
        const float2 v = *reinterpret_cast<const float2*>(&xs_s[k * KC + yc]);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          y[i][0] = fmaf(av[i], v.x, y[i][0]);
          y[i][1] = fmaf(av[i], v.y, y[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          ys_s[(yc + c) * BMP + yr + i] = as_operand<BandT>(y[i][c]);
      __syncthreads();  // ys_s ready; xs_s free

      for (int q = q0; q < q1; ++q) {
        const int cop = p.cons[2 * q];
        const int o = p.cons[2 * q + 1];
        const BandT* bc = p.bandc +
            ((static_cast<size_t>(j) * p.n_c + cop) * p.win_c + kc) * p.tile_c +
            c_off;
        for (int e = tid; e < KC * TN; e += THREADS) {
          const int cc = e / TN;
          const int n = e % TN;
          bc_s[e] = kc + cc < p.win_c
                        ? to_f32(bc[static_cast<size_t>(cc) * p.tile_c + n])
                        : 0.f;
        }
        __syncthreads();  // bc_s ready
#pragma unroll
        for (int oo = 0; oo < NOUT; ++oo) {
          if (oo != o) continue;
#pragma unroll 8
          for (int cc = 0; cc < KC; ++cc) {
            const float4 a =
                *reinterpret_cast<const float4*>(&ys_s[cc * BMP + zr]);
            const float4 v =
                *reinterpret_cast<const float4*>(&bc_s[cc * TN + zc]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[oo][i][c] = fmaf(av[i], vv[c], acc[oo][i][c]);
          }
        }
        __syncthreads();  // bc_s (and, after the last, ys_s) free
      }
    }
  }
}

// Which row block, row offset, column tile and column offset this CUDA
// block owns.
struct Tile {
  int b, r_off, j, c_off;
};

__device__ __forceinline__ Tile tile_of(int blk_r, int tile_c) {
  const int per_tile = tile_c / TN;
  const int per_blk = blk_r / BM;
  return {static_cast<int>(blockIdx.y) / per_blk,
          (static_cast<int>(blockIdx.y) % per_blk) * BM,
          static_cast<int>(blockIdx.x) / per_tile,
          (static_cast<int>(blockIdx.x) % per_tile) * TN};
}

template <typename BandT, int NOUT>
__global__ void __launch_bounds__(THREADS)
fused_fwd_kernel(Ops<BandT> p, const float* __restrict__ hr,
                 const BandT* __restrict__ lr, BandT* __restrict__ err, int h,
                 int w) {
  const Tile t = tile_of(p.blk_r, p.tile_c);
  float acc[NOUT][4][4];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[o][i][c] = 0.f;
  mainloop<BandT, float, NOUT>(acc, p, hr, t.b, t.r_off, t.j, t.c_off);

  const int tid = threadIdx.x;
  const int row = t.b * p.blk_r + t.r_off + (tid / 16) * 4;
  const int col = t.j * p.tile_c + t.c_off + (tid % 16) * 4;
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (row + i >= h || col + c >= w) continue;
        const size_t at = (static_cast<size_t>(o) * h + row + i) * w + col + c;
        err[at] = from_f32<BandT>(to_f32(lr[at]) - acc[o][i][c]);
      }
}

template <typename BandT>
__global__ void __launch_bounds__(THREADS)
fused_bwd_kernel(Ops<BandT> p, const BandT* __restrict__ err,
                 const float* __restrict__ hr, float* __restrict__ out, int H,
                 int W, float scale, float lo, float hi) {
  const Tile t = tile_of(p.blk_r, p.tile_c);
  float acc[1][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[0][i][c] = 0.f;
  mainloop<BandT, BandT, 1>(acc, p, err, t.b, t.r_off, t.j, t.c_off);

  const int tid = threadIdx.x;
  const int row = t.b * p.blk_r + t.r_off + (tid / 16) * 4;
  const int col = t.j * p.tile_c + t.c_off + (tid % 16) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (row + i >= H || col + c >= W) continue;
      const size_t at = static_cast<size_t>(row + i) * W + col + c;
      // hr + scale * z, rounded after each step as the plain version does
      const float v = __fadd_rn(hr[at], __fmul_rn(scale, acc[0][i][c]));
      out[at] = fminf(fmaxf(v, lo), hi);
    }
}

template <typename BandT>
int check(const Ops<BandT>& p, int nb, int nt, dim3* grid, size_t* smem) {
  if (nb <= 0 || nt <= 0 || p.n_u <= 0 || p.n_c <= 0 || p.win_r <= 0 ||
      p.win_c <= 0 || p.blk_r <= 0 || p.tile_c <= 0 || p.blk_r % BM != 0 ||
      p.tile_c % TN != 0 || p.n_groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(p.win_r);
  if (*smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(nt * (p.tile_c / TN), nb * (p.blk_r / BM), 1);
  if (grid->y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename BandT, int NOUT>
int launch_fwd(const Ops<BandT>& p, dim3 grid, size_t smem, cudaStream_t s,
               const float* hr, const void* lr, void* err, int h, int w) {
  auto kernel = fused_fwd_kernel<BandT, NOUT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, s>>>(p, hr, static_cast<const BandT*>(lr),
                                     static_cast<BandT*>(err), h, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename BandT>
int fwd(const Ops<BandT>& p, int nb, int nt, const float* hr, const void* lr,
        void* err, int n_frames, int h, int w, void* stream) {
  dim3 grid;
  size_t smem;
  const int rc = check(p, nb, nt, &grid, &smem);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_frames) {
    case 1: return launch_fwd<BandT, 1>(p, grid, smem, s, hr, lr, err, h, w);
    case 2: return launch_fwd<BandT, 2>(p, grid, smem, s, hr, lr, err, h, w);
    case 3: return launch_fwd<BandT, 3>(p, grid, smem, s, hr, lr, err, h, w);
    case 4: return launch_fwd<BandT, 4>(p, grid, smem, s, hr, lr, err, h, w);
    case 5: return launch_fwd<BandT, 5>(p, grid, smem, s, hr, lr, err, h, w);
    case 6: return launch_fwd<BandT, 6>(p, grid, smem, s, hr, lr, err, h, w);
    case 7: return launch_fwd<BandT, 7>(p, grid, smem, s, hr, lr, err, h, w);
    case MAX_OUT:
      return launch_fwd<BandT, MAX_OUT>(p, grid, smem, s, hr, lr, err, h, w);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename BandT>
int bwd(const Ops<BandT>& p, int nb, int nt, const void* err,
        const float* hr, float* out, int H, int W, float scale, float lo,
        float hi, void* stream) {
  dim3 grid;
  size_t smem;
  const int rc = check(p, nb, nt, &grid, &smem);
  if (rc != 0) return rc;
  auto kernel = fused_bwd_kernel<BandT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const BandT*>(err), hr, out, H, W, scale, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <typename BandT>
Ops<BandT> ops(const void* bandr, const int* sr, int n_u, int blk_r,
               int win_r, const void* bandc, const int* sc, int n_c,
               int win_c, int tile_c, const int* groups, int n_groups,
               const int* cons, int src_rows, int src_cols) {
  return {static_cast<const BandT*>(bandr), sr, static_cast<const BandT*>(bandc),
          sc, n_u, blk_r, win_r, n_c, win_c, tile_c, groups, cons, n_groups,
          src_rows, src_cols};
}

}  // namespace

// K2 on `stream`.  `bf16` selects the band type, which is also the type of
// lr [n_frames, h, w] and err (same shape); hr [H, W] is float32.  The row
// pack's sr/bandr hold nb blocks of blk_r rows, the column pack's sc/bandc
// nt tiles of tile_c columns.  Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for operands it does not take.
extern "C" int fused_fwd_launch(int bf16, const void* bandr, const int* sr,
                                int nb, int n_u, int blk_r, int win_r,
                                const void* bandc, const int* sc, int nt,
                                int n_c, int win_c, int tile_c,
                                const int* groups, int n_groups,
                                const int* cons, const float* hr, int H,
                                int W, const void* lr, void* err,
                                int n_frames, int h, int w, void* stream) {
  if (bf16)
    return fwd(ops<__nv_bfloat16>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c,
                                  win_c, tile_c, groups, n_groups, cons, H, W),
               nb, nt, hr, lr, err, n_frames, h, w, stream);
  return fwd(ops<float>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c, win_c,
                        tile_c, groups, n_groups, cons, H, W),
             nb, nt, hr, lr, err, n_frames, h, w, stream);
}

// K3 on `stream`: err [n_frames, h, w] of the band type, hr and out [H, W]
// float32, out = clip(hr + scale * z, lo, hi).  Same packs and return code
// as fused_fwd_launch.
extern "C" int fused_bwd_launch(int bf16, const void* bandr, const int* sr,
                                int nb, int n_u, int blk_r, int win_r,
                                const void* bandc, const int* sc, int nt,
                                int n_c, int win_c, int tile_c,
                                const int* groups, int n_groups,
                                const int* cons, const void* err, int h,
                                int w, const float* hr, float* out, int H,
                                int W, float scale, float lo, float hi,
                                void* stream) {
  if (bf16)
    return bwd(ops<__nv_bfloat16>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c,
                                  win_c, tile_c, groups, n_groups, cons, h, w),
               nb, nt, err, hr, out, H, W, scale, lo, hi, stream);
  return bwd(ops<float>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c, win_c,
                        tile_c, groups, n_groups, cons, h, w),
             nb, nt, err, hr, out, H, W, scale, lo, hi, stream);
}
