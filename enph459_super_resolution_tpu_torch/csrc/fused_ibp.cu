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
// operators and outputs that consume it.  Every CUDA block owns a 64 x 64
// output tile (BM x TN) of one row block and one column tile, so blocks and
// tiles of any multiple of 64 (the port's 64/64 pack, the TPU's 128/256
// pack) map onto the same grid; any window start is taken.
//
// Two band types:
//
// * bfloat16 bands run the reference's bf16 dots on the tensor cores
//   (mma.sync m16n8k16, bf16 x bf16 summed in f32): the input window is
//   rounded to bf16, each row product ys is rounded to bf16 (nearest even)
//   before its column product; lr and err are bf16, hr and the update f32.
//   Both products of a tile form a chain of two GEMMs, as in flash
//   attention: the f32 C fragments of two adjacent n8 tiles of ys are,
//   once packed to bf16 pairs, the A fragment of one k16 step of the column
//   product, so ys never leaves the registers.  Each of the 8 warps owns 16
//   output rows.  K2 keeps one accumulator set per frame, so its warps
//   split the 64 columns in two and both warps of a row strip form the same
//   ys: 16 f32 accumulators per frame, 80 at 5 frames, two CTAs per SM.
//   K3 has one output: the two warps of a row strip take alternate plan
//   groups over all 64 columns (no ys is formed twice) and add their sums
//   through shared memory in the epilogue.  A CTA keeps its 64-row slice of
//   every unique row operator resident in shared memory (as many as fit; the
//   window is walked once per set where they do not) and walks the column
//   window in chunks of 16 (KS) intermediate columns, chunk outer and plan
//   inner, so each input chunk and column-operator chunk is staged once and
//   used by every group.  A ring filled by cp.async (16-byte copies,
//   zero-filled past the window and the image; element copies where a
//   window start is not 16-byte aligned; the port's pack aligns its column
//   starts) overlaps the next chunks' loads with this chunk's products.
//   K2's hr is f32 in memory: its chunk lands as f32 and is rounded to bf16
//   pairs once per CTA; K3's err is bf16 and lands as it is, every frame's
//   chunk in each stage.  A K3 CTA walks four adjacent column tiles with its
//   row operators resident and the ring running on from one tile into the
//   next.  Windows are zero-padded to multiples of 16 in shared memory, so
//   the last chunk wastes nothing beyond the pack's own padding; rows are
//   padded to odd multiples of 16 bytes, so the ldmatrix reads are
//   conflict-free.  The epilogue of a whole tile issues every load of lr
//   or hr before its first store.
// * float32 bands run strict f32 (CUDA-core FMA only: no tensor cores, no
//   TF32, no --use_fast_math): the row operator's block as f32 in shared
//   memory, the input window streamed in 32-column chunks, each unique row
//   product formed once per chunk into shared memory and consumed at once
//   by every column operator that uses it, per-output 4x4 register tiles.
//
// What bounds it.  At LR 1536x2048 -> HR 3072x4096 with 5 frames and 3
// unique row operators, K2's dense-window work is ~2 * 7.3 G FMA and K3's
// ~2 * 6.3 G.  In f32 that is bound by the CUDA cores (SMs x 128 FMA/clk,
// ~67 TFLOP/s at 700 W: 0.27-0.30 ms), not by the ~0.2 GB each launch
// moves.  With bf16 bands the bound is the bytes (hr, lr and err, ~117 MB
// for K2 and ~135 MB for K3 at 3.35 TB/s: 0.035-0.040 ms); the products
// (~24 GFLOP each, with the padded windows and K2's doubled row product)
// take about as long at a third of the tensor cores' 989 TFLOP/s.  On an
// H100 at 700 W the kernels are bound by neither: they run at 0.23-0.25 ms
// per launch at that size, held by the latency of their chains of
// dependent ldmatrix and mma.sync steps and of the staging between them
// (PERF.md gives the breakdown).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;        // output rows per CUDA block (fused_ibp.py ROWS)
constexpr int TN = 64;        // output columns per CUDA block (fused_ibp.py COLS)
constexpr int KC = 32;        // intermediate columns per chunk
constexpr int BMP = BM + 4;   // padded row stride of the k-major tiles
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MAX_OUT = 8;    // frames of one K2 launch (fused_ibp.py MAX_FRAMES)
constexpr int MAX_SMEM = 232448;

using bf16 = __nv_bfloat16;

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
      br_s[k * BMP + r] = br[static_cast<size_t>(r) * p.win_r + k];
    }

    for (int kc = 0; kc < p.win_c; kc += KC) {
      for (int e = tid; e < p.win_r * KC; e += THREADS) {
        const int k = e / KC;
        const int cc = e % KC;
        const int xr = row0 + k;
        const int xc = col0 + kc + cc;
        xs_s[e] = (xr < p.src_rows && xc < p.src_cols && kc + cc < p.win_c)
                      ? x[static_cast<size_t>(xr) * p.src_cols + xc]
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
          ys_s[(yc + c) * BMP + yr + i] = y[i][c];
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
                        ? bc[static_cast<size_t>(cc) * p.tile_c + n]
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
        err[at] = lr[at] - acc[o][i][c];
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

// ---------------------------------------------------------------------------
// bfloat16 bands: both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int KS = 16;       // intermediate columns per chunk: one k16 step
constexpr int XS = KS + 8;   // row stride of a staged bf16 input chunk (48 B)
constexpr int CS = TN + 8;   // row stride of a staged bandc chunk (144 B)
// Depth of the cp.async ring: K2's f32 chunk leaves room for two stages at
// two CTAs per SM; K3 takes three (two measured the same).
constexpr int FWD_STAGES = 2;
constexpr int BWD_STAGES = 3;
// 64-column tiles per CUDA block, whose row operators stay resident across
// them.  K2's 768 tiles at the mono pack are 2.9 waves of 264 CTAs as they
// are (two per block measured slower); K3's 3,072 are short, and four per
// block measured fastest of 1, 2, 4 and 8.
constexpr int FWD_TILES = 1;
constexpr int BWD_TILES = 4;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout of the bf16 kernels, byte offsets from the base:
// n_res resident row operators [n_res][BM][wr]; for the f32 input (K2),
// one [kr][XS] buffer of its chunk rounded to bf16; then the ring of
// `stages` stages, each the input chunk (f32 input: [kr][KS] f32; bf16
// inputs: [n_src][kr][XS] bf16) followed by the column-operator chunk
// [n_c][KS][CS].  K3 also sums its two warp sets' accumulators through the
// stage just consumed, so its stages hold at least RED_BYTES.  kr is the row
// window padded to 16 and wr = kr + 8, so every row is an odd multiple of
// 16 bytes and the eight rows an ldmatrix reads fall in distinct banks.
constexpr int RED_BYTES = 4 * 32 * THREADS / 2;  // K3: 32 floats per thread

struct Layout {
  int kr, wr;
  size_t xb, ring, stage, bc, total;
};

__host__ __device__ inline Layout layout(int n_res, int win_r, int n_c,
                                         int n_src, bool f32_src,
                                         int stages) {
  Layout l;
  l.kr = round16(win_r);
  l.wr = l.kr + 8;
  l.xb = sizeof(bf16) * n_res * BM * l.wr;
  l.ring = l.xb + (f32_src ? sizeof(bf16) * l.kr * XS : 0);
  l.bc = f32_src ? sizeof(float) * l.kr * KS
                 : sizeof(bf16) * n_src * l.kr * XS;
  l.stage = l.bc + sizeof(bf16) * n_c * KS * CS;
  if (!f32_src && l.stage < static_cast<size_t>(RED_BYTES)) l.stage = RED_BYTES;
  l.total = l.ring + stages * l.stage;
  return l;
}

// The most row operators that stay resident together within MAX_SMEM (the
// kernel walks the plan once per such set); 0 if not even one fits.
inline int resident_ops(int n_u, int win_r, int n_c, int n_src, bool f32_src,
                        int stages) {
  int n = n_u;
  while (n > 0 && layout(n, win_r, n_c, n_src, f32_src, stages).total >
                      static_cast<size_t>(MAX_SMEM))
    --n;
  return n;
}

// rows x n bf16 elements (n a multiple of 8) from src (row stride ss) into
// dst (row stride ds); zero where row >= vrows or column >= vcols.  `vec`:
// 16-byte cp.async copies (src rows 16-byte aligned, vcols a multiple of
// 8); otherwise element by element.
__device__ __forceinline__ void stage_bf16(bf16* dst, int ds, const bf16* src,
                                           size_t ss, int rows, int n,
                                           int vrows, int vcols, bool vec) {
  const int per = n / 8;
  for (int e = threadIdx.x; e < rows * per; e += THREADS) {
    const int r = e / per;
    const int c = (e - r * per) * 8;
    bf16* d = dst + r * ds + c;
    if (vec) {
      const bool in = r < vrows && c < vcols;
      mma_bf16::cp_async16(d, in ? src + r * ss + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = r < vrows && c + i < vcols ? src[r * ss + c + i]
                                          : __float2bfloat16_rn(0.f);
    }
  }
}

// rows x KS floats, as stage_bf16 (`vec`: vcols a multiple of 4).
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t ss, int rows, int vrows,
                                          int vcols, bool vec) {
  for (int e = threadIdx.x; e < rows * (KS / 4); e += THREADS) {
    const int r = e / (KS / 4);
    const int c = (e % (KS / 4)) * 4;
    float* d = dst + r * KS + c;
    if (vec) {
      const bool in = r < vrows && c < vcols;
      mma_bf16::cp_async16(d, in ? src + r * ss + c : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = r < vrows && c + i < vcols ? src[r * ss + c + i] : 0.f;
    }
  }
}

// One k16 step of a 16 x 16 product: A from a row-major tile (ldmatrix),
// B from a k-major tile (ldmatrix.trans), into two n8 accumulators.
__device__ __forceinline__ void mma_k16(float (&y)[2][4], const bf16* a,
                                        const bf16* b) {
  uint32_t af[4], bf[4];
  mma_bf16::ldmatrix_x4(af, a);
  mma_bf16::ldmatrix_x4_trans(bf, b);
  mma_bf16::mma_16816(y[0], af, bf[0], bf[1]);
  mma_bf16::mma_16816(y[1], af, bf[2], bf[3]);
}

// The output tiles of one CUDA block: the 64-row strip r_off of row block b
// and n_tiles consecutive 64-column tiles from jt0 on, counted across the
// pack's column tiles (tile_c / TN each).
struct Strip {
  int b, r_off, jt0, n_tiles;
};

__device__ __forceinline__ Strip strip_of(int blk_r, int n_cols,
                                          int per_cta) {
  const int per_blk = blk_r / BM;
  const int y = blockIdx.y;
  const int jt0 = static_cast<int>(blockIdx.x) * per_cta;
  return {y / per_blk, (y % per_blk) * BM, jt0, min(per_cta, n_cols - jt0)};
}

// Walks this block's tiles and, for each, accumulates terms of the plan as
// mma C fragments, warp (wm, wn) = (warp % 4, warp / 4) holding rows
// wm*16..+15.  NT = 4 (K2): every term, columns wn*32 + nt*8 .. +7 (4 n8
// tiles); both warps of a row strip form the same row products, so each
// holds 16 accumulators per output.  NT = 8 (K3, one output): the terms of
// the groups g with g % 2 == wn, all 64 columns; the epilogue adds the two
// warps' sums.  After a tile's last chunk it calls epi(acc, j, c_off,
// scratch), scratch being the stage just consumed (free until the next
// chunk's loads are issued), and zeroes acc.  SrcT float: one input (hr),
// rounded to bf16 on the way in; bf16: n_src inputs (the err stack).  The
// row operators stay resident n_res at
// a time.  With one set (every pack of the solves) they are staged once
// and the ring runs on from one tile into the next; with more, each tile
// walks its column window once per set.
template <typename SrcT, int NOUT, int STAGES, int NT, typename Epi>
__device__ __forceinline__ void mma_tiles(const Ops<bf16>& p,
                                          const SrcT* __restrict__ src,
                                          int n_src, int n_res,
                                          const Strip& st, Epi&& epi) {
  using namespace mma_bf16;
  constexpr bool kF32 = std::is_same<SrcT, float>::value;
  constexpr int PER16 = 16 / static_cast<int>(sizeof(SrcT));
  extern __shared__ __align__(128) char mma_smem[];
  const Layout L = layout(n_res, p.win_r, p.n_c, n_src, kF32, STAGES);
  bf16* br_s = reinterpret_cast<bf16*>(mma_smem);
  bf16* xb_s = reinterpret_cast<bf16*>(mma_smem + L.xb);
  char* ring = mma_smem + L.ring;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  // ldmatrix lane addresses: lanes 8m..8m+7 give the rows of matrix m,
  // rows (m % 2) * 8 + lane % 8 at column (m / 2) * 8 of a 16 x 16 tile
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc = (lane >> 4) * 8;

  const int row0 = p.sr[st.b];
  const size_t plane = static_cast<size_t>(p.src_rows) * p.src_cols;
  const int vrows = min(p.win_r, p.src_rows - row0);
  const int nk = (p.win_c + KS - 1) / KS;
  const int nks = L.kr / 16;
  const int per_tile = p.tile_c / TN;
  const int n_sets = (p.n_u + n_res - 1) / n_res;
  const int seg_tiles = n_sets == 1 ? st.n_tiles : 1;
  const bool x_vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                     p.src_cols % PER16 == 0 && p.win_c % PER16 == 0;
  const bool br_vec =
      (reinterpret_cast<uintptr_t>(p.bandr) & 15) == 0 && p.win_r % 8 == 0;
  const bool bc_vec =
      (reinterpret_cast<uintptr_t>(p.bandc) & 15) == 0 && p.tile_c % 8 == 0;

  float acc[NOUT][NT][4];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[o][n][c] = 0.f;

  // step (tile ti0 + step / nk, chunk step % nk): that chunk of every
  // column operator and of the input(s) into its stage of the ring
  auto load_step = [&](int step, int ti0) {
    const int jt = st.jt0 + ti0 + step / nk;
    const int j = jt / per_tile;
    const int c_off = (jt % per_tile) * TN;
    const int k0 = (step % nk) * KS;
    const int col0 = p.sc[j];
    char* stage = ring + (step % STAGES) * L.stage;
    bf16* bc = reinterpret_cast<bf16*>(stage + L.bc);
    for (int c = 0; c < p.n_c; ++c)
      stage_bf16(bc + c * KS * CS, CS,
                 p.bandc + ((static_cast<size_t>(j) * p.n_c + c) * p.win_c +
                            k0) * p.tile_c + c_off,
                 p.tile_c, KS, TN, p.win_c - k0, TN, bc_vec);
    const int vcols = min(p.win_c - k0, p.src_cols - col0 - k0);
    const bool vec = x_vec && col0 % PER16 == 0;
    const SrcT* x = src + static_cast<size_t>(row0) * p.src_cols + col0 + k0;
    if constexpr (kF32) {
      stage_f32(reinterpret_cast<float*>(stage), x, p.src_cols, L.kr, vrows,
                vcols, vec);
    } else {
      for (int in = 0; in < n_src; ++in)
        stage_bf16(reinterpret_cast<bf16*>(stage) + in * L.kr * XS, XS,
                   x + in * plane, p.src_cols, L.kr, KS, vrows, vcols, vec);
    }
  };

  for (int ti0 = 0; ti0 < st.n_tiles; ti0 += seg_tiles) {
    const int n_steps = seg_tiles * nk;
    for (int set = 0; set < n_sets; ++set) {
      const int u0 = set * n_res;
      const int u1 = min(p.n_u, u0 + n_res);
      if (n_sets > 1 || ti0 == 0) {
        __syncthreads();  // every reader of the previous set is done
        for (int u = u0; u < u1; ++u)
          stage_bf16(br_s + (u - u0) * BM * L.wr, L.wr,
                     p.bandr + ((static_cast<size_t>(st.b) * p.n_u + u) *
                                    p.blk_r + st.r_off) * p.win_r,
                     p.win_r, BM, L.kr, BM, p.win_r, br_vec);
      }
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_steps) load_step(s, ti0);
        cp_async_commit();
      }

      for (int step = 0; step < n_steps; ++step) {
        const int kc = step % nk;
        char* stage = ring + (step % STAGES) * L.stage;
        cp_async_wait<STAGES - 2>();
        // this step's chunk has landed for every thread, and every thread
        // is done with the previous step, whose stage is refilled next
        __syncthreads();
        if constexpr (kF32) {
          const float* xf = reinterpret_cast<const float*>(stage);
          for (int e = tid; e < L.kr * (KS / 2); e += THREADS) {
            const int r = e / (KS / 2);
            const int c = (e % (KS / 2)) * 2;
            const float2 v =
                *reinterpret_cast<const float2*>(xf + r * KS + c);
            *reinterpret_cast<uint32_t*>(xb_s + r * XS + c) =
                pack_bf16x2(v.x, v.y);
          }
        }
        if (step + STAGES - 1 < n_steps) load_step(step + STAGES - 1, ti0);
        cp_async_commit();
        if constexpr (kF32) __syncthreads();  // the rounded chunk is ready

        const bf16* xs = kF32 ? xb_s : reinterpret_cast<const bf16*>(stage);
        const bf16* bc = reinterpret_cast<const bf16*>(stage + L.bc);
        for (int g = NT == 8 ? wn : 0; g < p.n_groups;
             g += NT == 8 ? 2 : 1) {
          // (input, row op, first consumer, end) in one load
          const int4 gr = __ldg(reinterpret_cast<const int4*>(p.groups) + g);
          const int u = gr.y;
          if (u < u0 || u >= u1) continue;
          // ys (16 rows x 16 intermediate columns) over the row window,
          // with two accumulator sets for even and odd k16 steps
          const bf16* a = br_s + ((u - u0) * BM + wm * 16 + lr) * L.wr + lc;
          const bf16* x = xs + (kF32 ? 0 : gr.x * L.kr * XS) + lr * XS + lc;
          float y0[2][4] = {}, y1[2][4] = {};
          int ks = 0;
          for (; ks + 1 < nks; ks += 2) {
            mma_k16(y0, a + ks * 16, x + ks * 16 * XS);
            mma_k16(y1, a + ks * 16 + 16, x + (ks + 1) * 16 * XS);
          }
          if (ks < nks) mma_k16(y0, a + ks * 16, x + ks * 16 * XS);
          // rounded to bf16: the C fragments of the two n8 tiles are the A
          // fragment of the column product's k16 step
          uint32_t ya[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ya[h] = pack_bf16x2(y0[0][2 * h] + y1[0][2 * h],
                                y0[0][2 * h + 1] + y1[0][2 * h + 1]);
            ya[2 + h] = pack_bf16x2(y0[1][2 * h] + y1[1][2 * h],
                                    y0[1][2 * h + 1] + y1[1][2 * h + 1]);
          }
          for (int q = gr.z; q < gr.w; ++q) {
            // (column op, output)
            const int2 co = __ldg(reinterpret_cast<const int2*>(p.cons) + q);
            const int cop = co.x;
            const int o = co.y;
            const bf16* cb =
                bc + cop * KS * CS + lr * CS + (NT == 8 ? 0 : wn * 32) + lc;
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              uint32_t bq[4];
              ldmatrix_x4_trans(bq, cb + np * 16);
#pragma unroll
              for (int oo = 0; oo < NOUT; ++oo) {
                if (oo != o) continue;
                mma_16816(acc[oo][2 * np], ya, bq[0], bq[1]);
                mma_16816(acc[oo][2 * np + 1], ya, bq[2], bq[3]);
              }
            }
          }
        }

        if (kc == nk - 1 && set == n_sets - 1) {
          const int jt = st.jt0 + ti0 + step / nk;
          epi(acc, jt / per_tile, (jt % per_tile) * TN, stage);
#pragma unroll
          for (int o = 0; o < NOUT; ++o)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[o][n][c] = 0.f;
        }
      }
    }
  }
}

// Two CTAs per SM where the accumulators leave room (<= 128 registers).
template <int NOUT>
struct FwdBlocks {
  static constexpr int value = NOUT <= 5 ? 2 : 1;
};

template <int NOUT>
__global__ void __launch_bounds__(THREADS, FwdBlocks<NOUT>::value)
fused_fwd_mma_kernel(Ops<bf16> p, int n_res, int n_cols, int per_cta,
                     const float* __restrict__ hr,
                     const bf16* __restrict__ lr, bf16* __restrict__ err,
                     int h, int w) {
  const Strip st = strip_of(p.blk_r, n_cols, per_cta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this thread's first row and column in the mma C layout: lane l holds
  // rows g, g + 8 and columns 2t, 2t + 1 of each n8 tile
  const int tile_row0 = st.b * p.blk_r + st.r_off;
  const int row0 = tile_row0 + (warp & 3) * 16 + (lane >> 2);
  const bool pairs = w % 2 == 0;  // bf16 pairs 4-byte aligned
  auto epi = [&](float (&acc)[NOUT][4][4], int j, int c_off, char*) {
    const int col0 = j * p.tile_c + c_off + (warp >> 2) * 32 + 2 * (lane & 3);
    if (pairs && tile_row0 + BM <= h && j * p.tile_c + c_off + TN <= w) {
      // a whole tile: each frame's lr loads in flight at once, then the
      // stores
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        __nv_bfloat162 l[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            l[hh][n] = *reinterpret_cast<const __nv_bfloat162*>(
                lr + (static_cast<size_t>(o) * h + row0 + 8 * hh) * w + col0 +
                n * 8);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float2 v = __bfloat1622float2(l[hh][n]);
            *reinterpret_cast<__nv_bfloat162*>(
                err + (static_cast<size_t>(o) * h + row0 + 8 * hh) * w +
                col0 + n * 8) =
                __floats2bfloat162_rn(v.x - acc[o][n][2 * hh],
                                      v.y - acc[o][n][2 * hh + 1]);
          }
      }
      return;
    }
#pragma unroll
    for (int o = 0; o < NOUT; ++o)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
        if (row >= h) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = col0 + n * 8;
          const size_t at = (static_cast<size_t>(o) * h + row) * w + col;
          const float z0 = acc[o][n][2 * hh];
          const float z1 = acc[o][n][2 * hh + 1];
          if (pairs && col + 1 < w) {
            const float2 l = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(lr + at));
            *reinterpret_cast<__nv_bfloat162*>(err + at) =
                __floats2bfloat162_rn(l.x - z0, l.y - z1);
          } else {
            if (col < w)
              err[at] = __float2bfloat16_rn(__bfloat162float(lr[at]) - z0);
            if (col + 1 < w)
              err[at + 1] =
                  __float2bfloat16_rn(__bfloat162float(lr[at + 1]) - z1);
          }
        }
      }
  };
  mma_tiles<float, NOUT, FWD_STAGES, 4>(p, hr, 1, n_res, st, epi);
}

__global__ void __launch_bounds__(THREADS, 2)
fused_bwd_mma_kernel(Ops<bf16> p, int n_res, int n_cols, int per_cta,
                     const bf16* __restrict__ err, int n_src,
                     const float* __restrict__ hr, float* __restrict__ out,
                     int H, int W, float scale, float lo, float hi) {
  const Strip st = strip_of(p.blk_r, n_cols, per_cta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = (warp & 3) * 32 + lane;
  const int tile_row0 = st.b * p.blk_r + st.r_off;
  const int row0 = tile_row0 + (warp & 3) * 16 + (lane >> 2);
  const bool pairs = W % 2 == 0;  // float2 8-byte aligned
  auto epi = [&](float (&acc)[1][8][4], int j, int c_off, char* scratch) {
    // the two warps of a row strip summed alternate groups: the second
    // hands its sums to the first (lane-contiguous, so conflict-free),
    // which adds them and writes the tile
    float* red = reinterpret_cast<float*>(scratch);
    __syncthreads();  // every warp is done with the stage
    if (warp >= 4) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[(n * 4 + c) * 128 + slot] = acc[0][n][c];
    }
    __syncthreads();
    if (warp >= 4) return;
    const int col0 = j * p.tile_c + c_off + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][n][c] += red[(n * 4 + c) * 128 + slot];
    // hr + scale * z, rounded after each step as the plain version does
    auto update = [&](float x, float z) {
      return fminf(fmaxf(__fadd_rn(x, __fmul_rn(scale, z)), lo), hi);
    };
    if (pairs && tile_row0 + BM <= H && j * p.tile_c + c_off + TN <= W) {
      // a whole tile: every hr load in flight at once, then the stores
      float2 x[2][8];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          x[hh][n] = *reinterpret_cast<const float2*>(
              hr + static_cast<size_t>(row0 + 8 * hh) * W + col0 + n * 8);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>(row0 + 8 * hh) * W + col0 + n * 8) =
              make_float2(update(x[hh][n].x, acc[0][n][2 * hh]),
                          update(x[hh][n].y, acc[0][n][2 * hh + 1]));
      return;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= H) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + n * 8 + e;
          const size_t at = static_cast<size_t>(row) * W + col;
          if (col < W) out[at] = update(hr[at], acc[0][n][2 * hh + e]);
        }
    }
  };
  mma_tiles<bf16, 1, BWD_STAGES, 8>(p, err, n_src, n_res, st, epi);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename BandT>
int check(const Ops<BandT>& p, int nb, int nt, size_t smem, dim3* grid) {
  if (nb <= 0 || nt <= 0 || p.n_u <= 0 || p.n_c <= 0 || p.win_r <= 0 ||
      p.win_c <= 0 || p.blk_r <= 0 || p.tile_c <= 0 || p.blk_r % BM != 0 ||
      p.tile_c % TN != 0 || p.n_groups <= 0 || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3(nt * (p.tile_c / TN), nb * (p.blk_r / BM), 1);
  if (grid->y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);

  kernel<<<grid, THREADS, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int NOUT>
int launch_fwd(const Ops<float>& p, int, dim3 grid, size_t smem,
               cudaStream_t s, const float* hr, const void* lr, void* err,
               int h, int w) {
  return launch(fused_fwd_kernel<float, NOUT>, grid, smem, s, p, hr,
                static_cast<const float*>(lr), static_cast<float*>(err), h,
                w);
}

// bf16: grid.x counts CUDA blocks of FWD_TILES tiles
template <int NOUT>
int launch_fwd(const Ops<bf16>& p, int n_res, dim3 grid, size_t smem,
               cudaStream_t s, const float* hr, const void* lr, void* err,
               int h, int w) {
  const int n_cols = static_cast<int>(grid.x);
  grid.x = (n_cols + FWD_TILES - 1) / FWD_TILES;
  return launch(fused_fwd_mma_kernel<NOUT>, grid, smem, s, p, n_res, n_cols,
                FWD_TILES, hr,
                static_cast<const bf16*>(lr), static_cast<bf16*>(err), h, w);
}

template <typename BandT>
int fwd(const Ops<BandT>& p, int nb, int nt, const float* hr, const void* lr,
        void* err, int n_frames, int h, int w, void* stream) {
  size_t smem = smem_bytes(p.win_r);
  int n_res = 0;
  if constexpr (std::is_same<BandT, bf16>::value) {
    n_res = resident_ops(p.n_u, p.win_r, p.n_c, 1, true, FWD_STAGES);
    if (n_res == 0) return static_cast<int>(cudaErrorInvalidValue);
    smem = layout(n_res, p.win_r, p.n_c, 1, true, FWD_STAGES).total;
  }
  dim3 grid;
  const int rc = check(p, nb, nt, smem, &grid);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_frames) {
    case 1: return launch_fwd<1>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 2: return launch_fwd<2>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 3: return launch_fwd<3>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 4: return launch_fwd<4>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 5: return launch_fwd<5>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 6: return launch_fwd<6>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case 7: return launch_fwd<7>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    case MAX_OUT:
      return launch_fwd<MAX_OUT>(p, n_res, grid, smem, s, hr, lr, err, h, w);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int bwd(const Ops<float>& p, int nb, int nt, const void* err, int,
        const float* hr, float* out, int H, int W, float scale, float lo,
        float hi, cudaStream_t s) {
  const size_t smem = smem_bytes(p.win_r);
  dim3 grid;
  const int rc = check(p, nb, nt, smem, &grid);
  if (rc != 0) return rc;
  return launch(fused_bwd_kernel<float>, grid, smem, s, p,
                static_cast<const float*>(err), hr, out, H, W, scale, lo, hi);
}

int bwd(const Ops<bf16>& p, int nb, int nt, const void* err, int n_frames,
        const float* hr, float* out, int H, int W, float scale, float lo,
        float hi, cudaStream_t s) {
  const int n_res =
      n_frames > 0
          ? resident_ops(p.n_u, p.win_r, p.n_c, n_frames, false, BWD_STAGES)
          : 0;
  if (n_res == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      layout(n_res, p.win_r, p.n_c, n_frames, false, BWD_STAGES).total;
  dim3 grid;
  const int rc = check(p, nb, nt, smem, &grid);
  if (rc != 0) return rc;
  const int n_cols = static_cast<int>(grid.x);
  grid.x = (n_cols + BWD_TILES - 1) / BWD_TILES;
  return launch(fused_bwd_mma_kernel, grid, smem, s, p, n_res, n_cols,
                BWD_TILES, static_cast<const bf16*>(err), n_frames, hr, out, H, W, scale,
                lo, hi);
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
                                const int* cons, const void* err,
                                int n_frames, int h, int w, const float* hr,
                                float* out, int H, int W, float scale,
                                float lo, float hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd(ops<__nv_bfloat16>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c,
                                  win_c, tile_c, groups, n_groups, cons, h, w),
               nb, nt, err, n_frames, hr, out, H, W, scale, lo, hi, s);
  return bwd(ops<float>(bandr, sr, n_u, blk_r, win_r, bandc, sc, n_c, win_c,
                        tile_c, groups, n_groups, cons, h, w),
             nb, nt, err, n_frames, hr, out, H, W, scale, lo, hi, s);
}
